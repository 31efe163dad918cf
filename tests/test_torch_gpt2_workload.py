"""The GPT-2 workload of the port against the JAX package's, on the CPU in
f32.

A one-layer tiny Flax GPT-2 converted by ``to_bayesian(delta=0.05,
freeze=True)`` is carried over with ``from_jax_params``. The ELBO objective
with the LM loss and ``make_elbo_train_step`` over one and two AdamW steps
(optax's ``adamw`` behind the trainable mask, as the JAX workload takes it)
run in both packages at the JAX package's own draws (antithetic pairs):
gradients within 1e-4 of each leaf's largest entry, parameters after the
steps within 1e-6. Also: the loss and metrics against their JAX
counterparts, the synthetic Markov language bit-equal to the JAX one, CPU
runs of ``gpt2_lm.train(size="tiny")`` at the naive default and
antithetic, and what still raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu import elbo as jelbo
from bayeformers_tpu import training as jtraining
from bayeformers_tpu.models import gpt2 as jgpt2
from bayeformers_tpu.utils.optim import masked_optimizer as jmasked_optimizer
from bayeformers_tpu.workloads import gpt2_lm as jlm
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.models.gpt2 import synthetic_lm_batch
from bayeformers_tpu_torch.nn.surgery import leaf
from bayeformers_tpu_torch.workloads import bert_glue, gpt2_lm
from test_torch_training import _hook
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, B, L = 4, 2, 12
N_BATCHES = 7
LR = 1e-3


def _ids(seed):
    rng = np.random.default_rng(seed)
    return synthetic_lm_batch(rng, B, L, 1024)["input_ids"].astype(np.int32)


@pytest.fixture(scope="module")
def jax_model():
    bundle = jgpt2.build_gpt2(size="tiny", seed=0, n_layer=1)
    bmodel, bp = bf.to_bayesian(bundle.apply_fn, bundle.params, delta=0.05, freeze=True)
    return bmodel, bp


def _port(bp):
    return bt.from_jax_params(flatten_dict(bp.params, sep="/"),
                              {p: np.asarray(r) for p, r in bp.rho.items()}, device="cpu")


def test_lm_objective_gradients_match_jax(jax_model):
    """The ELBO with ``lm_loss`` (sum NLL over B (L - 1) tokens of the
    S-mean logits) and its gradients, antithetic, at the JAX draws."""
    bmodel, bp = jax_model
    port = _port(bp)
    key = jax.random.key(13)
    ids = _ids(0)

    def objective(bparams):
        out, aux = bmodel.mc_apply_fused(bparams, key, S, input_ids=jnp.asarray(ids),
                                         antithetic=True)
        nll, _ = jlm.lm_loss(out, {"input_ids": jnp.asarray(ids)})
        return jelbo.elbo_loss(nll, aux["log_prior"], aux["log_variational_posterior"],
                               N_BATCHES)

    jloss, jgrads = jax.jit(jax.value_and_grad(objective))(bp)
    named = port.trainable_parameters()
    hook = _hook(bmodel, [[key]])
    loss, m = training.elbo_objective(
        training.pick_mc(port, True, "antithetic"), 0, S, {"input_ids": torch.from_numpy(ids).long()},
        N_BATCHES, gpt2_lm.lm_loss, ("input_ids",), eps_hook=lambda *a: hook(0, *a))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-5)
    jflat = flatten_dict(jgrads.params, sep="/")
    for name, t, _ in named:
        kind, path = name.split("/", 1)
        want = np.asarray(jgrads.rho[path] if kind == "rho" else jflat[path])
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
    # the tied wte: the lookup's gradient plus the head's
    assert "params/transformer/wte/embedding" in {n for n, _, _ in named}


def test_two_lm_steps_match_jax(jax_model):
    """Two AdamW steps of ``make_elbo_train_step(loss_fn=lm_loss)``: the
    workload's optimizer (``gpt2_lm.adamw``) against optax's ``adamw``
    behind the JAX package's ``masked_optimizer``; metrics 2e-5, every
    trained tensor within 1e-6 after each step, or within one f32 ulp of
    its value a step where that is larger (rho ~ -7, one ulp 4.8e-7 to
    9.5e-7, decays at 1e-4 here: XLA's AdamW update rounds an ulp off any
    plain f32 evaluation of optax's formula in ~3% of the elements, ours
    included, and the decay's share then flips the sum), frozen mu
    bit-equal."""
    bmodel, bp = jax_model
    port = _port(bp)
    jtx = jmasked_optimizer(optax.adamw(LR), bmodel.trainable_mask(bp))
    jstep = jtraining.make_elbo_train_step(bmodel, jtx, S, N_BATCHES, loss_fn=jlm.lm_loss,
                                           input_keys=("input_ids",),
                                           estimator="antithetic")
    opt = gpt2_lm.adamw(port.trainable_parameters(), LR)
    keys_of_step = [None]
    step = training.make_elbo_train_step(port, opt, S, N_BATCHES, loss_fn=gpt2_lm.lm_loss,
                                         input_keys=("input_ids",), estimator="antithetic",
                                         eps_hook=_hook(bmodel, keys_of_step))
    jbp, jstate = bp, jtx.init(bp)
    def close(got, want, path, n_steps):
        want = np.asarray(want)
        tol = np.maximum(1e-6, n_steps * np.spacing(np.abs(want).astype(np.float32)))
        assert np.all(np.abs(got - want) <= tol), (
            f"{path}: worst {np.abs(got - want).max()} over tolerance "
            f"{(np.abs(got - want) / tol).max()}x")

    for i, key in enumerate((jax.random.key(21), jax.random.key(22))):
        ids = _ids(10 + i)
        jbp, jstate, jm = jstep(jbp, jstate, key, {"input_ids": jnp.asarray(ids)})
        keys_of_step[0] = [key]
        m = step(100 + i, {"input_ids": torch.from_numpy(ids).long()})
        for k in ("loss", "nll", "log_prior", "log_variational_posterior"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5,
                                       err_msg=f"step {i} {k}")
        for k in ("acc", "acc_std"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-6)
        for path, want in flatten_dict(jbp.params, sep="/").items():
            got = leaf(port.model, path).detach().numpy()
            if path in port.spec.paths:
                np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)
            else:
                close(got, want, path, i + 1)
        for path, want in jbp.rho.items():
            close(port.rho[path].detach().numpy(), want, path, i + 1)
    assert opt.count == 2


def test_lm_losses_and_data_match_jax():
    """``lm_nll_sum``, ``lm_loss``'s metrics and ``lm_accuracy_and_std``
    against the JAX workload's on the same logits; the synthetic language
    equal to the JAX one for the same seed."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((S, 3, 10, 50)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 10))
    t = torch.from_numpy
    np.testing.assert_allclose(float(gpt2_lm.lm_nll_sum(t(logits[0]), t(ids))),
                               float(jlm.lm_nll_sum(jnp.asarray(logits[0]),
                                                    jnp.asarray(ids))), rtol=1e-6)
    for got, want in zip(gpt2_lm.lm_accuracy_and_std(t(logits), t(ids)),
                         jlm.lm_accuracy_and_std(jnp.asarray(logits), jnp.asarray(ids))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for seed in (0, 5):
        got = synthetic_lm_batch(np.random.default_rng(seed), 4, 16, 97)
        want = jgpt2.synthetic_lm_batch(np.random.default_rng(seed), 4, 16, 97)
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("estimator", ["naive", "antithetic"])
def test_gpt2_lm_runs_on_cpu(tmp_path, estimator):
    """``gpt2_lm.train(size="tiny")`` phases 1-4 on the CPU: finite results,
    the MOPED accuracy within 0.1 of the frequentist one, the ECE logged."""
    res = gpt2_lm.train(size="tiny", seq=32, n_train=32, n_test=16, limit_batches=2,
                        samples=4, estimator=estimator, device="cpu", logs=str(tmp_path))
    assert all(np.isfinite(v) for v in res.values()), res
    assert abs(res["moped_acc"] - res["freq_acc"]) < 0.1
    assert res["bayes_rate"] == pytest.approx(0.85 + 0.15 / 1024)
    assert "bayesian/ece" in (tmp_path / "gpt2_lm.DELTA_0.05.jsonl").read_text()


def test_what_still_raises(tmp_path):
    """The mesh in one process (no launcher's world) raises, and tp on the
    naive tier names its ROADMAP item (6(d)); a corpus without its
    tokenizer's files raises, naming them; a sequence longer than the
    model's maximum position raises; ``bert_glue`` sends GPT-2 to this
    workload."""
    kw = dict(size="tiny", device="cpu", logs=str(tmp_path))
    for bad, err, item in (({"dp": 2}, ValueError, "the world has 1"),
                           ({"tp": 2}, NotImplementedError, r"item 6\(d\)")):
        with pytest.raises(err, match=item):
            gpt2_lm.train(**bad, **kw)
    (tmp_path / "x.txt").write_text("some text")
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        gpt2_lm.train(corpus=str(tmp_path / "x.txt"), **kw)
    for model in ("gpt2", "llama"):
        with pytest.raises(ValueError, match="maximum position"):
            gpt2_lm.train(model=model, seq=129, **kw)
    with pytest.raises(ValueError, match="gpt2_lm"):
        bert_glue.train(model_name="gpt2", size="tiny", device="cpu", logs=str(tmp_path))
