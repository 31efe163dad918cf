"""Training the port's LLaMA-architecture families against the JAX
package, on the CPU in f32, and two repairs beside them.

A one-layer tiny Flax LLaMA (``bayeformers_tpu/models/llama.py``) converted
by ``to_bayesian(delta=0.05, freeze=True)`` is carried over with
``from_jax_params``; the ELBO objective with the LM loss and
``make_elbo_train_step`` over two AdamW steps (the workload's optimizer
against optax's ``adamw`` behind the JAX package's ``masked_optimizer``)
run in both packages at the JAX package's own draws: the gradients within
1e-4 of each leaf's largest entry, the trained tensors within 1e-6 after
each step (one f32 ulp a step on rho, as in the GPT-2 test). Then
``gpt2_lm.train(model="llama"|"gemma", size="tiny")`` end to end on the
CPU; a trainable tensor without a gradient moves as optax's masked AdamW
moves a zero-gradient leaf; and ``bert_glue`` refuses a CamemBERT name.
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
from bayeformers_tpu.models import llama as jllama
from bayeformers_tpu.utils.optim import masked_optimizer as jmasked_optimizer
from bayeformers_tpu.workloads import gpt2_lm as jlm
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.models.gpt2 import synthetic_lm_batch
from bayeformers_tpu_torch.models.llama import LlamaConfig
from bayeformers_tpu_torch.nn.surgery import leaf
from bayeformers_tpu_torch.utils.optim import ClippedAdamW
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
    bundle = jllama.build_llama_family("llama", size="tiny", seed=0, num_hidden_layers=1)
    bmodel, bp = bf.to_bayesian(bundle.apply_fn, bundle.params, delta=0.05, freeze=True)
    return bundle, bmodel, bp


def _port(bundle, bp):
    return bt.from_jax_params(flatten_dict(bp.params, sep="/"),
                              {p: np.asarray(r) for p, r in bp.rho.items()},
                              config=LlamaConfig.from_dict("llama", bundle.config.to_dict()),
                              device="cpu")


def test_lm_objective_gradients_match_jax(jax_model):
    """The ELBO with ``lm_loss`` and its gradients (rho, the embedding and
    the RMSNorm weights), antithetic, at the JAX draws."""
    bundle, bmodel, bp = jax_model
    port = _port(bundle, bp)
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
    loss, _ = training.elbo_objective(
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
    assert {n for n, _, _ in named} >= {"params/model/embed_tokens/embedding",
                                        "params/model/norm/weight"}


def test_two_lm_steps_match_jax(jax_model):
    """Two AdamW steps of ``make_elbo_train_step(loss_fn=lm_loss)``: metrics
    2e-5, every trained tensor within 1e-6 after each step or one f32 ulp of
    its value a step where that is larger, frozen mu bit-equal."""
    bundle, bmodel, bp = jax_model
    port = _port(bundle, bp)
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
        for path, want in flatten_dict(jbp.params, sep="/").items():
            got = leaf(port.model, path).detach().numpy()
            if path in port.spec.paths:
                np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)
            else:
                close(got, want, path, i + 1)
        for path, want in jbp.rho.items():
            close(port.rho[path].detach().numpy(), want, path, i + 1)
    assert opt.count == 2


@pytest.mark.parametrize("model,estimator", [("llama", "naive"), ("gemma", "antithetic")])
def test_llama_lm_runs_on_cpu(tmp_path, model, estimator):
    """``gpt2_lm.train(model=..., size="tiny")`` phases 1-4 on the CPU:
    finite results, the MOPED accuracy within 0.1 of the frequentist one."""
    res = gpt2_lm.train(model=model, size="tiny", seq=32, n_train=32, n_test=16,
                        limit_batches=2, samples=4, estimator=estimator, device="cpu",
                        logs=str(tmp_path))
    assert all(np.isfinite(v) for v in res.values()), res
    assert abs(res["moped_acc"] - res["freq_acc"]) < 0.1
    assert (tmp_path / f"{model}_lm.DELTA_0.05.jsonl").exists()


def test_gpt2_lm_takes_config_overrides(tmp_path):
    """``train(**config_overrides)`` reach ``build_llama_family``: a tiny
    LLaMA at ``max_position_embeddings=256`` runs at seq 192, past the
    preset's 128."""
    res = gpt2_lm.train(model="llama", size="tiny", seq=192, n_train=8, n_test=8,
                        limit_batches=1, samples=2, estimator="antithetic", device="cpu",
                        logs=str(tmp_path), max_position_embeddings=256,
                        num_hidden_layers=1)
    assert all(np.isfinite(v) for v in res.values()), res


def test_a_tensor_without_grad_moves_as_optax_masked_adamw():
    """A trainable tensor that the loss did not reach (``grad`` None) takes
    a zero gradient, as optax's ``masked(adamw)`` gives a zero-gradient
    leaf: its moments decay, it takes the m_hat update and it is decayed.
    Two steps against the JAX package's ``masked_optimizer``, 1e-6 (the two-step
    tests' tolerance); the
    frozen tensor, outside the optimizer, stays put."""
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(5).astype(np.float32) for k in ("a", "b", "frozen")}
    grads = [{"a": rng.standard_normal(5).astype(np.float32), "b": np.zeros(5, np.float32)}
             for _ in range(2)]
    jtx = jmasked_optimizer(optax.adamw(1e-2, weight_decay=0.1),
                            {"a": True, "b": True, "frozen": False})
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = jtx.init(jp)
    tensors = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = ClippedAdamW([("a", tensors["a"], True), ("b", tensors["b"], True)], 1e-2, 0.1,
                       clip_norm=None)
    for g in grads:
        upd, state = jtx.update({**{k: jnp.asarray(v) for k, v in g.items()},
                                 "frozen": jnp.ones(5)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        tensors["a"].grad = torch.from_numpy(g["a"])
        tensors["b"].grad = None  # the loss never reached b
        opt.step()
        for k in ("a", "b", "frozen"):
            np.testing.assert_allclose(tensors[k].numpy(), np.asarray(jp[k]), atol=1e-6,
                                       err_msg=k)
    assert not np.array_equal(tensors["b"].numpy(), init["b"])
    np.testing.assert_array_equal(tensors["frozen"].numpy(), init["frozen"])


def test_bert_glue_refuses_camembert(tmp_path, monkeypatch):
    """The reference's ``build_model`` sends a CamemBERT name to
    ``build_roberta`` (``bayeformers_tpu/models/bert.py:291``): the port's
    ``bert_glue`` no longer refuses it or the other BERT siblings; it hands
    each name to ``families.build_model``, which builds RoBERTa for
    CamemBERT."""
    from bayeformers_tpu_torch.models import families

    assert type(families.build_model("camembert-base", size="tiny", device="cpu")) is \
        families.RobertaForSequenceClassification
    asked = []

    def stop(name, **kw):
        asked.append(name)
        raise RuntimeError("built")

    monkeypatch.setattr(families, "build_model", stop)
    for name in ("camembert-base", "roberta-base", "distilbert-base-uncased"):
        with pytest.raises(RuntimeError, match="built"):
            bert_glue.train(model_name=name, size="tiny", device="cpu", logs=str(tmp_path))
    assert asked == ["camembert-base", "roberta-base", "distilbert-base-uncased"]