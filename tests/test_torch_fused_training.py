"""The port's independent-draw (``fused``) training against the JAX package,
on the CPU in f32, and the GLUE workload's estimator pick and its f32
default (antithetic at S=10, through the regenerating VJP where the
reference's routing sends it).

A tiny Flax BERT converted by ``bayeformers_tpu.to_bayesian(delta=0.05,
freeze=True)`` is carried over with ``from_jax_params``; both packages run
``make_elbo_train_step(estimator="fused")`` (S draws per step, one per
sample) with the JAX package's own per-leaf draws injected into the port,
as ``tests/test_torch_training.py`` does for the antithetic estimator.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
from bayeformers_tpu import training as jtraining
from bayeformers_tpu.models import bert as jbert
from bayeformers_tpu.utils.optim import masked_optimizer as jmasked_optimizer
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.nn.surgery import leaf
from bayeformers_tpu_torch.ops import fused_linear as fl
from bayeformers_tpu_torch.parallel import train as ptrain
from bayeformers_tpu_torch.utils import optim
from bayeformers_tpu_torch.workloads import bert_glue
from test_torch_training import LR, N_BATCHES, WD, _batch, _hook, _port, _port_batch
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def jax_model():
    bundle = jbert.build_bert(size="tiny", seed=0)
    return bf.to_bayesian(bundle.apply_fn, bundle.params, delta=0.05, freeze=True)


@pytest.mark.parametrize("S,mc_chunk", [(3, None), (6, 3)])
def test_fused_two_steps_match_jax(jax_model, S, mc_chunk):
    """One and two AdamW steps of ``estimator="fused"`` at an odd S, and
    with an odd ``mc_chunk``: metrics 2e-5 relative, parameters 1e-6
    absolute, frozen mu bit-equal (the bounds of the antithetic test)."""
    bmodel, bp = jax_model
    port = _port(bp)
    schedule = optax.linear_schedule(LR, 0.0, 10)
    jtx = jmasked_optimizer(
        jtraining.adamw_with_decay_groups(schedule, WD, jtraining.default_no_decay,
                                          eps=1e-8, clip_norm=1.0),
        bmodel.trainable_mask(bp))
    jstep = jtraining.make_elbo_train_step(bmodel, jtx, S, N_BATCHES,
                                           estimator="fused", mc_chunk=mc_chunk)
    tx = training.adamw_with_decay_groups(
        training.linear_schedule(LR, 0.0, 10), WD, training.default_no_decay,
        eps=1e-8, clip_norm=1.0)
    opt = optim.masked_optimizer(tx, port)
    keys_of_step = [None]
    drawn = []
    hook = _hook(bmodel, keys_of_step)

    def counting_hook(chunk, path, n_draws, shape):
        drawn.append(n_draws)
        return hook(chunk, path, n_draws, shape)

    step = training.make_elbo_train_step(port, opt, S, N_BATCHES, estimator="fused",
                                         mc_chunk=mc_chunk, eps_hook=counting_hook)
    jbp, jstate = bp, jtx.init(bp)
    n_chunks = S // mc_chunk if mc_chunk else 1
    for i, key in enumerate((jax.random.key(31), jax.random.key(32))):
        batch = _batch(i)
        jbp, jstate, jm = jstep(jbp, jstate, key, {k: jnp.asarray(v) for k, v in batch.items()})
        keys_of_step[0] = jax.random.split(key, n_chunks) if mc_chunk else [key]
        m = step(200 + i, _port_batch(batch))
        for k in ("loss", "nll", "log_prior", "log_variational_posterior"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5,
                                       err_msg=f"step {i} {k}")
        for k in ("acc", "acc_std"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-6)
        jflat = flatten_dict(jbp.params, sep="/")
        for path, want in jflat.items():
            got = leaf(port.model, path).detach().numpy()
            if path in port.spec.paths:
                np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)
            else:
                np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                           atol=1e-6, err_msg=path)
        for path, want in jbp.rho.items():
            np.testing.assert_allclose(port.rho[path].detach().numpy(),
                                       np.asarray(want), rtol=0, atol=1e-6,
                                       err_msg=path)
    assert set(drawn) == {mc_chunk or S}  # one draw per sample of a chunk
    assert opt.count == 2


def test_bert_glue_odd_samples_run_fused_on_cpu(tmp_path, monkeypatch):
    """An odd S takes the independent-draw estimator end to end."""
    picked = []
    make_step = ptrain.make_train_step  # the workloads' step factory

    def spy(*args, **kwargs):
        picked.append(kwargs["estimator"])
        return make_step(*args, **kwargs)

    monkeypatch.setattr(ptrain, "make_train_step", spy)
    score = bert_glue.train(size="tiny", limit_batches=3, epochs=1, b_epochs=1,
                            samples=3, batch_size=16, device="cpu",
                            logs=str(tmp_path))
    assert 0.0 <= score <= 1.0
    assert picked == ["fused"]


def test_bert_glue_refuses_f32_on_cuda(tmp_path, monkeypatch):
    """f32 activations on a CUDA device are no longer refused: the kernels
    take f32, so ``train()`` and the CLI at their f32 default pass the entry
    and go on to build the f32 model on the card (stopped there: the run
    itself is ``chip_smoke.py``'s)."""
    assert not hasattr(bert_glue, "check_activations")
    built = []

    class Built(Exception):
        pass

    def spy(*args, **kwargs):  # stops the run where it would reach the card
        built.append((kwargs["dtype"], torch.device(kwargs["device"]).type))
        raise Built

    monkeypatch.setattr(bert_glue.families, "build_model", spy)  # the family dispatch
    with pytest.raises(Built):
        bert_glue.train(size="tiny", device=torch.device("cuda"), logs=str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["bert_glue", "--size", "tiny", "--logs",
                                      str(tmp_path), "--device", "cuda"])
    with pytest.raises(Built):
        bert_glue.main()
    assert built == [(torch.float32, "cuda")] * 2


def test_bert_glue_f32_default_trains_on_cpu(tmp_path, monkeypatch):
    """The recipe at its defaults, f32 activations and S=10 (antithetic), on
    the CPU at the tiny size. The tiny model's K pads to 256 in every layer,
    below the f32 routing's threshold of 2048 (which BERT-base's FFN
    down-projections, K = 3072, pass), so the threshold is lowered to 0
    here: every converted layer then trains through the regenerating VJP."""
    picked, regen = [], []
    make_step = ptrain.make_train_step  # the workloads' step factory
    real_regen = fl.regenerate_weights

    def spy_step(*args, **kwargs):
        picked.append(kwargs["estimator"])
        return make_step(*args, **kwargs)

    def spy_regen(mu, rho, seeds, **kwargs):
        regen.append(tuple(mu.shape))
        return real_regen(mu, rho, seeds, **kwargs)

    monkeypatch.setattr(ptrain, "make_train_step", spy_step)
    monkeypatch.setattr(fl, "regenerate_weights", spy_regen)
    monkeypatch.setattr(fl, "ANTI_F32_SAVED_MAX_KP", 0)
    score = bert_glue.train(size="tiny", limit_batches=2, epochs=1, b_epochs=1,
                            batch_size=16, device="cpu", logs=str(tmp_path))
    assert 0.0 <= score <= 1.0
    assert picked == ["antithetic"]
    # two steps, each regenerating the 14 converted kernels once (2 layers
    # x q, k, v, out, FFN up, FFN down; the pooler; the classifier)
    assert len(regen) == 28 and regen.count((256, 128)) == 4
