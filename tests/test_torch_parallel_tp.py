"""The port's tensor-parallel step (the fused tier's Megatron plan,
``nn/fused.py``, over ``parallel/train.py``) on the CPU, ranks as threads
over gloo (``tests/torch_ranks.py``).

On a tiny BERT whose tp = 2 shard boundaries land on the (256, 128) eps
unit grid (hidden 512, 4 heads, intermediate 1024) every shard draws exactly
its slice of the whole layer's noise, so the tp = 2 step is the one-process
step (loss rtol 2e-5, the updated rho leaves rtol 1e-4, as
``tests/test_parallel.py:248-288``; against the JAX package's step:
``test_torch_parallel_tp_jax.py``). Off the grid (the tiny preset's 128-wide
hidden: 64-wide shards) the shards draw apart and the step still runs. And
dp = 2 x tp = 2 on four ranks, and the sharded-aware clip.
"""
import numpy as np
import pytest
import torch

from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.parallel import mesh as mesh_lib
from bayeformers_tpu_torch.parallel import train as ptrain
from bayeformers_tpu_torch.utils import optim
from torch_ranks import (ALIGNED, assert_grads_close, copy_model, optimizer, run_ranks,
                         single_grads, text_batch, tiny_bert, whole_grads)
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, B, L, N_BATCHES = 4, 4, 16, 10
LEAVES = ("bert/encoder/layer/0/attention/self/query/kernel",    # column
          "bert/encoder/layer/0/attention/output/dense/kernel",  # row
          "bert/encoder/layer/0/intermediate/dense/bias",        # column bias
          "classifier/kernel")                                   # replicated


def _tp_step(bmodel, batch, dp, tp, estimator, seed=7, eps_hook=None, clip=False,
             steps=1):
    """Each rank's metrics, whole gradients and whole state after ``steps``
    steps (each at ``seed``)."""
    def rank(r, mesh):
        bm = copy_model(bmodel)
        ptrain.prepare_bayes_params(bm, mesh)
        step = ptrain.make_train_step(
            bm, optimizer(bm, clip_norm=None), S, N_BATCHES, mesh, estimator=estimator,
            eps_hook=eps_hook, clip_norm=1.0 if clip else None)
        for _ in range(steps):
            m = step(seed, mesh_lib.shard_batch(batch, mesh))
        return ({k: float(v) for k, v in m.items()}, whole_grads(bm, mesh),
                mesh_lib.unshard_bayes_params(bm, mesh))

    return run_ranks(dp, tp, rank)


@pytest.fixture(scope="module")
def aligned():
    return tiny_bert(**ALIGNED)


@pytest.mark.parametrize("estimator", ["antithetic", "fused"])
def test_aligned_tp2_matches_one_process(aligned, estimator):
    batch = text_batch(B, L)
    single = copy_model(aligned)
    m1 = training.make_elbo_train_step(single, optimizer(single, clip_norm=None), S,
                                       N_BATCHES, estimator=estimator)(7, batch)
    g1 = single_grads(single)
    results = _tp_step(aligned, batch, 1, 2, estimator)
    for m2, g2, state in results:
        for k in ("loss", "nll", "log_prior", "log_variational_posterior"):
            np.testing.assert_allclose(m2[k], float(m1[k]), rtol=2e-5, err_msg=k)
        assert_grads_close(g2, g1)
        for path in LEAVES:
            np.testing.assert_allclose(state["rho"][path].numpy(),
                                       single.rho[path].detach().numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=path)
    # the column leaf really is split: each rank held half of it
    assert results[0][2]["rho"][LEAVES[0]].shape == aligned.rho[LEAVES[0]].shape


def test_dp2_tp2_on_four_ranks(aligned):
    batch = text_batch(2 * B, L)
    single = copy_model(aligned)
    m1 = training.make_elbo_train_step(single, optimizer(single, clip_norm=None), S,
                                       N_BATCHES, estimator="antithetic")(9, batch)
    results = _tp_step(aligned, batch, 2, 2, "antithetic", seed=9)
    for m2, g2, _ in results:
        np.testing.assert_allclose(m2["loss"], float(m1["loss"]), rtol=2e-5)
        assert_grads_close(g2, single_grads(single))


def test_misaligned_tp2_draws_apart_and_runs():
    """hidden 128 at tp = 2: 64-wide shards, off the unit grid. Each rank
    draws on its own seeds, so the step differs from the one-process one,
    and it is finite; a second step trains the shards that the first
    updated in place."""
    bmodel = tiny_bert(num_hidden_layers=1)
    batch = text_batch(B, L)
    single = copy_model(bmodel)
    m1 = training.make_elbo_train_step(single, optimizer(single, clip_norm=None), S,
                                       N_BATCHES, estimator="antithetic")(7, batch)
    (m2, g2, state), _ = _tp_step(bmodel, batch, 1, 2, "antithetic", clip=True, steps=2)
    assert np.isfinite(m2["loss"]) and m2["loss"] != float(m1["loss"])
    assert all(bool(torch.isfinite(g).all()) for g in g2.values())
    assert bool(torch.isfinite(state["rho"][LEAVES[0]]).all())


def test_sharded_clip_norm_is_the_global_norm(aligned):
    """``global_grad_norm`` on the ranks' shards: the one-process norm of
    the whole gradients."""
    batch = text_batch(B, L)
    single = copy_model(aligned)
    training.make_elbo_train_step(single, optimizer(single, clip_norm=None), S, N_BATCHES,
                                  estimator="antithetic")(7, batch)
    want = float(optim.global_norm(list(single_grads(single).values())))

    def rank(r, mesh):
        bm = copy_model(aligned)
        ptrain.prepare_bayes_params(bm, mesh)
        opt = optimizer(bm, clip_norm=None)
        ptrain.make_train_step(bm, opt, S, N_BATCHES, mesh, estimator="antithetic")(7, batch)
        sharded = mesh_lib.sharded_leaves(bm)
        ids = {id(bm.rho[p]) for p in sharded if p in bm.rho}
        ids |= {id(t) for n, t in bm.model.named_parameters() if n.replace(".", "/") in sharded}
        params = [p for p in opt.params if p.grad is not None]
        return float(ptrain.global_grad_norm([p.grad for p in params],
                                             [id(p) in ids for p in params], mesh.tp_group))

    for got in run_ranks(1, 2, rank):
        np.testing.assert_allclose(got, want, rtol=1e-5)
