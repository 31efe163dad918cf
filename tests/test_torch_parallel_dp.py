"""The port's data-parallel step (``parallel/train.py``) on the CPU, two
ranks as threads over gloo (``tests/torch_ranks.py``).

With shared draws a dp = 2 step is the one-process step on the whole batch:
each rank's KL part is divided by dp, the gradients summed over the ranks.
The weight-space estimators (``fused``, ``antithetic``, ``naive``) draw the
same weights on every rank, so loss and gradients match at f32 rounding;
flipout and local reparameterization draw per example, so, as the
reference's own dp test of LRT does (``tests/test_parallel.py:196-231``),
they are held in the sigma -> 0 limit (MOPED delta 1e-6), where every
estimator is the frequentist forward. ``independent_draws`` gives each dp
rank its own draws. At dp = tp = 1 the step is ``make_elbo_train_step``,
bit for bit.
"""
import numpy as np
import pytest
import torch

from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.parallel import mesh as mesh_lib
from bayeformers_tpu_torch.parallel import train as ptrain
from torch_ranks import (assert_grads_close, copy_model, optimizer, run_ranks,
                         single_grads, text_batch, tiny_bert, whole_grads)
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, B, L, N_BATCHES = 4, 8, 16, 10


@pytest.fixture(scope="module")
def models():
    return {"moped": tiny_bert(num_hidden_layers=1),
            "sigma0": tiny_bert(delta=1e-6, num_hidden_layers=1)}


def _dp_against_single(bmodel, estimator, mc_chunk=None, seed=7):
    batch = text_batch(B, L)
    single = copy_model(bmodel)
    m1 = training.make_elbo_train_step(single, optimizer(single), S, N_BATCHES,
                                       estimator=estimator, mc_chunk=mc_chunk)(seed, batch)

    def rank(r, mesh):
        bm = copy_model(bmodel)
        ptrain.prepare_bayes_params(bm, mesh)
        step = ptrain.make_train_step(bm, optimizer(bm), S, N_BATCHES, mesh,
                                      estimator=estimator, mc_chunk=mc_chunk)
        m = step(seed, mesh_lib.shard_batch(batch, mesh))
        return {k: float(v) for k, v in m.items()}, whole_grads(bm, mesh)

    (m2, g2), (m2b, _) = run_ranks(2, 1, rank)
    assert m2 == m2b  # every rank reports the whole batch's metrics
    return m1, single_grads(single), m2, g2


@pytest.mark.parametrize("estimator,mc_chunk", [
    ("fused", None), ("antithetic", None), ("naive", None), ("antithetic", 2),
    ("fused", 2)])
def test_dp2_matches_one_process(models, estimator, mc_chunk):
    m1, g1, m2, g2 = _dp_against_single(models["moped"], estimator, mc_chunk)
    for k in ("loss", "nll", "log_prior", "log_variational_posterior"):
        np.testing.assert_allclose(m2[k], float(m1[k]), rtol=2e-5, err_msg=k)
    assert_grads_close(g2, g1)


@pytest.mark.parametrize("estimator", ["flipout", "local"])
def test_dp2_per_example_estimators_at_sigma0(models, estimator):
    """Per-example draws depend on the rank's rows; at sigma -> 0 the dp
    step reproduces the one-process loss and gradients."""
    m1, g1, m2, g2 = _dp_against_single(models["sigma0"], estimator)
    np.testing.assert_allclose(m2["loss"], float(m1["loss"]), rtol=2e-5)
    np.testing.assert_allclose(m2["nll"], float(m1["nll"]), rtol=1e-4)
    assert_grads_close(g2, g1)


def test_independent_draws(models):
    """Each dp rank draws its own sample set: the loss changes against
    shared draws but stays an estimate of the same objective."""
    bmodel, batch = models["moped"], text_batch(B, L)

    def rank(r, mesh, independent):
        bm = copy_model(bmodel)
        step = ptrain.make_train_step(bm, optimizer(bm), S, N_BATCHES, mesh,
                                      estimator="antithetic", independent_draws=independent)
        return {k: float(v) for k, v in step(3, mesh_lib.shard_batch(batch, mesh)).items()}

    shared = run_ranks(2, 1, rank, False)[0]
    indep = run_ranks(2, 1, rank, True)[0]
    assert shared["loss"] != indep["loss"]
    assert abs(indep["loss"] - shared["loss"]) / abs(shared["loss"]) < 0.05
    assert set(indep) == set(shared)


@pytest.mark.parametrize("one_rank_mesh,impl", [(False, "kernel"), (True, "kernel"),
                                                (True, "plain")])
def test_dp1_tp1_is_the_single_step_bit_for_bit(models, one_rank_mesh, impl):
    """``make_train_step`` at dp = tp = 1 (no mesh, or a mesh of one rank)
    and ``make_elbo_train_step``: two steps, every metric and tensor equal;
    also with ``impl="plain"`` (the plain versions, which a CPU tensor takes
    anyway)."""
    bmodel = models["moped"]
    a, b = copy_model(bmodel), copy_model(bmodel)
    single = training.make_elbo_train_step(a, optimizer(a), S, N_BATCHES,
                                           estimator="antithetic", mc_chunk=2)

    def rank(r, mesh):
        return ptrain.make_train_step(b, optimizer(b), S, N_BATCHES,
                                      mesh if one_rank_mesh else None,
                                      estimator="antithetic", mc_chunk=2, impl=impl)

    step = run_ranks(1, 1, rank)[0]
    for i in range(2):
        batch = text_batch(B, L, seed=i)
        ma, mb = single(40 + i, batch), step(40 + i, batch)
        assert set(ma) == set(mb)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
    for (na, ta), (nb, tb) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(ta, tb), na
    for path in a.rho:
        assert torch.equal(a.rho[path], b.rho[path]), path


def test_dp_eval_step_gathers_the_whole_batch(models):
    """The dp eval step: every rank returns the whole batch's outputs and
    metrics, equal to the one-process eval step's."""
    bmodel, batch = models["moped"], text_batch(B, L)
    out1, m1 = training.make_elbo_eval_step(bmodel, S, estimator="antithetic")(5, batch)

    def rank(r, mesh):
        return ptrain.make_eval_step(bmodel, S, mesh, estimator="antithetic")(5, batch)

    for out2, m2 in run_ranks(2, 1, rank):
        assert out2.shape == out1.shape
        np.testing.assert_allclose(out2.numpy(), out1.numpy(), rtol=1e-5, atol=1e-5)
        for k in m1:
            np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5, err_msg=k)
