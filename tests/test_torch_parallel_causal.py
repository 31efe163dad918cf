"""The causal families under tensor parallelism on the CPU: the tiny GPT-2
(its packed c_attn permuted to the head-aligned layout,
``parallel/mesh.py::permute_gpt2_qkv``) and the tiny LLaMA (grouped-query
attention on local q and kv heads) at tp = 2, two ranks as threads over
gloo, against the one-process step at the same draws (an ``eps_hook`` that
gives each layer's whole draw; under the permutation the c_attn draw is
permuted as its weight is). Their shard widths are off the unit grid, so
without the hook the shards would draw apart. And the refusals: a head
count (or, under GQA, a kv-head count) that tp does not divide, and the
families whose attention the fused tier does not run on local heads (T5,
CLIP, Whisper: ROADMAP item 6(d)).
"""
import copy

import numpy as np
import pytest
import torch

import bayeformers_tpu_torch as bt
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.parallel import collectives as coll
from bayeformers_tpu_torch.parallel import mesh as mesh_lib
from bayeformers_tpu_torch.parallel import train as ptrain
from bayeformers_tpu_torch.workloads.gpt2_lm import lm_loss
from torch_ranks import assert_grads_close, optimizer, run_ranks, single_grads, whole_grads
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, B, L, N_BATCHES = 4, 4, 16, 10


def _frozen(net):
    with torch.no_grad():
        for p in net.parameters():
            p.masked_fill_(p == 0, 0.01)
    return bt.to_bayesian(net, delta=0.05, freeze=True)


def _gpt2(**kw):
    return _frozen(bt.build_gpt2(size="tiny", device="cpu", dtype=torch.float32,
                                 n_layer=1, **kw))


def _llama(**kw):
    return _frozen(bt.build_llama_family("llama", size="tiny", device="cpu",
                                         dtype=torch.float32, num_hidden_layers=1, **kw))


def _hook(permute_tp=1):
    """Each leaf's whole draw from a generator seeded by its path; with
    ``permute_tp`` the c_attn draws in the head-aligned layout."""
    draws = {}

    def hook(chunk, path, n_draws, shape):
        if path not in draws:
            gen = torch.Generator().manual_seed(sum(map(ord, path)) * 7919 + len(path))
            draws[path] = torch.randn((n_draws,) + tuple(shape), generator=gen)
        eps = draws[path]
        if permute_tp > 1 and "c_attn" in path:
            perm = torch.from_numpy(mesh_lib._qkv_perm(eps.shape[-1] // 3, permute_tp))
            eps = eps[..., perm]
        return eps

    return hook


def _against_one_process(bmodel, estimator):
    rng = np.random.default_rng(0)
    batch = {"input_ids": torch.from_numpy(rng.integers(0, 1024, (B, L)))}
    kw = dict(loss_fn=lm_loss, input_keys=("input_ids",), estimator=estimator)
    single = copy.deepcopy(bmodel)
    m1 = training.make_elbo_train_step(single, optimizer(single, clip_norm=None), S,
                                       N_BATCHES, eps_hook=_hook(), **kw)(5, batch)

    def rank(r, mesh):
        bm = copy.deepcopy(bmodel)
        ptrain.prepare_bayes_params(bm, mesh)
        step = ptrain.make_train_step(bm, optimizer(bm, clip_norm=None), S, N_BATCHES, mesh,
                                      eps_hook=_hook(mesh.tp), **kw)
        m = step(5, batch)
        grads = whole_grads(bm, mesh)
        if mesh_lib.needs_qkv_perm(bm.spec.paths, mesh.tp):
            grads = {n: (mesh_lib._permuted(g, mesh.tp, inverse=True) if "c_attn" in n else g)
                     for n, g in grads.items()}
        return {k: float(v) for k, v in m.items()}, grads

    for m2, g2 in run_ranks(1, 2, rank):
        for k in ("loss", "nll", "log_prior", "log_variational_posterior"):
            np.testing.assert_allclose(m2[k], float(m1[k]), rtol=2e-5, err_msg=k)
        assert_grads_close(g2, single_grads(single))


@pytest.mark.parametrize("estimator", ["antithetic", "fused"])
def test_gpt2_tp2_matches_one_process(estimator):
    _against_one_process(_gpt2(), estimator)


def test_llama_tp2_matches_one_process():
    _against_one_process(_llama(), "antithetic")


@pytest.mark.parametrize("build,match", [
    (lambda: _gpt2(n_embd=192, n_head=3), "n_heads=3"),
    (lambda: _llama(num_key_value_heads=1), "n_kv=1"),
])
def test_heads_that_tp_does_not_divide_raise(build, match):
    """The leaves shard (the rules' blocks divide), but the attention
    handler refuses heads that tp does not divide, as the reference's
    ``_local_heads`` does (Gemma-2B's one kv head refuses tp = 2)."""
    bmodel = build()
    ids = torch.zeros((2, 8), dtype=torch.long)

    def rank(r, mesh):
        bm = copy.deepcopy(bmodel)
        ptrain.prepare_bayes_params(bm, mesh)
        ctx = coll.tp_context(mesh, mesh_lib.family_tp_fns(bm.spec.paths)[1])
        with pytest.raises(ValueError, match=match):
            bm.mc_apply_fused(1, 2, ids, antithetic=True, tp=ctx)
        return True

    assert run_ranks(1, 2, rank) == [True, True]


@pytest.mark.parametrize("name", ["t5", "clip", "whisper"])
def test_families_outside_the_fused_plan_name_item_6d(name):
    build = {"t5": lambda: bt.build_t5(size="tiny", device="cpu"),
             "clip": lambda: bt.build_clip(size="tiny", device="cpu"),
             "whisper": lambda: bt.build_whisper(size="tiny", device="cpu")}[name]
    bmodel = bt.to_bayesian(build(), delta=0.05, freeze=True)
    assert not mesh_lib.family_tp_fns(bmodel.spec.paths)[2]

    def rank(r, mesh):
        with pytest.raises(NotImplementedError, match=r"item 6\(d\)"):
            ptrain.make_train_step(bmodel, optimizer(bmodel, clip_norm=None), 2, 1, mesh,
                                   estimator="antithetic")
        return True

    assert run_ranks(1, 2, rank) == [True, True]
