"""The experts over ranks within the port (``parallel/moe.py``,
``parallel/transformer.py::make_ep_lm_train_step``; ranks as threads on
gloo, ``torch_ranks.run_axis``): at ep = 2 and 4 the steps equal one
rank's (loss 1e-6 relative, the gathered parameters or gradients at
1e-5); the routers' gradients are whole and equal on every rank, and a
planted fault (x and the router without the "f", ``copy_many_to_shards``)
leaves each rank the partial of its own experts, which this test must
catch; capacity overflow drops the same tokens on every rank; the
refusals (a world or a group of another size, a module without experts)."""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_parallel_pp import DM, FF, H, T, V, GradSnap, close_loss, lm_batch, mse
from torch_ranks import run_axis
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu_torch.parallel import collectives as coll
from bayeformers_tpu_torch.parallel import moe as tmoe
from bayeformers_tpu_torch.parallel import transformer as ttfm

E, D, F, TOK = 4, 16, 32, 24
X = torch.from_numpy(np.random.default_rng(0).normal(size=(TOK, D)).astype(np.float32))
Y = torch.from_numpy(np.random.default_rng(1).normal(size=(TOK, D)).astype(np.float32))
MOE = dict(n_experts=4, ffn=32)


def moe_lm():
    return ttfm.lm_init(ttfm.TransformerStack(2, DM, H, FF, moe=MOE, device="cpu"), V, T)


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_steps_match_one_rank(ep):
    """Two SGD steps (S = 2): each rank's loss and the experts gathered
    after them (the router too) equal one rank's."""
    one = tmoe.BayesMoE(E, D, F, device="cpu")
    step1 = tmoe.make_ep_train_step(one, torch.optim.SGD(one.parameters(), 1e-3), n_samples=2,
                                    n_batches=10, loss_fn=mse)
    want = [step1(s, {"x": X, "y": Y})["loss"] for s in (200, 201)]

    def rank(r, ranks):
        m = tmoe.shard_experts(tmoe.BayesMoE(E, D, F, device="cpu"), ranks)
        step = tmoe.make_ep_train_step(m, torch.optim.SGD(m.parameters(), 1e-3), n_samples=2,
                                       n_batches=10, loss_fn=mse, group=ranks)
        losses = [step(s, {"x": X, "y": Y})["loss"] for s in (200, 201)]
        return losses, tmoe.unshard_experts(m, ranks)

    for losses, whole in run_axis(ep, "ep", rank):
        for got, w in zip(losses, want):
            close_loss(got, w)
        for (n, p), (_, q) in zip(whole.named_parameters(), one.named_parameters()):
            torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=n)


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_lm_step_matches_one_rank(ep):
    """The MoE LM's ``make_ep_lm_train_step`` (S = 2): each rank's loss
    equals one rank's, its experts' gradients are slices of one rank's,
    and every replicated leaf's gradient (attention, LayerNorms, routers,
    tables) is one rank's and equal on every rank."""
    one = moe_lm()
    snap = GradSnap(one)
    want = ttfm.make_ep_lm_train_step(one, snap, n_samples=2, n_batches=10)(500, lm_batch())

    def rank(r, ranks):
        model = tmoe.shard_experts(moe_lm(), ranks)
        s = GradSnap(model)
        m = ttfm.make_ep_lm_train_step(model, s, n_samples=2, n_batches=10,
                                       group=ranks)(500, lm_batch())
        return m, s.grads

    got = run_axis(ep, "ep", rank)
    el = E // ep
    specs = tmoe.expert_specs(one)
    for r, (m, grads) in enumerate(got):
        close_loss(m["loss"], want["loss"])
        assert set(grads) == set(snap.grads)
        for n, g in grads.items():
            w = snap.grads[n]
            if n in specs:
                w = w[:, r * el:(r + 1) * el]
            else:
                assert torch.equal(g, got[0][1][n]), n
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6, msg=n)


def _router_grads(ep):
    def rank(r, ranks):
        m = tmoe.shard_experts(tmoe.BayesMoE(E, D, F, device="cpu"), ranks)
        x = X.clone().requires_grad_()
        out, lq, lp = m.apply_local(None, 4, x, group=ranks)
        (torch.sum(out * out) + (lq - lp) / 10.0).backward()
        return m.router.grad.clone(), x.grad.clone()

    return run_axis(ep, "ep", rank)


def test_router_gradients_whole_and_equal_on_every_rank(monkeypatch):
    """The router's and x's gradients at ep = 2 equal one rank's and each
    other's; with the "f" taken out (a planted fault) each rank holds only
    its experts' partial: the gradients differ between the ranks and from
    one rank's by far more than the gate."""
    one = tmoe.BayesMoE(E, D, F, device="cpu")
    x = X.clone().requires_grad_()
    out, lq, lp = one.apply_local(None, 4, x)
    (torch.sum(out * out) + (lq - lp) / 10.0).backward()
    want = one.router.grad
    got = _router_grads(2)
    for g, gx in got:
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gx, x.grad, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])

    monkeypatch.setattr(coll, "copy_many_to_shards", lambda xs, group: tuple(xs))
    broken = _router_grads(2)
    rel = [((g - want).norm() / want.norm()).item() for g, _ in broken]
    assert min(rel) > 0.1, rel
    assert not torch.allclose(broken[0][0], broken[1][0], rtol=1e-3)


def test_overflow_drops_the_same_tokens_on_every_rank():
    """A router that sends every token to expert 2 (rank 1's at ep = 2):
    the first C tokens come out of it, every other token is zero, on both
    ranks."""
    def rank(r, ranks):
        m = tmoe.shard_experts(tmoe.BayesMoE(E, D, F, device="cpu"), ranks)
        router = torch.zeros(D, E)
        router[:, 2] = 1.0
        with torch.no_grad():
            return m.apply_local({**m.params(), "router": router}, 3, X.abs(), group=ranks)[0]

    C = tmoe.BayesMoE(E, D, F, device="cpu").capacity(TOK)
    outs = run_axis(2, "ep", rank)
    assert torch.equal(outs[0], outs[1])
    assert torch.count_nonzero(outs[0][C:]) == 0 and torch.count_nonzero(outs[0][:C]) > 0


def test_world_size_other_than_ep_raises():
    with pytest.raises(ValueError, match="ep=4 needs 4 ranks; the world has 2"):
        tmoe.make_ep_mesh(4, backend="gloo", store=dist.HashStore(), rank=0, world_size=2)


def test_group_other_than_the_shards_raises():
    """A layer cut for two ranks run on a group of one, and one not cut
    run on a group of two, raise."""
    def rank(r, ranks):
        m = tmoe.BayesMoE(E, D, F, device="cpu")
        tmoe.make_ep_train_step(m, GradSnap(m), n_samples=1, n_batches=1, loss_fn=mse,
                                group=ranks)

    with pytest.raises(ValueError, match="a group of 2 ranks, but the module is cut into 1"):
        run_axis(2, "ep", rank)

    def cut(r, ranks):
        return tmoe.shard_experts(tmoe.BayesMoE(E, D, F, device="cpu"), ranks)

    with pytest.raises(ValueError, match="a group of 1 ranks, but the module is cut into 2"):
        run_axis(2, "ep", cut)[0].apply_local(None, 1, X)


def test_modules_without_experts_raise():
    dense = ttfm.lm_init(ttfm.TransformerStack(2, DM, H, FF, device="cpu"), V, T)
    with pytest.raises(ValueError, match="holds no BayesMoE"):
        tmoe.expert_specs(dense)
    with pytest.raises(ValueError, match="make_ep_lm_train_step needs a MoE"):
        ttfm.make_ep_lm_train_step(dense, GradSnap(dense), n_samples=1, n_batches=1)
