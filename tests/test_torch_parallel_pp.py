"""The pipeline over ranks within the port (``parallel/pipeline.py``,
``parallel/collectives.py::shift_to_next``, ``parallel/transformer.py::
make_pp_lm_train_step``; ranks as threads on gloo, ``torch_ranks.run_axis``):
at pp = 2 and 4 the steps equal one rank's (loss 1e-6 relative, the
gathered parameters or gradients at 1e-6 / 1e-5), M = 1, a batch that M
does not divide, the shift's gradient against a plain reverse shift, the
stages' shards against slices of the one-process init, and the refusals
(a world or a group of another size, a MoE stack under pp)."""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_ranks import run_axis
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu_torch.parallel import collectives as coll
from bayeformers_tpu_torch.parallel import pipeline as tpp
from bayeformers_tpu_torch.parallel import transformer as ttfm

L, D, B = 4, 32, 8
V, T, DM, H, FF = 17, 8, 16, 2, 32


def _data(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


X, Y = _data(0, B, D), _data(1, B, D)


def mse(out, batch):
    err = out - batch["y"]
    return torch.sum(err * err), {"mse": torch.mean(err * err)}


class GradSnap:
    """An optimizer that keeps the step's gradients and updates nothing."""

    def __init__(self, module):
        self.module, self.grads = module, {}

    def zero_grad(self):
        for p in self.module.parameters():
            p.grad = None

    def step(self):
        self.grads = {n: p.grad.clone() for n, p in self.module.named_parameters()
                      if p.grad is not None}


def lm(n_blocks=4):
    return ttfm.lm_init(ttfm.TransformerStack(n_blocks, DM, H, FF, device="cpu"), V, T)


def lm_batch():
    rng = np.random.default_rng(1)
    seq = rng.integers(0, V, size=(8, T // 2))
    seq = np.concatenate([seq, seq], axis=1)
    mask = np.zeros((8, T - 1), np.int64)
    mask[:, T // 2 - 1:] = 1
    return {"tokens": torch.from_numpy(seq[:, :-1]), "targets": torch.from_numpy(seq[:, 1:]),
            "eval_mask": torch.from_numpy(mask)}


def close_loss(got, want, rtol=1e-6):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), (float(got), float(want))


@pytest.mark.parametrize("pp", [2, 4])
def test_block_stack_steps_match_one_rank(pp):
    """Two SGD steps (S = 2, M = 2): each rank's loss, and the stages
    gathered after them, equal one rank's."""
    one = tpp.BlockStack(L, D, device="cpu")
    step1 = tpp.make_pp_train_step(one, torch.optim.SGD(one.parameters(), 1e-3), n_samples=2,
                                   n_batches=10, n_microbatches=2, loss_fn=mse)
    want = [step1(s, {"x": X, "y": Y})["loss"] for s in (100, 101)]

    def rank(r, ranks):
        st = tpp.shard_stack(tpp.BlockStack(L, D, device="cpu"), ranks)
        step = tpp.make_pp_train_step(st, torch.optim.SGD(st.parameters(), 1e-3),
                                      n_samples=2, n_batches=10, n_microbatches=2,
                                      loss_fn=mse, group=ranks)
        losses = [step(s, {"x": X, "y": Y})["loss"] for s in (100, 101)]
        return losses, tpp.unshard_stack(st, ranks)

    for losses, whole in run_axis(pp, "pp", rank):
        for got, w in zip(losses, want):
            close_loss(got, w)
        for (n, p), (_, q) in zip(whole.named_parameters(), one.named_parameters()):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=n)


@pytest.mark.parametrize("pp,m", [(2, 1), (4, 1), (4, 8)])
def test_pipeline_apply_matches_one_rank(pp, m):
    """M = 1 (every tick but one a bubble on each stage) and M = 8 at pp = 4:
    the whole output and the log-probs on every rank."""
    one = tpp.BlockStack(L, D, device="cpu")
    with torch.no_grad():
        want = tpp.pipeline_apply(one, 3, X, n_microbatches=m)

    def rank(r, ranks):
        st = tpp.shard_stack(tpp.BlockStack(L, D, device="cpu"), ranks)
        with torch.no_grad():
            return tpp.pipeline_apply(st, 3, X, n_microbatches=m, group=ranks)

    for got in run_axis(pp, "pp", rank):
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
        for g, w in zip(got[1:], want[1:]):
            close_loss(g, w)


def test_batch_not_divisible_raises():
    def rank(r, ranks):
        st = tpp.shard_stack(tpp.BlockStack(L, D, device="cpu"), ranks)
        tpp.pipeline_apply(st, 1, X, n_microbatches=3, group=ranks)

    with pytest.raises(ValueError, match="microbatches"):
        run_axis(2, "pp", rank)


@pytest.mark.parametrize("pp", [2, 3, 4])
def test_shift_gradient_is_the_reverse_shift(pp):
    """``shift_to_next`` moves stage s's tensor to s + 1 (zeros on stage 0);
    its gradient is the cotangent shifted back (zeros on the last stage)."""
    def rank(r, ranks):
        x = torch.full((2, 3), float(r + 1), requires_grad=True)
        y = coll.shift_to_next(x, ranks)
        g = torch.arange(6.0).view(2, 3) * (r + 1)
        y.backward(g)
        return y.detach(), x.grad

    for r, (y, grad) in enumerate(run_axis(pp, "pp", rank)):
        torch.testing.assert_close(y, torch.full((2, 3), float(r)))
        want = torch.arange(6.0).view(2, 3) * (r + 2) if r < pp - 1 else torch.zeros(2, 3)
        torch.testing.assert_close(grad, want)


@pytest.mark.parametrize("pp", [2, 4])
def test_lm_step_matches_one_rank(pp):
    """The dense LM's ``make_pp_lm_train_step`` (S = 2, M = 2): each rank's
    loss equals one rank's, its stage's gradients are the slices of one
    rank's, and the embed and pos gradients are one rank's and equal on
    every stage (the "f" on the embedded input)."""
    one = lm()
    snap = GradSnap(one)
    want = ttfm.make_pp_lm_train_step(one, snap, n_samples=2, n_batches=10,
                                      n_microbatches=2)(400, lm_batch())

    def rank(r, ranks):
        model = tpp.shard_stack(lm(), ranks)
        s = GradSnap(model)
        m = ttfm.make_pp_lm_train_step(model, s, n_samples=2, n_batches=10,
                                       n_microbatches=2, group=ranks)(400, lm_batch())
        return m, s.grads

    got = run_axis(pp, "pp", rank)
    n_local = 4 // pp
    for r, (m, grads) in enumerate(got):
        close_loss(m["loss"], want["loss"])
        for n, g in grads.items():
            w = snap.grads[n]
            if n.startswith("stack."):
                w = w[r * n_local:(r + 1) * n_local]
            else:
                assert torch.equal(g, got[0][1][n]), n
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6, msg=n)


def test_shards_are_slices_of_the_whole_init():
    """A stage's blocks are the slice of the one-process init at the same
    seed, own their storage, and gather back to it."""
    whole = lm()

    def rank(r, ranks):
        model = tpp.shard_stack(lm(), ranks)
        return dict(model.named_parameters()), tpp.unshard_stack(model, ranks)

    for r, (params, back) in enumerate(run_axis(2, "pp", rank)):
        for n, p in whole.named_parameters():
            w = p[2 * r:2 * r + 2] if n.startswith("stack.") else p
            assert torch.equal(params[n], w), n
            assert params[n].untyped_storage().size() == params[n].numel() * 4, n
            assert torch.equal(dict(back.named_parameters())[n], p), n


def test_world_size_other_than_pp_raises():
    with pytest.raises(ValueError, match="pp=2 needs 2 ranks; the world has 3"):
        tpp.make_pp_mesh(2, backend="gloo", store=dist.HashStore(), rank=0, world_size=3)


def test_group_other_than_the_shards_raises():
    """A stack cut for one stage (not sharded) on a group of two raises
    before any collective, on every rank."""
    def rank(r, ranks):
        tpp.pipeline_apply(tpp.BlockStack(L, D, device="cpu"), 1, X, n_microbatches=2,
                           group=ranks)

    with pytest.raises(ValueError, match="a group of 2 ranks, but the module is cut into 1"):
        run_axis(2, "pp", rank)


def test_moe_stack_under_pp_raises():
    moe_lm = ttfm.lm_init(ttfm.TransformerStack(2, DM, H, FF, moe=dict(n_experts=4, ffn=32),
                                                device="cpu"), V, T)
    with pytest.raises(NotImplementedError, match="pp x ep mesh"):
        ttfm.make_pp_lm_train_step(moe_lm, GradSnap(moe_lm), n_samples=1, n_batches=1,
                                   n_microbatches=2)
    with pytest.raises(ValueError, match="pp x ep mesh"):
        tpp.stack_specs(moe_lm)
