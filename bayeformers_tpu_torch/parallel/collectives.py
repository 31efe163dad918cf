"""Megatron's conjugate collectives over a process group (counterpart of
``bayeformers_tpu/parallel/collectives.py``).

Where the JAX package runs one program per device inside ``shard_map`` and
sums with ``lax.psum``, the port runs one process (or, in the tests, one
thread) per rank and calls the process group itself:

- :func:`copy_to_shards` ("f"): identity forward on a replicated activation
  about to be consumed by column-parallel shards; the backward all-reduces
  the partial cotangents, so that the replicated layers upstream see the
  whole gradient on every rank.
- :func:`reduce_from_shards` ("g"): all-reduce forward of row-parallel
  partial outputs (or of the sharded leaves' log-prob sums); identity
  backward, the cotangent of a replicated sum being the same on every rank.

- :func:`shift_to_next` (the pipeline's ``lax.ppermute``): stage s's
  tensor to stage s + 1; the backward shifts the cotangent back.

Every collective here is an ``allreduce`` or a ``broadcast`` on the
tensor's own device, the two operations that the gloo backend takes on CUDA
tensors (so that two ranks can share one card, which NCCL refuses); the
other gathers run on CPU copies (``parallel/mesh.py::unshard_bayes_params``).
The shift is a broadcast in a two-rank group under gloo and a
``batch_isend_irecv`` pair under NCCL (untried across cards).
A 16-bit tensor is summed in float32 and rounded once, so that a sum of
partials does not depend on the backend's own 16-bit arithmetic. The calls
go to the process group object (``group.allreduce([t])``), which need not be
registered with ``torch.distributed``'s default group; a group of ``None``
is a group of one, and every operation on it is the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """The ranks of ``group``: 1 for None, a :class:`Ranks`' ``world_size``,
    else the process group's ``size()``."""
    if group is None:
        return 1
    return group.world_size if isinstance(group, Ranks) else group.size()


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if group_size(group) == 1:
        return t
    if t.dtype in (torch.bfloat16, torch.float16):
        wide = t.float()
        group.allreduce([wide]).wait()
        t.copy_(wide)
    else:
        group.allreduce([t]).wait()
    return t


def broadcast_(t: torch.Tensor, group, root: int = 0) -> torch.Tensor:
    """``t`` of the group's rank ``root`` on every rank, in place."""
    if group_size(group) > 1:
        group.broadcast(t, root).wait()
    return t


def _coalesced(tensors: list[torch.Tensor], fn) -> None:
    """``fn`` on one flat buffer per (device, dtype) holding ``tensors``, the
    results copied back: one collective instead of one a tensor."""
    buckets: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        fn(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_coalesced_(tensors: list[torch.Tensor], group) -> None:
    """Sum each of ``tensors`` over ``group`` in place, in one all-reduce a
    dtype (the gradient all-reduce of a data-parallel step)."""
    if group_size(group) > 1 and tensors:
        _coalesced(tensors, lambda flat: all_reduce_(flat, group))


def broadcast_coalesced_(tensors: list[torch.Tensor], group, root: int = 0) -> None:
    """Each of ``tensors`` of rank ``root`` on every rank of ``group``, in
    place, in one broadcast a dtype."""
    if group_size(group) > 1 and tensors:
        _coalesced(tensors, lambda flat: broadcast_(flat, group, root))


def gather_rows(t: torch.Tensor, group, rank: int, dim: int = 0) -> torch.Tensor:
    """The ranks' equal blocks of ``dim`` side by side, in rank order, on
    every rank: each rank writes its block into zeros of the whole size and
    the group sums them (an all-gather made of one all-reduce)."""
    size = group_size(group)
    if size == 1:
        return t
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * size
    out = t.new_zeros(shape)
    out.narrow(dim, rank * n, n).copy_(t)
    return all_reduce_(out, group)


class _ReduceFromShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyManyToShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [g.contiguous().clone() for g in gs]
        all_reduce_coalesced_(gs, ctx.group)
        return (None, *gs)


def copy_many_to_shards(xs: Sequence[torch.Tensor], group) -> tuple:
    """Identity forward / all-reduce backward (Megatron "f") of each of
    ``xs``, their cotangents summed in one all-reduce a dtype: one
    collective in the backward, however the autograd engine orders its
    ready nodes."""
    if group_size(group) == 1:
        return tuple(xs)
    return _CopyManyToShards.apply(group, *xs)


def copy_to_shards(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "f" of one tensor (:func:`copy_many_to_shards`)."""
    return copy_many_to_shards((x,), group)[0]


def reduce_from_shards(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward / identity backward (Megatron "g")."""
    return x if group_size(group) == 1 else _ReduceFromShards.apply(x, group)


@dataclasses.dataclass(frozen=True)
class Ranks:
    """A rank's place on a one-axis mesh named ``axis`` (``"pp"``, the
    pipeline's stages, or ``"ep"``, the experts' shards;
    ``pipeline.make_pp_mesh``, ``moe.make_ep_mesh``): its index ``rank`` of
    ``world_size``, ``group`` (all of them), its ``backend`` and, under
    gloo on a pp mesh, ``hops``: hop i's two-rank group {i, i + 1}, for
    :func:`shift_to_next`."""

    axis: str
    rank: int
    world_size: int
    group: object
    backend: str
    hops: tuple = ()


def _shift(t: torch.Tensor, ranks: Ranks, step: int) -> torch.Tensor:
    """Rank s's ``t`` to rank s + ``step``; returns what rank s - ``step``
    sent, zeros where no rank sends (the wrap-around hop carries only a
    dead value, so it is dropped)."""
    s, n = ranks.rank, ranks.world_size
    out = None
    if ranks.backend == "gloo":
        # gloo's point-to-point ops take CPU tensors only: each hop is a
        # broadcast in its pair group from the sending end. The even hops
        # run first, then the odd ones, so that the two hops of a rank never
        # wait on each other.
        for i in sorted((i for i in (s - 1, s) if 0 <= i < n - 1), key=lambda i: i % 2):
            root = 0 if step > 0 else 1
            if i + root == s:
                ranks.hops[i].broadcast(t, root).wait()
            else:
                out = torch.empty_like(t)
                ranks.hops[i].broadcast(out, root).wait()
    else:
        ops = []
        if 0 <= s + step < n:
            peer = dist.get_global_rank(ranks.group, s + step)
            ops.append(dist.P2POp(dist.isend, t, peer, ranks.group))
        if 0 <= s - step < n:
            out = torch.empty_like(t)
            peer = dist.get_global_rank(ranks.group, s - step)
            ops.append(dist.P2POp(dist.irecv, out, peer, ranks.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return torch.zeros_like(t) if out is None else out


class _ShiftToNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks):
        ctx.ranks = ranks
        return _shift(x.contiguous(), ranks, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.ranks, -1), None


def shift_to_next(x: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    """Stage s's ``x`` to stage s + 1 and stage s - 1's to stage s (zeros
    on stage 0), as ``lax.ppermute(x, axis, [(i, i + 1)])``; the backward
    shifts the cotangent from s + 1 back to s. Every rank of ``ranks``
    calls it, in the same order."""
    return _ShiftToNext.apply(x, ranks)


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep_shape, ctx.dep_dtype = dep.shape, dep.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(ctx.dep_shape, dtype=ctx.dep_dtype)


def tie(x: torch.Tensor, dep: torch.Tensor) -> torch.Tensor:
    """``x``, with ``dep`` in its autograd graph at a zero cotangent: a
    value that a rank does not read (a dead tick's, another stage's input)
    stays on the path from the loss, so that the collectives behind it
    still run in the backward on every rank."""
    return _Tie.apply(x, dep) if dep.requires_grad else x


@dataclasses.dataclass(frozen=True)
class TPContext:
    """The tensor-parallel side of a forward: the tp ``group``, its
    ``size``, this rank's place in it and ``kind_fn(path)``, which classes a
    converted leaf as ``'col'`` (out-features sharded), ``'row'``
    (in-features sharded) or ``'rep'`` (replicated), as the leaves were
    sharded (``parallel/mesh.py``: the kinds derive from the same rules)."""

    group: object
    size: int
    rank: int
    kind_fn: Callable[[str], str]


def tp_context(mesh, kind_fn: Optional[Callable[[str], str]]) -> Optional[TPContext]:
    """The :class:`TPContext` of ``mesh`` (None when tp is 1)."""
    if mesh is None or mesh.tp == 1:
        return None
    return TPContext(mesh.tp_group, mesh.tp, mesh.tp_rank, kind_fn)
