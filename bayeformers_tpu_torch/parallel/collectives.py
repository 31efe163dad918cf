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

Every collective here is an ``allreduce`` or a ``broadcast`` on the
tensor's own device, the two operations that the gloo backend takes on CUDA
tensors (so that two ranks can share one card, which NCCL refuses); the
other gathers run on CPU copies (``parallel/mesh.py::unshard_bayes_params``).
A 16-bit tensor is summed in float32 and rounded once, so that a sum of
partials does not depend on the backend's own 16-bit arithmetic. The calls
go to the process group object (``group.allreduce([t])``), which need not be
registered with ``torch.distributed``'s default group; a group of ``None``
is a group of one, and every operation on it is the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


def group_size(group) -> int:
    return 1 if group is None else group.size()


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


class _CopyToShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_shards(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward / all-reduce backward (Megatron "f")."""
    return x if group_size(group) == 1 else _CopyToShards.apply(x, group)


def reduce_from_shards(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward / identity backward (Megatron "g")."""
    return x if group_size(group) == 1 else _ReduceFromShards.apply(x, group)


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
