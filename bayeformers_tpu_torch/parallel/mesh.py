"""The dp x tp process groups and the Megatron sharding rules (counterpart
of ``bayeformers_tpu/parallel/mesh.py``).

Where the JAX package lays a ``Mesh`` over its devices and places arrays
with ``NamedSharding``, the port runs one process per rank (the tests: one
thread per rank) and holds, on each rank, only that rank's block of every
sharded tensor:

- **dp**: each rank takes its slice of the batch's leading axis
  (:func:`shard_batch`); the step all-reduces the gradients over the dp
  group (``parallel/train.py``).
- **tp**: the Megatron layout over the transformer's dense layers (Shoeybi
  et al., arXiv:1909.08053): q/k/v and the MLP's first projection
  column-sharded, the attention output and the MLP's second projection
  row-sharded, so that each block needs one all-reduce a sublayer
  (``nn/fused.py``'s plan).

Rank ``r`` sits at ``(d, t) = (r // tp, r % tp)``, the reference's
``devices.reshape(dp, tp)``. A spec is the reference's ``PartitionSpec``
as a plain tuple of axis names: ``(None, "tp")`` shards dim 1 (a column
kernel), ``("tp",)`` a column layer's bias, ``("tp", None)`` dim 0 (a row
kernel), ``()`` replicates. ``rho`` and ``prior_mu`` of a leaf shard as its
mu, so that sampling and the KL terms stay local.
"""
from __future__ import annotations

import copy
import dataclasses
import datetime
import re
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from bayeformers_tpu_torch.nn.surgery import SEP, BayesianModel, leaf
from bayeformers_tpu_torch.parallel import collectives as coll

ITEM_6D = "ROADMAP queue 1 item 6(d)"
TP = "tp"
COL = (None, TP)      # a column kernel, stored (in, out)
COL_1D = (TP,)        # a column layer's bias
ROW = (TP, None)      # a row kernel, stored (in, out)
REP = ()

# Megatron sharding of the Flax parameter paths ('/'-joined): BERT,
# RoBERTa, CamemBERT and Electra (one set of encoder paths), ViT (its q/k/v
# under attention/attention), DistilBERT and ALBERT (its attention holds its
# own output projection, ``dense``).
_TP_RULES: list[tuple[re.Pattern, tuple]] = [
    (re.compile(r"attention/self/(query|key|value)/kernel$"), COL),
    (re.compile(r"attention/self/(query|key|value)/bias$"), COL_1D),
    (re.compile(r"attention/output/dense/kernel$"), ROW),
    (re.compile(r"(?<!attention/)intermediate/dense/kernel$"), COL),
    (re.compile(r"intermediate/dense/bias$"), COL_1D),
    (re.compile(r"\d+/output/dense/kernel$"), ROW),
    (re.compile(r"attention/attention/(query|key|value)/kernel$"), COL),
    (re.compile(r"attention/attention/(query|key|value)/bias$"), COL_1D),
    (re.compile(r"attention/[qkv]_lin/kernel$"), COL),
    (re.compile(r"attention/[qkv]_lin/bias$"), COL_1D),
    (re.compile(r"attention/out_lin/kernel$"), ROW),
    (re.compile(r"ffn/lin1/kernel$"), COL),
    (re.compile(r"ffn/lin1/bias$"), COL_1D),
    (re.compile(r"ffn/lin2/kernel$"), ROW),
    (re.compile(r"albert_layers/\d+/attention/(query|key|value)/kernel$"), COL),
    (re.compile(r"albert_layers/\d+/attention/(query|key|value)/bias$"), COL_1D),
    (re.compile(r"albert_layers/\d+/attention/dense/kernel$"), ROW),
    (re.compile(r"albert_layers/\d+/ffn/kernel$"), COL),
    (re.compile(r"albert_layers/\d+/ffn/bias$"), COL_1D),
    (re.compile(r"albert_layers/\d+/ffn_output/kernel$"), ROW),
]

# GPT-2's Conv1D kernels are stored (out, in), the transpose of a Dense, so
# the roles flip the sharded dim: a column kernel shards dim 0, a row kernel
# dim 1, and the kind cannot be read from the spec (it is the third field).
# c_attn packs Q|K|V along out: a block of it is head-aligned only after
# :func:`permute_gpt2_qkv`.
_GPT2_TP_RULES: list[tuple[re.Pattern, tuple, str]] = [
    (re.compile(r"attn/c_attn/kernel$"), (TP, None), "col"),
    (re.compile(r"attn/c_attn/bias$"), COL_1D, "col"),
    (re.compile(r"attn/c_proj/kernel$"), (None, TP), "row"),
    (re.compile(r"mlp/c_fc/kernel$"), (TP, None), "col"),
    (re.compile(r"mlp/c_fc/bias$"), COL_1D, "col"),
    (re.compile(r"mlp/c_proj/kernel$"), (None, TP), "row"),
]

# The LLaMA-architecture families: q/k/v and gate/up column, o and down row;
# a column block is whole heads when tp divides the head counts (the
# attention handler checks it). Bias rules for attention_bias configs.
_LLAMA_TP_RULES: list[tuple[re.Pattern, tuple]] = [
    (re.compile(r"self_attn/[qkv]_proj/kernel$"), COL),
    (re.compile(r"self_attn/[qkv]_proj/bias$"), COL_1D),
    (re.compile(r"self_attn/o_proj/kernel$"), ROW),
    (re.compile(r"mlp/(gate|up)_proj/kernel$"), COL),
    (re.compile(r"mlp/(gate|up)_proj/bias$"), COL_1D),
    (re.compile(r"mlp/down_proj/kernel$"), ROW),
]

# T5: the rules exist, but its attention (relative position bias per head)
# is not one that the fused tier's handlers run with local heads, so tp on
# T5 waits for the GSPMD-style tier (``family_tp_fns`` flags it).
_T5_TP_RULES: list[tuple[re.Pattern, tuple]] = [
    (re.compile(r"Attention/(q|k|v)/kernel$"), COL),
    (re.compile(r"Attention/o/kernel$"), ROW),
    (re.compile(r"DenseReluDense/wi(_\d+)?/kernel$"), COL),
    (re.compile(r"DenseReluDense/wo/kernel$"), ROW),
]


def _first(rules, path: str):
    for rule in rules:
        if rule[0].search(path):
            return rule
    return None


def tp_param_spec(path: str) -> tuple:
    rule = _first(_TP_RULES, path)
    return REP if rule is None else rule[1]


def gpt2_param_spec(path: str) -> tuple:
    rule = _first(_GPT2_TP_RULES, path)
    return REP if rule is None else rule[1]


def gpt2_tp_kind(path: str) -> str:
    rule = _first(_GPT2_TP_RULES, path)
    return "rep" if rule is None else rule[2]


def llama_param_spec(path: str) -> tuple:
    rule = _first(_LLAMA_TP_RULES, path)
    return REP if rule is None else rule[1]


def t5_param_spec(path: str) -> tuple:
    rule = _first(_T5_TP_RULES, path)
    return REP if rule is None else rule[1]


def kind_from_spec(spec: tuple) -> str:
    """``'col'``, ``'row'`` or ``'rep'`` of a Dense family's spec; a
    sharded 1-D leaf (a column layer's bias) is ``'col'``."""
    spec = tuple(spec)
    if spec in (COL, COL_1D):
        return "col"
    if spec == ROW:
        return "row"
    return "rep"


def tp_kind(path: str) -> str:
    return kind_from_spec(tp_param_spec(path))


def family_tp_fns(paths) -> tuple[Callable, Callable, bool]:
    """``(spec_fn, kind_fn, fused_tp_ok)`` of the model family that owns
    ``paths``: GPT-2's Conv1D rules, the LLaMA rules, T5's, or the encoders'
    (every other Dense family). ``fused_tp_ok`` is False where the fused
    tier's attention handlers do not run the family's attention with local
    heads (T5; CLIP and Whisper, whose ``self_attn/out_proj`` paths the LLaMA
    rules would otherwise take): tp there is :data:`ITEM_6D`."""
    paths = list(paths)
    if any("c_attn" in p for p in paths):
        return gpt2_param_spec, gpt2_tp_kind, True
    if any("self_attn/q_proj" in p for p in paths):
        ok = not any("self_attn/out_proj" in p for p in paths)
        return llama_param_spec, lambda p: kind_from_spec(llama_param_spec(p)), ok
    if any("DenseReluDense" in p for p in paths):
        return t5_param_spec, lambda p: kind_from_spec(t5_param_spec(p)), False
    return tp_param_spec, tp_kind, True


def sharded_dim(spec: tuple) -> Optional[int]:
    """The dim that ``spec`` shards over tp, or None."""
    spec = tuple(spec)
    return spec.index(TP) if TP in spec else None


def assert_tp_coverage(paths, spec_fn=None) -> None:
    """Raise when tp > 1 would shard nothing: no converted path matches a
    rule of ``spec_fn``, so every rank would hold the whole model."""
    spec_fn = spec_fn or tp_param_spec
    paths = list(paths)
    if not any(sharded_dim(spec_fn(p)) is not None for p in paths):
        sample = "\n  ".join(paths[:8])
        raise ValueError(
            "tensor parallelism requested but no converted parameter path matches a tp "
            "sharding rule: every rank would replicate every weight. Extend "
            f"parallel/mesh.py's rules for this family. First paths:\n  {sample}")


def _qkv_perm(n_embd: int, tp: int) -> np.ndarray:
    """Row permutation of the packed (3E, E) c_attn kernel so that the tp
    contiguous blocks are head-aligned: block r holds [Q_r | K_r | V_r]."""
    blk = n_embd // tp
    idx = np.empty(3 * n_embd, np.int64)
    o = 0
    for r in range(tp):
        for sec in range(3):
            start = sec * n_embd + r * blk
            idx[o:o + blk] = np.arange(start, start + blk)
            o += blk
    return idx


def _is_c_attn(path: str) -> bool:
    return path.endswith("attn/c_attn/kernel") or path.endswith("attn/c_attn/bias")


def _permuted(t: torch.Tensor, tp: int, inverse: bool) -> torch.Tensor:
    idx = _qkv_perm(t.shape[0] // 3, tp)
    if inverse:
        idx = np.argsort(idx)
    return t[torch.from_numpy(idx).to(t.device)].contiguous()


def needs_qkv_perm(paths, tp: int) -> bool:
    """GPT-2 at tp > 1: its packed c_attn is permuted before sharding."""
    return tp > 1 and any(_is_c_attn(p) for p in paths)


def permute_gpt2_qkv(target, tp: int, inverse: bool = False):
    """(Un)permute every packed c_attn leaf (kernel rows and bias) into the
    head-aligned tp layout that the GPT-2 attention handler splits into its
    local q/k/v: a converted model in place (mu, rho and prior_mu; returns
    it), or a state ``{"params" | "rho" | "prior_mu": {path: tensor}}``
    (returns a new one). Apply before :func:`shard_bayes_params`, and with
    ``inverse=True`` to a gathered state before it is written, so that a
    checkpoint holds the stock layout. The permutation relabels output
    channels that the split undoes, so the model's function is the same;
    only the draws' unit mapping moves."""
    if isinstance(target, BayesianModel):
        with torch.no_grad():
            for name, p in target.model.named_parameters():
                path = name.replace(".", SEP)
                if _is_c_attn(path):
                    p.data = _permuted(p.data, tp, inverse)
            for part in (target.rho, target.prior_mu):
                for path in list(part):
                    if _is_c_attn(path):
                        part[path] = _keep_grad(part[path], _permuted(part[path], tp, inverse))
            _refresh_frozen_prior(target)
        return target
    return {part: {p: (_permuted(t, tp, inverse) if _is_c_attn(p) else t)
                   for p, t in tensors.items()} for part, tensors in target.items()}


def _keep_grad(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    return new.requires_grad_(old.requires_grad)


def _refresh_frozen_prior(bmodel: BayesianModel) -> None:
    """A frozen conversion's ``prior_mu`` is mu itself: point it at the
    (re-laid-out) parameter again."""
    if bmodel.spec.moped and bmodel.spec.frozen:
        for path in bmodel.prior_mu:
            bmodel.prior_mu[path] = leaf(bmodel.model, path).detach()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The calling rank's place in the dp x tp grid and its process groups:
    ``dp_group`` (the ranks of its tp coordinate), ``tp_group`` (the ranks
    of its dp coordinate), ``world_group`` (all), each None when of one
    rank, and ``export_group``, a gloo group over the tp ranks for the CPU
    gathers of :func:`unshard_bayes_params` (the tp group itself under
    gloo)."""

    dp: int
    tp: int
    rank: int
    backend: str
    dp_group: object
    tp_group: object
    world_group: object
    export_group: object

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU. Two ranks on one
    card take ``gloo``: NCCL refuses them."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


TIMEOUT = datetime.timedelta(minutes=10)


def _world(backend: str, store, rank: Optional[int],
           world_size: Optional[int]) -> tuple[int, int]:
    """``(rank, world_size)`` of the calling rank: from the default process
    group (initialised here from the environment with ``backend`` if it is
    not yet) without ``store``, else as given."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if store is None:
        if not dist.is_initialized():
            dist.init_process_group(backend=backend, timeout=TIMEOUT)
        elif dist.get_backend() != backend:
            raise ValueError(f"the default process group runs {dist.get_backend()!r}, "
                             f"the mesh was asked for {backend!r}")
        return dist.get_rank(), dist.get_world_size()
    if backend != "gloo":
        raise ValueError("a mesh on a store builds gloo groups only; nccl ranks take "
                         "the default process group")
    if rank is None or world_size is None:
        raise ValueError("a mesh on a store needs rank and world_size")
    return rank, world_size


def group_factory(backend: str, store, rank: int) -> Callable:
    """``group(ranks, tag, kind=backend)``: the process group of ``ranks``
    (None when of one rank, or, on a store, when the caller is not in it),
    from the default group or, with ``store``, a gloo group on it under
    ``tag``. Every rank creates every group, in one order
    (``torch.distributed``'s rule)."""
    def group(ranks, tag, kind=backend):
        if len(ranks) == 1:
            return None
        if store is None:
            return dist.new_group(ranks, backend=kind, timeout=TIMEOUT)
        if rank not in ranks:
            return None
        sub = dist.PrefixStore(f"bft_mesh/{tag}/", store)
        return dist.ProcessGroupGloo(sub, ranks.index(rank), len(ranks), TIMEOUT)

    return group


def make_mesh(dp: int, tp: int = 1, sp: int = 1, *, backend: str,
              store=None, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """The calling rank's dp and tp process groups, rank ``d * tp + t``.

    Without ``store`` the groups come from ``torch.distributed``'s default
    process group, initialised here from the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, as
    ``torch.distributed.run`` sets them) with ``backend`` if it is not yet;
    one initialised with another backend raises (the backend is never
    switched silently; :func:`default_backend` names the device's). With a
    ``store`` (``torch.distributed.FileStore``, ``TCPStore`` or, for
    threads, ``HashStore``) and ``rank`` / ``world_size``, gloo groups are
    built on it and no default group is needed (one thread a rank in the
    tests, ranks that share one card). ``dp <= 0`` takes
    ``world_size // tp``; a world size other than dp * tp raises, as does
    ``sp > 1`` (:data:`ITEM_6D`)."""
    if sp > 1:
        raise NotImplementedError(
            f"sequence parallelism (sp={sp}) is {ITEM_6D}: in the reference it is a "
            "GSPMD layout over the token axis, not a shard_map program; run sp=1")
    rank, world_size = _world(backend, store, rank, world_size)
    if tp < 1:
        raise ValueError(f"tp must be at least 1, got {tp}")
    if dp <= 0:
        dp = world_size // tp
    if dp * tp != world_size:
        raise ValueError(f"mesh dp={dp} x tp={tp} needs {dp * tp} ranks; the world has "
                         f"{world_size}")
    group = group_factory(backend, store, rank)
    dp_groups = [group([d * tp + t for d in range(dp)], f"dp{t}") for t in range(tp)]
    tp_ranks = [[d * tp + t for t in range(tp)] for d in range(dp)]
    tp_groups = [group(r, f"tp{d}") for d, r in enumerate(tp_ranks)]
    world = group(list(range(world_size)), "world")
    if backend == "gloo":
        export_groups = tp_groups
    else:
        export_groups = [group(r, f"export{d}", "gloo") for d, r in enumerate(tp_ranks)]
    d, t = divmod(rank, tp)
    return Mesh(dp, tp, rank, backend, dp_groups[t], tp_groups[d], world,
                export_groups[d])


def make_axis(n: int, axis: str, *, backend: str, store=None, rank: Optional[int] = None,
              world_size: Optional[int] = None, hops: bool = False) -> coll.Ranks:
    """The calling rank's place on a one-axis mesh of ``n`` ranks named
    ``axis`` (``"pp"`` or ``"ep"``): its group of all ``n`` and, with
    ``hops`` under gloo, the pair groups {i, i + 1} of the pipeline's shift.
    The groups and the keywords are :func:`make_mesh`'s; a world size other
    than ``n`` raises."""
    if n < 1:
        raise ValueError(f"{axis} must be at least 1, got {n}")
    rank, world_size = _world(backend, store, rank, world_size)
    if world_size != n:
        raise ValueError(f"mesh {axis}={n} needs {n} ranks; the world has {world_size}")
    group = group_factory(backend, store, rank)
    world = group(list(range(n)), f"{axis}/world")
    pairs = ()
    if hops and backend == "gloo":
        pairs = tuple(group([i, i + 1], f"{axis}/hop{i}") for i in range(n - 1))
    return coll.Ranks(axis, rank, n, world, backend, pairs)


def shard_batch(batch, mesh: Optional[Mesh]):
    """The rank's dp slice of the leading axis of every tensor (or array)
    of ``batch`` (a dict, tuple or list of them, or one; what has no shape,
    None among it, passes as it is); every dp rank's slice is equal in
    size, or ValueError."""
    if mesh is None or mesh.dp == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if not hasattr(batch, "shape"):
        return batch
    n = batch.shape[0]
    if n % mesh.dp:
        raise ValueError(f"a batch of {n} rows does not divide over dp={mesh.dp}")
    b = n // mesh.dp
    return batch[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]


def sharded_leaves(bmodel: BayesianModel, spec_fn=None) -> dict[str, int]:
    """``{path: dim}`` of the model's parameters that tp shards: each whose
    rule shards it, in a layer whose kernel is converted (the converted mu
    and bias, and a frequentist bias of such a layer). ``rho`` and
    ``prior_mu`` of these paths shard with them."""
    spec_fn = spec_fn or family_tp_fns(bmodel.spec.paths)[0]
    out = {}
    for name, _ in bmodel.model.named_parameters():
        path = name.replace(".", SEP)
        dim = sharded_dim(spec_fn(path))
        head = path.rpartition(SEP)[0]
        if dim is not None and (head + SEP + "kernel") in bmodel.rho:
            out[path] = dim
    return out


def bayes_param_specs(bmodel: BayesianModel, spec_fn=None) -> dict[str, dict[str, tuple]]:
    """The spec of every tensor of the variational state as it is sharded,
    ``{"params" | "rho" | "prior_mu": {path: spec}}`` (``()`` where it is
    replicated)."""
    spec_fn = spec_fn or family_tp_fns(bmodel.spec.paths)[0]
    sharded = sharded_leaves(bmodel, spec_fn)

    def spec(path):
        return tuple(spec_fn(path)) if path in sharded else REP

    params = [n.replace(".", SEP) for n, _ in bmodel.model.named_parameters()]
    return {"params": {p: spec(p) for p in params},
            "rho": {p: spec(p) for p in bmodel.rho},
            "prior_mu": {p: spec(p) for p in bmodel.prior_mu}}


def _block(t: torch.Tensor, dim: int, n: int, r: int, axis: str = "tp") -> torch.Tensor:
    """Rank ``r``'s block of ``n`` along ``dim``, a copy of its own."""
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"a dim of {size} does not divide over {axis}={n}")
    b = size // n
    # a copy, never a view: the block must own its storage (the whole
    # tensor is freed, and the optimizer updates the block in place)
    return t.narrow(dim, r * b, b).clone(memory_format=torch.contiguous_format)


@torch.no_grad()
def shard_params(module: torch.nn.Module, dims: dict[str, int], ranks: coll.Ranks) -> None:
    """Keep, in place, the rank's block of each parameter named in ``dims``
    along its dim there, on a one-axis mesh (:func:`make_axis`; the
    pipeline's ``shard_stack``, the experts' ``shard_experts``). The
    parameter objects stay, so an optimizer built before or after holds the
    blocks. The whole module is drawn first, so that a rank's block is the
    slice of the one-process init at the same seed."""
    for name, p in module.named_parameters():
        if name in dims:
            p.data = _block(p.data, dims[name], ranks.world_size, ranks.rank, ranks.axis)
            p.grad = None


@torch.no_grad()
def unshard_params(module: torch.nn.Module, dims: dict[str, int],
                   ranks: Optional[coll.Ranks]) -> torch.nn.Module:
    """A copy of ``module`` with every parameter named in ``dims`` gathered
    from the ranks' blocks (an all-reduce of zero-padded blocks on the
    tensors' device; every rank must call it) and ``n_shards`` 1 on every
    submodule."""
    whole = copy.deepcopy(module)
    for name, p in whole.named_parameters():
        p.grad = None
        if ranks is not None and name in dims:
            p.data = coll.gather_rows(p.data, ranks.group, ranks.rank, dims[name])
    for m in whole.modules():
        if hasattr(m, "n_shards"):
            m.n_shards = 1
    return whole


def shard_bayes_params(bmodel: BayesianModel, mesh: Mesh, spec_fn=None) -> BayesianModel:
    """Keep only the rank's tp block of every sharded leaf
    (:func:`sharded_leaves`), in place: the model's parameters, ``rho`` and
    ``prior_mu``. ``spec_fn=None`` takes the family's rules
    (:func:`family_tp_fns`). GPT-2's c_attn must be permuted first
    (:func:`permute_gpt2_qkv`)."""
    if mesh.tp == 1:
        return bmodel
    spec_fn = spec_fn or family_tp_fns(bmodel.spec.paths)[0]
    assert_tp_coverage(bmodel.spec.paths, spec_fn)
    with torch.no_grad():
        for path, dim in sharded_leaves(bmodel, spec_fn).items():
            p = leaf(bmodel.model, path)
            p.data = _block(p.data, dim, mesh.tp, mesh.tp_rank)
            for part in (bmodel.rho, bmodel.prior_mu):
                if path in part:
                    part[path] = _keep_grad(part[path],
                                            _block(part[path], dim, mesh.tp, mesh.tp_rank))
        _refresh_frozen_prior(bmodel)
    return bmodel


def unshard_bayes_params(bmodel: BayesianModel, mesh: Optional[Mesh],
                         spec_fn=None) -> dict[str, dict[str, torch.Tensor]]:
    """The whole variational state ``{"params" | "rho" | "prior_mu": {path:
    tensor}}`` as CPU tensors, every sharded leaf gathered from the tp ranks
    (an all-gather of CPU copies over ``mesh.export_group``, outside any
    step; every tp rank must call it). The layout is the sharded one: GPT-2's
    c_attn stays permuted (``permute_gpt2_qkv(..., inverse=True)``)."""
    from bayeformers_tpu_torch.utils.checkpoint import variational_state

    specs = bayes_param_specs(bmodel, spec_fn) if mesh is not None and mesh.tp > 1 else None
    out = {}
    for part, tensors in variational_state(bmodel).items():
        out[part] = {}
        for path, t in tensors.items():
            cpu = t.detach().to("cpu", copy=True)
            dim = None if specs is None else sharded_dim(specs[part][path])
            if dim is not None:
                blocks = [torch.empty_like(cpu) for _ in range(mesh.tp)]
                mesh.export_group.allgather([blocks], [cpu]).wait()
                cpu = torch.cat(blocks, dim=dim)
            out[part][path] = cpu
    return out


@torch.no_grad()
def load_unsharded(bmodel: BayesianModel, mesh: Optional[Mesh],
                   state: dict[str, dict[str, torch.Tensor]], spec_fn=None) -> None:
    """Copy a whole state (as :func:`unshard_bayes_params` returns it) into
    a sharded model in place, each sharded leaf its rank's block."""
    specs = bayes_param_specs(bmodel, spec_fn) if mesh is not None and mesh.tp > 1 else None
    from bayeformers_tpu_torch.utils.checkpoint import variational_state

    for part, tensors in variational_state(bmodel).items():
        for path, t in tensors.items():
            src = state[part][path]
            dim = None if specs is None else sharded_dim(specs[part][path])
            if dim is not None:
                src = _block(src, dim, mesh.tp, mesh.tp_rank)
            t.copy_(src)


def replicate(bmodel: BayesianModel, mesh: Optional[Mesh]) -> BayesianModel:
    """Rank 0's variational state on every rank (one broadcast a dtype
    over all ranks), in place: run before sharding, so that the replicas
    start equal whatever each computed before."""
    if mesh is not None:
        from bayeformers_tpu_torch.utils.checkpoint import variational_state

        with torch.no_grad():
            state = variational_state(bmodel)
            tensors = list(state["params"].values()) + list(state["rho"].values())
            if not (bmodel.spec.moped and bmodel.spec.frozen):
                tensors += list(state["prior_mu"].values())
            coll.broadcast_coalesced_(tensors, mesh.world_group)
    return bmodel
