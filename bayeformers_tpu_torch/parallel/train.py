"""Data- and tensor-parallel training over ``torch.distributed`` (counterpart
of ``bayeformers_tpu/parallel/train.py``).

Each rank runs the single-device step of ``training.py``, the kernels
included, on its local shard, and explicit collectives take the place of
the reference's ``shard_map`` ``psum``s:

- **dp**: every rank holds the whole model (or its tp shards) and its
  slice of the batch; after the local backward the gradients are summed
  over the dp group (one all-reduce a dtype).
- **tp**: the converted leaves hold the rank's Megatron block
  (``parallel/mesh.py``) and the fused tier's plan (``nn/fused.py``,
  ``tp=``) runs the f/g collectives inside the forward.

Draws: by default every dp rank takes the step's seed, so every replica
draws the same S weights and the step equals the one-process step on the
whole batch. ``independent_draws=True`` derives each dp rank's seed from
its coordinate (the reference's ``fold_in(key, axis_index)``): the
reference's ``DataParallel`` semantics, S x dp draws a step, the summed
ELBO then the MC average over all of them.

The step's collectives are all-reduces only (the f/g pair, the gradient
all-reduce, the KL and metric sums, the grad-norm sum), so that two ranks
can share one card over gloo.
"""
from __future__ import annotations

import functools
import os
from typing import Callable, Optional

import torch

from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.nn.fused import derive_seed
from bayeformers_tpu_torch.nn.surgery import leaf
from bayeformers_tpu_torch.parallel import collectives as coll
from bayeformers_tpu_torch.parallel import mesh as mesh_lib
from bayeformers_tpu_torch.parallel.mesh import ITEM_6D, replicate  # noqa: F401
from bayeformers_tpu_torch.utils.dumper import Dumper
from bayeformers_tpu_torch.utils.metrics import MetricsWriter, NullWriter
from bayeformers_tpu_torch.utils.optim import ClippedAdamW

FUSED = ("fused", "antithetic")


def init_mesh(dp: int, tp: int = 1, sp: int = 1, backend: Optional[str] = None,
              device="cuda"):
    """``(mesh, device)`` of a workload's rank: ``(None, device)`` for one
    process (dp = tp = sp = 1 and no launcher's ``WORLD_SIZE`` above 1),
    else the process groups of :func:`parallel.mesh.make_mesh`, the default
    group initialised from the environment that ``python -m
    torch.distributed.run`` sets. ``backend`` defaults to ``nccl`` on a CUDA
    device and ``gloo`` on the CPU (two ranks on one card take ``gloo``); a
    CUDA device without an index becomes ``cuda:LOCAL_RANK`` (modulo the
    cards there are, so that ranks may share one)."""
    if (dp, tp, sp) == (1, 1, 1) and _launched_world() == 1:
        return None, torch.device(device)
    need = dp * tp if sp == 1 and dp > 0 else None
    backend, dev = _launched_rank(need, f"mesh dp={dp} x tp={tp}", backend, device)
    return mesh_lib.make_mesh(dp, tp, sp, backend=backend), dev


def init_axis(make: Callable, n: int, what: str, backend: Optional[str] = None,
              device="cuda"):
    """``(ranks, device)`` of a workload's rank on a one-axis mesh of ``n``
    ranks (``make``: ``pipeline.make_pp_mesh`` or
    ``moe.make_ep_mesh``): ``(None, device)`` for n = 1, else under
    :func:`init_mesh`'s rules for the launcher's world, the backend and the
    device; ``what`` names the flag in the error."""
    if n == 1:
        return None, torch.device(device)
    backend, dev = _launched_rank(n, what, backend, device)
    return make(n, backend=backend), dev


def _launched_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def _launched_rank(need: Optional[int], what: str, backend: Optional[str],
                   device) -> tuple[str, torch.device]:
    """``(backend, device)`` of a rank that ``python -m
    torch.distributed.run`` started, once its world is held to ``need``
    ranks (None: not checked here). A CUDA device without an index becomes
    ``cuda:LOCAL_RANK`` (modulo the cards there are, so that ranks may share
    one), made current."""
    world = _launched_world()
    if need is not None and need != world:
        raise ValueError(f"{what} needs {need} ranks; the world has {world} "
                         "(start the ranks with python -m torch.distributed.run "
                         f"--nproc-per-node {need})")
    dev = torch.device(device)
    backend = backend or mesh_lib.default_backend(dev)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return backend, dev


def add_mesh_args(parser) -> None:
    """The workloads' mesh flags: ``--dp``, ``--tp``, ``--sp``,
    ``--independent-draws`` and ``--backend``."""
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel ranks (0: the world size over --tp)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel ranks (the fused tier's Megatron sharding)")
    parser.add_argument("--sp", type=int, default=1,
                        help=f"sequence-parallel ranks: above 1, {ITEM_6D}")
    parser.add_argument("--independent-draws", action="store_true",
                        help="each dp rank draws its own MC sample set (S x dp draws)")
    parser.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                        help="process-group backend: default nccl on the card, gloo on "
                             "the CPU; gloo where ranks share one card")


def mesh_kwargs(args) -> dict:
    """The keywords of :func:`add_mesh_args`'s flags for a workload's
    ``train``."""
    return dict(dp=args.dp, tp=args.tp, sp=args.sp,
                independent_draws=args.independent_draws, backend=args.backend)


def finish() -> None:
    """Leave the default process group, if a workload joined one."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def launcher_print(*args, **kwargs) -> None:
    """``print`` on the launcher's rank 0 (``RANK``) only."""
    if os.environ.get("RANK", "0") == "0":
        print(*args, **kwargs)


def is_rank0(mesh) -> bool:
    """Whether this rank logs and writes (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0


def _quiet(*args, **kwargs) -> None:
    pass


def rank_logging(mesh, logs: str, name: str):
    """``(writer, dumper, say)`` of a workload's rank: rank 0's JSONL
    metrics and results under ``logs`` and ``print``; the other ranks'
    write and print nothing."""
    if is_rank0(mesh):
        return (MetricsWriter(logs, name), Dumper(os.path.join(logs, name + ".results")),
                print)
    return NullWriter(), Dumper(None), _quiet


def _check_tp_estimator(tp: int, estimator: str) -> None:
    if tp > 1 and estimator not in FUSED:
        raise NotImplementedError(
            f"tp > 1 with the {estimator!r} estimator is {ITEM_6D} (the reference's GSPMD "
            "tier); the Megatron plan runs 'fused' or 'antithetic'")


def check_mesh(dp: int, tp: int, estimator: str, batch_size: int) -> None:
    """A workload's refusals before any work: tp > 1 off the fused tier
    (:data:`ITEM_6D`), a batch that does not divide over dp."""
    _check_tp_estimator(tp, estimator)
    if dp > 0 and batch_size % dp:
        raise ValueError(f"batch_size {batch_size} must divide over dp={dp}")


def tp_fns(bmodel, mesh, estimator: str, spec_fn=None, kind_fn=None):
    """``(spec_fn, kind_fn)`` of the model's family (``mesh.family_tp_fns``;
    a given ``spec_fn`` derives its kinds from its specs); tp > 1 on a
    family whose attention the fused tier does not run on local heads (T5,
    CLIP, Whisper), or with another estimator than the fused tier's, raises
    (:data:`ITEM_6D`)."""
    if spec_fn is None:
        spec_fn, default_kind, ok = mesh_lib.family_tp_fns(bmodel.spec.paths)
    else:
        default_kind, ok = (lambda p: mesh_lib.kind_from_spec(spec_fn(p))), True
    if mesh is not None and mesh.tp > 1:
        if not ok:
            raise NotImplementedError(
                f"tp > 1 on this family is {ITEM_6D}: the fused tier does not run its "
                "attention on local heads (the reference shards it under GSPMD only)")
        _check_tp_estimator(mesh.tp, estimator)
    return spec_fn, kind_fn or default_kind


def make_mc(bmodel, mesh, fused: bool = True, estimator: Optional[str] = None,
            save_weights: bool = True, kind_fn=None, gather: bool = False):
    """The MC forward ``mc(seed, n_samples, **inputs, **kwargs)`` of a
    rank: ``training.pick_mc``'s, and under tp the fused tier with the
    rank's :class:`collectives.TPContext`. With ``gather`` the inputs are
    the whole batch: the rank runs its dp slice and the outputs come back
    whole on every rank (:func:`gather_outputs`)."""
    if estimator is None:
        estimator = "fused" if fused else "naive"
    _, kind_fn = tp_fns(bmodel, mesh, estimator, kind_fn=kind_fn)
    ctx = coll.tp_context(mesh, kind_fn)
    if ctx is not None:
        mc = functools.partial(bmodel.mc_apply_fused, antithetic=estimator == "antithetic",
                               save_weights=save_weights, tp=ctx)
    else:
        mc = training.pick_mc(bmodel, fused, estimator, save_weights=save_weights)
    if not gather or mesh is None or mesh.dp == 1:
        return mc

    def gathered(seed, n_samples, *args, **inputs):
        args, inputs = mesh_lib.shard_batch((args, inputs), mesh)
        out, aux = mc(seed, n_samples, *args, **inputs)
        return gather_outputs(out, mesh), aux

    return gathered


def gather_outputs(out, mesh, dim: int = 1):
    """(S, B_local, ...) outputs (or a tuple of them) of the dp ranks side
    by side along the batch (``dim``; 0 for outputs without a sample
    axis): (S, B, ...) on every rank."""
    if mesh is None or mesh.dp == 1:
        return out
    if isinstance(out, tuple):
        return tuple(gather_outputs(o, mesh, dim) for o in out)
    return coll.gather_rows(out, mesh.dp_group, mesh.dp_rank, dim=dim)


def all_reduce_grads(tensors, mesh) -> None:
    """Sum the gradients that exist over the dp ranks, in place (a
    frequentist step's data parallelism)."""
    if mesh is not None:
        coll.all_reduce_coalesced_([t.grad for t in tensors if t.grad is not None],
                                   mesh.dp_group)


def dp_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the dp ranks (a copy; ``t`` itself without a
    mesh)."""
    return t if mesh is None else coll.all_reduce_(t.clone(), mesh.dp_group)


def sum_over(values: dict[str, torch.Tensor], group, mean_keys=()) -> dict:
    """Scalar metrics summed over ``group`` in one all-reduce, those of
    ``mean_keys`` then divided by its size."""
    n = coll.group_size(group)
    if n == 1:
        return values
    keys = sorted(values)
    vec = coll.all_reduce_(torch.stack([values[k].float() for k in keys]), group)
    return {k: (v / n if k in mean_keys else v) for k, v in zip(keys, vec.unbind())}


def global_grad_norm(grads: list[torch.Tensor], sharded: list[bool], tp_group) -> torch.Tensor:
    """The global L2 norm of a tp-sharded gradient list (the reference's
    ``_global_grad_norm``): the sharded leaves' squares summed over the tp
    ranks, the replicated ones (equal on every rank) counted once."""
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    sq_sh = sum((torch.sum(g.float() * g.float()) for g, s in zip(grads, sharded) if s), zero)
    sq_rep = sum((torch.sum(g.float() * g.float()) for g, s in zip(grads, sharded) if not s),
                 zero)
    return torch.sqrt(coll.all_reduce_(sq_sh, tp_group) + sq_rep)


def make_train_step(bmodel, optimizer: ClippedAdamW, n_samples: int, n_batches: int,
                    mesh, loss_fn: Callable = training.classification_loss,
                    fused: bool = True, input_keys: tuple[str, ...] = training.INPUT_KEYS,
                    estimator: Optional[str] = None, mc_chunk: Optional[int] = None,
                    spec_fn=None, kind_fn=None, independent_draws: bool = False,
                    clip_norm: Optional[float] = None, eps_hook: Optional[Callable] = None,
                    impl: str = "kernel", untile_axes: tuple[int, ...] = ()):
    """Returns ``step(seed, batch) -> metrics`` for this rank, ``batch``
    its dp slice (``mesh.shard_batch``); it updates the rank's tensors in
    place. Build it, and ``optimizer``, after ``shard_bayes_params``.

    The KL part of each rank's loss is divided by dp, so that the sum over
    the dp ranks is the ELBO of the whole batch; the gradients are averaged
    over ``mc_chunk`` chunks as in ``training.make_elbo_train_step``, then
    summed over dp. ``loss`` and ``nll`` are summed over dp, the other
    metrics averaged. ``clip_norm``: the global-norm clip after the dp sum,
    sharded-aware (:func:`global_grad_norm`); under tp it must be here and
    not in ``optimizer``, whose clip would take a rank's own norm and
    desynchronise the replicated leaves. ``estimator``: any of
    ``training.pick_mc``'s for dp alone, ``fused`` or ``antithetic`` under
    tp. ``eps_hook(chunk, path, n_draws, shape)`` supplies whole layers'
    draws (tests), ``impl="plain"`` runs the plain versions (the card's
    reference). At dp = tp = 1 (or ``mesh=None``) it computes
    ``make_elbo_train_step``'s step, bit for bit: the collectives are
    no-ops on one rank."""
    dp = 1 if mesh is None else mesh.dp
    tp = 1 if mesh is None else mesh.tp
    if estimator is None:
        estimator = "fused" if fused else "naive"
    spec_fn, kind_fn = tp_fns(bmodel, mesh, estimator, spec_fn, kind_fn)
    sharded_ids = set()
    if tp > 1:
        if optimizer.clip_norm is not None:
            raise ValueError("under tp the optimizer's own clip takes a rank's norm; build "
                             "it with clip_norm=None and pass clip_norm to the step")
        for path in mesh_lib.sharded_leaves(bmodel, spec_fn):
            sharded_ids.add(id(leaf(bmodel.model, path)))
            if path in bmodel.rho:
                sharded_ids.add(id(bmodel.rho[path]))
    mc = make_mc(bmodel, mesh, fused, estimator, kind_fn=kind_fn)
    n_chunks, chunk = training.chunks(n_samples, mc_chunk)
    mc_kwargs = {} if impl == "kernel" else {"impl": impl}
    dp_group = None if mesh is None else mesh.dp_group

    def step(seed: int, batch: dict) -> dict[str, torch.Tensor]:
        if independent_draws and dp > 1:
            seed = derive_seed(seed, mesh.dp_rank)
        totals = training.accumulate_grads(mc, optimizer, seed, n_chunks, chunk, batch,
                                           n_batches * dp, loss_fn, input_keys, eps_hook,
                                           untile_axes, **mc_kwargs)
        with torch.no_grad():
            coll.all_reduce_coalesced_(optimizer.grads(), dp_group)
            if clip_norm is not None:
                params = [p for p in optimizer.params if p.grad is not None]
                grads = [p.grad for p in params]
                norm = global_grad_norm(grads, [id(p) in sharded_ids for p in params],
                                        None if mesh is None else mesh.tp_group)
                scale = torch.clamp(clip_norm / (norm + 1e-12), max=1.0)
                for g in grads:
                    g.mul_(scale.to(g.dtype))
        optimizer.step()
        return sum_over(totals, dp_group, mean_keys=set(totals) - {"loss", "nll"})

    return step


def make_dp_train_step(*args, **kwargs):
    """The reference's dp-only name for :func:`make_train_step`."""
    return make_train_step(*args, **kwargs)


def make_eval_step(bmodel, n_samples: int, mesh,
                   loss_fn: Callable = training.classification_loss, fused: bool = True,
                   input_keys: tuple[str, ...] = training.INPUT_KEYS,
                   estimator: Optional[str] = None, untile_axes: tuple[int, ...] = ()):
    """``training.make_elbo_eval_step`` over the mesh: ``eval_step(seed,
    batch) -> (out, metrics)`` of the whole ``batch``, each rank running its
    dp slice (shared draws) and the outputs gathered, so that every rank
    computes the metrics of the whole batch; on one rank
    ``make_elbo_eval_step``'s."""
    if mesh is None or mesh.dp == mesh.tp == 1:
        return training.make_elbo_eval_step(bmodel, n_samples, loss_fn=loss_fn, fused=fused,
                                            input_keys=input_keys, estimator=estimator,
                                            untile_axes=untile_axes)
    mc = make_mc(bmodel, mesh, fused, estimator, save_weights=False, gather=True)

    @torch.inference_mode()
    def eval_step(seed: int, batch: dict):
        inputs = {k: batch[k] for k in input_keys if k in batch}
        out, aux = mc(seed, n_samples, **inputs, untile_axes=untile_axes)
        nll, metrics = loss_fn(out, batch)
        metrics = dict(
            metrics, nll=nll, log_prior=torch.mean(aux["log_prior"]),
            log_variational_posterior=torch.mean(aux["log_variational_posterior"]),
        )
        return out, metrics

    return eval_step


def prepare_bayes_params(bmodel, mesh, spec_fn=None):
    """A converted model made ready for the mesh, in place: rank 0's state
    on every rank (:func:`parallel.mesh.replicate`), then under tp GPT-2's
    c_attn permuted and the rank's shards kept
    (``shard_bayes_params``)."""
    if mesh is None:
        return bmodel
    replicate(bmodel, mesh)
    if mesh.tp > 1:
        if mesh_lib.needs_qkv_perm(bmodel.spec.paths, mesh.tp):
            mesh_lib.permute_gpt2_qkv(bmodel, mesh.tp)
        mesh_lib.shard_bayes_params(bmodel, mesh, spec_fn)
    return bmodel
