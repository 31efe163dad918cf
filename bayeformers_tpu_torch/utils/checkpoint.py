"""Checkpoint save and restore of a converted model (counterpart of
``bayeformers_tpu/utils/checkpoint.py``).

The layout is the JAX package's: ``{directory}/step_{N}`` holds the whole
variational state, the model's parameters (mu among them), ``rho`` and
``prior_mu``, and ``{directory}/step_{N}.meta.json`` the metadata. Where the
JAX package writes with Orbax, the port writes ``step_{N}/params.pt``,
``rho.pt`` and ``prior_mu.pt`` with ``torch.save`` of ``{path: tensor}``
dicts on the CPU, and reads them with ``torch.load(weights_only=True)``.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import torch

from bayeformers_tpu_torch.nn.surgery import SEP, BayesianModel

PARTS = ("params", "rho", "prior_mu")


def variational_state(bmodel: BayesianModel) -> dict[str, dict[str, torch.Tensor]]:
    """The three parts as ``{path: tensor}`` dicts (the model's parameters
    under their '/'-joined paths)."""
    params = {n.replace(".", SEP): p for n, p in bmodel.model.named_parameters()}
    return {"params": params, "rho": bmodel.rho, "prior_mu": bmodel.prior_mu}


def save_checkpoint(directory: str, bmodel: BayesianModel, *, step: int = 0,
                    metadata: Optional[dict] = None, mesh=None) -> str:
    """Write ``{directory}/step_{step}`` with the full variational state (and
    the metadata beside it); returns the step's path. Under a ``mesh``
    (``parallel/mesh.py``) every rank calls it: the tp shards are gathered
    on CPU copies, GPT-2's c_attn goes back to the stock layout, and rank 0
    alone writes the whole state, as one process would."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step}")
    if mesh is None:
        state = {part: {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}
                 for part, tensors in variational_state(bmodel).items()}
    else:
        from bayeformers_tpu_torch.parallel import mesh as mesh_lib

        state = mesh_lib.unshard_bayes_params(bmodel, mesh)
        if mesh_lib.needs_qkv_perm(bmodel.spec.paths, mesh.tp):
            state = mesh_lib.permute_gpt2_qkv(state, mesh.tp, inverse=True)
        if mesh.rank != 0:
            return path
    os.makedirs(path, exist_ok=True)
    for part, cpu in state.items():
        tmp = os.path.join(path, f".{part}.pt.tmp")
        torch.save(cpu, tmp)
        os.replace(tmp, os.path.join(path, f"{part}.pt"))
    if metadata is not None:
        with open(os.path.join(directory, f"step_{step}.meta.json"), "w") as fh:
            json.dump(metadata, fh, indent=2, default=float)
    return path


@torch.no_grad()
def load_checkpoint(directory: str, bmodel: BayesianModel, *, step: int = 0, mesh=None):
    """Restore a state written by :func:`save_checkpoint` into ``bmodel`` (a
    freshly converted model of the same structure, the JAX package's
    ``template``), in place; returns ``(bmodel, metadata)``. A missing or
    unexpected leaf, or one of another shape, raises, naming it. Under a
    ``mesh`` with tp > 1 the model holds its shards: the whole state is
    read (GPT-2's c_attn permuted as the shards are) and each rank keeps
    its blocks."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step}")
    state = {part: torch.load(os.path.join(path, f"{part}.pt"), map_location="cpu",
                              weights_only=True) for part in PARTS}
    for part, tensors in variational_state(bmodel).items():
        saved = state[part]
        if set(saved) != set(tensors):
            raise ValueError(f"{path}/{part}.pt does not match the model: missing "
                             f"{sorted(set(tensors) - set(saved))}, unexpected "
                             f"{sorted(set(saved) - set(tensors))}")
    if mesh is not None and mesh.tp > 1:
        from bayeformers_tpu_torch.parallel import mesh as mesh_lib

        if mesh_lib.needs_qkv_perm(bmodel.spec.paths, mesh.tp):
            state = mesh_lib.permute_gpt2_qkv(state, mesh.tp)
        mesh_lib.load_unsharded(bmodel, mesh, state)
    else:
        for part, tensors in variational_state(bmodel).items():
            for k, t in tensors.items():
                if state[part][k].shape != t.shape:
                    raise ValueError(f"{path}/{part}.pt: {k} has shape "
                                     f"{tuple(state[part][k].shape)}, the model "
                                     f"{tuple(t.shape)}")
                t.copy_(state[part][k])
    meta_path = os.path.join(directory, f"step_{step}.meta.json")
    metadata = None
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            metadata = json.load(fh)
    return bmodel, metadata


def latest_step(directory: str) -> Optional[int]:
    """Highest step number present under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_", 1)[1]) for name in os.listdir(directory)
             if name.startswith("step_") and not name.endswith(".json")
             and name.split("_", 1)[1].isdigit()]
    return max(steps) if steps else None


def resume_epoch(directory: Optional[str], bmodel: BayesianModel, resume: bool,
                 name: str, mesh=None) -> int:
    """The recipes' resume policy (the reference only saves): with ``resume``,
    restore the latest step under ``directory`` into ``bmodel``; returns the
    Bayesian epoch to continue from, that step's number (0 when nothing was
    restored). Under a ``mesh`` each rank restores its shards."""
    step = latest_step(directory) if resume and directory else None
    if step is None:
        return 0
    load_checkpoint(directory, bmodel, step=step, **({} if mesh is None else {"mesh": mesh}))
    if mesh is None or mesh.rank == 0:
        print(f"[{name}] resumed from {directory} step {step}")
    return int(step)


def save_epoch(directory: Optional[str], bmodel: BayesianModel, epoch: int,
               metadata: dict, mesh=None) -> None:
    """After Bayesian epoch ``epoch``, write ``step_{epoch + 1}`` with its
    metadata, when a ``directory`` was given (every rank calls it under a
    ``mesh``; rank 0 writes)."""
    if directory:
        save_checkpoint(directory, bmodel, step=epoch + 1, metadata=metadata, mesh=mesh)
