"""Ranks as threads for the port's parallel tests.

:func:`run_ranks` starts one thread a rank; each calls ``fn(rank, mesh,
*args)`` with its :class:`parallel.mesh.Mesh`, whose gloo groups are built
on one ``HashStore`` (``make_mesh(store=...)``), so that no default process
group is needed; :func:`run_axis` does the same with a pp or ep mesh
(``make_pp_mesh``, ``make_ep_mesh``). A rank that raises fails the call; its peers, blocked in
a collective, are daemon threads and are left behind. Also the small
models, batches and optimizers the parallel tests share, and
:func:`whole_grads`, a rank's gradients with the tp shards gathered.
"""
import copy
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

import bayeformers_tpu_torch as bt
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.parallel import collectives as coll
from bayeformers_tpu_torch.parallel import mesh as mesh_lib
from bayeformers_tpu_torch.utils.optim import masked_optimizer

TIMEOUT_S = 240
# a tiny BERT whose tp = 2 shard boundaries land on the (256, 128) unit
# grid: q/k/v 512 -> 256 (n0 = 256), FFN 512 -> 512 (n0 = 512) and its
# row halves 512 -> 512 (k0 = 512); attention output 256 -> 512 (k0 = 256)
ALIGNED = dict(hidden_size=512, num_attention_heads=4, intermediate_size=1024,
               num_hidden_layers=1)


def run_ranks(dp: int, tp: int, fn, *args):
    """``[fn(rank, mesh, *args) for rank]`` run on dp x tp threads."""
    return _threads(dp * tp, lambda store, rank, world: mesh_lib.make_mesh(
        dp, tp, backend="gloo", store=store, rank=rank, world_size=world), fn, *args)


def run_axis(n: int, axis: str, fn, *args):
    """``[fn(rank, ranks, *args) for rank]`` on ``n`` threads, ``ranks`` the
    rank's ``make_pp_mesh(n)`` (``axis`` ``"pp"``) or ``make_ep_mesh(n)``
    (``"ep"``) on one store."""
    from bayeformers_tpu_torch.parallel import moe, pipeline

    make = pipeline.make_pp_mesh if axis == "pp" else moe.make_ep_mesh
    return _threads(n, lambda store, rank, world: make(
        n, backend="gloo", store=store, rank=rank, world_size=world), fn, *args)


def _threads(world: int, make, fn, *args):
    store = dist.HashStore()
    results, errors = [None] * world, []

    def target(rank):
        try:
            results[rank] = fn(rank, make(store, rank, world), *args)
        except BaseException as e:  # noqa: BLE001 (re-raised by the caller)
            errors.append(e)

    threads = [threading.Thread(target=target, args=(r,), daemon=True) for r in range(world)]
    for t in threads:
        t.start()
    deadline = time.time() + TIMEOUT_S
    while any(t.is_alive() for t in threads) and not errors and time.time() < deadline:
        time.sleep(0.01)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"ranks still running after {TIMEOUT_S} s")
    return results


def tiny_bert(delta=0.05, seed=0, **overrides):
    """A frozen-MOPED tiny BERT on the CPU in f32 (``overrides`` over the
    tiny preset); zero leaves set to 0.01 first, as the JAX package's tests
    do, so that MOPED gives them a small sigma."""
    net = bt.build_model("bert-base-uncased", size="tiny", seed=seed, device="cpu",
                         dtype=torch.float32, **overrides)
    with torch.no_grad():
        for p in net.parameters():
            p.masked_fill_(p == 0, 0.01)
    return bt.to_bayesian(net, delta=delta, freeze=True)


def text_batch(B, L, seed=3, vocab=1024):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L), np.int64)
    mask[1, L - 5:] = 0
    return {"input_ids": torch.from_numpy(rng.integers(1, vocab, (B, L))),
            "attention_mask": torch.from_numpy(mask),
            "token_type_ids": torch.zeros(B, L, dtype=torch.long),
            "labels": torch.from_numpy(rng.integers(0, 2, (B,)))}


def optimizer(bmodel, clip_norm=1.0, lr=1e-3):
    tx = training.adamw_with_decay_groups(lr, 0.0, training.default_no_decay,
                                          clip_norm=clip_norm)
    return masked_optimizer(tx, bmodel)


def copy_model(bmodel):
    return copy.deepcopy(bmodel)


def whole_grads(bmodel, mesh) -> dict:
    """``{"params/<path>" | "rho/<path>": gradient}`` of a rank's trainable
    tensors, the tp shards gathered (an all-reduce of zero-padded blocks)."""
    specs = mesh_lib.bayes_param_specs(bmodel) if mesh is not None else None
    out = {}
    for name, t, _ in bmodel.trainable_parameters():
        if t.grad is None:
            continue
        part, path = name.split("/", 1)
        g = t.grad.detach()
        dim = None if specs is None else mesh_lib.sharded_dim(specs[part][path])
        if dim is not None and mesh.tp > 1:
            g = coll.gather_rows(g, mesh.tp_group, mesh.tp_rank, dim)
        out[name] = g.clone()
    return out


def single_grads(bmodel) -> dict:
    return {name: t.grad.detach().clone() for name, t, _ in bmodel.trainable_parameters()
            if t.grad is not None}


def assert_grads_close(got: dict, want: dict, rtol=1e-4, scale_tol=1e-4) -> None:
    """Each leaf's gradient within ``rtol`` and ``scale_tol`` of its largest
    entry (f32 sums in another order)."""
    assert set(got) == set(want), set(got) ^ set(want)
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-12)
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol,
                                   atol=scale_tol * scale, err_msg=name)
