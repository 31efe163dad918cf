"""The hand-built stacked tiers' training CLI (counterpart of
``bayeformers_tpu/workloads/stack_lm.py``, with its flags and defaults).

- ``--arch dense`` (the default) trains a ``parallel/pipeline.py::BlockStack``
  through ``make_pp_train_step`` (``--microbatches`` microbatches) on
  linearly separable two-class data in ``--features`` dims, the first two
  output features read as the class logits; with ``--ep N`` (N > 1) a
  ``parallel/moe.py::BayesMoE`` through ``make_ep_train_step`` instead.
- ``--arch transformer`` trains the causal LM of
  ``parallel/transformer.py`` through ``make_single_lm_train_step``,
  ``make_pp_lm_train_step`` (``--pp N``) or, with its MoE FFN,
  ``make_ep_lm_train_step`` (``--ep N``) on the repeated-half copy corpus
  (``copy_acc`` -> 1.0 on the predictable half).

The mode rule is the reference's (``--pp 1 --ep 1`` with ``--arch dense``
is the pipeline mode; both above 1 raise ``ValueError``). ``--pp N`` /
``--ep N`` with N > 1 run one process a rank under ``python -m
torch.distributed.run --nproc-per-node N``: the stages' blocks or the
experts sharded over the ranks (every rank draws the whole model from
``--seed`` and keeps its block), the activations shifted stage to stage
and the combines summed over ``--backend`` (gloo, or NCCL on several
cards; default nccl on the card, gloo on the CPU; gloo where ranks share
one card); a world size other than N raises. Every projection runs kernels
#7/#8 forward and #9 backward on the card (f32, scale-mixture prior, S = 1
a call). The optimizer is ``torch.optim.Adam(lr, eps=1e-8)``, optax's
``adam(lr)``, over the rank's leaves. Rank 0 writes one JSON line an eval
interval to ``--logs/stack_lm.jsonl`` (with ``n_dev``) and prints the last
metrics.

    python -m bayeformers_tpu_torch.workloads.stack_lm --steps 3
    python -m bayeformers_tpu_torch.workloads.stack_lm --arch transformer --steps 3
    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m bayeformers_tpu_torch.workloads.stack_lm --pp 2 --backend gloo --steps 3
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from bayeformers_tpu_torch import elbo
from bayeformers_tpu_torch.nn.fused import derive_seed
from bayeformers_tpu_torch.models.bert import check_device
from bayeformers_tpu_torch.parallel import moe as moe_lib
from bayeformers_tpu_torch.parallel import pipeline as pp_lib
from bayeformers_tpu_torch.parallel import train as ptrain
from bayeformers_tpu_torch.parallel import transformer as tfm_lib


def synthetic_task(seed: int, n: int, d: int):
    """Linearly separable two-class data with 3% label noise, the
    reference's numpy draws in its order: (X (n, d) f32, y (n,) int64)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d,))
    y = (X @ w > 0).astype(np.int64)
    flip = rng.random(n) < 0.03
    y[flip] = 1 - y[flip]
    return X, y


def classification_loss(out: torch.Tensor, batch: dict):
    """(nll_sum, {"acc"}) on the stack's (B, d) output, its first two
    features the class logits."""
    logits = out[:, :2]
    nll = elbo.cross_entropy_sum(logits, batch["y"])
    acc = torch.mean((torch.argmax(logits, -1) == batch["y"]).float())
    return nll, {"acc": acc}


def synthetic_copy_corpus(seed: int, n: int, T: int, V: int):
    """(tokens, targets, eval_mask), each (n, T - 1): sequences whose second
    half repeats the first, the mask on the predictable positions (from
    T // 2 - 1 on); the reference's numpy draws."""
    rng = np.random.default_rng(seed)
    half = T // 2
    seq = rng.integers(0, V, size=(n, half)).astype(np.int32)
    seq = np.concatenate([seq, seq], axis=1)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    mask = np.zeros_like(targets)
    mask[:, half - 1:] = 1
    return tokens, targets, mask


def adam(module: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """optax's ``adam(lr)``."""
    return torch.optim.Adam(module.parameters(), lr, betas=(0.9, 0.999), eps=1e-8)


def build_pp(args, device, ranks=None):
    """A ``BlockStack`` and its step; under ``ranks`` (``make_pp_mesh``) the
    stage's blocks of the whole stack drawn from ``--seed``."""
    stack = pp_lib.BlockStack(args.blocks, args.features, residual=True,
                              generator=args.seed, device=device)
    pp_lib.shard_stack(stack, ranks)
    step = pp_lib.make_pp_train_step(
        stack, adam(stack, args.lr), n_samples=args.samples, n_batches=args.n_batches,
        n_microbatches=args.microbatches, loss_fn=classification_loss, group=ranks)
    return stack, step


def build_ep(args, device, ranks=None):
    """A ``BayesMoE`` (``--experts``, ``--features``, ``--ffn``) and its
    step; under ``ranks`` (``make_ep_mesh``) the rank's experts."""
    moe = moe_lib.BayesMoE(args.experts, args.features, args.ffn, generator=args.seed,
                           device=device)
    moe_lib.shard_experts(moe, ranks)
    step = moe_lib.make_ep_train_step(moe, adam(moe, args.lr), n_samples=args.samples,
                                      n_batches=args.n_batches, loss_fn=classification_loss,
                                      group=ranks)
    return moe, step


def build_transformer(args, device, mode: str = "single", ranks=None):
    """The LM and its step: ``mode`` ``"single"``, ``"pp"`` (the pipeline
    schedule over ``--microbatches``) or ``"ep"`` (the MoE FFN of
    ``--experts``, ``--ffn``); under ``ranks`` the stage's blocks or the
    rank's experts of the whole LM drawn from ``--seed``."""
    moe = dict(n_experts=args.experts, ffn=args.ffn) if mode == "ep" else None
    stack = tfm_lib.TransformerStack(args.blocks, args.features, args.heads, args.ffn,
                                     moe=moe, generator=derive_seed(args.seed, 0),
                                     device=device)
    lm = tfm_lib.lm_init(stack, args.vocab, args.seq_len, derive_seed(args.seed, 1))
    kw = dict(n_samples=args.samples, n_batches=args.n_batches)
    if mode == "pp":
        pp_lib.shard_stack(lm, ranks)
        step = tfm_lib.make_pp_lm_train_step(lm, adam(lm, args.lr),
                                             n_microbatches=args.microbatches, group=ranks,
                                             **kw)
    elif mode == "ep":
        moe_lib.shard_experts(lm, ranks)
        step = tfm_lib.make_ep_lm_train_step(lm, adam(lm, args.lr), group=ranks, **kw)
    else:
        step = tfm_lib.make_single_lm_train_step(lm, adam(lm, args.lr), **kw)
    return lm, step


def run(args) -> dict:
    """Train as the flags say; returns the last logged metrics (on every
    rank: the loss and metrics are whole on each)."""
    if not hasattr(args, "arch"):
        args.arch = "dense"
    if (args.pp > 1) == (args.ep > 1) and args.pp > 1:
        raise ValueError("--pp and --ep are separate modes; pick one axis")
    if args.arch == "transformer":
        mode = "pp" if args.pp > 1 else ("ep" if args.ep > 1 else "single")
    else:
        mode = "pp" if args.pp > 1 or args.ep == 1 else "ep"
    n_dev = {"pp": args.pp, "ep": args.ep, "single": 1}[mode]
    device = check_device(getattr(args, "device", "cuda"), "stack_lm")
    make = pp_lib.make_pp_mesh if mode == "pp" else moe_lib.make_ep_mesh
    ranks, device = ptrain.init_axis(make, n_dev, f"--{mode} {n_dev}",
                                     getattr(args, "backend", None), device)
    args.n_batches = max(1, args.n_examples // args.batch_size)
    if args.arch == "transformer":
        toks, tgts, mask = synthetic_copy_corpus(args.seed, args.n_examples, args.seq_len,
                                                 args.vocab)
        data = {"tokens": toks, "targets": tgts, "eval_mask": mask}
        _, step = build_transformer(args, device, mode, ranks)
    else:
        X, y = synthetic_task(args.seed, args.n_examples, args.features)
        data = {"x": X, "y": y}
        _, step = (build_pp if mode == "pp" else build_ep)(args, device, ranks)
    data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}

    rank0 = ranks is None or ranks.rank == 0
    if rank0:
        os.makedirs(args.logs, exist_ok=True)
    log_path = os.path.join(args.logs, "stack_lm.jsonl")
    t0 = time.time()
    last = {}
    with (open(log_path, "a") if rank0 else contextlib.nullcontext()) as fh:
        for it in range(args.steps):
            # the reference's dynamic_slice: a start past n - B clamps to it
            lo = max(0, min((it * args.batch_size) % args.n_examples,
                            args.n_examples - args.batch_size))
            batch = {k: v[lo:lo + args.batch_size] for k, v in data.items()}
            metrics = step(derive_seed(args.seed + 1, it), batch)
            if it % args.eval_every == 0 or it == args.steps - 1:
                last = {k: float(v) for k, v in metrics.items()} | {
                    "step": it, "mode": mode, "arch": args.arch, "n_dev": n_dev,
                    "wall_s": round(time.time() - t0, 2)}
                if rank0:
                    fh.write(json.dumps(last) + "\n")
    return last


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Stacked Bayesian blocks / MoE / transformer LM "
                                            "over pp / ep ranks")
    p.add_argument("--arch", choices=("dense", "transformer"), default="dense",
                   help="dense stacks (BlockStack) or the depth-stacked Bayesian "
                        "transformer LM")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages, one rank each (torch.distributed.run)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel ranks (torch.distributed.run)")
    p.add_argument("--heads", type=int, default=4, help="attention heads (transformer arch)")
    p.add_argument("--seq-len", type=int, default=16,
                   help="copy-task sequence length (transformer arch)")
    p.add_argument("--vocab", type=int, default=64,
                   help="copy-task vocabulary (transformer arch)")
    p.add_argument("--blocks", type=int, default=8)
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--features", type=int, default=128)
    p.add_argument("--ffn", type=int, default=256)
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--samples", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--n-examples", type=int, default=1024)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--eval-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--logs", default="logs")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                   help="process-group backend of --pp/--ep: default nccl on the card, "
                        "gloo on the CPU; gloo where ranks share one card")
    return p


def main():
    last = run(parser().parse_args())
    ptrain.launcher_print(json.dumps(last))
    ptrain.finish()


if __name__ == "__main__":
    main()
