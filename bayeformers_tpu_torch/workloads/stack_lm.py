"""The hand-built stacked tiers' training CLI on one GPU (counterpart of
``bayeformers_tpu/workloads/stack_lm.py``, with its flags and defaults).

- ``--arch dense`` (the default) trains a ``parallel/pipeline.py::BlockStack``
  through ``make_pp_train_step`` (``--microbatches`` microbatches) on
  linearly separable two-class data in ``--features`` dims, the first two
  output features read as the class logits.
- ``--arch transformer`` trains the causal LM of
  ``parallel/transformer.py`` through ``make_single_lm_train_step`` on the
  repeated-half copy corpus (``copy_acc`` -> 1.0 on the predictable half).

The mode rule is the reference's (``--pp 1 --ep 1`` with ``--arch dense``
is the pipeline mode), and ``--pp N`` / ``--ep N`` with N > 1, the ranks'
schedules, raise ``NotImplementedError`` (ROADMAP queue 1 item 6(c)); both
above 1 raise ``ValueError``. Every projection runs kernels #7/#8 forward
and #9 backward on the card (f32, scale-mixture prior, S = 1 a call).
The optimizer is ``torch.optim.Adam(lr, eps=1e-8)``, optax's ``adam(lr)``.
One JSON line an eval interval goes to ``--logs/stack_lm.jsonl`` and the
last metrics to stdout.

    python -m bayeformers_tpu_torch.workloads.stack_lm --steps 3
    python -m bayeformers_tpu_torch.workloads.stack_lm --arch transformer --steps 3
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from bayeformers_tpu_torch import elbo
from bayeformers_tpu_torch.nn.fused import derive_seed
from bayeformers_tpu_torch.parallel import moe as moe_lib
from bayeformers_tpu_torch.parallel import pipeline as pp_lib
from bayeformers_tpu_torch.parallel import transformer as tfm_lib
from bayeformers_tpu_torch.models.bert import check_device
from bayeformers_tpu_torch.parallel.sampling import ITEM_6C


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


def build_pp(args, device):
    stack = pp_lib.BlockStack(args.blocks, args.features, residual=True,
                              generator=args.seed, device=device)
    step = pp_lib.make_pp_train_step(
        stack, adam(stack, args.lr), n_samples=args.samples, n_batches=args.n_batches,
        n_microbatches=args.microbatches, loss_fn=classification_loss)
    return stack, step


def build_ep(args, device):
    """A ``BayesMoE`` (``--experts``, ``--features``, ``--ffn``) and its
    step at one rank (``run`` reaches it only with ``--ep`` above 1)."""
    moe = moe_lib.BayesMoE(args.experts, args.features, args.ffn, generator=args.seed,
                           device=device)
    step = moe_lib.make_ep_train_step(moe, adam(moe, args.lr), n_samples=args.samples,
                                      n_batches=args.n_batches, loss_fn=classification_loss)
    return moe, step


def build_transformer(args, device, mode: str = "single"):
    """The LM and its step: ``mode`` ``"single"``, ``"pp"`` (the pipeline
    schedule over ``--microbatches``) or ``"ep"`` (the MoE FFN of
    ``--experts``, ``--ffn``), each at one rank."""
    moe = dict(n_experts=args.experts, ffn=args.ffn) if mode == "ep" else None
    stack = tfm_lib.TransformerStack(args.blocks, args.features, args.heads, args.ffn,
                                     moe=moe, generator=derive_seed(args.seed, 0),
                                     device=device)
    lm = tfm_lib.lm_init(stack, args.vocab, args.seq_len, derive_seed(args.seed, 1))
    kw = dict(n_samples=args.samples, n_batches=args.n_batches)
    if mode == "pp":
        step = tfm_lib.make_pp_lm_train_step(lm, adam(lm, args.lr),
                                             n_microbatches=args.microbatches, **kw)
    elif mode == "ep":
        step = tfm_lib.make_ep_lm_train_step(lm, adam(lm, args.lr), **kw)
    else:
        step = tfm_lib.make_single_lm_train_step(lm, adam(lm, args.lr), **kw)
    return lm, step


def run(args) -> dict:
    """Train as the flags say; returns the last logged metrics."""
    if not hasattr(args, "arch"):
        args.arch = "dense"
    if (args.pp > 1) == (args.ep > 1) and args.pp > 1:
        raise ValueError("--pp and --ep are separate modes; pick one axis")
    if args.arch == "transformer":
        mode = "pp" if args.pp > 1 else ("ep" if args.ep > 1 else "single")
    else:
        mode = "pp" if args.pp > 1 or args.ep == 1 else "ep"
    n_dev = {"pp": args.pp, "ep": args.ep, "single": 1}[mode]
    if n_dev > 1:
        raise NotImplementedError(
            f"--{mode} {n_dev}: the stages' and experts' schedules over ranks are "
            f"{ITEM_6C}, not ported yet; --pp 1 --ep 1 runs on one GPU")
    device = check_device(getattr(args, "device", "cuda"), "stack_lm")
    args.n_batches = max(1, args.n_examples // args.batch_size)
    if args.arch == "transformer":
        toks, tgts, mask = synthetic_copy_corpus(args.seed, args.n_examples, args.seq_len,
                                                 args.vocab)
        data = {"tokens": toks, "targets": tgts, "eval_mask": mask}
        _, step = build_transformer(args, device, mode)
    else:
        X, y = synthetic_task(args.seed, args.n_examples, args.features)
        data = {"x": X, "y": y}
        _, step = build_pp(args, device)
    data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}

    os.makedirs(args.logs, exist_ok=True)
    log_path = os.path.join(args.logs, "stack_lm.jsonl")
    t0 = time.time()
    last = {}
    with open(log_path, "a") as fh:
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
                fh.write(json.dumps(last) + "\n")
    return last


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Stacked Bayesian blocks / MoE / transformer LM "
                                            "on one GPU")
    p.add_argument("--arch", choices=("dense", "transformer"), default="dense",
                   help="dense stacks (BlockStack) or the depth-stacked Bayesian "
                        "transformer LM")
    p.add_argument("--pp", type=int, default=1, help="pipeline stages (1 on one GPU)")
    p.add_argument("--ep", type=int, default=1, help="expert-parallel ranks (1 on one GPU)")
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
    return p


def main():
    print(json.dumps(run(parser().parse_args())))


if __name__ == "__main__":
    main()
