#!/usr/bin/env python3
"""Where do a causal LM's bf16 serving logits leave f32? Block by block.

For GPT-2 base and LLaMA base (seed 0, frozen MOPED 0.05; GPT-2's zero
leaves set to 0.01 first, as ``chip_smoke.py`` does), one antithetic S = 10
forward of the 8x128 request of ``chip_smoke.py``'s serving phase at one
seed, three ways on the card: through the kernels in bf16, through the
plain versions in bf16 (``impl="plain"``), and through the plain versions
in f32 from the same weights and draws. Each decoder block's output and
the logits are captured; for each the script prints, against the f32
plain run, the kernel path's and the bf16 plain path's max |d| and
relative L2, and the two bf16 paths against each other. If the kernel path
is no farther from f32 than the bf16 plain path is, the bf16 rounding of
the model itself (norms, residuals, activations) accounts for the
distance; if it is farther, the block where it first pulls away names
the instance to look at.

    python3 probe_bf16_blocks.py [gpt2|llama ...]

Needs one CUDA card; exits 2 without one.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

import chip_smoke as cs


def blocks_of(model):
    """The decoder blocks of a port causal LM, in order."""
    if hasattr(model, "transformer"):
        return list(model.transformer.h)
    return list(model.model.layers)


def run(bmodel, args, impl):
    """Each block's output and the logits of one forward, as f32."""
    outs = []
    hooks = [b.register_forward_hook(lambda m, i, o: outs.append(o.detach().float()))
             for b in blocks_of(bmodel.model)]
    try:
        with torch.inference_mode():
            logits, _ = bmodel.mc_apply_fused(12345, 10, *args, antithetic=True, impl=impl)
    finally:
        for h in hooks:
            h.remove()
    return outs + [logits.float()]


def dist(a, b):
    return (a - b).abs().max().item(), ((a - b).norm() / b.norm()).item()


def probe(bt, family) -> None:
    req = cs.gpt2_requests(cs.LM_VOCAB[family])[1]
    runs = {}
    for name, dtype, impl in (("f32 plain", cs.F32, "plain"), ("bf16 plain", cs.BF16, "plain"),
                              ("bf16 kernels", cs.BF16, "kernel")):
        bmodel, _ = cs.converted_base(bt, dtype, "on_mu", family)
        args = tuple(torch.from_numpy(req[k]).cuda() for k in ("input_ids", "attention_mask"))
        runs[name] = run(bmodel, args, impl)
        del bmodel
        torch.cuda.empty_cache()
    ref = runs["f32 plain"]
    # the live positions only: the padded rows' tails are masked keys
    live = torch.from_numpy(req["attention_mask"]).cuda().bool().repeat(10, 1)
    print(f"{cs.LM_NAME[family]} base, 8x128, S=10, antithetic, seed 12345: each block's "
          "output (the last: the logits) at the live positions; max|d| / rel L2")
    print("block | kernels vs f32 | bf16 plain vs f32 | kernels vs bf16 plain | "
          "kernels / plain distance (rel L2)")
    ratios = []
    for i, (r, p, k) in enumerate(zip(ref, runs["bf16 plain"], runs["bf16 kernels"])):
        r, p, k = (t.reshape(10 * 8, 128, -1)[live] for t in (r, p, k))
        kd, pd, kp = dist(k, r), dist(p, r), dist(k, p)
        ratios.append(kd[1] / pd[1])
        what = "logits" if i == len(ref) - 1 else str(i)
        print(f"{what} | {kd[0]:.4g} / {kd[1]:.4g} | {pd[0]:.4g} / {pd[1]:.4g} | "
              f"{kp[0]:.4g} / {kp[1]:.4g} | {ratios[-1]:.3f}")
    print(f"{cs.LM_NAME[family]}: the kernel path's distance from f32 over the bf16 plain "
          f"path's, by block: min {min(ratios):.3f}, max {max(ratios):.3f}, median "
          f"{float(np.median(ratios)):.3f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_bf16_blocks: no CUDA device", file=sys.stderr)
        return 2
    import bayeformers_tpu_torch as bt

    cs.require_f32_matmuls()
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60).stdout.strip(), flush=True)
    families = {"gpt2": cs.GPT2, "llama": cs.LLAMA}
    for name in sys.argv[1:] or list(families):
        probe(bt, families[name])
    return 0


if __name__ == "__main__":
    sys.exit(main())
