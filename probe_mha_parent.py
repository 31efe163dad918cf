#!/usr/bin/env python3
"""Bit-equality probe of the head-width-64, L <= 512 attention kernels
across a change.

Runs ``mha_cuda`` and ``mha_bwd_cuda`` of the ``bayeformers_tpu_torch``
package found under ``TREE`` (its ``csrc/`` built by that tree's own
``_build``), bf16 and f32, causal and not, on fixed seeded inputs with
padded keys and a fully masked row, at the serving/training shape, at L =
512 and at a ragged L; then either saves the outputs or compares them with
saved ones by ``torch.equal``. To hold a change's instances against its
parent's on one card, in one call::

    git archive <parent> bayeformers_tpu_torch | tar -x -C .scratch/parent
    python3 probe_mha_parent.py save .scratch/parent .scratch/mha_parent.pt
    python3 probe_mha_parent.py compare . .scratch/mha_parent.pt

Needs one CUDA card; exits 2 without one.
"""
from __future__ import annotations

import os
import sys

import torch

SHAPES = ((80, 128, 768), (8, 512, 768), (6, 77, 768))


def outputs(tree: str) -> dict[str, torch.Tensor]:
    sys.path.insert(0, os.path.abspath(tree))
    from bayeformers_tpu_torch.ops import attention as at

    assert os.path.abspath(at.__file__).startswith(os.path.abspath(tree)), at.__file__
    out = {}
    dev = torch.device("cuda")
    for N, L, H in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(N * 1000 + L)
            q, k, v, g = (torch.randn(N, L, H, device=dev, generator=gen).to(dtype)
                          for _ in range(4))
            mask = torch.ones(N, L, device=dev)
            mask[: N // 2, L - L // 3:] = 0
            mask[N - 1] = 0
            bias = at.mask_to_bias(mask)
            for causal in (False, True):
                tag = f"{N}x{L}x{H}/{str(dtype)[6:]}" + ("/causal" if causal else "")
                out[f"fwd/{tag}"] = at.mha_cuda(q, k, v, bias, 12, causal)
                for name, t in zip(("dq", "dk", "dv"),
                                   at.mha_bwd_cuda(q, k, v, bias, g, 12, causal)):
                    out[f"{name}/{tag}"] = t
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mha_parent: no CUDA device", file=sys.stderr)
        return 2
    mode, tree, path = sys.argv[1:4]
    got = outputs(tree)
    if mode == "save":
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(got, path)
        print(f"saved {len(got)} outputs of {tree}")
        return 0
    want = torch.load(path)
    same = [k for k in want if torch.equal(got[k], want[k])]
    for k in want:
        if k not in same:
            print(f"DIFFERS {k}: max {(got[k].float() - want[k].float()).abs().max().item()}")
    print(f"attention outputs (d = 64, L <= 512) bit-equal to the saved tree's: "
          f"{len(same)} of {len(want)}")
    return 0 if len(same) == len(want) == len(got) else 1


if __name__ == "__main__":
    sys.exit(main())
