#!/usr/bin/env python3
"""The attention kernels (#3/#4 forward, #5 backward) of this tree against a
parent tree's, on one card: outputs and times, in turns.

Every instance: head width 32 and 64, L = 128, 512 and 1024, causal or not,
bf16 and f32, forward and backward, on the same seeded inputs in both trees
(right-padded keys in half the rows, one fully masked row, one row whose
first key is masked). Head width 64 runs at H = 768 (12 heads), 32 at H =
128 (4 heads, the tiny LLaMA's, #4's shape at L = 1024); N = 80, 8 and 10
at the three lengths (the serving and training bucket, the check shape, the
long-context request). The trees run in turns, one process each: parent,
change, change, parent. The change's first run holds its outputs against the
parent's first at ``chip_smoke.py``'s attention gates (bf16: forward 2e-2
absolute, backward 2e-2 absolute plus 2e-2 relative; f32: 1e-4 absolute
plus 1e-4 relative) and counts the instances whose outputs are bit-equal
to the parent's (a forward: out; a backward: dq, dk and dv), 48 in all: a
change that leaves these widths' arithmetic alone keeps all 48. Each run times every instance twice:
the call as ``chip_smoke.py`` times it (CUDA events around back-to-back
calls, the median of 5 windows: the host's time where the calls outrun the
card), and the card's time in the kernels the call launched
(``torch.profiler``, ``-device`` in the table). The table gives each tree's
two runs and the parent's mean over the change's. On one card, in one
call::

    mkdir -p .scratch/parent
    git archive <parent> bayeformers_tpu_torch | tar -x -C .scratch/parent
    python3 probe_mha_parent.py .scratch/parent

(``run TREE OUT [REF]`` is one turn: the probe of TREE's package, saved to
OUT, held against REF when given.) Needs one CUDA card; exits 2 without
one. Exits 1 if a check fails.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

# (head width, L): N, H, heads
SHAPES = {(64, 128): (80, 768, 12), (64, 512): (8, 768, 12), (64, 1024): (10, 768, 12),
          (32, 128): (80, 128, 4), (32, 512): (8, 128, 4), (32, 1024): (10, 128, 4)}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def device_ms(fn, iters: int = 10, windows: int = 3) -> float:
    """The card's time in kernels of one call of ``fn`` (``torch.profiler``:
    the sum of the device time of every kernel it launched), the median of
    ``windows`` profiled windows (a single window can read low when the
    profiler misses events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times.append(sum(e.device_time_total for e in prof.key_averages()) / iters / 1e3)
    return float(np.median(times))


def time_ms(fn, iters: int = 20, windows: int = 5) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def inputs(at, N, L, H, dtype):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(N * 1000 + L + H)
    q, k, v, g = (torch.randn(N, L, H, device=dev, generator=gen).to(dtype) for _ in range(4))
    mask = torch.ones(N, L, device=dev)
    mask[: N // 2, L - L // 3:] = 0
    mask[N - 1] = 0
    mask[N - 2, 0] = 0
    return q, k, v, g, at.mask_to_bias(mask)


def run(tree: str) -> tuple[dict, dict]:
    """Outputs (on the CPU) and times of every instance of ``tree``'s
    package."""
    sys.path.insert(0, os.path.abspath(tree))
    from bayeformers_tpu_torch.ops import attention as at

    assert os.path.abspath(at.__file__).startswith(os.path.abspath(tree)), at.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    out, times = {}, {}
    for (d, L), (N, H, nh) in SHAPES.items():
        for tag, dtype in DTYPES.items():
            q, k, v, g, bias = inputs(at, N, L, H, dtype)
            for causal in (False, True):
                key = f"{tag}/d={d}/L={L}" + ("/causal" if causal else "")
                o = at.mha_cuda(q, k, v, bias, nh, causal)
                grads = at.mha_bwd_cuda(q, k, v, bias, g, nh, causal)
                torch.cuda.synchronize()
                out[key] = {n: t.cpu() for n, t in zip(("out", "dq", "dk", "dv"), (o,) + grads)}
                iters = 20 if L == 128 else 10

                def fwd():
                    at.mha_cuda(q, k, v, bias, nh, causal)

                def bwd():
                    at.mha_bwd_cuda(q, k, v, bias, g, nh, causal)

                for what, fn in (("forward", fwd), ("backward", bwd)):
                    times[f"{what}/{key}"] = time_ms(fn, iters)
                    times[f"{what}-device/{key}"] = device_ms(fn)
                print(f"{tree} {key}: forward {times['forward/' + key]:.4f} ms "
                      f"({times['forward-device/' + key]:.4f} on the card), backward "
                      f"{times['backward/' + key]:.4f} ms "
                      f"({times['backward-device/' + key]:.4f})", flush=True)
            del q, k, v, g, bias
            torch.cuda.empty_cache()
    return out, times


def gate_ok(a: torch.Tensor, b: torch.Tensor, f32: bool, backward: bool) -> bool:
    """``chip_smoke.attn_gate_ok``: bf16 forward 2e-2 absolute, bf16
    backward 2e-2 absolute plus 2e-2 relative, f32 1e-4 absolute plus 1e-4
    relative."""
    tol = 1e-4 if f32 else 2e-2
    if not f32 and not backward:
        return (a.float() - b.float()).abs().max().item() <= tol
    return torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)


def compare(got: dict, want: dict) -> tuple[list[str], int, int]:
    """The change's outputs against the parent's at the attention gates;
    returns the failures, and how many of the instances (each key's
    forward and backward) are bit-equal, of how many."""
    bad, equal = [], 0
    for key, o in want.items():
        c = got[key]
        f32 = key.startswith("f32")
        errs = {n: (c[n].float() - o[n].float()).abs().max().item() for n in o}
        for n in o:
            if not gate_ok(c[n], o[n], f32, n != "out"):
                bad.append(f"{key}: {n} max|d| {errs[n]:.3g}")
        same = {n: torch.equal(c[n], o[n]) for n in o}
        equal += same["out"] + all(same[n] for n in ("dq", "dk", "dv"))
        print(f"{key}: max|d| " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
              + ("" if all(same.values()) else " (not bit-equal)"), flush=True)
    return bad, equal, 2 * len(want)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mha_parent: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1] == "run":
        tree, path = sys.argv[2], sys.argv[3]
        got, times = run(tree)
        torch.save({"out": got, "times": times}, path)
        if len(sys.argv) > 4:
            bad, equal, total = compare(got, torch.load(sys.argv[4])["out"])
            for b in bad:
                print("FAIL", b)
            print(f"outputs within chip_smoke.py's attention gates of the parent's: "
                  f"{'all' if not bad else f'{len(bad)} failures'}; bit-equal to the "
                  f"parent's: {equal} of {total} instances")
            return 1 if bad else 0
        return 0
    parent = sys.argv[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    scratch = os.path.join(".scratch", "probe_mha")
    os.makedirs(scratch, exist_ok=True)
    turns = [("parent", parent, None), ("change", ".", "parent"),
             ("change", ".", None), ("parent", parent, None)]
    files, rc = [], 0
    for i, (who, tree, ref) in enumerate(turns):
        path = os.path.join(scratch, f"{i}_{who}.pt")
        cmd = [sys.executable, __file__, "run", tree, path]
        if ref:
            cmd.append(files[0])
        rc |= subprocess.run(cmd).returncode
        files.append(path)
    t = [torch.load(f)["times"] for f in files]
    print(f"{smi}; ms, turns parent / change / change / parent; parent mean over change mean")
    worst = None
    for k in t[0]:
        p, c = (t[0][k] + t[3][k]) / 2, (t[1][k] + t[2][k]) / 2
        print(f"{k}: {t[0][k]:.4f} / {t[1][k]:.4f} / {t[2][k]:.4f} / {t[3][k]:.4f}; "
              f"{p / c:.2f}x", flush=True)
        worst = min(worst or p / c, p / c)
    print(f"slowest change against its parent: {worst:.2f}x the parent's speed")
    return rc


if __name__ == "__main__":
    sys.exit(main())
