#!/usr/bin/env python3
"""The Bayesian linear forward (#1/#2, #7/#8) and its dmu/drho reduce (#6,
#9) of this tree against a parent tree's, on one card: outputs and times.

At BERT-base's three shapes (M = 1024; K -> N = 768 -> 768, 768 -> 3072,
3072 -> 768; S = 10), in bf16 and f32, antithetic and independent draws,
under the prior on mu: ``bayes_linear_with_w`` (y, log-probs, W) and the
reduce on that W (A, B, V), on the same seeded inputs in both trees. The
trees run in turns, one process each: parent, change, change, parent. The
change's first run holds its outputs against the parent's first: W bit-equal,
y within ``chip_smoke.py``'s gates (bf16 2e-2, f32 2e-5 of max |y|),
log-probs 1e-5 relative, A/B/V within 1e-4 (bf16) or 1e-5 (f32) of each
one's largest entry. Each run times every instance twice: the call as
``chip_smoke.py`` times it (CUDA events around 20 back-to-back calls, the
median of 5 windows: the host's time where the calls outrun the card), and
the card's time in the kernels the call launched (``torch.profiler``,
``-device`` in the table). The table gives each tree's two runs and the
parent's mean over the change's. On one card, in one call::

    mkdir -p .scratch/parent
    git archive <parent> bayeformers_tpu_torch | tar -x -C .scratch/parent
    python3 probe_linear_parent.py .scratch/parent

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

SHAPES = ((1024, 768, 768), (1024, 768, 3072), (1024, 3072, 768))
S = 10
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def device_ms(fn, iters: int = 10) -> float:
    """The card's time in kernels of one call of ``fn`` (``torch.profiler``:
    the sum of the device time of every kernel it launched), without the
    host's share that ``time_ms`` sees when the calls outrun the card."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / iters / 1e3


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


def inputs(M, K, N, dtype, n_draws):
    """Seeded x, mu, rho (MOPED: sigma = 0.05 |mu| clamped as
    ``core.init.moped_rho``), seeds, g and g_p on the card."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(M * 7 + K * 3 + N)
    x = torch.randn(S, M, K, device=dev, generator=gen).to(dtype)
    mu = torch.randn(K, N, device=dev, generator=gen) * 0.02
    sigma = (0.05 * mu.abs()).clamp_min(1e-5)
    rho = torch.log(torch.expm1(sigma))
    seeds = torch.randint(0, 2**31 - 1, (n_draws,), device=dev, generator=gen,
                          dtype=torch.int32)
    g = (torch.randn(S, M, N, device=dev, generator=gen) * 0.01).to(dtype)
    g_p = torch.randn(S, device=dev, generator=gen)
    return x, mu, rho, seeds, g, g_p


def run(tree: str) -> tuple[dict, dict]:
    """Outputs (on the CPU) and times of every instance of ``tree``'s
    package."""
    sys.path.insert(0, os.path.abspath(tree))
    from bayeformers_tpu_torch.ops import fused_backward as fb
    from bayeformers_tpu_torch.ops import fused_linear as fl

    assert os.path.abspath(fl.__file__).startswith(os.path.abspath(tree)), fl.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    out, times = {}, {}
    for tag, dtype in DTYPES.items():
        for anti in (True, False):
            est = "anti" if anti else "indep"
            for M, K, N in SHAPES:
                key = f"{tag}/{est}/{K}x{N}"
                x, mu, rho, seeds, g, g_p = inputs(M, K, N, dtype, S // 2 if anti else S)
                y, lq, lp, w = fl.bayes_linear_with_w(x, mu, rho, seeds, antithetic=anti)
                red = fb.reduce_abuv_anti if anti else fb.reduce_abuv
                a, b, v = red(x, g, w, mu, g_p)
                torch.cuda.synchronize()
                out[key] = {n: t.cpu() for n, t in
                            (("y", y), ("log_q", lq), ("log_p", lp), ("W", w), ("A", a),
                             ("B", b), ("V", v))}

                def fwd():
                    fl.bayes_linear(x, mu, rho, seeds, antithetic=anti, prior_on_mu=True)

                def bwd():
                    red(x, g, w, mu, g_p)

                for what, fn in (("forward", fwd), ("reduce", bwd)):
                    times[f"{what}/{key}"] = time_ms(fn)
                    times[f"{what}-device/{key}"] = device_ms(fn)
                print(f"{tree} {key}: forward {times['forward/' + key]:.4f} ms "
                      f"({times['forward-device/' + key]:.4f} on the card), reduce "
                      f"{times['reduce/' + key]:.4f} ms ({times['reduce-device/' + key]:.4f})",
                      flush=True)
    return out, times


def compare(got: dict, want: dict) -> list[str]:
    """The change's outputs against the parent's at chip_smoke.py's gates;
    returns the failures."""
    bad = []
    for key, o in want.items():
        c = got[key]
        f32 = key.startswith("f32")
        if not torch.equal(c["W"], o["W"]):
            bad.append(f"{key}: W differs ({(c['W'] != o['W']).float().mean().item():.3g} "
                       "of its elements)")
        yc, yo = c["y"].float(), o["y"].float()
        err = (yc - yo).abs().max().item()
        if f32 and err > 2e-5 * yo.abs().max().item():
            bad.append(f"{key}: y {err:.3g}, {err / yo.abs().max().item():.3g} of max |y|")
        if not f32 and not torch.allclose(yc, yo, rtol=2e-2, atol=2e-2):
            bad.append(f"{key}: y {err:.3g}")
        for n in ("log_q", "log_p"):
            if not torch.allclose(c[n], o[n], rtol=1e-5, atol=0.0):
                bad.append(f"{key}: {n} {c[n].tolist()} vs {o[n].tolist()}")
        limit = 1e-5 if f32 else 1e-4
        for n in "ABV":
            rel = ((c[n] - o[n]).abs().max() / o[n].abs().max()).item()
            if rel > limit:
                bad.append(f"{key}: {n} rel err {rel:.3g} (gate {limit})")
        print(f"{key}: W equal {torch.equal(c['W'], o['W'])}, y max|d| {err:.3g}, "
              f"A/B/V rel " + "/".join(
                  f"{((c[n] - o[n]).abs().max() / o[n].abs().max()).item():.3g}" for n in "ABV"),
              flush=True)
    return bad


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_linear_parent: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1] == "run":
        tree, path = sys.argv[2], sys.argv[3]
        got, times = run(tree)
        torch.save({"out": got, "times": times}, path)
        if len(sys.argv) > 4:
            bad = compare(got, torch.load(sys.argv[4])["out"])
            for b in bad:
                print("FAIL", b)
            print(f"outputs within chip_smoke.py's gates of the parent's, W bit-equal: "
                  f"{'all' if not bad else f'{len(bad)} failures'}")
            return 1 if bad else 0
        return 0
    parent = sys.argv[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    scratch = os.path.join(".scratch", "probe_linear")
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
