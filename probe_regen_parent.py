#!/usr/bin/env python3
"""The weight regeneration (#10, #13: ``csrc/regen.cu``, ``bft_regen``) of
this tree against a parent tree's, on one card: outputs and times.

Per turn, on the same seeded inputs in both trees:

- the W production of one antithetic regenerating layer (the f32 recipe's
  FFN down-projection, 3072 -> 768, five pairs): what
  ``BayesLinearRegen.backward`` hands to dx and the reduce. In a tree with
  the pair instance one ``regenerate_weights(..., antithetic=True)`` (f32
  x) or ``regenerate_weights_cuda(..., antithetic=True,
  lo_dtype=bfloat16)`` (bf16 x: the pairs and their bf16 copy); in the
  parent #10's independent draws, then ``interleave_antithetic`` (and the
  cast to bf16) in torch;
- #10's independent instance, f32 W, S' = 5 at 3072 -> 768;
- #13's instances, flipout's S = 10 perturbation draws (mu = 0) at BERT's
  three shapes, with the bf16 copy and f32 W alone;
- the f32 antithetic BERT-base ELBO step (S = 10, B = 8, L = 128, frozen
  MOPED), whose 12 FFN down-projections take the regenerating backward: the
  median of 10 (host clock around synchronised work) and the card's busy
  time a step (``torch.profiler``, 3 steps).

Each call is timed as ``chip_smoke.py`` times it (CUDA events around
back-to-back calls, the median of 5 windows) and as the card's time in the
kernels it launched (``-device``). The trees run in turns, one process each:
parent, change, change, parent; #10 first in each turn. The change's first
run holds its outputs against the parent's first: every W bit-equal (by a
SHA-256 of its bytes). On one card, in one call::

    mkdir -p .scratch/parent
    git archive <parent> bayeformers_tpu_torch | tar -x -C .scratch/parent
    python3 probe_regen_parent.py .scratch/parent

(``run TREE OUT [REF]`` is one turn: the probe of TREE's package, saved to
OUT, held against REF when given; the model helpers come from this tree's
``chip_smoke.py``.) Needs one CUDA card; exits 2 without one. Exits 1 if a
check fails.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

from probe_linear_parent import device_ms, time_ms

K, N, PAIRS = 3072, 768, 5
SPLIT_SHAPES = ((768, 768), (768, 3072), (3072, 768))


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (its dtype and shape included)."""
    h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
    h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def regen_calls(fl, mu, rho, seeds):
    """The tree's W production of an antithetic regenerating layer: (f32 x,
    bf16 x) calls, each returning what the backward reads."""
    if "antithetic" in fl.regenerate_weights.__code__.co_varnames:
        def f32():
            return (fl.regenerate_weights(mu, rho, seeds, antithetic=True),)

        def bf16():
            return fl.regenerate_weights_cuda(mu, rho, seeds, antithetic=True,
                                              lo_dtype=torch.bfloat16)
        return f32, bf16

    def f32():
        return (fl.interleave_antithetic(fl.regenerate_weights(mu, rho, seeds), mu),)

    def bf16():
        w = fl.interleave_antithetic(fl.regenerate_weights(mu, rho, seeds), mu)
        return w, w.to(torch.bfloat16)
    return f32, bf16


def f32_step(bt, cs, times):
    """The f32 antithetic BERT-base ELBO step: median of 10 and the card's
    busy time a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bmodel, named = cs.converted_base(bt, torch.float32, "on_mu")
    batch = cs.train_batch(bt)
    tx = bt.training.adamw_with_decay_groups(2e-5, 0.0, bt.training.default_no_decay)
    step_fn = bt.make_elbo_train_step(bmodel, tx.init(named), 10, 256, estimator="antithetic")
    for i in range(3):
        step_fn(i, batch)
    lat = []
    for i in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_fn(100 + i, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    times["step-f32-anti"] = float(np.median(lat))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            step_fn(200 + i, batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    times["step-f32-anti-busy"] = sum(e.self_device_time_total for e in events) / 3 / 1e3
    times["step-f32-anti-draw"] = sum(e.self_device_time_total for e in events
                                      if "draw_kernel" in e.key) / 3 / 1e3
    print(f"f32 antithetic step: median {times['step-f32-anti']:.3f} ms, card busy "
          f"{times['step-f32-anti-busy']:.3f} ms (draw kernels "
          f"{times['step-f32-anti-draw']:.3f})", flush=True)


def run(tree: str) -> tuple[dict, dict]:
    """Output digests and times of ``tree``'s package."""
    sys.path.insert(0, os.path.abspath(tree))
    import bayeformers_tpu_torch as bt
    from bayeformers_tpu_torch.core.init import moped_rho
    from bayeformers_tpu_torch.ops import fused_linear as fl
    from bayeformers_tpu_torch.ops import sampled_linear as sl

    assert os.path.abspath(fl.__file__).startswith(os.path.abspath(tree)), fl.__file__
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    out, times = {}, {}
    # #10 first, on a card that has run nothing else in this process
    _, mu, rho, sd, _ = cs.bayes_linear_inputs(10, 8, K, N, moped_rho, PAIRS,
                                               dtype=torch.float32)
    f32, bf16 = regen_calls(fl, mu, rho, sd)
    indep = lambda: (fl.regenerate_weights(mu, rho, sd),)  # noqa: E731
    for key, fn in (("regen-pair/f32", f32), ("regen-pair/bf16", bf16),
                    ("regen-indep/f32", indep)):
        out[key] = [digest(t) for t in fn()]
        times[key] = time_ms(fn, 50)
        times[key.replace("/", "-device/", 1)] = device_ms(fn)
        print(f"{tree} {key} S'={PAIRS} {K}x{N}: {times[key]:.4f} ms "
              f"({times[key.replace('/', '-device/', 1)]:.4f} on the card)", flush=True)
    del mu, rho, sd
    for K_, N_ in SPLIT_SHAPES:
        _, mu, rho, sd = cs.sampled_dense_inputs(10, 8, K_, N_, moped_rho, torch.float32, True)
        for tag, lo in (("bf16", torch.bfloat16), ("f32", None)):
            key = f"split-regen/{tag}/{K_}x{N_}"
            fn = lambda: sl.regen_cuda(mu, rho, sd, sl.REGEN_LAUNCHES, lo)  # noqa: E731
            got = fn()
            out[key] = [digest(t) for t in (got if lo else (got,))]
            times[key] = time_ms(fn, 20)
            times[key.replace("/", "-device/", 1)] = device_ms(fn)
            print(f"{tree} {key} S=10: {times[key]:.4f} ms "
                  f"({times[key.replace('/', '-device/', 1)]:.4f} on the card)", flush=True)
    torch.cuda.empty_cache()
    f32_step(bt, cs, times)
    return out, times


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_regen_parent: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1] == "run":
        tree, path = sys.argv[2], sys.argv[3]
        got, times = run(tree)
        torch.save({"out": got, "times": times}, path)
        if len(sys.argv) > 4:
            want = torch.load(sys.argv[4])["out"]
            bad = [k for k in want if got[k] != want[k]]
            for k in want:
                print(f"{k}: bit-equal to the parent's {got[k] == want[k]}")
            print(f"outputs bit-equal to the parent's: "
                  f"{'all' if not bad else f'{len(bad)} differ: {bad}'}")
            return 1 if bad else 0
        return 0
    parent = sys.argv[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    scratch = os.path.join(".scratch", "probe_regen")
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
    for k in t[0]:
        p, c = (t[0][k] + t[3][k]) / 2, (t[1][k] + t[2][k]) / 2
        print(f"{k}: {t[0][k]:.4f} / {t[1][k]:.4f} / {t[2][k]:.4f} / {t[3][k]:.4f}; "
              f"{p / c:.2f}x", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
