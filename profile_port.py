#!/usr/bin/env python3
"""Where the port's time goes on the GPU, from ``torch.profiler``: the
device time of each kernel in ``chip_smoke.py``'s 8x128 serving request or
its ELBO train step (BERT-base, S=10, antithetic, bf16).

    python3 profile_port.py [--path serving|train] [--n 3] [--time 0]
                            [--out trace.json]

It runs ``chip_smoke.py``'s predictor and request (``serving``) or its
converted model, batch and step (``train``), and prints the device's busy
share over the ``n`` profiled requests or steps and the device time by
kernel name; with ``--out``, it writes the Chrome trace there. ``--time N``
first times N requests or steps without the profiler (host clock around
each synchronised one) and prints their median and quartiles; it uses only
``chip_smoke.build_predictor`` and ``serving_requests`` for serving, so a
copy of this script next to an older ``chip_smoke.py`` times that tree.
Needs one CUDA card; exits with code 2 without one.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("serving", "train"), default="serving")
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--time", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    import bayeformers_tpu_torch as bt
    import chip_smoke

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    if args.path == "serving":
        pred = chip_smoke.build_predictor(bt)
        req = chip_smoke.serving_requests(bt)[1]  # fills the (8, 128) bucket

        def run(i):
            pred(req, seed=i)
    else:
        bmodel, named = chip_smoke.converted_base(bt, torch.bfloat16)
        batch = chip_smoke.train_batch(bt)
        tx = bt.training.adamw_with_decay_groups(2e-5, 0.0, bt.training.default_no_decay)
        step = bt.make_elbo_train_step(bmodel, tx.init(named), 10, 256)

        def run(i):
            step(i, batch)
    for i in range(3):  # build the kernels, warm the allocator
        run(i)
    torch.cuda.synchronize()
    if args.time:
        ms = []
        for i in range(args.time):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(1000 + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        print(f"unprofiled {args.path}: median {med:.3f} ms, quartiles {q1:.3f} / "
              f"{q3:.3f} ms over {args.time}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(args.n):
            run(100 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels, copies), so nothing counts twice
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    unit = "request" if args.path == "serving" else "step"
    print(f"profiled {args.n} {unit}s: wall {wall_ms:.3f} ms, device busy "
          f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e3 / wall_ms:.1f}% of wall)")
    rows = sorted(events, key=lambda e: -e.self_device_time_total)
    print(f"{'device ms/' + unit:>18} {'calls/' + unit:>14}  name")
    for e in rows[:30]:
        d = e.self_device_time_total
        print(f"{d / 1e3 / args.n:18.4f} {e.count / args.n:14.1f}  {e.key[:90]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        prof.export_chrome_trace(args.out)
        print(f"trace: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
