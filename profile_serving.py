#!/usr/bin/env python3
"""Where a serving request's time goes on the GPU: the device time of each
kernel in the 8x128 request of ``chip_smoke.py`` (BERT-base, S=10,
antithetic), from ``torch.profiler``.

    python3 profile_serving.py [--requests 3] [--out trace.json]

It serves with ``chip_smoke.py``'s predictor and requests, and prints the
device's busy share over the profiled requests and device time by kernel
name; with ``--out``, it writes the Chrome trace there. The request latency
without the profiler is ``chip_smoke.py``'s. Needs one CUDA card; exits with
code 2 without one.
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
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import bayeformers_tpu_torch as bt
    from chip_smoke import build_predictor, serving_requests

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    pred = build_predictor(bt)
    req = serving_requests(bt)[1]  # fills the (8, 128) bucket
    for i in range(3):  # build the kernels, warm the allocator
        pred(req, seed=i)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(args.requests):
            pred(req, seed=100 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels, copies), so nothing counts twice
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"profiled {args.requests} requests: wall {wall_ms:.3f} ms, device busy "
          f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e3 / wall_ms:.1f}% of wall)")
    rows = sorted(events, key=lambda e: -e.self_device_time_total)
    print(f"{'device ms/request':>18} {'calls/request':>14}  name")
    for e in rows[:25]:
        d = e.self_device_time_total
        print(f"{d / 1e3 / args.requests:18.4f} {e.count / args.requests:14.1f}  {e.key[:90]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        prof.export_chrome_trace(args.out)
        print(f"trace: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
