#!/usr/bin/env python3
"""Where the port's time goes on the GPU, from ``torch.profiler``: the
device time of each kernel in ``chip_smoke.py``'s serving request or its
ELBO train step (S=10), antithetic or with independent draws
(``--estimator fused``), or under flipout or local reparameterization
(``--estimator flipout|local``), in bf16 or f32 activations (``--dtype``),
for BERT-base (the default) or a causal LM at base width (``--family gpt2``
or ``llama``) at a batch and length (``--shape BxL``, default 8x128),
converted for a prior (``--prior``: frozen MOPED ``on_mu``, the default;
``gaussian``, MOPED with a trainable mu; ``mixture``, random init under the
scale mixture, whose KL flipout and LRT score by the grouped #11 and its
VJP).

    python3 profile_port.py [--path serving|train] [--n 3] [--time 0]
                            [--estimator antithetic|fused|flipout|local]
                            [--prior on_mu|gaussian|mixture] [--dtype bf16|f32]
                            [--family bert|gpt2|llama] [--shape 8x128]
                            [--tree DIR] [--out trace.json]

It runs ``chip_smoke.py``'s predictor and request (``serving``) or its
converted model, batch and step (``train``), and prints the device's busy
share over the ``n`` profiled requests or steps, the device time of the
attention kernels (``mha`` in their names) and their share, and the device
time by kernel name; with ``--out``, it writes the Chrome trace there.
``--time N`` first times N requests or steps without the profiler (host
clock around each synchronised one) and prints their median and
quartiles. ``--tree DIR`` profiles the ``bayeformers_tpu_torch`` package
under DIR (a parent's, unpacked there) with this tree's ``chip_smoke.py``
helpers: run it in turns with the change, e.g. for the LLaMA base step at
(1, 1024):

    python3 profile_port.py --path train --family llama --shape 1x1024 --tree .scratch/parent
    python3 profile_port.py --path train --family llama --shape 1x1024

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
    ap.add_argument("--estimator", choices=("antithetic", "fused", "flipout", "local"),
                    default="antithetic")
    ap.add_argument("--prior", choices=("on_mu", "gaussian", "mixture"), default="on_mu")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--family", choices=("bert", "gpt2", "llama"), default="bert")
    ap.add_argument("--shape", default="8x128")
    ap.add_argument("--tree", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    import bayeformers_tpu_torch as bt
    import chip_smoke

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    print(f"package: {os.path.dirname(bt.__file__)}")
    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
    family = {"bert": chip_smoke.BERT, "gpt2": chip_smoke.GPT2,
              "llama": chip_smoke.LLAMA}[args.family]
    B, L = (int(x) for x in args.shape.split("x"))
    anti = args.estimator == "antithetic"
    analytic = args.estimator in ("flipout", "local")
    if args.path == "serving" and family == chip_smoke.BERT and analytic:
        bmodel, _ = chip_smoke.converted_base(bt, dtype, args.prior)
        req = chip_smoke.serving_requests(bt)[1]
        inputs = tuple(torch.from_numpy(req[k]).to(bmodel.device)
                       for k in ("input_ids", "attention_mask", "token_type_ids"))
        mc = bt.training.pick_mc(bmodel, True, args.estimator)

        def run(i):
            with torch.inference_mode():
                mc(i, 10, *inputs)
    elif args.path == "serving" and family == chip_smoke.BERT:
        pred = chip_smoke.build_predictor(bt, anti, dtype, args.prior)
        req = chip_smoke.serving_requests(bt)[1]  # fills the (8, 128) bucket

        def run(i):
            pred(req, seed=i)
    elif args.path == "serving":
        bmodel, _ = chip_smoke.converted_base(bt, dtype, args.prior, family)
        pred = bt.Predictor(bmodel, n_samples=10, batch_sizes=(B,), seq_lens=(L,),
                            antithetic=anti, task="causal-lm")
        vocab = bmodel.model.config.vocab_size
        req = {"input_ids": np.random.default_rng(L).integers(0, vocab, (B, L)),
               "attention_mask": np.ones((B, L), np.int64)}

        def run(i):
            pred(req, seed=i)
    else:
        bmodel, named = chip_smoke.converted_base(bt, dtype, args.prior, family)
        vocab = None if family == chip_smoke.BERT else bmodel.model.config.vocab_size
        batch = chip_smoke.train_batch(bt, B, L, family=family, vocab=vocab)
        tx = bt.training.adamw_with_decay_groups(2e-5, 0.0, bt.training.default_no_decay)
        step = bt.make_elbo_train_step(bmodel, tx.init(named), 10, 256,
                                       estimator=args.estimator,
                                       **chip_smoke.loss_keywords(family))

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
    print(f"profiled {args.n} {unit}s ({args.estimator}, {args.prior}, {args.dtype}): wall "
          f"{wall_ms:.3f} ms, device busy "
          f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e3 / wall_ms:.1f}% of wall)")
    attn_us = sum(e.self_device_time_total for e in events if "mha" in e.key)
    print(f"attention kernels: {attn_us / 1e3 / args.n:.3f} ms a {unit} "
          f"({100 * attn_us / max(dev_us, 1):.1f}% of the device busy time)")
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
