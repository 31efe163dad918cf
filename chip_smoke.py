#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bayeformers_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; it builds the kernels from ``bayeformers_tpu_torch/csrc`` itself.
Phases, each timed, each raising on failure:

1. the card's name and power limit (``nvidia-smi``);
2. the kernel build (one ``nvcc`` call);
3. the eps stream: the device stream against the plain-torch stream (equal
   bits, normals within 1e-6), its moments, seed determinism;
4. ``bayes_linear_anti`` against its plain version at every shape of the
   BERT-base serving path (S=10, B=8, L=128), and on its scalar x path
   (K % 8 != 0, and x not 16-byte aligned);
5. ``mha_fwd`` against its plain version at the serving shape, with padded
   keys and one fully masked row;
6. serving: BERT-base from a seed, MOPED conversion, a ``Predictor`` that
   answers three ragged requests through the kernels (launch counts read
   around exactly those requests), determinism per seed, and the logits
   against the plain path on the card;
7. timings of each kernel, its plain version and one PyTorch library call
   at each shape, and the request latency.

The line before the last is a JSON object with one entry per kernel and
shape; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
card it prints no result and exits with code 2.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12   # dense tensor-core rate, NVIDIA data sheet (SXM)
H100_BYTES_PER_S = 3.35e12  # HBM3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_eps(lib, common, _build) -> None:
    dev = torch.device("cuda")
    seeds = torch.tensor([1, 7, 123456789], dtype=torch.int32, device=dev)
    for K, N, k0, n0 in ((512, 256, 0, 0), (300, 130, 256, 128), (768, 768, 512, 1024)):
        eps = torch.empty((3, K, N), dtype=torch.float32, device=dev)
        bits = torch.empty((3, K, N, 2), dtype=torch.int32, device=dev)
        _build.check(lib.bft_unit_eps(seeds.data_ptr(), 3, K, N, k0, n0,
                                      eps.data_ptr(), bits.data_ptr(),
                                      common.cuda_stream(eps)), "bft_unit_eps")
        torch.cuda.synchronize()
        b1, b2, _ = common.philox_bits(
            seeds, torch.arange(K, device=dev) + k0, torch.arange(N, device=dev) + n0)
        words = bits.to(torch.int64) & 0xFFFFFFFF
        check(bool((words[..., 0] == b1).all() and (words[..., 1] == b2).all()),
              f"device eps bits differ from the plain stream at {(K, N, k0, n0)}")
        err = (eps - common.unit_eps(seeds, (K, N), (k0, n0))).abs().max().item()
        check(err <= 1e-6, f"device eps differs by {err} at {(K, N, k0, n0)}")
        say(f"eps K={K} N={N} offsets=({k0},{n0}): bits equal, max |d eps| = {err}")
    draw = common.unit_eps(torch.tensor([42], dtype=torch.int32, device=dev), (768, 768))
    again = common.unit_eps(torch.tensor([42], dtype=torch.int32, device=dev), (768, 768))
    other = common.unit_eps(torch.tensor([43], dtype=torch.int32, device=dev), (768, 768))
    mean, var = draw.mean().item(), draw.var().item()
    say(f"eps 768x768 draw: mean {mean:.6f} var {var:.6f}")
    check(abs(mean) < 0.01 and abs(var - 1.0) < 0.01, "eps moments off")
    check(torch.equal(draw, again), "same seed gave another draw")
    check(not torch.equal(draw, other), "another seed gave the same draw")


def bayes_linear_inputs(S, M, K, N, moped_rho, offset=0):
    """Seeded bf16 x (S, M, K), f32 mu/rho (K, N) and S/2 pair seeds on the
    card; ``offset`` > 0 starts x that many bf16 elements into its buffer,
    so that it is contiguous but not 16-byte aligned."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(M * 7 + K * 3 + N)
    buf = torch.empty(S * M * K + offset, dtype=torch.bfloat16, device=dev)
    x = buf[offset:].view(S, M, K)
    x.copy_(torch.randn(S, M, K, device=dev, generator=gen))
    mu = torch.randn(K, N, device=dev, generator=gen) * 0.02
    rho = moped_rho(mu, 0.05)
    sh = torch.randint(0, 2**31 - 1, (S // 2,), device=dev, generator=gen,
                       dtype=torch.int32)
    return x, mu, rho, sh


def compare_bayes_linear(fl, x, mu, rho, sh):
    """Kernel A against its plain version on one input; raises on a
    mismatch. Returns (max |d y|, the kernel's W pair, a summary)."""
    shape = tuple(x.shape[1:]) + (mu.shape[1],)
    y, lq, lp, w = fl.bayes_linear(x, mu, rho, sh, save_weights=True)
    torch.cuda.synchronize()
    yp, lqp, lpp, wp = fl.bayes_linear_plain(x, mu, rho, sh, save_weights=True)
    err = (y.float() - yp.float()).abs().max().item()
    check(torch.allclose(y.float(), yp.float(), rtol=2e-2, atol=2e-2),
          f"bayes_linear y differs at {shape}: max {err}")
    for name, a, b in (("log_q", lq, lqp), ("log_p", lp, lpp)):
        check(torch.allclose(a, b, rtol=1e-5, atol=0.0),
              f"bayes_linear {name} differs at {shape}: {a} vs {b}")
    # W pair = mu +- softplus(rho) eps_plain in bf16: at most one bf16
    # rounding step apart where the f32 values round differently
    w_err = (w.float() - wp.float()).abs().max().item()
    check(torch.allclose(w.float(), wp.float(), rtol=2 ** -7, atol=0.0),
          f"bayes_linear W differs at {shape}: max {w_err}")
    return err, w, (
        f"y max|d| {err:.3g}, W max|d| {w_err:.3g} "
        f"({(w == wp).float().mean().item():.6f} equal), "
        f"log_q {lq[0].item():.6g} vs {lqp[0].item():.6g}")


def phase_bayes_linear(fl, moped_rho) -> list[dict]:
    """Kernel A against its plain version; returns the timing rows."""
    S, B, L = 10, 8, 128
    rows = []
    for M, K, N in ((B * L, 768, 768), (B * L, 768, 3072), (B * L, 3072, 768),
                    (B, 768, 768), (B, 768, 2)):
        x, mu, rho, sh = bayes_linear_inputs(S, M, K, N, moped_rho)
        err, w, summary = compare_bayes_linear(fl, x, mu, rho, sh)
        ms = time_ms(lambda: fl.bayes_linear(x, mu, rho, sh), 20)
        plain_ms = time_ms(lambda: fl.bayes_linear_plain(x, mu, rho, sh), 3, 1)
        lib_ms = time_ms(lambda: torch.bmm(x, w), 20)
        n_bytes = S * M * K * 2 + 2 * K * N * 4 + S * M * N * 2 + 2 * S * 4 + S * 2
        b_ms, b_by = bound(n_bytes, 2.0 * S * M * K * N)
        say(f"bayes_linear_anti M={M} K={K} N={N}: {summary}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(
            name=f"bayes_linear_anti[M={M},K={K},N={N}]", shape=(M, K, N),
            route="cuda", source="bayeformers_tpu_torch/csrc/bayes_linear.cu",
            replaces=("bayeformers_tpu/ops/fused_linear.py:912" if K >= 2048
                      else "bayeformers_tpu/ops/fused_linear.py:636"),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms,
        ))
    # the kernel's scalar x path, taken when K % 8 != 0 or x is not 16-byte
    # aligned: off the serving path, so checked here but neither timed nor
    # counted
    for M, K, N, offset in ((100, 300, 130, 0), (64, 768, 130, 1)):
        x, mu, rho, sh = bayes_linear_inputs(S, M, K, N, moped_rho, offset)
        check(K % 8 != 0 or x.data_ptr() % 16 != 0,
              f"{(M, K, N, offset)} does not take the scalar x path")
        _, _, summary = compare_bayes_linear(fl, x, mu, rho, sh)
        say(f"bayes_linear_anti scalar x path M={M} K={K} N={N} "
            f"x offset {offset}: {summary}")
    return rows


def phase_mha(at) -> dict:
    dev = torch.device("cuda")
    N, L, H, nh = 80, 128, 768, 12
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(N, L, H, device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    mask = torch.ones(N, L, device=dev)
    mask[: N // 2, L - 40:] = 0   # padded keys in half the rows
    mask[N - 1] = 0               # one fully masked row
    bias = at.mask_to_bias(mask)
    out = at.mha(q, k, v, bias, nh)
    torch.cuda.synchronize()
    ref = at.mha_plain(q, k, v, bias, nh)
    err = (out.float() - ref.float()).abs().max().item()
    check(bool(torch.isfinite(out.float()).all()), "mha output not finite")
    check(err <= 2e-2, f"mha differs from its plain version: max {err}")
    ms = time_ms(lambda: at.mha(q, k, v, bias, nh), 50)
    plain_ms = time_ms(lambda: at.mha_plain(q, k, v, bias, nh), 5, 1)
    sdpa_mask = bias.clamp_min(torch.finfo(torch.bfloat16).min).to(torch.bfloat16)
    sdpa_mask = sdpa_mask[:, None, None, :]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q.view(N, L, nh, H // nh).transpose(1, 2),
            k.view(N, L, nh, H // nh).transpose(1, 2),
            v.view(N, L, nh, H // nh).transpose(1, 2), attn_mask=sdpa_mask)

    lib_ms = time_ms(sdpa, 50)
    b_ms, b_by = bound(4 * N * L * H * 2 + N * L * 4, 4.0 * N * L * L * H)
    say(f"mha_fwd N={N} L={L} H={H}: max|d| {err:.3g}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name=f"mha_fwd[N={N},L={L},H={H}]", shape=(N, L, H), route="cuda",
                source="bayeformers_tpu_torch/csrc/mha.cu",
                replaces="bayeformers_tpu/ops/attention.py:119",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def build_predictor(bt):
    """BERT-base from seed 0, MOPED-converted (delta 0.05, frozen), served at
    S=10 antithetic in one (8, 128) bucket on the card."""
    model = bt.build_bert(size="base", n_labels=2, seed=0, dtype=torch.bfloat16,
                          device="cuda")
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True)
    return bt.Predictor(bmodel, n_samples=10, batch_sizes=(8,), seq_lens=(128,),
                        antithetic=True)


def serving_requests(bt) -> list[dict]:
    """Three ragged requests (3x77, 8x128, 5x20 token ids) from a seed; the
    second fills the (8, 128) bucket."""
    rng = np.random.default_rng(0)
    vocab = bt.BERT_BASE_KWARGS["vocab_size"]
    return [{"input_ids": rng.integers(1, vocab, (n, L)),
             "attention_mask": np.ones((n, L), np.int64),
             "token_type_ids": np.zeros((n, L), np.int64)}
            for n, L in ((3, 77), (8, 128), (5, 20))]


def phase_serving(bt, fl, at) -> tuple[dict, float]:
    """Returns per-kernel launch counts by shape over the three requests,
    and the median latency (ms) of the 8x128 request."""
    t0 = time.perf_counter()
    pred = build_predictor(bt)
    bmodel = pred.bmodel
    torch.cuda.synchronize()
    say(f"serving: BERT-base built and converted in {time.perf_counter() - t0:.2f} s "
        f"({len(bmodel.spec.paths)} converted leaves)")
    requests = serving_requests(bt)
    pred(requests[0], seed=100)  # the first request pays one-time set-up
    torch.cuda.synchronize()

    fl.LAUNCHES.reset()
    at.LAUNCHES.reset()
    outs = [pred(r, seed=100 + i) for i, r in enumerate(requests)]
    torch.cuda.synchronize()
    launches = {"bayes_linear_anti": dict(fl.LAUNCHES.by_shape),
                "mha_fwd": dict(at.LAUNCHES.by_shape)}
    check(fl.LAUNCHES.count > 0 and at.LAUNCHES.count > 0,
          f"the requests launched no kernel: {launches}")
    say(f"serving: launches over 3 requests: bayes_linear_anti "
        f"{fl.LAUNCHES.count} {launches['bayes_linear_anti']}, mha_fwd "
        f"{at.LAUNCHES.count} {launches['mha_fwd']}")

    for r, o in zip(requests, outs):
        n = r["input_ids"].shape[0]
        check(o["probs"].shape == (n, 2), f"probs shape {o['probs'].shape}")
        check(all(np.isfinite(v).all() for v in o.values()), "non-finite output")
        check(np.allclose(o["probs"].sum(-1), 1.0, atol=1e-5), "probs do not sum to 1")
        check(bool((o["mutual_info"] >= -1e-6).all()
                   and (o["mutual_info"] <= o["entropy"] + 1e-6).all()),
              "BALD mutual information outside [0, entropy]")
    again = pred(requests[1], seed=101)
    other = pred(requests[1], seed=999)
    check(all(np.array_equal(again[k], outs[1][k]) for k in again),
          "the same seed gave other outputs")
    check(not np.array_equal(other["probs"], outs[1]["probs"]),
          "another seed gave the same outputs")
    say(f"serving: probs of request 2: {outs[1]['probs'][:, 0].round(4).tolist()}")

    # logits through the kernels against the plain path, on the card
    dev = bmodel.device
    batch = {k: torch.from_numpy(v).to(dev) for k, v in requests[1].items()}
    args = (batch["input_ids"], batch["attention_mask"], batch["token_type_ids"])
    lk, auxk = bmodel.mc_apply_fused(12345, 10, *args)
    lp, auxp = bmodel.mc_apply_fused(12345, 10, *args, impl="plain")
    err = (lk.float() - lp.float()).abs().max().item()
    check(err <= 5e-2, f"logits through the kernels differ from the plain path by {err}")
    for key in auxk:
        check(torch.allclose(auxk[key], auxp[key], rtol=1e-5, atol=0.0),
              f"{key} differs from the plain path: {auxk[key]} vs {auxp[key]}")
    say(f"serving: logits kernels vs plain max|d| {err:.4g} (S=10, B=8, L=128); "
        f"log_q {auxk['log_variational_posterior'][0].item():.7g} vs "
        f"{auxp['log_variational_posterior'][0].item():.7g}")

    lat = []
    for i in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred(requests[1], seed=200 + i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    latency = float(np.median(lat))
    say(f"serving: 8x128 request latency (S=10) median {latency:.3f} ms over 10: "
        f"{[round(v, 3) for v in lat]}")
    return launches, latency


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    import bayeformers_tpu_torch as bt
    from bayeformers_tpu_torch.core.init import moped_rho
    from bayeformers_tpu_torch.ops import _build, common
    from bayeformers_tpu_torch.ops import attention as at
    from bayeformers_tpu_torch.ops import fused_linear as fl

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t = time.perf_counter()
    lib = _build.library()
    say(f"phase build: {time.perf_counter() - t:.2f} s (nvcc {_build.last_build_seconds:.2f} s)")

    t = time.perf_counter()
    phase_eps(lib, common, _build)
    say(f"phase eps: {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    rows = phase_bayes_linear(fl, moped_rho)
    say(f"phase bayes_linear: {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    rows.append(phase_mha(at))
    say(f"phase mha: {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    launches, latency = phase_serving(bt, fl, at)
    say(f"phase serving: {time.perf_counter() - t:.2f} s")

    kernels = []
    for r in rows:
        kind = r["name"].split("[")[0]
        n = launches[kind].get(tuple(r.pop("shape")), 0)
        check(n > 0, f"{r['name']} was not launched by the requests")
        kernels.append({"name": r["name"], "route": r["route"], "source": r["source"],
                        "replaces": r["replaces"], "launches": n,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    say(f"{smi}; request latency 8x128 S=10: {latency:.3f} ms; "
        f"total {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
