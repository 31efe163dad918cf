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
4. ``bayes_linear_anti`` and ``bayes_linear`` (independent draws) against
   their plain versions at every shape of the BERT-base serving path (S=10,
   B=8, L=128), and on their scalar x path (K % 8 != 0, and x not 16-byte
   aligned), with bit-identical reruns;
5. ``mha_fwd`` against its plain version at the serving shape, with padded
   keys and one fully masked row;
6. serving, antithetic and then independent draws (the ``Predictor``
   default): BERT-base from a seed, MOPED conversion, a ``Predictor`` that
   answers three ragged requests through the kernels (launch counts read
   around exactly those requests), determinism per seed, the logits
   against the plain path on the card, and the request latency;
7. timings of each kernel, its plain version and one PyTorch library call
   at each shape;
8. ``reduce_abuv_anti`` and ``reduce_abuv`` (the backward's dmu/drho
   reduce) against their plain versions at every shape of the training
   path and one odd shape, on the W the forward kernel wrote, with
   bit-identical reruns;
9. ``mha_bwd`` against its plain version at the training shape (padded
   keys, one fully masked row) and at L = 512, with bit-identical reruns;
10. the ELBO step, antithetic and then independent draws (``fused``):
    BERT-base from a seed, MOPED-converted, through
    ``make_elbo_train_step`` at S=10, B=8, L=128, bf16: finite loss and
    log-probs, the ELBO falling over steps on one batch and draw, the
    gradients through the kernels against the ``impl="plain"`` step on the
    card, bit-identical reruns, launch counts read around exactly the timed
    steps, and the median step time;
11. the workload: ``workloads/bert_glue.train`` phases A-D at BERT-base on
    the synthetic data, three batches an epoch, at S=10 (antithetic) and at
    S=3 (the default pick for an odd S: independent draws).

The line before the last is a JSON object with one entry per kernel and
shape; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
card it prints no result and exits with code 2.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
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


def bayes_linear_inputs(S, M, K, N, moped_rho, n_draws, offset=0):
    """Seeded bf16 x (S, M, K), f32 mu/rho (K, N) and ``n_draws`` seeds on
    the card; ``offset`` > 0 starts x that many bf16 elements into its
    buffer, so that it is contiguous but not 16-byte aligned."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(M * 7 + K * 3 + N)
    buf = torch.empty(S * M * K + offset, dtype=torch.bfloat16, device=dev)
    x = buf[offset:].view(S, M, K)
    x.copy_(torch.randn(S, M, K, device=dev, generator=gen))
    mu = torch.randn(K, N, device=dev, generator=gen) * 0.02
    rho = moped_rho(mu, 0.05)
    seeds = torch.randint(0, 2**31 - 1, (n_draws,), device=dev, generator=gen,
                          dtype=torch.int32)
    return x, mu, rho, seeds


def compare_bayes_linear(fl, x, mu, rho, seeds, antithetic):
    """The forward kernel against its plain version on one input, and a
    rerun; raises on a mismatch. Returns (max |d y|, the kernel's W, a
    summary)."""
    shape = tuple(x.shape[1:]) + (mu.shape[1],)
    name = "bayes_linear_anti" if antithetic else "bayes_linear"
    y, lq, lp, w = fl.bayes_linear_with_w(x, mu, rho, seeds, antithetic=antithetic)
    again = fl.bayes_linear_with_w(x, mu, rho, seeds, antithetic=antithetic)
    torch.cuda.synchronize()
    yp, lqp, lpp, wp = fl.bayes_linear_plain(x, mu, rho, seeds, antithetic=antithetic,
                                             save_weights=True)
    check(all(torch.equal(a, b) for a, b in zip((y, lq, lp, w), again)),
          f"{name} reruns differ at {shape}")
    err = (y.float() - yp.float()).abs().max().item()
    check(torch.allclose(y.float(), yp.float(), rtol=2e-2, atol=2e-2),
          f"{name} y differs at {shape}: max {err}")
    for tag, a, b in (("log_q", lq, lqp), ("log_p", lp, lpp)):
        check(torch.allclose(a, b, rtol=1e-5, atol=0.0),
              f"{name} {tag} differs at {shape}: {a} vs {b}")
    # W = mu + softplus(rho) eps in bf16 (and 2 mu - w for a pair's second
    # member), each step rounded as the plain version rounds it, from the
    # same normals (phase eps): equal to the plain W
    w_err = (w.float() - wp.float()).abs().max().item()
    check(torch.equal(w, wp), f"{name} W differs at {shape}: max {w_err}")
    return err, w, (
        f"y max|d| {err:.3g}, W max|d| {w_err:.3g} "
        f"({(w == wp).float().mean().item():.6f} equal), "
        f"log_q {lq[0].item():.6g} vs {lqp[0].item():.6g}, reruns equal")


SERVING_SHAPES = ((1024, 768, 768), (1024, 768, 3072), (1024, 3072, 768),
                  (8, 768, 768), (8, 768, 2))


def phase_bayes_linear(fl, moped_rho, antithetic) -> list[dict]:
    """A forward kernel against its plain version; returns the timing rows."""
    S = 10
    n_draws = S // 2 if antithetic else S
    name = "bayes_linear_anti" if antithetic else "bayes_linear"
    rows = []
    for M, K, N in SERVING_SHAPES:
        x, mu, rho, seeds = bayes_linear_inputs(S, M, K, N, moped_rho, n_draws)
        err, w, summary = compare_bayes_linear(fl, x, mu, rho, seeds, antithetic)
        ms = time_ms(lambda: fl.bayes_linear(x, mu, rho, seeds, prior_on_mu=True,
                                             antithetic=antithetic), 20)
        plain_ms = time_ms(lambda: fl.bayes_linear_plain(
            x, mu, rho, seeds, antithetic=antithetic), 3, 1)
        lib_ms = time_ms(lambda: torch.bmm(x, w), 20)
        n_bytes = (S * M * K * 2 + 2 * K * N * 4 + S * M * N * 2 + 2 * S * 4
                   + n_draws * 4)
        b_ms, b_by = bound(n_bytes, 2.0 * S * M * K * N)
        say(f"{name} M={M} K={K} N={N}: {summary}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        if antithetic:
            line = 912 if K >= 2048 else 636
        else:
            line = 412 if K >= 2048 else 106
        rows.append(dict(
            name=f"{name}[M={M},K={K},N={N}]", shape=(M, K, N),
            route="cuda", source="bayeformers_tpu_torch/csrc/bayes_linear.cu",
            replaces=f"bayeformers_tpu/ops/fused_linear.py:{line}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms,
        ))
    # the kernel's scalar x path, taken when K % 8 != 0 or x is not 16-byte
    # aligned: off the serving path, so checked here but neither timed nor
    # counted
    for M, K, N, offset in ((100, 300, 130, 0), (64, 768, 130, 1)):
        x, mu, rho, seeds = bayes_linear_inputs(S, M, K, N, moped_rho, n_draws, offset)
        check(K % 8 != 0 or x.data_ptr() % 16 != 0,
              f"{(M, K, N, offset)} does not take the scalar x path")
        _, _, summary = compare_bayes_linear(fl, x, mu, rho, seeds, antithetic)
        say(f"{name} scalar x path M={M} K={K} N={N} "
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


def build_predictor(bt, antithetic=True):
    """BERT-base from seed 0, MOPED-converted (delta 0.05, frozen), served at
    S=10, antithetic or with independent draws, in one (8, 128) bucket on
    the card."""
    model = bt.build_bert(size="base", n_labels=2, seed=0, dtype=torch.bfloat16,
                          device="cuda")
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True)
    return bt.Predictor(bmodel, n_samples=10, batch_sizes=(8,), seq_lens=(128,),
                        antithetic=antithetic)


def serving_requests(bt) -> list[dict]:
    """Three ragged requests (3x77, 8x128, 5x20 token ids) from a seed; the
    second fills the (8, 128) bucket."""
    rng = np.random.default_rng(0)
    vocab = bt.BERT_BASE_KWARGS["vocab_size"]
    return [{"input_ids": rng.integers(1, vocab, (n, L)),
             "attention_mask": np.ones((n, L), np.int64),
             "token_type_ids": np.zeros((n, L), np.int64)}
            for n, L in ((3, 77), (8, 128), (5, 20))]


def phase_serving(bt, fl, at, antithetic) -> tuple[dict, float]:
    """Returns per-kernel launch counts by shape over the three requests,
    and the median latency (ms) of the 8x128 request."""
    t0 = time.perf_counter()
    pred = build_predictor(bt, antithetic)
    fwd, fwd_name = ((fl.LAUNCHES, "bayes_linear_anti") if antithetic
                     else (fl.INDEP_LAUNCHES, "bayes_linear"))
    tag = "antithetic" if antithetic else "independent"
    bmodel = pred.bmodel
    torch.cuda.synchronize()
    say(f"serving ({tag}): BERT-base built and converted in "
        f"{time.perf_counter() - t0:.2f} s ({len(bmodel.spec.paths)} converted leaves)")
    requests = serving_requests(bt)
    pred(requests[0], seed=100)  # the first request pays one-time set-up
    torch.cuda.synchronize()

    reset_counters(fl, at)
    outs = [pred(r, seed=100 + i) for i, r in enumerate(requests)]
    torch.cuda.synchronize()
    launches = {fwd_name: dict(fwd.by_shape), "mha_fwd": dict(at.LAUNCHES.by_shape)}
    check(fwd.count > 0 and at.LAUNCHES.count > 0,
          f"the requests launched no kernel: {launches}")
    say(f"serving ({tag}): launches over 3 requests: {fwd_name} "
        f"{fwd.count} {launches[fwd_name]}, mha_fwd "
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
    say(f"serving ({tag}): probs of request 2: "
        f"{outs[1]['probs'][:, 0].round(4).tolist()}")

    # logits through the kernels against the plain path, on the card
    dev = bmodel.device
    batch = {k: torch.from_numpy(v).to(dev) for k, v in requests[1].items()}
    args = (batch["input_ids"], batch["attention_mask"], batch["token_type_ids"])
    lk, auxk = bmodel.mc_apply_fused(12345, 10, *args, antithetic=antithetic)
    lp, auxp = bmodel.mc_apply_fused(12345, 10, *args, antithetic=antithetic,
                                     impl="plain")
    err = (lk.float() - lp.float()).abs().max().item()
    check(err <= 5e-2, f"logits through the kernels differ from the plain path by {err}")
    for key in auxk:
        check(torch.allclose(auxk[key], auxp[key], rtol=1e-5, atol=0.0),
              f"{key} differs from the plain path: {auxk[key]} vs {auxp[key]}")
    say(f"serving ({tag}): logits kernels vs plain max|d| {err:.4g} (S=10, B=8, L=128); "
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
    say(f"serving ({tag}): 8x128 request latency (S=10) median {latency:.3f} ms "
        f"over 10: {[round(v, 3) for v in lat]}")
    del pred, bmodel
    torch.cuda.empty_cache()
    return launches, latency


def reset_counters(*modules) -> None:
    """Every launch counter of the given op modules to 0."""
    for m in modules:
        for name in ("LAUNCHES", "INDEP_LAUNCHES", "BWD_LAUNCHES"):
            if hasattr(m, name):
                getattr(m, name).reset()

def rel_err(a, b) -> float:
    """max |a - b| over max |b| (f32 sums of the same products in another
    order are judged against the scale of the result)."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


TRAIN_SHAPES = ((1024, 768, 768), (1024, 768, 3072), (1024, 3072, 768),
                (8, 768, 768), (8, 768, 2))


def phase_reduce(fl, fb, moped_rho, antithetic) -> list[dict]:
    """A reduce kernel against its plain version on the W the forward
    kernel wrote; returns the timing rows of the training shapes."""
    S = 10
    n_draws = S // 2 if antithetic else S
    if antithetic:
        name, fn, plain = "reduce_abuv_anti", fb.reduce_abuv_anti, fb.reduce_abuv_anti_plain
    else:
        name, fn, plain = "reduce_abuv", fb.reduce_abuv, fb.reduce_abuv_plain
    rows = []
    for M, K, N in TRAIN_SHAPES + ((100, 300, 130),):
        x, mu, rho, seeds = bayes_linear_inputs(S, M, K, N, moped_rho, n_draws)
        w = fl.bayes_linear_with_w(x, mu, rho, seeds, antithetic=antithetic)[3]
        gen = torch.Generator(device="cuda").manual_seed(M + K + N)
        g = (torch.randn(S, M, N, device="cuda", generator=gen) * 0.01).to(torch.bfloat16)
        g_p = torch.randn(S, device="cuda", generator=gen)
        out = fn(x, g, w, mu, g_p)
        again = fn(x, g, w, mu, g_p)
        torch.cuda.synchronize()
        ref = plain(x, g, w, mu, g_p)
        errs = [rel_err(a, r) for a, r in zip(out, ref)]
        check(max(errs) <= 1e-4, f"{name} differs at {(M, K, N)}: "
              f"A/B/V rel err {errs}")
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"{name} reruns differ at {(M, K, N)}")
        summary = "A/B/V rel err " + "/".join(f"{e:.3g}" for e in errs)
        if (M, K, N) not in TRAIN_SHAPES:
            say(f"{name} odd shape M={M} K={K} N={N}: {summary}, reruns equal")
            continue
        ms = time_ms(lambda: fn(x, g, w, mu, g_p), 20)
        plain_ms = time_ms(lambda: plain(x, g, w, mu, g_p), 3, 1)
        xt = x.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.bmm(xt, g), 20)
        # the pair reduce reads the even half of W, the independent one all
        n_bytes = (S * M * (K + N) * 2 + n_draws * K * N * 2 + K * N * 4 + S * 4
                   + 3 * K * N * 4)
        b_ms, b_by = bound(n_bytes, 2.0 * S * M * K * N)
        say(f"{name} M={M} K={K} N={N}: {summary}, reruns equal; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm x^T g "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(
            name=f"{name}[M={M},K={K},N={N}]", shape=(M, K, N),
            route="cuda", source="bayeformers_tpu_torch/csrc/fused_backward.cu",
            replaces=("bayeformers_tpu/ops/fused_backward.py:202" if antithetic
                      else "bayeformers_tpu/ops/fused_backward.py:97"),
            max_abs_err=max((a - r).abs().max().item() for a, r in zip(out, ref)),
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms,
        ))
    return rows


def mha_bwd_inputs(at, N, L, H, seed):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn(N, L, H, device=dev, generator=gen).to(torch.bfloat16)
                  for _ in range(4))
    mask = torch.ones(N, L, device=dev)
    mask[: N // 2, L - L // 3:] = 0  # padded keys in half the rows
    mask[N - 1] = 0                  # one fully masked row
    return q, k, v, at.mask_to_bias(mask), g


def phase_mha_bwd(at) -> dict:
    """Kernel #5 against its plain version; returns the timing row of the
    training shape."""
    nh = 12
    row = None
    for N, L, H in ((80, 128, 768), (8, 512, 768)):
        q, k, v, bias, g = mha_bwd_inputs(at, N, L, H, L)
        out = at.mha_bwd_cuda(q, k, v, bias, g, nh)
        again = at.mha_bwd_cuda(q, k, v, bias, g, nh)
        torch.cuda.synchronize()
        ref = at.mha_bwd_plain(q, k, v, bias, g, nh)
        errs = [(a.float() - r.float()).abs().max().item() for a, r in zip(out, ref)]
        for name, a, r in zip(("dq", "dk", "dv"), out, ref):
            check(bool(torch.isfinite(a.float()).all()), f"mha_bwd {name} not finite")
            # bf16 outputs: 2e-2 absolute as the forward, plus 2e-2 relative
            # where gradients reach |x| ~ 10 and one bf16 step is 0.06
            check(torch.allclose(a.float(), r.float(), rtol=2e-2, atol=2e-2),
                  f"mha_bwd {name} differs at {(N, L, H)}: max {errs}")
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"mha_bwd reruns differ at {(N, L, H)}")
        summary = "dq/dk/dv max|d| " + "/".join(f"{e:.3g}" for e in errs)
        if L != 128:
            say(f"mha_bwd N={N} L={L} H={H}: {summary}, reruns equal")
            continue
        ms = time_ms(lambda: at.mha_bwd_cuda(q, k, v, bias, g, nh), 20)
        plain_ms = time_ms(lambda: at.mha_bwd_plain(q, k, v, bias, g, nh), 3, 1)
        d = H // nh
        heads = [t.view(N, L, nh, d).transpose(1, 2).detach().requires_grad_()
                 for t in (q, k, v)]
        sdpa_mask = bias.clamp_min(torch.finfo(torch.bfloat16).min).to(torch.bfloat16)
        o = torch.nn.functional.scaled_dot_product_attention(
            *heads, attn_mask=sdpa_mask[:, None, None, :])
        go = g.view(N, L, nh, d).transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(o, heads, go, retain_graph=True), 20)
        b_ms, b_by = bound(7 * N * L * H * 2 + N * L * 4, 10.0 * N * L * L * H)
        say(f"mha_bwd N={N} L={L} H={H}: {summary}, reruns equal; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        row = dict(name=f"mha_bwd[N={N},L={L},H={H}]", shape=(N, L, H), route="cuda",
                   source="bayeformers_tpu_torch/csrc/mha_bwd.cu",
                   replaces="bayeformers_tpu/ops/attention.py:181",
                   max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms)
    return row


def train_batch(bt, B=8, L=128, seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, bt.BERT_BASE_KWARGS["vocab_size"], (B, L))
    mask = np.ones((B, L), np.int64)
    mask[B // 2:, L - 30:] = 0
    return {k: torch.from_numpy(v).cuda() for k, v in (
        ("input_ids", ids), ("attention_mask", mask),
        ("token_type_ids", np.zeros((B, L), np.int64)),
        ("labels", rng.integers(0, 2, (B,))))}


def grads_of(bt, bmodel, named, seed, batch, impl, estimator):
    """Loss and gradients of one ELBO objective (S=10) at the given draw."""
    for _, t, _ in named:
        t.grad = None
    loss, m = bt.training.elbo_objective(
        bt.training.pick_mc(bmodel, estimator), seed, 10, batch, 256, impl=impl)
    loss.backward()
    return loss.detach(), m, {n: t.grad.clone() for n, t, _ in named}


def converted_base(bt, dtype):
    """BERT-base from seed 0, MOPED-converted (delta 0.05, frozen), and its
    trainable tensors."""
    model = bt.build_bert(size="base", n_labels=2, seed=0, dtype=dtype, device="cuda")
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True)
    return bmodel, bmodel.trainable_parameters()


def worst_agreement(a: dict, b: dict, names) -> tuple[float, float, str]:
    """(largest relative L2 error, smallest cosine, the leaf of the first)
    of gradients ``a`` against ``b`` over ``names``."""
    worst = (0.0, 1.0, "")
    for n in names:
        x, y = a[n].double().flatten(), b[n].double().flatten()
        rel = ((x - y).norm() / y.norm().clamp_min(1e-300)).item()
        cos = (x @ y / (x.norm() * y.norm()).clamp_min(1e-300)).item()
        worst = (max(worst[0], rel), min(worst[1], cos), n if rel > worst[0] else worst[2])
    return worst


def phase_train(bt, fl, at, fb, estimator) -> tuple[dict, float]:
    """The ELBO step at the recipe: returns the launch counts by kernel and
    shape over the timed steps and the median step time (ms)."""
    S, n_batches = 10, 256
    anti = estimator == "antithetic"
    batch = train_batch(bt)
    # the same step in f32 activations through the plain versions: the
    # yardstick for gradients that bf16 activations blur on either path
    bmodel32, named32 = converted_base(bt, torch.float32)
    _, _, g32 = grads_of(bt, bmodel32, named32, 123, batch, "plain", estimator)
    del bmodel32, named32
    torch.cuda.empty_cache()

    bmodel, named = converted_base(bt, torch.bfloat16)
    # the step through the kernels against the plain step, same draw
    loss_k, mk, gk = grads_of(bt, bmodel, named, 123, batch, "kernel", estimator)
    loss_k2, _, gk2 = grads_of(bt, bmodel, named, 123, batch, "kernel", estimator)
    loss_p, mp, gp = grads_of(bt, bmodel, named, 123, batch, "plain", estimator)
    check(torch.equal(loss_k, loss_k2) and all(torch.equal(gk[n], gk2[n]) for n in gk),
          "the same seed gave another loss or gradient through the kernels")
    for key in ("loss", "log_prior", "log_variational_posterior", "nll"):
        check(bool(torch.isfinite(mk[key])), f"{key} is not finite: {mk[key]}")
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    check(loss_rel <= 1e-2, f"step loss kernels {loss_k.item()} vs plain {loss_p.item()}")
    say(f"train ({estimator}): loss kernels {loss_k.item():.9g} vs plain {loss_p.item():.9g} (rel "
        f"{loss_rel:.3g}), nll {mk['nll'].item():.7g} vs {mp['nll'].item():.7g}; "
        "reruns bit-equal")
    rho = [n for n in gk if n.startswith("rho/")]
    rel, cos, at_ = worst_agreement(gk, gp, rho)
    say(f"train ({estimator}): rho gradients ({len(rho)} leaves), kernels vs plain: worst rel L2 "
        f"{rel:.4g} ({at_}), worst cosine {cos:.7f}")
    check(rel <= 5e-2 and cos >= 0.999, "rho gradients through the kernels differ "
          f"from the plain step: rel L2 {rel}, cosine {cos}")
    # LayerNorm and embedding gradients come from the task loss alone, which
    # bf16 activations blur on both paths: the kernels' distance from the
    # f32 step must stay within 1.5x the bf16 plain step's own
    for group in ("LayerNorm/scale", "LayerNorm/bias", "embedding"):
        names = [n for n in gk if n.startswith("params/") and n.endswith(group)]
        rk, ck, nk = worst_agreement(gk, g32, names)
        rp, cp, _ = worst_agreement(gp, g32, names)
        rkp, ckp, _ = worst_agreement(gk, gp, names)
        say(f"train ({estimator}): {group} gradients ({len(names)} leaves) against the f32 plain "
            f"step: kernels rel L2 {rk:.4g} ({nk}) cosine {ck:.6f}; bf16 plain "
            f"rel L2 {rp:.4g} cosine {cp:.6f}; kernels vs bf16 plain rel L2 "
            f"{rkp:.4g} cosine {ckp:.6f}")
        check(rk <= 1.5 * rp and 1.0 - ck <= 1.5 * (1.0 - cp),
              f"{group} gradients through the kernels are further from the f32 "
              "step than the bf16 plain step's")
    del gk, gk2, gp, g32

    # the ELBO falls on one batch and one draw
    tx = bt.training.adamw_with_decay_groups(
        bt.training.linear_schedule(2e-5, 0.0, 100), 0.0,
        bt.training.default_no_decay, eps=1e-8, clip_norm=1.0)
    opt = tx.init(named)
    step = bt.training.make_elbo_train_step(bmodel, opt, S, n_batches,
                                            estimator=estimator)
    losses = [step(55, batch)["loss"].item() for _ in range(4)]
    say(f"train ({estimator}): loss over 4 steps at one batch and draw: {losses}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "the ELBO did not fall")

    # timed steps, fresh draws; launches counted around exactly these
    torch.cuda.synchronize()
    reset_counters(fl, at, fb)
    times = []
    for i in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(1000 + i, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(m["loss"])), f"step {i} loss {m['loss']}")
    fwd, red = ((fl.LAUNCHES, fb.LAUNCHES) if anti
                else (fl.INDEP_LAUNCHES, fb.INDEP_LAUNCHES))
    launches = {fwd.name: dict(fwd.by_shape),
                "mha_fwd": dict(at.LAUNCHES.by_shape),
                "mha_bwd": dict(at.BWD_LAUNCHES.by_shape),
                red.name: dict(red.by_shape)}
    check(all(sum(v.values()) > 0 for v in launches.values()),
          f"the train steps launched no kernel of some kind: {launches}")
    step_ms = float(np.median(times))
    say(f"train ({estimator}): launches over 10 steps: {launches}")
    say(f"train ({estimator}): ELBO step (S=10, B=8, L=128, bf16) median {step_ms:.3f} ms over 10: "
        f"{[round(v, 3) for v in times]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del opt, step, named, bmodel
    torch.cuda.empty_cache()
    return launches, step_ms


def phase_workload(fl, fb, samples) -> float:
    """bert_glue phases A-D at ``samples`` draws; an odd S must run the
    independent-draw kernels and no antithetic one."""
    from bayeformers_tpu_torch.workloads import bert_glue

    reset_counters(fl, fb)
    with tempfile.TemporaryDirectory() as logs:
        score = bert_glue.train(size="base", limit_batches=3, epochs=1, b_epochs=1,
                                bf16=True, logs=logs, samples=samples)
    check(np.isfinite(score), f"bert_glue score {score}")
    counts = {c.name: c.count for c in (fl.LAUNCHES, fl.INDEP_LAUNCHES,
                                         fb.LAUNCHES, fb.INDEP_LAUNCHES)}
    odd = samples % 2 == 1
    check(all((counts[n] > 0) == (("anti" in n) != odd) for n in counts),
          f"bert_glue at S={samples} took the wrong estimator's kernels: {counts}")
    say(f"workload: bert_glue phases A-D at S={samples}, 3 batches an epoch: "
        f"score {score:.4f}; launches {counts}")
    return score


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    import bayeformers_tpu_torch as bt
    from bayeformers_tpu_torch.core.init import moped_rho
    from bayeformers_tpu_torch.ops import _build, common
    from bayeformers_tpu_torch.ops import attention as at
    from bayeformers_tpu_torch.ops import fused_backward as fb
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

    rows, train_rows, serve, train = [], [], {}, {}
    for anti in (True, False):
        t = time.perf_counter()
        rows.append((phase_bayes_linear(fl, moped_rho, anti), anti))
        say(f"phase bayes_linear ({'antithetic' if anti else 'independent'}): "
            f"{time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    rows.append(([phase_mha(at)], True))
    say(f"phase mha: {time.perf_counter() - t:.2f} s")

    for anti in (True, False):
        t = time.perf_counter()
        serve[anti] = phase_serving(bt, fl, at, anti)
        say(f"phase serving ({'antithetic' if anti else 'independent'}): "
            f"{time.perf_counter() - t:.2f} s")

    for anti in (True, False):
        t = time.perf_counter()
        train_rows.append((phase_reduce(fl, fb, moped_rho, anti), anti))
        say(f"phase reduce ({'antithetic' if anti else 'independent'}): "
            f"{time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    train_rows.append(([phase_mha_bwd(at)], True))
    say(f"phase mha_bwd: {time.perf_counter() - t:.2f} s")

    for anti in (True, False):
        est = "antithetic" if anti else "fused"
        t = time.perf_counter()
        train[anti] = phase_train(bt, fl, at, fb, est)
        say(f"phase train ({est}): {time.perf_counter() - t:.2f} s")

    for samples in (10, 3):
        t = time.perf_counter()
        phase_workload(fl, fb, samples)
        say(f"phase workload (S={samples}): {time.perf_counter() - t:.2f} s")

    # each kernel's launches are those of the path it serves: the forward
    # kernels' and mha_fwd's the requests', the backward kernels' the train
    # steps', each estimator's its own
    kernels = []
    pairs = ([(r, serve[anti][0]) for group, anti in rows for r in group]
             + [(r, train[anti][0]) for group, anti in train_rows for r in group])
    for r, counts in pairs:
        kind = r["name"].split("[")[0]
        n = counts[kind].get(tuple(r.pop("shape")), 0)
        check(n > 0, f"{r['name']} was not launched on the path it serves")
        kernels.append({"name": r["name"], "route": r["route"], "source": r["source"],
                        "replaces": r["replaces"], "launches": n,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    latency, latency_ind = serve[True][1], serve[False][1]
    step_ms, step_ind = train[True][1], train[False][1]
    say(f"{smi}; request latency 8x128 S=10: antithetic {latency:.3f} ms, "
        f"independent {latency_ind:.3f} ms; ELBO step S=10 B=8 L=128: antithetic "
        f"{step_ms:.3f} ms, fused {step_ind:.3f} ms; total "
        f"{time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
