#!/usr/bin/env python3
"""The split ops' kernels (#11, #13) and the estimators that run them, this
tree against a parent tree's, on one card: outputs and times.

Per turn, on the same seeded inputs in both trees:

- the mixture KL's log-probs over BERT-base's 74 converted leaves at S = 4
  (``KL_DRAWS``): one grouped call where the tree has
  ``sampled_logprobs_grouped``, else one ``sampled_logprobs`` call a leaf;
- their VJP at fixed cotangents: the grouped ``logprob_vjp_grouped_cuda``,
  else each leaf's ``SampledLogprobs.backward`` (W by #13, then the torch
  epilogue);
- flipout's ``sampled_dense`` VJP at BERT's three shapes (S = 10, M =
  1024), bf16 and f32: ``sampled_dense_vjp``, else ``SampledDense.backward``;
- #10 (``fused_linear.regenerate_weights``, f32, S' = 5 at 3072 -> 768),
  which shares ``bft_regen``, first in each turn (timed after other work in
  the process it read up to 9% apart between identical kernels);
- BERT-base's 8x128 request and ELBO step (S = 10, B = 8, L = 128, bf16)
  under flipout and LRT, each with random init (the mixture's KL) and with
  frozen MOPED: the median of 10 (host clock around
  synchronised work) and the card's busy time a request or step
  (``torch.profiler``, 3 of them).

Each kernel call is timed as ``chip_smoke.py`` times it (CUDA events around
back-to-back calls, the median of 5 windows) and as the card's time in the
kernels it launched (``-device``). The trees run in turns, one process each:
parent, change, change, parent. The change's first run holds its outputs
against the parent's first: log-probs within 1e-5 relative, the VJPs' dmu
and drho within 1e-5 (f32) or 1e-4 (flipout's bf16 VJP) of each one's
largest entry, flipout's dx and #10's W bit-equal. On one card, in one
call::

    mkdir -p .scratch/parent
    git archive <parent> bayeformers_tpu_torch | tar -x -C .scratch/parent
    python3 probe_split_parent.py .scratch/parent

(``run TREE OUT [REF]`` is one turn: the probe of TREE's package, saved to
OUT, held against REF when given; the model helpers come from this tree's
``chip_smoke.py``.) Needs one CUDA card; exits 2 without one. Exits 1 if a
check fails.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

from probe_linear_parent import device_ms, time_ms

S_KL = 4
MIXTURE = (0.5, 1.0, float(np.exp(-6.0)))
VJP_SHAPES = ((768, 768), (768, 3072), (3072, 768))


def kl_inputs(shapes):
    """Random-init leaves (mu ~ U(-0.2, 0.2), rho ~ U(-5, -4)), each
    leaf's S_KL seeds and the cotangents (n, S_KL) on the card."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    mus = [torch.rand(K, N, device="cuda", generator=gen) * 0.4 - 0.2 for K, N in shapes]
    rhos = [torch.rand(K, N, device="cuda", generator=gen) - 5.0 for K, N in shapes]
    seeds = [torch.randint(0, 2**31 - 1, (S_KL,), device="cuda", generator=gen,
                           dtype=torch.int32) for _ in shapes]
    g_q = torch.randn(len(shapes), S_KL, device="cuda", generator=gen)
    g_p = torch.randn(len(shapes), S_KL, device="cuda", generator=gen)
    return mus, rhos, seeds, g_q, g_p


def kl_calls(lpm, mus, rhos, seeds, g_q, g_p):
    """(forward, VJP) of the tree's mixture KL over the leaves: each returns
    its outputs."""
    prior = ("mixture",) + MIXTURE
    if hasattr(lpm, "sampled_logprobs_grouped"):
        def fwd():
            return lpm.logprobs_grouped_cuda(mus, rhos, seeds, prior)

        def vjp():
            dmu, drho = lpm.logprob_vjp_grouped_cuda(mus, rhos, seeds, prior, g_q, g_p)
            return dmu + drho
        return fwd, vjp

    def fwd():
        out = [lpm.sampled_logprobs(m, r, s, mixture=MIXTURE)
               for m, r, s in zip(mus, rhos, seeds)]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    def vjp():
        dmu, drho = [], []
        for i, (m, r, s) in enumerate(zip(mus, rhos, seeds)):
            ctx = types.SimpleNamespace(saved_tensors=(m, r, s, None, None), plain=False,
                                        prior=prior)
            out = lpm.SampledLogprobs.backward(ctx, g_q[i], g_p[i])
            dmu.append(out[0])
            drho.append(out[1])
        return dmu + drho
    return fwd, vjp


def flipout_vjp(sl, x, mu, rho, seeds, g):
    """The tree's VJP of ``sampled_dense``: (dx, dmu, drho)."""
    if hasattr(sl, "sampled_dense_vjp"):
        return sl.sampled_dense_vjp(x, mu, rho, seeds, g)
    ctx = types.SimpleNamespace(saved_tensors=(x, mu, rho, seeds, None), plain=False,
                                needs_input_grad=(True, True, True, False, False, False))
    return sl.SampledDense.backward(ctx, g)[:3]


def steps(bt, cs, times):
    """BERT-base's request and step under flipout and LRT, random init and
    frozen MOPED, bf16: medians of 10 and the card's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for est, prior in (("flipout", "mixture"), ("local", "mixture"), ("flipout", "on_mu"),
                       ("local", "on_mu")):
        key = f"{est}/{prior}"
        bmodel, named = cs.converted_base(bt, cs.BF16, prior)
        req = cs.serving_requests(bt)[1]
        dev = bmodel.device
        args = tuple(torch.from_numpy(req[k]).to(dev)
                     for k in ("input_ids", "attention_mask", "token_type_ids"))
        mc = bt.training.pick_mc(bmodel, True, est)

        def serve(i):
            with torch.inference_mode():
                mc(i, 10, *args)
        batch = cs.train_batch(bt)
        tx = bt.training.adamw_with_decay_groups(2e-5, 0.0, bt.training.default_no_decay)
        step_fn = bt.make_elbo_train_step(bmodel, tx.init(named), 10, 256, estimator=est)

        def step(i):
            step_fn(i, batch)
        for what, fn in (("request", serve), ("step", step)):
            for i in range(3):
                fn(i)
            lat = []
            for i in range(10):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn(100 + i)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t) * 1e3)
            times[f"{what}/{key}"] = float(np.median(lat))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for i in range(3):
                    fn(200 + i)
                torch.cuda.synchronize()
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
            times[f"{what}-busy/{key}"] = busy / 3 / 1e3
            print(f"{key} {what}: median {times[f'{what}/{key}']:.3f} ms, card busy "
                  f"{times[f'{what}-busy/{key}']:.3f} ms", flush=True)
        del step_fn, named, bmodel, mc
        torch.cuda.empty_cache()


def run(tree: str) -> tuple[dict, dict]:
    """Outputs (on the CPU) and times of ``tree``'s package."""
    sys.path.insert(0, os.path.abspath(tree))
    import bayeformers_tpu_torch as bt
    from bayeformers_tpu_torch.core.init import moped_rho
    from bayeformers_tpu_torch.ops import fused_linear as fl
    from bayeformers_tpu_torch.ops import logprob as lpm
    from bayeformers_tpu_torch.ops import sampled_linear as sl

    assert os.path.abspath(lpm.__file__).startswith(os.path.abspath(tree)), lpm.__file__
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    out, times = {}, {}
    # #10 first, on a card that has run nothing else in this process
    _, mu, rho, sd, _ = cs.bayes_linear_inputs(10, 8, 3072, 768, moped_rho, 5, dtype=torch.float32)
    out["regen10/W"] = fl.regenerate_weights(mu, rho, sd).cpu()
    fn = lambda: fl.regenerate_weights(mu, rho, sd)
    times["regen10/3072x768"] = time_ms(fn, 50)
    times["regen10-device/3072x768"] = device_ms(fn)
    del mu, rho, sd
    mus, rhos, seeds, g_q, g_p = kl_inputs(cs.BERT_LEAVES)
    fwd, vjp = kl_calls(lpm, mus, rhos, seeds, g_q, g_p)
    out["kl/log_q"], out["kl/log_p"] = (t.cpu() for t in fwd())
    out["kl/vjp"] = [t.cpu() for t in vjp()]
    for what, fn in (("kl-forward", fwd), ("kl-vjp", vjp)):
        times[what] = time_ms(fn)
        times[f"{what}-device"] = device_ms(fn)
        print(f"{tree} {what} (74 leaves, S=4): {times[what]:.4f} ms "
              f"({times[what + '-device']:.4f} on the card)", flush=True)
    del mus, rhos, seeds
    torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for K, N in VJP_SHAPES:
            key = f"flipout-vjp/{tag}/{K}x{N}"
            x, mu, rho, sd = cs.sampled_dense_inputs(10, 1024, K, N, moped_rho, dtype, True)
            gen = torch.Generator(device="cuda").manual_seed(K + N)
            g = (torch.randn(10, 1024, N, device="cuda", generator=gen) * 0.01).to(dtype)
            out[key] = [t.cpu() for t in flipout_vjp(sl, x, mu, rho, sd, g)]
            fn = lambda: flipout_vjp(sl, x, mu, rho, sd, g)
            times[key] = time_ms(fn, 10)
            times[key.replace("/", "-device/", 1)] = device_ms(fn)
            print(f"{tree} {key}: {times[key]:.4f} ms "
                  f"({times[key.replace('/', '-device/', 1)]:.4f} on the card)", flush=True)
    torch.cuda.empty_cache()
    steps(bt, cs, times)
    return out, times


def compare(got: dict, want: dict) -> list[str]:
    """The change's outputs against the parent's; returns the failures."""
    bad = []
    for n in ("kl/log_q", "kl/log_p"):
        rel = ((got[n] - want[n]).abs() / want[n].abs()).max().item()
        print(f"{n}: rel err {rel:.3g}")
        if rel > 1e-5:
            bad.append(f"{n}: rel err {rel:.3g}")
    worst = max((a - b).abs().max().item() / b.abs().max().item()
                for a, b in zip(got["kl/vjp"], want["kl/vjp"]))
    print(f"kl/vjp: worst {worst:.3g} of the largest entry")
    if worst > 1e-5:
        bad.append(f"kl/vjp: {worst:.3g} of the largest entry")
    for key in [k for k in want if k.startswith("flipout-vjp")]:
        gate = 1e-4 if "/bf16/" in key else 1e-5
        (gx, gm, gr), (wx, wm, wr) = got[key], want[key]
        rel = [(a - b).abs().max().item() / b.abs().max().item() for a, b in ((gm, wm), (gr, wr))]
        print(f"{key}: dx equal {torch.equal(gx, wx)}, dmu/drho {rel[0]:.3g}/{rel[1]:.3g} of "
              "the largest entry")
        if not torch.equal(gx, wx) or max(rel) > gate:
            bad.append(f"{key}: dx equal {torch.equal(gx, wx)}, dmu/drho {rel}")
    if not torch.equal(got["regen10/W"], want["regen10/W"]):
        bad.append("#10's W differs")
    print(f"#10's W bit-equal: {torch.equal(got['regen10/W'], want['regen10/W'])}")
    return bad


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_split_parent: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1] == "run":
        tree, path = sys.argv[2], sys.argv[3]
        got, times = run(tree)
        torch.save({"out": got, "times": times}, path)
        if len(sys.argv) > 4:
            bad = compare(got, torch.load(sys.argv[4])["out"])
            for b in bad:
                print("FAIL", b)
            print(f"outputs within the gates of the parent's: "
                  f"{'all' if not bad else f'{len(bad)} failures'}")
            return 1 if bad else 0
        return 0
    parent = sys.argv[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    scratch = os.path.join(".scratch", "probe_split")
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
