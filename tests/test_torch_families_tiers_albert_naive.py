"""The naive tier on ALBERT's attention handler against the JAX package on
the CPU in f32 (tiny ALBERT, its one layer called twice, frozen MOPED),
and a witness in f64 of what bounds the one leaf that stands apart.

The query bias's rho gradient of the logits' part is 3-4e-6 of the part's
largest gradient: shifting every query by one bias moves each score by
its dot with the keys, and the softmax over keys takes the mean of that
away, so the gradient is a sum over keys that mostly cancels. The port
run in f64 (every ``.float()`` kept in f64: :func:`port_f64`) gives the
sum that both f32 sides round: the port's f32 gradient stands 1.6e-4
(one call) and 2.7e-4 (two calls) of the leaf's largest entry from it,
the JAX package's 1.0e-4 and 2.2e-4, and the two f32 sides 2.0e-4 and
1.5e-4 from each other, while every other leaf agrees within 4e-6
(``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_families_tiers_albert_naive.py`` prints these readings). So a leaf below ``NEAR_ZERO[0]`` of its part's largest
gradient is held within ``NEAR_ZERO[1]`` of its own largest entry: 5e-4,
above the largest f32-to-f64 reading; every other leaf keeps
``check_against_jax``'s 1e-4.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_estimators as te
from test_torch_estimators import B, L, check_against_jax
from test_torch_families import convert_pair, family_batch, inputs_of
from bayeformers_tpu_torch import training
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

NEAR_ZERO = (1e-5, 5e-4)


@contextlib.contextmanager
def port_f64(port):
    """The port's model, rho and prior means in f64 and ``Tensor.float()``
    a no-op on f64 tensors, so that the forward's f32 casts keep f64;
    restored on exit (the model stays in f64)."""
    port.model.double()
    for m in port.model.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = torch.float64
    for d in (port.rho, port.prior_mu):
        for t in d.values():
            t.data = t.data.double()
    orig = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else orig(t, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = orig


def naive_grads(port, batch, hook, weights, dtype):
    """The port's naive-tier logits and the gradients of ``sum(logits *
    weights)`` and of the KL part, in ``dtype``, at the hook's draws."""
    named = port.trainable_parameters()
    t = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    out, aux = training.pick_mc(port, True, "naive")(
        0, te.S, **t, eps_hook=lambda p, s: hook(p, s).to(dtype))
    assert out.dtype == dtype
    kl = torch.mean(aux["log_variational_posterior"] - aux["log_prior"])
    g_out = te._port_grads(port, named, torch.sum(out * torch.from_numpy(weights).to(dtype)))
    g_kl = te._port_grads(port, named, kl)
    return {n: g.double().numpy() for n, g in g_out.items()}, \
        {n: g.double().numpy() for n, g in g_kl.items()}


def readings(calls):
    """Per part, per leaf (largest entry over the part's largest; port f32,
    JAX f32 and port f32 against JAX, each as max |d| over the leaf's
    largest entry of the f64 gradient or of the JAX one) on tiny ALBERT
    with ``calls`` calls of its layer, at the JAX package's draws."""
    bundle, bmodel, bp, port = convert_pair("albert-base-v2",
                                            layers={"num_hidden_layers": calls})
    batch = inputs_of(family_batch(bundle, Bn=B, Ln=L))
    key = jax.random.key(11)
    weights = np.random.default_rng(3).normal(size=(te.S, B, 2)).astype(np.float32)
    _, _, jg_out, jg_kl = te._jax_run(bmodel, bp, key, "naive", batch, jnp.asarray(weights))
    hook = te._hook(bmodel, key, "naive")
    p32 = naive_grads(port, batch, hook, weights, torch.float32)
    with port_f64(port):
        p64 = naive_grads(port, batch, hook, weights, torch.float64)
    out = {}
    for part, jg, g32, g64 in (("logits", jg_out, p32[0], p64[0]), ("kl", jg_kl, p32[1], p64[1])):
        jax_g = {n: te._jax_grad(jg, n).astype(np.float64) for n in g32}
        top = max(np.abs(w).max() for w in jax_g.values())
        out[part] = {n: (np.abs(jax_g[n]).max() / top,
                         np.abs(g32[n] - g64[n]).max() / np.abs(g64[n]).max(),
                         np.abs(jax_g[n] - g64[n]).max() / np.abs(g64[n]).max(),
                         np.abs(g32[n] - jax_g[n]).max() / np.abs(jax_g[n]).max())
                     for n in g32}
    return out


def test_naive_on_albert_matches_jax():
    """``check_against_jax`` on the naive tier over ALBERT's shared layer,
    the near-zero leaves at ``NEAR_ZERO``."""
    bundle, bmodel, bp, port = convert_pair("albert-base-v2")
    batch = inputs_of(family_batch(bundle, Bn=B, Ln=L))
    check_against_jax(("frozen-moped", bmodel, bp, port), "naive", batch, (B, 2),
                      small=NEAR_ZERO)


@pytest.mark.parametrize("calls", [1, 2])
def test_naive_on_albert_f64_witness(calls):
    """Both f32 sides against the port's f64 gradients: each leaf at or
    above ``NEAR_ZERO[0]`` of its part's largest within 1e-5 of its own
    largest entry, each near-zero leaf within ``NEAR_ZERO[1]`` (the leaves
    under ``check_against_jax``'s 1e-6 vanish and are not compared)."""
    for part, leaves in readings(calls).items():
        for n, (share, port32, jax32, _) in leaves.items():
            if share <= 1e-6:
                continue
            bound = NEAR_ZERO[1] if share < NEAR_ZERO[0] else 1e-5
            assert port32 <= bound and jax32 <= bound, (part, n, share, port32, jax32)


if __name__ == "__main__":
    torch.set_num_threads(1)
    for calls in (1, 2):
        for part, leaves in readings(calls).items():
            rows = sorted(leaves.items(), key=lambda kv: -kv[1][3])[:6]
            print(f"{calls} call(s), {part} part: leaf share, port32-f64, jax32-f64, "
                  "port32-jax32")
            for n, (share, a, b, c) in rows:
                print(f"  {share:.3e} {a:.3e} {b:.3e} {c:.3e} {n}")
