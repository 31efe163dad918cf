"""The tensor-parallel unit offsets of the Bayesian linear op
(``bayes_linear(unit_offsets=)``): a (K, N) weight that is the shard at
element offsets (k0, n0) of a larger layer draws exactly that slice of the
whole layer's noise. Held on the CPU for the port's plain path and, in the
same tests, for the JAX package's ``bayes_linear(unit_offsets=)``: column
shards give the column slice of the whole layer's y, row shards' y and
log-probs sum to the whole layer's, the regenerating backward at offsets
equals the saved one, and unaligned offsets raise. The kernels' side of the
same invariants (W bit-equal to the whole layer's slice) is held on the card
by ``chip_smoke.py``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu.ops import fused_linear as jfl
from bayeformers_tpu_torch.core.init import moped_rho
from bayeformers_tpu_torch.ops import fused_linear as fl
from bayeformers_tpu_torch.ops import sampled_linear as sl
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, M, K, N = 4, 8, 512, 256
MIXTURE = (0.5, 1.0, math.exp(-6.0))
PRIORS = ("on_mu", "gaussian", "mixture")
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# column shards of one unit strip each; row shards of one unit each
COL_SHARDS = ((0, 0), (0, 128))
ROW_SHARDS = ((0, 0), (256, 0))


def _inputs(prior, seed=0):
    """x (S, M, K), mu / rho (K, N) and the prior keywords as numpy arrays,
    and the seeds of S draws (antithetic pairs take the first S / 2)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, M, K)).astype(np.float32)
    if prior == "mixture":
        mu = rng.uniform(-0.2, 0.2, (K, N)).astype(np.float32)
        rho = rng.uniform(-5.0, -4.0, (K, N)).astype(np.float32)
    else:
        mu = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
        rho = moped_rho(torch.from_numpy(mu), 0.05).numpy()
    kw = {}
    if prior == "gaussian":
        kw["prior_mu"] = mu + 0.05 * rng.standard_normal((K, N)).astype(np.float32)
    elif prior == "mixture":
        kw["mixture"] = MIXTURE
    else:
        kw["prior_on_mu"] = True
    seeds = rng.integers(0, 2**31 - 1, S, dtype=np.int64).astype(np.int32)
    return x, mu, rho, kw, seeds


def _op(impl, dtype, x, mu, rho, kw, seeds, antithetic, offsets=None):
    """(y, log_q, log_p) as float32 numpy from the port's plain path or the
    JAX package's op, on the (sliced) numpy inputs."""
    seeds = seeds[: S // 2] if antithetic else seeds
    if impl == "port":
        t = torch.from_numpy
        tkw = {k: (t(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        out = fl.bayes_linear(t(np.ascontiguousarray(x)).to(DTYPES[dtype][0]),
                              t(np.ascontiguousarray(mu)), t(np.ascontiguousarray(rho)),
                              t(seeds), antithetic=antithetic, unit_offsets=offsets, **tkw)
        return tuple(o.float().numpy() for o in out)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    out = jfl.bayes_linear(jnp.asarray(x, DTYPES[dtype][1]), jnp.asarray(mu),
                           jnp.asarray(rho), jnp.asarray(seeds), antithetic=antithetic,
                           unit_offsets=None if offsets is None else jnp.asarray(offsets),
                           **jkw)
    return tuple(np.asarray(o, np.float32) for o in out)


def _slice_kw(kw, rows=slice(None), cols=slice(None)):
    return {k: (v[rows, cols] if isinstance(v, np.ndarray) else v) for k, v in kw.items()}


@pytest.mark.parametrize("antithetic", [True, False], ids=["anti", "indep"])
@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["port", "jax"])
def test_shards_draw_the_whole_layers_slice(impl, dtype, prior, antithetic):
    """Column shards at (0, n0) give the columns n0 .. n0 + 127 of the whole
    layer's y (1e-5 of max |y| in f32; bf16: 2e-2, one rounding of y each);
    row shards at (k0, 0), fed their rows of x, give y's that sum to the
    whole layer's, and log-probs that sum to its (2e-5 relative: the shards
    sum the same f32 terms in another order)."""
    x, mu, rho, kw, seeds = _inputs(prior)
    y, lq, lp = _op(impl, dtype, x, mu, rho, kw, seeds, antithetic)
    scale = np.abs(y).max()
    lq_sum, lp_sum = 0.0, 0.0
    for k0, n0 in COL_SHARDS:
        cols = slice(n0, n0 + 128)
        ys, lqs, lps = _op(impl, dtype, x, mu[:, cols], rho[:, cols], _slice_kw(kw, cols=cols),
                           seeds, antithetic, (k0, n0))
        if dtype == "f32":
            np.testing.assert_allclose(ys, y[..., cols], rtol=1e-5, atol=1e-5 * scale)
        else:
            np.testing.assert_allclose(ys, y[..., cols], rtol=2e-2, atol=2e-2)
        lq_sum, lp_sum = lq_sum + lqs.astype(np.float64), lp_sum + lps.astype(np.float64)
    np.testing.assert_allclose(lq_sum, lq, rtol=2e-5)
    np.testing.assert_allclose(lp_sum, lp, rtol=2e-5)
    y_sum, lq_sum, lp_sum = 0.0, 0.0, 0.0
    for k0, n0 in ROW_SHARDS:
        rows = slice(k0, k0 + 256)
        ys, lqs, lps = _op(impl, dtype, x[..., rows], mu[rows], rho[rows],
                           _slice_kw(kw, rows=rows), seeds, antithetic, (k0, n0))
        y_sum = y_sum + ys.astype(np.float64)
        lq_sum, lp_sum = lq_sum + lqs.astype(np.float64), lp_sum + lps.astype(np.float64)
    if dtype == "f32":
        np.testing.assert_allclose(y_sum, y, rtol=1e-5, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(y_sum, y, rtol=2e-2, atol=2e-2 * scale)
    np.testing.assert_allclose(lq_sum, lq, rtol=2e-5)
    np.testing.assert_allclose(lp_sum, lp, rtol=2e-5)


@pytest.mark.parametrize("antithetic", [True, False], ids=["anti", "indep"])
@pytest.mark.parametrize("prior", PRIORS)
def test_regenerating_vjp_at_offsets(prior, antithetic):
    """At a shard's offsets the regenerating VJP (``save_weights=False``,
    which redraws W at the offsets) equals the saved one (1e-6 of each
    gradient's largest entry), and both equal the whole layer's gradients
    of the same loss in the shard's rows and columns (1e-5): the log-probs
    of the whole layer are the shards' sums."""
    x, mu, rho, kw, seeds = _inputs(prior, seed=1)
    seeds = torch.from_numpy(seeds[: S // 2] if antithetic else seeds)
    rng = np.random.default_rng(2)
    g_y = torch.from_numpy(rng.standard_normal((S, M, N)).astype(np.float32))
    g_q = torch.from_numpy(rng.standard_normal(S).astype(np.float32))
    g_p = torch.from_numpy(rng.standard_normal(S).astype(np.float32))
    rows, cols = slice(256, 512), slice(128, 256)

    def grads(xs, mus, rhos, kws, g, offsets, save_weights):
        t = torch.from_numpy
        xt, mut, rhot = (t(np.ascontiguousarray(a)).requires_grad_() for a in (xs, mus, rhos))
        tkw = {k: (t(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v)
               for k, v in kws.items()}
        y, lq, lp = fl.bayes_linear(xt, mut, rhot, seeds, antithetic=antithetic,
                                    save_weights=save_weights, unit_offsets=offsets, **tkw)
        fn = fl.BayesLinearRegen if not save_weights else fl.BayesLinear
        assert isinstance(y.grad_fn, fn._backward_cls)
        loss = (y * g).sum() + (lq * g_q).sum() + (lp * g_p).sum()
        return torch.autograd.grad(loss, (xt, mut, rhot))

    shard = (x[..., rows], mu[rows, cols], rho[rows, cols], _slice_kw(kw, rows, cols),
             g_y[..., cols])
    saved = grads(*shard, (256, 128), True)
    regen = grads(*shard, (256, 128), False)
    for a, b in zip(regen, saved):
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-6 * b.abs().max().item())
    whole = grads(x, mu, rho, kw, g_y, None, False)
    # mu and rho: the shard's block of the whole layer's gradients
    for a, b in zip(regen[1:], whole[1:]):
        b = b[rows, cols]
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-5 * b.abs().max().item())
    # at other offsets the shard draws other noise: its drho moves
    other = grads(*shard, (0, 0), False)
    assert not torch.allclose(other[2], regen[2], rtol=1e-3, atol=0.0)


@pytest.mark.parametrize("offsets", [(128, 0), (0, 64), (-256, 0), (256, 130)])
def test_unaligned_offsets_raise(offsets):
    """Offsets off the (256, 128) units raise ValueError naming the units,
    on every entry point that takes them, before any draw."""
    x, mu, rho, kw, seeds = _inputs("on_mu")
    t = torch.from_numpy
    with pytest.raises(ValueError, match="256, 128"):
        fl.bayes_linear(t(x), t(mu), t(rho), t(seeds), prior_on_mu=True, unit_offsets=offsets)
    with pytest.raises(ValueError, match="256, 128"):
        fl.regenerate_weights(t(mu), t(rho), t(seeds), antithetic=True, offsets=offsets)
    with pytest.raises(ValueError, match="256, 128"):
        sl.naive_weights(t(mu), t(rho), t(seeds), offsets=offsets)


@pytest.mark.parametrize("offsets", [None, (256, 0), (0, 128), (512, 256)])
def test_pair_regeneration_plain_mirror(offsets):
    """The pair instance's plain mirror (``regenerate_weights(...,
    antithetic=True)``, what the regenerating backward reads) equals, bit
    for bit, ``interleave_antithetic`` of the independent draws, the draw
    pass's plain mirror, and the shard's slice of the whole layer's pairs
    (whose rows and columns reach past the offsets)."""
    _, mu, rho, _, seeds = _inputs("on_mu", seed=3)
    k0, n0 = offsets or (0, 0)
    t = torch.from_numpy
    big_mu = np.zeros((k0 + K, n0 + N), np.float32)
    big_rho = np.full((k0 + K, n0 + N), -5.0, np.float32)
    big_mu[k0:, n0:], big_rho[k0:, n0:] = mu, rho
    mu, rho, seeds = t(mu), t(rho), t(seeds[: S // 2])
    pair = fl.regenerate_weights(mu, rho, seeds, antithetic=True, offsets=offsets)
    assert pair.shape == (S, K, N) and pair.dtype == torch.float32
    half = fl.regenerate_weights(mu, rho, seeds, offsets=offsets)
    assert torch.equal(pair, fl.interleave_antithetic(half, mu))
    assert torch.equal(pair, fl.draw_plain(mu, rho, seeds, antithetic=True,
                                           offsets=offsets)[0])
    whole = fl.regenerate_weights(t(big_mu), t(big_rho), seeds, antithetic=True)
    assert torch.equal(pair, whole[:, k0:, n0:])
    assert not torch.equal(pair[0], pair[1])


def test_pair_kernel_wrapper_takes_no_cpu_tensor():
    """The kernel's wrapper launches for a CUDA tensor or raises: the pair
    instance at offsets too."""
    _, mu, rho, _, seeds = _inputs("on_mu")
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.regenerate_weights_cuda(t(mu), t(rho), t(seeds), antithetic=True,
                                   offsets=(256, 128), lo_dtype=torch.bfloat16)
