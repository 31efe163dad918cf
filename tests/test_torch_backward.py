"""The backward of the port's Bayesian linear op, on the CPU in f32.

The plain reduce and ``finalize`` against the JAX package's
``_xla_reduce_anti`` and ``finalize``; the explicit backward of
``BayesLinearAnti`` against torch autograd through ``bayes_linear_plain``
and against ``jax.vjp`` of the JAX package's ``bayes_linear(antithetic=True,
prior_on_mu=True)`` at the same eps; the CUDA wrapper's checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu.ops import common as jcommon
from bayeformers_tpu.ops import fused_backward as jfb
from bayeformers_tpu.ops import fused_linear as jfl
from bayeformers_tpu.ops import sampled_linear as jsl
from bayeformers_tpu_torch.core.init import moped_rho
from bayeformers_tpu_torch.ops import fused_backward as fb
from bayeformers_tpu_torch.ops import fused_linear as fl

SHAPES = [(4, 16, 64, 48), (2, 5, 300, 2), (6, 8, 256, 130)]


def _inputs(S, M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, M, K)).astype(np.float32)
    mu = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    mu[0, 0] = 0.0  # moped's -inf patch: rho = 0 exactly
    rho = moped_rho(torch.from_numpy(mu), 0.05).numpy()
    g = rng.standard_normal((S, M, N)).astype(np.float32)
    g_q = rng.standard_normal(S).astype(np.float32)
    g_p = rng.standard_normal(S).astype(np.float32)
    return x, mu, rho, g, g_q, g_p


def _pair_w(mu, rho, eps):
    w_half = mu[None] + np.logaddexp(rho, 0.0)[None] * eps
    return np.stack([w_half, 2 * mu[None] - w_half], 1).reshape(
        (-1,) + mu.shape).astype(np.float32)


@pytest.mark.parametrize("S,M,K,N", SHAPES)
def test_reduce_and_finalize_match_jax(S, M, K, N):
    x, mu, rho, g, g_q, g_p = _inputs(S, M, K, N)
    eps = np.random.default_rng(1).standard_normal((S // 2, K, N)).astype(np.float32)
    w = _pair_w(mu, rho, eps)
    ja, jb, _, jv = jfb._xla_reduce_anti(*(jnp.asarray(a) for a in (x, g, w, mu, g_p)),
                                         None)
    t = torch.from_numpy
    a, b, v = fb.reduce_abuv_anti(t(x), t(g), t(w), t(mu), t(g_p))
    # f32 sums over M and the pairs in another order: 1e-5 of each
    # accumulator's largest entry
    for got, want in ((a, ja), (b, jb), (v, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    jdmu, jdrho, _ = jfb.finalize(("gaussian_on_mu",), ja, jb, None, jv,
                                  jnp.asarray(mu), jnp.asarray(rho), jnp.asarray(mu),
                                  jnp.asarray(g_q), jnp.asarray(g_p))
    dmu, drho = fb.finalize(*(t(np.array(a)) for a in (ja, jb, jv)), t(rho), t(g_q))
    # the same elementwise algebra on the same accumulators
    np.testing.assert_allclose(dmu.numpy(), np.asarray(jdmu), rtol=1e-6)
    np.testing.assert_allclose(drho.numpy(), np.asarray(jdrho), rtol=1e-5, atol=1e-6)


def _port_grads(fn, x, mu, rho, g, g_q, g_p):
    xt, mut, rhot = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, mu, rho))
    y, lq, lp = fn(xt, mut, rhot)
    torch.autograd.backward((y, lq, lp), tuple(map(torch.from_numpy, (g, g_q, g_p))))
    return y.detach(), (xt.grad, mut.grad, rhot.grad)


@pytest.mark.parametrize("S,M,K,N", SHAPES)
def test_backward_matches_autograd(S, M, K, N):
    """Against autograd of the plain forward, at sigma ~ 0.05: autograd
    differentiates log q and log p through (w - mu) / sigma, whose terms of
    size eps / sigma cancel, so at MOPED's sigma ~ 1e-3 (and far below it
    for small weights) its dmu and drho carry that cancellation error; the
    explicit backward reads W - mu = sigma eps, as the reference does."""
    x, mu, _, g, g_q, g_p = _inputs(S, M, K, N, seed=4)
    rho = np.random.default_rng(5).normal(-3.0, 0.5, mu.shape).astype(np.float32)
    eps = torch.from_numpy(
        np.random.default_rng(6).standard_normal((S // 2, K, N)).astype(np.float32))
    _, got = _port_grads(lambda a, b, c: fl.bayes_linear(a, b, c, None, eps=eps),
                         x, mu, rho, g, g_q, g_p)
    _, want = _port_grads(lambda a, b, c: fl.bayes_linear_plain(a, b, c, eps=eps),
                          x, mu, rho, g, g_q, g_p)
    for name, a, b in zip(("dx", "dmu", "drho"), got, want):
        # the same products summed in another order
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * b.abs().max().item(), err_msg=name)


@pytest.mark.parametrize("S,M,K,N", SHAPES)
def test_backward_matches_jax_vjp(S, M, K, N):
    """Against the JAX package's custom VJP at the same draw, MOPED sigma."""
    x, mu, rho, g, g_q, g_p = _inputs(S, M, K, N, seed=2)
    seeds = jcommon.seed_from_key(jax.random.split(jax.random.key(S + K), S // 2))
    eps = torch.from_numpy(np.array(jsl.naive_eps(seeds, (K, N))))

    def jfn(x, mu, rho):
        return jfl.bayes_linear(x, mu, rho, seeds, prior_on_mu=True, antithetic=True)

    jout, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(mu), jnp.asarray(rho))
    want = vjp((jnp.asarray(g), jnp.asarray(g_q), jnp.asarray(g_p)))
    y, got = _port_grads(lambda a, b, c: fl.bayes_linear(a, b, c, None, eps=eps),
                         x, mu, rho, g, g_q, g_p)
    np.testing.assert_allclose(y.numpy(), np.asarray(jout[0]), atol=1e-5)
    for name, a, b in zip(("dx", "dmu", "drho"), got, want):
        # both explicit backwards, f32 sums in another order
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_backward_returns_only_what_is_asked():
    x, mu, rho, g, g_q, g_p = _inputs(2, 4, 8, 8, seed=3)
    t = torch.from_numpy
    xt, rhot = t(x).requires_grad_(), t(rho).requires_grad_()
    y, lq, lp = fl.bayes_linear(xt, t(mu), rhot, torch.tensor([5], dtype=torch.int32))
    (y.sum() + lq.sum()).backward()
    assert xt.grad is not None and rhot.grad is not None
    assert isinstance(y.grad_fn, fl.BayesLinearAnti._backward_cls)
    # without gradients the op keeps no residual and no graph
    with torch.no_grad():
        y2, _, _ = fl.bayes_linear(xt, t(mu), rhot, torch.tensor([5], dtype=torch.int32))
    assert y2.grad_fn is None
    torch.testing.assert_close(y2, y.detach(), rtol=0, atol=0)


def test_other_priors_raise():
    x, mu, rho, g, _, g_p = _inputs(2, 4, 8, 8)
    t = torch.from_numpy
    w = t(_pair_w(mu, rho, np.zeros((1, 8, 8), np.float32)))
    with pytest.raises(NotImplementedError, match="other priors"):
        fb.reduce_abuv_anti(t(x), t(g), w, t(mu), t(g_p), mixture=(0.5, 1.0, 0.1))
    with pytest.raises(NotImplementedError):
        fb.reduce_abuv_anti(t(x), t(g), w, t(mu), t(g_p), want_u=True)


def test_kernel_wrapper_takes_no_cpu_tensor():
    x, mu, rho, g, _, g_p = _inputs(2, 4, 8, 8)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    w = bf(_pair_w(mu, rho, np.zeros((1, 8, 8), np.float32)))
    before = fb.LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA tensor"):
        fb.reduce_abuv_anti_cuda(bf(x), bf(g), w, torch.from_numpy(mu),
                                 torch.from_numpy(g_p))
    # on the CPU the wrapper takes the plain version and launches nothing
    a = fb.reduce_abuv_anti(bf(x), bf(g), w, torch.from_numpy(mu), torch.from_numpy(g_p))
    b = fb.reduce_abuv_anti_plain(bf(x), bf(g), w, torch.from_numpy(mu),
                                  torch.from_numpy(g_p))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert fb.LAUNCHES.count == before
