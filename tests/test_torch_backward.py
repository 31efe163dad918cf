"""The backward of the port's Bayesian linear op, on the CPU in f32.

The plain reduces and ``finalize`` against the JAX package's
``_xla_reduce_anti`` / ``_xla_reduce`` and ``finalize``; the explicit
backward of ``BayesLinear`` against torch autograd through
``bayes_linear_plain`` and against ``jax.vjp`` of the JAX package's
``bayes_linear(prior_on_mu=True)``, antithetic and independent, at the same
eps; the CUDA wrappers' checks.
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
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

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
    _, got = _port_grads(lambda a, b, c: fl.bayes_linear(
        a, b, c, None, prior_on_mu=True, antithetic=True, eps=eps),
        x, mu, rho, g, g_q, g_p)
    _, want = _port_grads(lambda a, b, c: fl.bayes_linear_plain(
        a, b, c, eps=eps, antithetic=True), x, mu, rho, g, g_q, g_p)
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
    y, got = _port_grads(lambda a, b, c: fl.bayes_linear(
        a, b, c, None, prior_on_mu=True, antithetic=True, eps=eps),
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
    seeds = torch.tensor([5], dtype=torch.int32)
    y, lq, lp = fl.bayes_linear(xt, t(mu), rhot, seeds, prior_on_mu=True,
                                antithetic=True)
    (y.sum() + lq.sum()).backward()
    assert xt.grad is not None and rhot.grad is not None
    assert isinstance(y.grad_fn, fl.BayesLinear._backward_cls)
    # without gradients the op keeps no residual and no graph
    with torch.no_grad():
        y2, _, _ = fl.bayes_linear(xt, t(mu), rhot, seeds, prior_on_mu=True,
                                   antithetic=True)
    assert y2.grad_fn is None
    torch.testing.assert_close(y2, y.detach(), rtol=0, atol=0)


def test_other_priors_raise():
    """The reduces take every prior: ``want_u`` adds U (four outputs), the
    mixture takes U and V of its score. What raises is the mixture without
    U, which its ``finalize`` reads."""
    x, mu, rho, g, _, g_p = _inputs(2, 4, 8, 8)
    t = torch.from_numpy
    w = t(_pair_w(mu, rho, np.zeros((1, 8, 8), np.float32)))
    with pytest.raises(ValueError, match="want_u"):
        fb.reduce_abuv_anti(t(x), t(g), w, t(mu), t(g_p), mixture=(0.5, 1.0, 0.1))
    with pytest.raises(ValueError, match="want_u"):
        fb.reduce_abuv(t(x), t(g), w, t(mu), t(g_p), mixture=(0.5, 1.0, 0.1))
    three = fb.reduce_abuv_anti(t(x), t(g), w, t(mu), t(g_p))
    four = fb.reduce_abuv_anti(t(x), t(g), w, t(mu), t(g_p), want_u=True)
    assert len(three) == 3 and len(four) == 4
    assert all(torch.equal(a, b) for a, b in zip(three, four[:2] + four[3:]))
    mix = fb.reduce_abuv(t(x), t(g), w, t(mu), t(g_p), mixture=(0.5, 1.0, 0.1),
                         want_u=True)
    assert len(mix) == 4
    assert torch.equal(mix[0], fb.reduce_abuv(t(x), t(g), w, t(mu), t(g_p))[0])


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
    # the same for the independent reduce
    before = fb.INDEP_LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA tensor"):
        fb.reduce_abuv_cuda(bf(x), bf(g), w, torch.from_numpy(mu), torch.from_numpy(g_p))
    a = fb.reduce_abuv(bf(x), bf(g), w, torch.from_numpy(mu), torch.from_numpy(g_p))
    b = fb.reduce_abuv_plain(bf(x), bf(g), w, torch.from_numpy(mu), torch.from_numpy(g_p))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert fb.INDEP_LAUNCHES.count == before


IND_SHAPES = [(3, 16, 64, 48), (2, 5, 300, 2), (5, 8, 256, 130)]


@pytest.mark.parametrize("S,M,K,N", IND_SHAPES)
def test_independent_reduce_matches_jax(S, M, K, N):
    """``reduce_abuv``'s plain version against ``_xla_reduce`` (no mixture)
    on the same independent W."""
    x, mu, rho, g, _, g_p = _inputs(S, M, K, N, seed=7)
    eps = np.random.default_rng(8).standard_normal((S, K, N)).astype(np.float32)
    w = (mu[None] + np.logaddexp(rho, 0.0)[None] * eps).astype(np.float32)
    ja, jb, _, jv = jfb._xla_reduce(*(jnp.asarray(a) for a in (x, g, w, mu, g_p)),
                                    None)
    t = torch.from_numpy
    a, b, v = fb.reduce_abuv(t(x), t(g), t(w), t(mu), t(g_p))
    # f32 sums over M and the samples in another order: 1e-5 of each
    # accumulator's largest entry
    for got, want in ((a, ja), (b, jb), (v, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("S,M,K,N", IND_SHAPES)
def test_independent_backward_matches_jax_vjp(S, M, K, N):
    """The saved-residual backward of independent draws against the JAX
    package's custom VJP (``bayes_linear(prior_on_mu=True)``, whose default
    ``save_weights=True`` takes ``_fwd_saved`` / ``_bwd_common``) at the
    same draw, MOPED sigma."""
    x, mu, rho, g, g_q, g_p = _inputs(S, M, K, N, seed=9)
    seeds = jcommon.seed_from_key(jax.random.split(jax.random.key(S + K + 1), S))
    eps = torch.from_numpy(np.array(jsl.naive_eps(seeds, (K, N))))

    def jfn(x, mu, rho):
        return jfl.bayes_linear(x, mu, rho, seeds, prior_on_mu=True)

    jout, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(mu), jnp.asarray(rho))
    want = vjp((jnp.asarray(g), jnp.asarray(g_q), jnp.asarray(g_p)))
    y, got = _port_grads(lambda a, b, c: fl.bayes_linear(
        a, b, c, None, prior_on_mu=True, eps=eps), x, mu, rho, g, g_q, g_p)
    np.testing.assert_allclose(y.numpy(), np.asarray(jout[0]), atol=1e-5)
    for name, a, b in zip(("dx", "dmu", "drho"), got, want):
        # both explicit backwards, f32 sums in another order: 1e-4 of each
        # leaf's largest entry
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)
