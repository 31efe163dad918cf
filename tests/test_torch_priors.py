"""The port's other two priors at op level, on the CPU, against the JAX
package: the scale mixture (random init, the reference's default
conversion) and the Gaussian prior on a separate ``prior_mu`` (MOPED with a
trainable mu).

The mixture's elementwise log-density and score; ``core/``'s remainder
(``gaussian_log_prob``, ``moped_prior_log_prob``, ``UniformInit``); the
forward ``bayes_linear(mixture=...)`` / ``bayes_linear(prior_mu=...)``
under both estimators in f32 and bf16 against the JAX package's
``bayes_linear``; the reduces with U and ``finalize`` against
``_xla_reduce(_anti)`` and ``finalize``; and the saved and regenerating
VJPs, ``dmu`` included, against ``jax.vjp`` of the JAX op. The draw: the
JAX package's own regenerated W on the CPU gives ``eps = (W - mu) /
sigma``, which the port takes as its injected ``eps``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu.core import distributions as jdist
from bayeformers_tpu.core import init as jinit
from bayeformers_tpu.core import prior as jprior
from bayeformers_tpu.ops import common as jcommon
from bayeformers_tpu.ops import fused_backward as jfb
from bayeformers_tpu.ops import fused_linear as jfl
from bayeformers_tpu.ops import logprob as jlp
from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.core import init as init_lib
from bayeformers_tpu_torch.core import prior as prior_lib
from bayeformers_tpu_torch.ops import fused_backward as fb
from bayeformers_tpu_torch.ops import fused_linear as fl
from bayeformers_tpu_torch.ops import logprob
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

MIX = (0.5, 1.0, math.exp(-6.0))
PRIORS = ["mixture", "gaussian"]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(S, M, K, N, prior, seed=0):
    """x, mu, rho and the cotangents; the mixture's mu and rho from the
    uniform init's ranges, the Gaussian prior's from MOPED with a prior_mu
    that mu has moved away from (as training moves it)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, M, K)).astype(np.float32)
    if prior == "mixture":
        mu = rng.uniform(-0.2, 0.2, (K, N)).astype(np.float32)
        rho = rng.uniform(-5.0, -4.0, (K, N)).astype(np.float32)
        pmu = None
    else:
        pmu = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
        pmu[0, 0] = 0.0
        rho = init_lib.moped_rho(torch.from_numpy(pmu), 0.05).numpy()
        mu = (pmu + rng.standard_normal((K, N)) * 0.01).astype(np.float32)
    g = rng.standard_normal((S, M, N)).astype(np.float32)
    g_q = rng.standard_normal(S).astype(np.float32)
    g_p = rng.standard_normal(S).astype(np.float32)
    return x, mu, rho, pmu, g, g_q, g_p


def _jax_prior(prior, pmu):
    return {"mixture": MIX} if prior == "mixture" else {"prior_mu": jnp.asarray(pmu)}


def _port_prior(prior, pmu):
    return {"mixture": MIX} if prior == "mixture" else {"prior_mu": torch.from_numpy(pmu)}


def _draw(mu, rho, n, salt):
    """The JAX package's W for ``n`` seeds on the CPU and the eps it
    implies, ``(W - mu) / sigma`` (float64, then f32)."""
    seeds = jcommon.seed_from_key(jax.random.split(jax.random.key(salt), n))
    jw = np.asarray(jfl.regenerate_weights(jnp.asarray(mu), jnp.asarray(rho), seeds))
    sig = np.logaddexp(rho.astype(np.float64), 0.0)
    eps = (jw.astype(np.float64) - mu) / sig
    return seeds, torch.from_numpy(eps.astype(np.float32))


def test_mixture_terms_match_jax():
    """The elementwise log-density and score, also where the narrow
    component's pdf underflows (|w| up to 1: exponents near -8e4)."""
    w = np.concatenate([np.linspace(-1.0, 1.0, 4001),
                        np.linspace(-0.02, 0.02, 2001)]).astype(np.float32)
    tw = torch.from_numpy(w)
    lp = logprob.mixture_log_pdf(tw, *MIX).numpy()
    np.testing.assert_allclose(lp, np.asarray(jlp._mixture_log_pdf(jnp.asarray(w), *MIX)),
                               rtol=1e-6, atol=1e-6)
    sc = logprob.mixture_score(tw, *MIX).numpy()
    jsc = np.asarray(jlp._mixture_score(jnp.asarray(w), *MIX))
    # the responsibility is steep where the components cross: one ulp of its
    # exponent moves the score by ~1e-6 of its size
    np.testing.assert_allclose(sc, jsc, rtol=1e-5, atol=1e-5 * np.abs(jsc).max())
    assert np.isfinite(lp).all() and np.isfinite(sc).all()
    # the score is the log-density's derivative (central differences in f64)
    w64 = torch.linspace(-0.05, 0.05, 101, dtype=torch.float64)
    h = 1e-7
    fd = (logprob.mixture_log_pdf(w64 + h, *MIX) - logprob.mixture_log_pdf(w64 - h, *MIX)) / (2 * h)
    np.testing.assert_allclose(logprob.mixture_score(w64, *MIX).numpy(), fd.numpy(),
                               rtol=1e-5, atol=1e-3)


def test_core_remainder_matches_jax():
    rng = np.random.default_rng(1)
    w, mu = (rng.standard_normal((64, 32)).astype(np.float32) * 0.1 for _ in range(2))
    sig = rng.uniform(0.01, 2.0, (64, 32)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        dist.gaussian_log_prob(t(w), t(mu), t(sig)).item(),
        float(jdist.gaussian_log_prob(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sig))),
        rtol=1e-6)
    np.testing.assert_allclose(
        prior_lib.moped_prior_log_prob(t(w), t(mu)).item(),
        float(jprior.moped_prior_log_prob(jnp.asarray(w), jnp.asarray(mu))), rtol=1e-6)
    assert init_lib.DEFAULT_UNIFORM == init_lib.UniformInit()
    assert (init_lib.DEFAULT_UNIFORM.mu_range, init_lib.DEFAULT_UNIFORM.rho_range) == (
        jinit.DEFAULT_UNIFORM.mu_range, jinit.DEFAULT_UNIFORM.rho_range)
    # summed over a dim: each slice's total, as the op's per-sample log_p
    ws = t(np.stack([w, mu]))
    per = prior_lib.moped_prior_log_prob(ws, t(sig), dim=(1, 2))
    for i, wi in enumerate((w, mu)):
        np.testing.assert_allclose(
            per[i].item(), prior_lib.moped_prior_log_prob(t(wi), t(sig)).item(), rtol=1e-6)


def test_prior_resolution():
    """One prior tuple per call: the forward's keywords (the entry points'
    default is the prior on mu, ``bayes_linear`` names one), the reduce's
    ``(mixture, want_u)`` and back, and the log-prior of each."""
    pm = torch.zeros(3, 2)
    assert logprob.prior_of() == logprob.ON_MU
    assert logprob.prior_of(prior_on_mu=True) == logprob.ON_MU
    assert logprob.prior_of(prior_mu=pm) == logprob.GAUSSIAN
    assert logprob.prior_of(mixture=MIX) == ("mixture",) + MIX
    for bad in ({}, {"prior_mu": pm, "mixture": MIX}, {"prior_mu": pm, "prior_on_mu": True}):
        with pytest.raises(ValueError, match="exactly one"):
            logprob.prior_of(**dict({"prior_on_mu": False}, **bad))
    for prior in (logprob.ON_MU, logprob.GAUSSIAN, ("mixture",) + MIX):
        assert logprob.reduce_prior(**logprob.reduce_keywords(prior)) == prior
    with pytest.raises(ValueError, match="want_u"):
        logprob.reduce_prior(MIX, want_u=False)
    w = torch.randn(4, 3, 2, dtype=torch.float64) * 0.1
    np.testing.assert_allclose(
        logprob.prior_log_prob(w, None, ("mixture",) + MIX, dim=(1, 2)).numpy(),
        [prior_lib.DEFAULT_SCALE_MIXTURE.log_prob(wi).item() for wi in w], rtol=1e-12)
    np.testing.assert_allclose(
        logprob.prior_log_prob(w, pm, logprob.GAUSSIAN, dim=-1).numpy(),
        prior_lib.moped_prior_log_prob(w, pm.double(), dim=-1).numpy(), rtol=1e-12)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "fused"])
@pytest.mark.parametrize("prior", PRIORS)
def test_forward_matches_jax(prior, antithetic, dtype):
    """``bayes_linear`` under each prior against the JAX op at the same
    draw: y to 1e-5 in f32 (one bf16 step of max |y| in bf16), both
    log-probs to 2e-5 relative (XLA's CPU sums of the K N f32 terms),
    taken at the f32 W in either dtype; a pair shares log_q, and under the
    mixture each member has its own log_p."""
    tdt, jdt = DTYPES[dtype]
    S, M, K, N = 4, 6, 300, 130
    x, mu, rho, pmu, *_ = _inputs(S, M, K, N, prior, seed=2 + antithetic)
    seeds, eps = _draw(mu, rho, S // 2 if antithetic else S, K + antithetic)
    jy, jq, jp = jfl.bayes_linear(jnp.asarray(x, jdt), jnp.asarray(mu), jnp.asarray(rho),
                                  seeds, antithetic=antithetic, **_jax_prior(prior, pmu))
    t = torch.from_numpy
    y, lq, lp = fl.bayes_linear(t(x).to(tdt), t(mu), t(rho), None, antithetic=antithetic,
                                eps=eps, **_port_prior(prior, pmu))
    jy = np.asarray(jy, np.float32)
    atol = 1e-5 if dtype == "f32" else 2.0 ** -7 * np.abs(jy).max()
    np.testing.assert_allclose(y.float().numpy(), jy, atol=atol)
    np.testing.assert_allclose(lq.numpy(), np.asarray(jq), rtol=2e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jp), rtol=2e-5)
    if antithetic:
        assert lq[0] == lq[1]
        if prior == "mixture":  # each member's own log_p
            assert lp[0] != lp[1]


@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "fused"])
@pytest.mark.parametrize("prior", PRIORS)
def test_reduce_and_finalize_match_jax(prior, antithetic):
    """The plain reduces with U (and the mixture's score sums) against
    ``_xla_reduce(_anti)``, then ``finalize``'s branch against the
    reference's on the same accumulators."""
    S, M, K, N = 4, 16, 64, 48
    x, mu, rho, pmu, g, g_q, g_p = _inputs(S, M, K, N, prior, seed=4)
    _, eps = _draw(mu, rho, S // 2 if antithetic else S, 7)
    w = fl.sample_weights(torch.from_numpy(mu), torch.from_numpy(rho), eps=eps,
                          antithetic=antithetic).numpy()
    mix = MIX if prior == "mixture" else None
    jred = jfb._xla_reduce_anti if antithetic else jfb._xla_reduce
    red = fb.reduce_abuv_anti if antithetic else fb.reduce_abuv
    want = jred(*(jnp.asarray(a) for a in (x, g, w, mu, g_p)), mix)
    t = torch.from_numpy
    got = red(t(x), t(g), t(w), t(mu), t(g_p), mixture=mix, want_u=True)
    for name, a, b in zip("ABUV", got, want):
        # f32 sums over M and the samples in another order: 1e-5 of each
        # accumulator's largest entry
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
    jprior_t = ("mixture",) + MIX if prior == "mixture" else ("gaussian",)
    pm = pmu if prior == "gaussian" else mu
    jdmu, jdrho, _ = jfb.finalize(jprior_t, *want, jnp.asarray(mu), jnp.asarray(rho),
                                  jnp.asarray(pm), jnp.asarray(g_q), jnp.asarray(g_p))
    a, b, u, v = (t(np.array(z)) for z in want)
    dmu, drho = fb.finalize(a, b, v, t(rho), t(g_q), u, prior=logprob.prior_of(
        mix, t(pm) if prior == "gaussian" else None), mu=t(mu), prior_mu=t(pm), g_p=t(g_p))
    # the same elementwise algebra on the same accumulators
    np.testing.assert_allclose(dmu.numpy(), np.asarray(jdmu), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(jdmu)).max())
    np.testing.assert_allclose(drho.numpy(), np.asarray(jdrho), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(jdrho)).max())


VJPS = [  # (dtype, save_weights, tolerance of dmu and drho)
    ("f32", True, 1e-4),
    ("f32", False, 1e-4),
    # the port keeps a bf16 W residual, the JAX package's CPU path an f32
    # one: the reduce's W - mu and the mixture's score carry the residual's
    # rounding (ROADMAP queue 3, "bf16 W residuals")
    ("bf16", True, 2e-2),
]


@pytest.mark.parametrize("dtype,save_weights,tol", VJPS)
@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "fused"])
@pytest.mark.parametrize("prior", PRIORS)
def test_vjp_matches_jax(prior, antithetic, dtype, save_weights, tol):
    """The saved-residual and the regenerating VJP against ``jax.vjp`` of
    the JAX op with a trainable mu: dx, dmu and drho within ``tol`` of each
    leaf's largest entry (dx always 1e-4); no gradient reaches prior_mu."""
    tdt, jdt = DTYPES[dtype]
    S, M, K, N = 4, 5, 300, 130
    x, mu, rho, pmu, g, g_q, g_p = _inputs(S, M, K, N, prior, seed=9 + antithetic)
    seeds, eps = _draw(mu, rho, S // 2 if antithetic else S, 11 + antithetic)

    def jfn(x, mu, rho):
        return jfl.bayes_linear(x, mu, rho, seeds, antithetic=antithetic,
                                save_weights=save_weights, **_jax_prior(prior, pmu))

    _, vjp = jax.vjp(jfn, jnp.asarray(x, jdt), jnp.asarray(mu), jnp.asarray(rho))
    want = vjp((jnp.asarray(g, jdt), jnp.asarray(g_q), jnp.asarray(g_p)))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    mut, rhot = (torch.from_numpy(a.copy()).requires_grad_() for a in (mu, rho))
    pkw = _port_prior(prior, pmu)
    y, lq, lp = fl.bayes_linear(xt, mut, rhot, None, antithetic=antithetic,
                                save_weights=save_weights, eps=eps, **pkw)
    cls = fl.BayesLinear if save_weights else fl.BayesLinearRegen
    assert isinstance(y.grad_fn, cls._backward_cls)
    torch.autograd.backward((y, lq, lp), (torch.from_numpy(g).to(tdt),
                                          torch.from_numpy(g_q), torch.from_numpy(g_p)))
    for name, a, b, t_ in zip(("dx", "dmu", "drho"), (xt.grad, mut.grad, rhot.grad),
                              want, (1e-4, tol, tol)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=t_, atol=t_ * np.abs(b).max(),
                                   err_msg=name)
    if "prior_mu" in pkw:
        assert pkw["prior_mu"].grad is None
