"""The port's Bayesian linear op (plain version) against the JAX package's
``ops/fused_linear.py::_naive_from_w`` fed the same W (antithetic pairs and
independent draws), and the wrapper's dispatch rules."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu.ops import fused_linear as jfl
from bayeformers_tpu_torch.core.init import moped_rho
from bayeformers_tpu_torch.ops import fused_linear as fl
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

PRIOR = ("gaussian_on_mu",)


def _inputs(S, M, K, N, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, M, K)).astype(np.float32)
    mu = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    mu[0, 0] = 0.0  # moped's -inf patch: sigma = softplus(0)
    rho = moped_rho(torch.from_numpy(mu), 0.05).numpy()
    eps = rng.standard_normal((S // 2, K, N)).astype(np.float32)
    return x, mu, rho, eps


def _jax_w(mu, rho, eps):
    w_half = jnp.asarray(mu)[None] + jax.nn.softplus(jnp.asarray(rho))[None] * jnp.asarray(eps)
    return jfl.interleave_antithetic(w_half, jnp.asarray(mu))


def _logprobs64(w, mu, rho):
    """log_q, log_p of each sample of W, summed in float64."""
    w, mu, rho = (np.asarray(a, np.float64) for a in (w, mu, rho))
    sig = np.logaddexp(rho, 0.0)
    e = (w - mu) / sig
    lq = np.sum(-0.5 * np.log(2 * np.pi) - np.log(sig) - 0.5 * e * e, axis=(1, 2))
    sp = np.log1p(np.e)
    z = (w - mu) / sp
    lp = np.sum(-0.5 * np.log(2 * np.pi) - np.log(sp) - 0.5 * z * z, axis=(1, 2))
    return lq, lp


@pytest.mark.parametrize("S,M,K,N", [(4, 16, 64, 48), (2, 5, 300, 2), (6, 8, 256, 130)])
def test_plain_matches_jax_naive_from_w(S, M, K, N):
    x, mu, rho, eps = _inputs(S, M, K, N)
    w = _jax_w(mu, rho, eps)
    jy, jq, jp = jfl._naive_from_w(jnp.asarray(x), w, jnp.asarray(mu),
                                   jnp.asarray(rho), jnp.asarray(mu), PRIOR)
    t = torch.from_numpy
    # the same interleaved W fed to both
    w_np = np.array(w)
    y, lq, lp = fl.bayes_linear_plain(t(x), t(mu), t(rho), w=t(w_np))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    # the port's f32 sums against float64 sums of the same terms
    q64, p64 = _logprobs64(w_np, mu, rho)
    np.testing.assert_allclose(lq.numpy(), q64, rtol=1e-6)
    np.testing.assert_allclose(lp.numpy(), p64, rtol=1e-6)
    # against JAX: XLA's CPU reduction of the K*N f32 terms is off a float64
    # sum by up to ~1e-5 relative (8.8e-6 measured at K*N = 3072)
    np.testing.assert_allclose(lq.numpy(), np.asarray(jq), rtol=2e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jp), rtol=2e-5)
    # the port's own W from the same eps: softplus form and 2 mu - w pairing
    y2, lq2, lp2 = fl.bayes_linear_plain(t(x), t(mu), t(rho), eps=t(eps),
                                         antithetic=True)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(lq2.numpy(), q64, rtol=1e-6)
    np.testing.assert_allclose(lp2.numpy(), p64, rtol=1e-6)


def test_plain_bf16_matches_jax():
    x, mu, rho, eps = _inputs(4, 16, 128, 64, seed=2)
    w = _jax_w(mu, rho, eps)
    jy, jq, _ = jfl._naive_from_w(jnp.asarray(x, jnp.bfloat16), w, jnp.asarray(mu),
                                  jnp.asarray(rho), jnp.asarray(mu), PRIOR)
    t = torch.from_numpy
    y, lq, _ = fl.bayes_linear_plain(t(x).to(torch.bfloat16), t(mu), t(rho), eps=t(eps),
                                     antithetic=True)
    assert y.dtype == torch.bfloat16
    # bf16 dot operands with f32 accumulation, one bf16 rounding of y
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(lq.numpy(), np.asarray(jq), rtol=2e-5)


def test_wrapper_on_cpu_is_the_plain_version():
    x, mu, rho, _ = _inputs(4, 8, 256, 128, seed=3)
    t = torch.from_numpy
    seeds = torch.tensor([11, 12], dtype=torch.int32)
    before = fl.LAUNCHES.count, fl.INDEP_LAUNCHES.count
    out = fl.bayes_linear_with_w(t(x), t(mu), t(rho), seeds, antithetic=True)
    ref = fl.bayes_linear_plain(t(x), t(mu), t(rho), seeds, antithetic=True,
                                save_weights=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    three = fl.bayes_linear(t(x), t(mu), t(rho), seeds, prior_on_mu=True,
                            antithetic=True)
    assert len(three) == 3 and all(torch.equal(a, b) for a, b in zip(three, ref))
    assert (fl.LAUNCHES.count, fl.INDEP_LAUNCHES.count) == before  # no kernel ran
    w = out[3]
    assert w.shape == (4, 256, 128)
    torch.testing.assert_close(w[1], (2 * t(mu) - w[0]).to(w.dtype), rtol=1e-6, atol=1e-6)
    # independent draws: sample s of seed seeds4[s] is what pair 0 of the
    # same seed draws first
    seeds4 = torch.tensor([11, 12, 13, 14], dtype=torch.int32)
    wi = fl.bayes_linear_with_w(t(x), t(mu), t(rho), seeds4)[3]
    assert torch.equal(wi[0], w[0]) and torch.equal(wi[1], out[3][2])


def test_other_estimators_raise():
    """The op takes each of the reference's three priors, exactly one at a
    time: none, or two, raise, as in the reference; the mixture and a
    separate ``prior_mu`` run (their log-priors differ from the one on mu).
    The regenerating backward (``save_weights=False`` under autograd) runs
    ``BayesLinearRegen``; the tensor-parallel unit offsets (0, 0) are the
    whole layer's draw."""
    x, mu, rho, _ = _inputs(2, 4, 8, 8)
    t = torch.from_numpy
    seeds = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly one"):
        fl.bayes_linear(t(x), t(mu), t(rho), seeds)  # the reference's default
    with pytest.raises(ValueError, match="exactly one"):
        fl.bayes_linear(t(x), t(mu), t(rho), seeds, prior_mu=t(mu), prior_on_mu=True)
    on_mu = fl.bayes_linear(t(x), t(mu), t(rho), seeds, prior_on_mu=True)
    at_zero = fl.bayes_linear(t(x), t(mu), t(rho), seeds, prior_on_mu=True,
                              unit_offsets=(0, 0))
    assert all(torch.equal(a, b) for a, b in zip(at_zero, on_mu))
    mix = fl.bayes_linear(t(x), t(mu), t(rho), seeds, mixture=(0.5, 1.0, 0.0025))
    moved = fl.bayes_linear(t(x), t(mu), t(rho), seeds, prior_mu=t(mu) + 0.5)
    for out in (mix, moved):
        assert torch.equal(out[0], on_mu[0]) and torch.equal(out[1], on_mu[1])
        assert not torch.allclose(out[2], on_mu[2])
    y, _, _ = fl.bayes_linear(t(x).requires_grad_(), t(mu), t(rho), seeds,
                              prior_on_mu=True, save_weights=False)
    assert isinstance(y.grad_fn, fl.BayesLinearRegen._backward_cls)


def test_kernel_wrapper_takes_no_cpu_tensor():
    x, mu, rho, _ = _inputs(2, 4, 8, 8)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.bayes_linear_cuda(t(x).to(torch.bfloat16), t(mu), t(rho),
                             torch.tensor([1], dtype=torch.int32), antithetic=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.bayes_linear_cuda(t(x).to(torch.bfloat16), t(mu), t(rho),
                             torch.tensor([1, 2], dtype=torch.int32))


@pytest.mark.parametrize("S,M,K,N", [(3, 16, 64, 48), (2, 5, 300, 2), (5, 8, 256, 130)])
def test_independent_plain_matches_jax_naive_from_w(S, M, K, N):
    """Independent draws (one eps per sample) against ``_naive_from_w`` at
    W = mu + softplus(rho) eps, for the ``gaussian_on_mu`` prior."""
    x, mu, rho, _ = _inputs(S, M, K, N, seed=5)
    eps = np.random.default_rng(6).standard_normal((S, K, N)).astype(np.float32)
    w = jnp.asarray(mu)[None] + jax.nn.softplus(jnp.asarray(rho))[None] * jnp.asarray(eps)
    jy, jq, jp = jfl._naive_from_w(jnp.asarray(x), w, jnp.asarray(mu),
                                   jnp.asarray(rho), jnp.asarray(mu), PRIOR)
    t = torch.from_numpy
    y, lq, lp = fl.bayes_linear(t(x), t(mu), t(rho), None, prior_on_mu=True,
                                eps=t(eps))
    # f32 products and sums of the same terms in another order
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    # XLA's CPU reduction of the K*N f32 terms (see above): 2e-5 relative
    np.testing.assert_allclose(lq.numpy(), np.asarray(jq), rtol=2e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jp), rtol=2e-5)
    # log-probs now differ per sample
    assert len(set(lq.tolist())) == S


def test_signature_matches_reference():
    """``bayes_linear`` keeps the reference's parameters, order and defaults,
    the tensor-parallel ``unit_offsets`` included; the port adds only
    ``plain`` and ``eps``."""
    ref = inspect.signature(jfl.bayes_linear).parameters
    got = inspect.signature(fl.bayes_linear).parameters
    names = list(ref)
    assert list(got)[:len(names)] == names
    for n in names:
        assert got[n].default == ref[n].default, n
        assert got[n].kind == ref[n].kind, n
    assert list(got)[len(names):] == ["plain", "eps"]
