"""The regenerating backward of the port's Bayesian linear op, on the CPU.

``bayes_linear(save_weights=False)`` (``BayesLinearRegen``) against the JAX
package's non-saved custom VJP (``_fwd`` / ``_bwd``, ``_fwd_anti`` /
``_bwd_anti``) at the same draw, for both estimators in f32 and bf16; the
reference's f32 antithetic routing (a padded K above 2048 takes the
regenerating VJP even with ``save_weights=True``); the regenerating and the
saved VJP within the port; ``sampled_weights`` against the reference's; and
``regenerate_weights`` against the plain unit stream and the forward's W.

The draw: the JAX package's own regenerated W on the CPU
(``regenerate_weights``) gives ``eps = (W - mu) / sigma``, which the port
takes as its injected ``eps``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu.ops import common as jcommon
from bayeformers_tpu.ops import fused_linear as jfl
from bayeformers_tpu_torch.core.distributions import sigma_from_rho
from bayeformers_tpu_torch.core.init import moped_rho
from bayeformers_tpu_torch.ops import common
from bayeformers_tpu_torch.ops import fused_linear as fl
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


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


def _jax_seeds(n, salt):
    return jcommon.seed_from_key(jax.random.split(jax.random.key(salt), n))


def _eps_of_jax_w(mu, rho, seeds):
    """The JAX package's regenerated W for ``seeds`` on the CPU, and the eps
    it implies, ``(W - mu) / sigma`` (float64, then f32)."""
    jw = np.asarray(jfl.regenerate_weights(jnp.asarray(mu), jnp.asarray(rho), seeds))
    sig = np.logaddexp(rho.astype(np.float64), 0.0)
    eps = (jw.astype(np.float64) - mu) / sig
    return jw, torch.from_numpy(eps.astype(np.float32))


def _port_grads(x, mu, rho, g, g_q, g_p, dtype, **kw):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    mut, rhot = (torch.from_numpy(a.copy()).requires_grad_() for a in (mu, rho))
    y, lq, lp = fl.bayes_linear(xt, mut, rhot, None, prior_on_mu=True, **kw)
    torch.autograd.backward(
        (y, lq, lp), (torch.from_numpy(g).to(dtype), torch.from_numpy(g_q),
                      torch.from_numpy(g_p)))
    return y, (xt.grad, mut.grad, rhot.grad)


def _jax_grads(x, mu, rho, g, g_q, g_p, jdt, seeds, **kw):
    def f(x, mu, rho):
        return jfl.bayes_linear(x, mu, rho, seeds, prior_on_mu=True, **kw)

    out, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(mu), jnp.asarray(rho))
    return out[0], vjp((jnp.asarray(g, jdt), jnp.asarray(g_q), jnp.asarray(g_p)))


def _assert_grads_close(got, want, tol, drho_tol=None):
    for name, a, b in zip(("dx", "dmu", "drho"), got, want):
        t = drho_tol if name == "drho" and drho_tol else tol
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=t,
                                   atol=t * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "fused"])
@pytest.mark.parametrize("S,M,K,N", [(4, 5, 300, 130)])
def test_regen_backward_matches_jax_vjp(S, M, K, N, antithetic, dtype):
    """``save_weights=False`` against the JAX op's ``save_weights=False``:
    both rebuild W from the draw in the backward and hand the f32 W to the
    reduce; gradients within 1e-4 of each leaf's largest entry (f32 sums in
    another order; in bf16 the same products of bf16 operands)."""
    tdt, jdt = DTYPES[dtype]
    x, mu, rho, g, g_q, g_p = _inputs(S, M, K, N, seed=S + K)
    seeds = _jax_seeds(S // 2 if antithetic else S, K + N + antithetic)
    _, eps = _eps_of_jax_w(mu, rho, seeds)
    jy, want = _jax_grads(x, mu, rho, g, g_q, g_p, jdt, seeds,
                          save_weights=False, antithetic=antithetic)
    y, got = _port_grads(x, mu, rho, g, g_q, g_p, tdt, save_weights=False,
                         antithetic=antithetic, eps=eps)
    assert isinstance(y.grad_fn, fl.BayesLinearRegen._backward_cls)
    assert got[0].dtype == tdt
    # the forward at the same draw: f32 to 1e-5; bf16 within one bf16 step
    atol = 1e-5 if dtype == "f32" else 2.0 ** -7 * float(np.abs(np.asarray(jy, np.float32)).max())
    np.testing.assert_allclose(y.float().detach().numpy(), np.asarray(jy, np.float32),
                               atol=atol)
    _assert_grads_close(got, want, 1e-4)


ROUTES = [  # (K, dtype, antithetic, regenerates)
    (2560, "f32", True, True),    # Kp = 2560 > 2048: the reference's non-saved VJP
    (768, "f32", True, False),
    (2560, "bf16", True, False),  # bf16 keeps the saved VJP at any K
    (2560, "f32", False, False),  # independent draws keep it too
]


@pytest.mark.parametrize("K,dtype,antithetic,regen", ROUTES)
def test_f32_antithetic_routing(K, dtype, antithetic, regen):
    """With ``save_weights=True``, antithetic f32 layers whose padded K
    exceeds 2048 take the regenerating VJP, as the reference routes them
    (``fused_linear.py:1561``); the others keep the saved one. The route is
    asserted, and the gradients against the JAX op's (same arguments), to
    1e-4 of each leaf's largest entry. One exception: the bf16 saved VJP
    keeps a bf16 W residual, as the reference's kernel path does, while the
    JAX package's CPU path keeps f32 W; its drho then carries the bf16
    residual's noise (``fused_linear.py:253-263``), held at 2e-2."""
    tdt, jdt = DTYPES[dtype]
    S, M, N = 4, 3, 8
    x, mu, rho, g, g_q, g_p = _inputs(S, M, K, N, seed=K)
    seeds = _jax_seeds(S // 2 if antithetic else S, K + antithetic)
    _, eps = _eps_of_jax_w(mu, rho, seeds)
    assert fl.takes_regen_vjp(torch.zeros((S, M, K), dtype=tdt), antithetic,
                              save_weights=True) == regen
    y, got = _port_grads(x, mu, rho, g, g_q, g_p, tdt, save_weights=True,
                         antithetic=antithetic, eps=eps)
    want_cls = fl.BayesLinearRegen if regen else fl.BayesLinear
    assert isinstance(y.grad_fn, want_cls._backward_cls)
    _, want = _jax_grads(x, mu, rho, g, g_q, g_p, jdt, seeds, save_weights=True,
                         antithetic=antithetic)
    bf16_residual = dtype == "bf16" and not regen
    _assert_grads_close(got, want, 1e-4, drho_tol=2e-2 if bf16_residual else None)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "fused"])
def test_regen_and_saved_vjps_agree(antithetic, dtype):
    """Within the port, on one draw of the unit stream: in f32 the two VJPs
    read the same W and agree within 1e-6 of each leaf's largest entry. In
    bf16 the saved VJP reads the bf16 W residual and the regenerating one
    the f32 W: dx (W cast to bf16 either way) and dmu (no W) agree exactly,
    and drho carries the bf16 residual's noise, ~1% of its dw.eps term
    (the reference's note at ``fused_linear.py:253-263``; measured 0.7%):
    within 2e-2 of its largest entry."""
    tdt, _ = DTYPES[dtype]
    S, M, K, N = 4, 8, 300, 130
    x, mu, rho, g, g_q, g_p = _inputs(S, M, K, N, seed=11)
    seeds = torch.arange(S // 2 if antithetic else S, dtype=torch.int32) + 17
    grads = {}
    for sw in (True, False):
        xt = torch.from_numpy(x).to(tdt).requires_grad_()
        mut, rhot = (torch.from_numpy(a.copy()).requires_grad_() for a in (mu, rho))
        y, lq, lp = fl.bayes_linear(xt, mut, rhot, seeds, prior_on_mu=True,
                                    save_weights=sw, antithetic=antithetic)
        torch.autograd.backward(
            (y, lq, lp), (torch.from_numpy(g).to(tdt), torch.from_numpy(g_q),
                          torch.from_numpy(g_p)))
        grads[sw] = (xt.grad, mut.grad, rhot.grad)
    for name, a, b in zip(("dx", "dmu", "drho"), grads[False], grads[True]):
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        if dtype == "f32":
            assert err <= 1e-6 * scale, (name, err, scale)
        elif name == "drho":
            assert err <= 2e-2 * scale, (name, err, scale)
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("S,K,N", [(3, 64, 48), (2, 300, 130)])
def test_sampled_weights_vjp_matches_jax(S, K, N):
    """``sampled_weights`` against ``fused_linear.py::sampled_weights``: the
    same W (to an ulp: eps read back from the JAX W) and the
    reparametrisation VJP within 1e-5 of each leaf's largest entry."""
    _, mu, rho, _, _, _ = _inputs(1, 1, K, N, seed=K)
    seeds = _jax_seeds(S, K * N)
    G = np.random.default_rng(S).standard_normal((S, K, N)).astype(np.float32)
    jw, vjp = jax.vjp(lambda m, r: jfl.sampled_weights(m, r, seeds),
                      jnp.asarray(mu), jnp.asarray(rho))
    jdmu, jdrho = vjp(jnp.asarray(G))
    _, eps = _eps_of_jax_w(mu, rho, seeds)
    mut, rhot = (torch.from_numpy(a.copy()).requires_grad_() for a in (mu, rho))
    w = fl.sampled_weights(mut, rhot, None, eps=eps)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=0,
                               atol=1e-7 * np.abs(np.asarray(jw)).max())
    w.backward(torch.from_numpy(G))
    for name, a, b in (("dmu", mut.grad, jdmu), ("drho", rhot.grad, jdrho)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)
    # on the port's own stream it is the regenerated W
    pseeds = torch.arange(S, dtype=torch.int32) + 5
    w2 = fl.sampled_weights(torch.from_numpy(mu), torch.from_numpy(rho), pseeds)
    assert torch.equal(w2, fl.regenerate_weights(torch.from_numpy(mu),
                                                 torch.from_numpy(rho), pseeds))


@pytest.mark.parametrize("S,K,N", [(3, 300, 130), (2, 512, 256)])
def test_regenerate_weights_matches_plain_stream(S, K, N):
    """``regenerate_weights`` is ``mu + sigma * unit_eps(seeds)`` bit for bit
    and equals the f32 W that the forward draws for the same seeds (the
    same-draw invariant), a pair's even members included; on a CPU tensor
    the CUDA wrapper raises and nothing launches."""
    _, mu, rho, _, _, _ = _inputs(1, 1, K, N, seed=N)
    mu, rho = torch.from_numpy(mu), torch.from_numpy(rho)
    seeds = torch.tensor([7, 123456789, 2**31 - 1][:S], dtype=torch.int32)
    w = fl.regenerate_weights(mu, rho, seeds)
    assert w.dtype == torch.float32 and tuple(w.shape) == (S, K, N)
    want = mu[None] + sigma_from_rho(rho)[None] * common.unit_eps(seeds, (K, N))
    assert torch.equal(w, want)
    x = torch.randn(S, 4, K)
    assert torch.equal(fl.bayes_linear_with_w(x, mu, rho, seeds)[3], w)
    x2 = torch.randn(2 * S, 4, K)
    w_pair = fl.bayes_linear_with_w(x2, mu, rho, seeds, antithetic=True)[3]
    assert torch.equal(w_pair, fl.interleave_antithetic(w, mu))
    before = fl.REGEN_LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.regenerate_weights_cuda(mu, rho, seeds)
    assert fl.REGEN_LAUNCHES.count == before


def test_kernel_dtypes():
    """The kernels take bf16 and f32 operands; the wrappers refuse others."""
    assert common.kernel_dtype(torch.zeros(1, dtype=torch.bfloat16), "k") == "bf16"
    assert common.kernel_dtype(torch.zeros(1), "k") == "f32"
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="bf16 or float32"):
            common.kernel_dtype(torch.zeros(1, dtype=dt), "k")
