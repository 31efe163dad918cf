"""The dmu/drho reduce of the Bayesian linear backward.

Counterpart of ``bayeformers_tpu/ops/fused_backward.py``. Everything the
gradients of mu and rho need is three or four (K, N) accumulators. Over S
independent samples (:func:`reduce_abuv`, the counterpart of
``reduce_abuv`` / ``_xla_reduce``):

    p = x[s]^T g[s],  wc = W[s] - mu
    A = sum_s p,  B = sum_s p * wc
    U = sum_s g_p[s] * wc,       V = sum_s g_p[s] * wc^2       (Gaussian priors)
    U = sum_s g_p[s] * score(W[s]),  V = sum_s g_p[s] * score(W[s]) * wc
                                                               (mixture)

Over an interleaved antithetic batch (:func:`reduce_abuv_anti`, the
counterpart of ``reduce_abuv_anti`` / ``_xla_reduce_anti``), of which only
the even (+) members' weights are read (``w1 - mu = -(w0 - mu)``):

    p0 = x[2t]^T g[2t],  p1 = x[2t+1]^T g[2t+1],  wc = W[2t] - mu
    A = sum_t (p0 + p1),  B = sum_t (p0 - p1) * wc
    U = sum_t (g_p[2t] - g_p[2t+1]) * wc,  V = sum_t (g_p[2t] + g_p[2t+1]) * wc^2
    (mixture: s0 = score(mu + wc), s1 = score(mu - wc),
     U = sum_t g_p[2t] s0 + g_p[2t+1] s1,  V = sum_t (g_p[2t] s0 - g_p[2t+1] s1) * wc)

with ``score`` the mixture's (``ops/logprob.py::mixture_score``), taken on
the W the reduce is given: the saved residual (bf16 in bf16 runs) or the
regenerated f32 W. U is computed only when asked (``want_u``: every prior
but the one centred on mu, which never reads it); the reduce then returns
``(A, B, U, V)``, else ``(A, B, V)``. :func:`finalize` turns them into dmu
and drho with elementwise torch on (K, N) tensors, as XLA does it in the
reference.

Each reduce is a wrapper: a CPU tensor takes its plain version; a CUDA
tensor launches ``csrc/fused_backward.cu`` (``bft_reduce_abuv`` or
``bft_reduce_abuv_anti``) or raises. The kernel has an instance per prior
(centred on mu; Gaussian with U; mixture) and per pair of types of x and g
and of W: (bf16, bf16) behind the saved bf16 residual, (f32, f32) at f32
activations, and (bf16, f32) behind the regenerating backward at bf16,
which hands the reduce the regenerated f32 W as the reference does; the
launch counters key each launch by ``(M, K, N, tag)`` with tag ``"bf16"``,
``"f32"`` or ``"bf16x-f32w"``, followed by ``"/gaussian"`` or
``"/mixture"`` for those priors.
"""
from __future__ import annotations

import torch

from bayeformers_tpu_torch.core.distributions import sigma_from_rho
from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA
from bayeformers_tpu_torch.ops import _build, common
from bayeformers_tpu_torch.ops.logprob import (
    ON_MU, PRIOR_CODE, PRIOR_TAG, mixture_constants, mixture_score, reduce_prior)

LAUNCHES = common.LaunchCounter("reduce_abuv_anti")
INDEP_LAUNCHES = common.LaunchCounter("reduce_abuv")


def _results(a, b, u, v, want_u: bool):
    return (a, b, u, v) if want_u else (a, b, v)


def reduce_abuv_plain(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """Plain version (``_xla_reduce``): the per-sample products in f32 from
    the operands as given, W minus mu in f32. Returns ``(A, B, V)``, or
    ``(A, B, U, V)`` with ``want_u``, (K, N) f32 each."""
    reduce_prior(mixture, want_u)
    dw = torch.bmm(x.float().transpose(1, 2), g.float())
    wc = w.float() - mu[None]
    a = torch.sum(dw, dim=0)
    b = torch.sum(dw * wc, dim=0)
    gp = g_p.float()[:, None, None]
    if mixture is None:
        u = torch.sum(gp * wc, dim=0) if want_u else None
        v = torch.sum(gp * wc * wc, dim=0)
    else:
        score = mixture_score(w.float(), *mixture)
        u = torch.sum(gp * score, dim=0)
        v = torch.sum(gp * score * wc, dim=0)
    return _results(a, b, u, v, want_u)


def reduce_abuv(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """``(A, B, V)`` or, with ``want_u``, ``(A, B, U, V)`` for x (S, M, K),
    g (S, M, N), the sampled weights W (S, K, N), mu (K, N) and the
    log-prior cotangent g_p (S,); ``mixture=(pi, sigma1, sigma2)`` takes
    U and V of the mixture's score. A CPU tensor runs the plain version; a
    CUDA tensor the kernel."""
    if x.device.type == "cpu":
        return reduce_abuv_plain(x, g, w, mu, g_p, mixture, want_u)
    return reduce_abuv_cuda(x, g, w, mu, g_p, mixture, want_u)


def reduce_abuv_anti_plain(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """Plain version (``_xla_reduce_anti``): the per-pair products in f32
    from the operands as given, W's even members minus mu in f32. Returns
    ``(A, B, V)``, or ``(A, B, U, V)`` with ``want_u``, (K, N) f32 each."""
    reduce_prior(mixture, want_u)
    S, M, K = x.shape
    N = mu.shape[1]
    x2 = x.reshape(S // 2, 2, M, K).float()
    g2 = g.reshape(S // 2, 2, M, N).float()
    dw0 = torch.bmm(x2[:, 0].transpose(1, 2), g2[:, 0])
    dw1 = torch.bmm(x2[:, 1].transpose(1, 2), g2[:, 1])
    wc = w[0::2].float() - mu[None]
    gp2 = g_p.reshape(S // 2, 2).float()
    gp0, gp1 = gp2[:, 0, None, None], gp2[:, 1, None, None]
    a = torch.sum(dw0 + dw1, dim=0)
    b = torch.sum((dw0 - dw1) * wc, dim=0)
    if mixture is None:
        u = torch.sum((gp0 - gp1) * wc, dim=0) if want_u else None
        v = torch.sum((gp0 + gp1) * wc * wc, dim=0)
    else:
        score0 = mixture_score(mu[None] + wc, *mixture)
        score1 = mixture_score(mu[None] - wc, *mixture)
        u = torch.sum(gp0 * score0 + gp1 * score1, dim=0)
        v = torch.sum((gp0 * score0 - gp1 * score1) * wc, dim=0)
    return _results(a, b, u, v, want_u)


def reduce_abuv_anti(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """``(A, B, V)`` or, with ``want_u``, ``(A, B, U, V)`` for x (S, M, K),
    g (S, M, N), the pair weights W (S, K, N), mu (K, N) and the log-prior
    cotangent g_p (S,); ``mixture`` as in :func:`reduce_abuv`. A CPU tensor
    runs the plain version; a CUDA tensor the kernel."""
    if x.device.type == "cpu":
        return reduce_abuv_anti_plain(x, g, w, mu, g_p, mixture, want_u)
    return reduce_abuv_anti_cuda(x, g, w, mu, g_p, mixture, want_u)


def reduce_abuv_anti_cuda(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """Launch ``bft_reduce_abuv_anti`` (csrc/fused_backward.cu)."""
    return _reduce_cuda(x, g, w, mu, g_p, mixture, want_u, antithetic=True)


def reduce_abuv_cuda(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """Launch ``bft_reduce_abuv`` (csrc/fused_backward.cu)."""
    return _reduce_cuda(x, g, w, mu, g_p, mixture, want_u, antithetic=False)


def _reduce_cuda(x, g, w, mu, g_p, mixture, want_u: bool, antithetic: bool):
    req = common.require
    prior = reduce_prior(mixture, want_u)
    req(x.is_cuda, f"reduce_abuv kernel needs a CUDA tensor, got {x.device}")
    req(x.dim() == 3 and g.dim() == 3 and w.dim() == 3 and mu.dim() == 2,
        "x must be (S, M, K), g (S, M, N), w (S, K, N), mu (K, N)")
    S, M, K = x.shape
    N = mu.shape[1]
    req(S % 2 == 0 or not antithetic, f"antithetic needs an even S, got {S}")
    req(tuple(g.shape) == (S, M, N), f"g is {tuple(g.shape)}, want {(S, M, N)}")
    req(tuple(w.shape) == (S, K, N), f"w is {tuple(w.shape)}, want {(S, K, N)}")
    req(mu.shape[0] == K, f"mu is {tuple(mu.shape)}, x has K={K}")
    req(tuple(g_p.shape) == (S,), f"g_p is {tuple(g_p.shape)}, want ({S},)")
    xt = common.kernel_dtype(x, "reduce_abuv")
    wt = common.kernel_dtype(w, "reduce_abuv")
    req(g.dtype == x.dtype, f"g must be {x.dtype} as x, got {g.dtype}")
    req(xt == "bf16" or wt == "f32",
        "reduce_abuv kernel takes W as f32 or, with bf16 x, as bf16; "
        f"got x {x.dtype}, W {w.dtype}")
    for name, t in (("mu", mu), ("g_p", g_p)):
        req(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("g", g), ("w", w), ("mu", mu), ("g_p", g_p)):
        req(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        req(t.is_contiguous(), f"{name} must be contiguous")
    lib = _build.library()
    a, b, v = (torch.empty((K, N), dtype=torch.float32, device=x.device)
               for _ in range(3))
    u = torch.empty((K, N), dtype=torch.float32, device=x.device) if want_u else None
    pi, s1, s2 = prior[1:] if prior[0] == "mixture" else (0.5, 1.0, 1.0)
    per16 = 16 // x.element_size()  # elements in a 16-byte copy
    x_vec = int(K % per16 == 0 and x.data_ptr() % 16 == 0)
    g_vec = int(N % per16 == 0 and g.data_ptr() % 16 == 0)
    name = "bft_reduce_abuv_anti" if antithetic else "bft_reduce_abuv"
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            x.data_ptr(), g.data_ptr(), w.data_ptr(), mu.data_ptr(),
            g_p.data_ptr(), a.data_ptr(), b.data_ptr(),
            None if u is None else u.data_ptr(), v.data_ptr(),
            S, M, K, N, x_vec, g_vec, int(xt == "f32"), int(wt == "f32"),
            PRIOR_CODE[prior[0]],
            *mixture_constants(pi, s1, s2), common.cuda_stream(x),
        )
    _build.check(err, name)
    tag = (xt if xt == wt else f"{xt}x-{wt}w") + PRIOR_TAG[prior[0]]
    (LAUNCHES if antithetic else INDEP_LAUNCHES).add((M, K, N, tag))
    return _results(a, b, u, v, want_u)


def finalize(a, b, v, rho, g_q, u=None, *, prior=ON_MU, mu=None,
             prior_mu=None, g_p=None):
    """``(dmu, drho)`` from the accumulators, the reference's ``finalize``
    for each prior (its ``dprior_mu`` is never trained and not returned):

      gaussian_on_mu:  dmu = A,  prior_eps = -V / (sigma_p^2 sigma)
      gaussian:        pr = -(U + (mu - prior_mu) sum(g_p)) / sigma_p^2,
                       dmu = A + pr,
                       prior_eps = -(V + (mu - prior_mu) U) / (sigma_p^2 sigma)
      mixture:         dmu = A + U,  prior_eps = V / sigma

    and ``drho = (B / sigma + prior_eps - sum(g_q) / sigma) sigmoid(rho)``."""
    sigma = sigma_from_rho(rho)
    sum_gq = torch.sum(g_q)
    ps2 = MOPED_PRIOR_SIGMA ** 2
    if prior[0] == "gaussian":
        d = mu - prior_mu
        dmu = a - (u + d * torch.sum(g_p)) / ps2
        prior_eps = -(v + d * u) / (ps2 * sigma)
    elif prior[0] == "gaussian_on_mu":
        dmu = a
        prior_eps = -v / (ps2 * sigma)
    else:
        dmu = a + u
        prior_eps = v / sigma
    drho = (b / sigma + prior_eps - sum_gq / sigma) * torch.sigmoid(rho)
    return dmu, drho
