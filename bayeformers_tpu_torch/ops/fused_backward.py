"""The dmu/drho reduce of the Bayesian linear backward.

Counterpart of ``bayeformers_tpu/ops/fused_backward.py``, restricted to the
frozen-MOPED prior centred on mu (``gaussian_on_mu``, which never reads the
U accumulator). Everything the gradients of mu and rho need is three
(K, N) accumulators. Over S independent samples (:func:`reduce_abuv`, the
counterpart of ``reduce_abuv`` / ``_xla_reduce``):

    p = x[s]^T g[s],  wc = W[s] - mu
    A = sum_s p,  B = sum_s p * wc,  V = sum_s g_p[s] * wc^2

Over an interleaved antithetic batch (:func:`reduce_abuv_anti`, the
counterpart of ``reduce_abuv_anti`` / ``_xla_reduce_anti``), of which only
the even (+) members' weights are read (``w1 - mu = -(w0 - mu)``):

    p0 = x[2t]^T g[2t],  p1 = x[2t+1]^T g[2t+1],  wc = W[2t] - mu
    A = sum_t (p0 + p1)
    B = sum_t (p0 - p1) * wc
    V = sum_t (g_p[2t] + g_p[2t+1]) * wc^2

:func:`finalize` turns either into ``dmu = A`` and
``drho = (B / sigma - V / (sigma_p^2 sigma) - sum(g_q) / sigma) * sigmoid(rho)``
with elementwise torch on (K, N) tensors, as XLA does it in the reference.

Each reduce is a wrapper: a CPU tensor takes its plain version; a CUDA
tensor launches ``csrc/fused_backward.cu`` (``bft_reduce_abuv`` or
``bft_reduce_abuv_anti``) or raises. The kernel has three instances, by the
types of x and g and of W: (bf16, bf16) behind the saved bf16 residual,
(f32, f32) at f32 activations, and (bf16, f32) behind the regenerating
backward at bf16, which hands the reduce the regenerated f32 W as the
reference does; the launch counters key each launch by ``(M, K, N, tag)``
with tag ``"bf16"``, ``"f32"`` or ``"bf16x-f32w"``. The mixture prior, a
separate ``prior_mu`` and the U accumulator come with the slice that ports
the other priors and raise here.
"""
from __future__ import annotations

import torch

from bayeformers_tpu_torch.core.distributions import sigma_from_rho
from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA
from bayeformers_tpu_torch.ops import _build, common

LAUNCHES = common.LaunchCounter("reduce_abuv_anti")
INDEP_LAUNCHES = common.LaunchCounter("reduce_abuv")


def _check_prior(mixture, want_u: bool) -> None:
    if mixture is not None or want_u:
        raise NotImplementedError(
            "reduce_abuv: the port takes the frozen-MOPED prior centred on mu "
            "(mixture=None, want_u=False); the mixture prior, a separate "
            "prior_mu and the U accumulator come with the slice that ports the "
            "other priors (ROADMAP queue 1, item 3)"
        )


def reduce_abuv_plain(x, g, w, mu, g_p):
    """Plain version (``_xla_reduce`` for ``mixture=None``): the per-sample
    products in f32 from the operands as given, W minus mu in f32. Returns
    ``(A, B, V)``, (K, N) f32 each."""
    dw = torch.bmm(x.float().transpose(1, 2), g.float())
    wc = w.float() - mu[None]
    a = torch.sum(dw, dim=0)
    b = torch.sum(dw * wc, dim=0)
    v = torch.sum(g_p.float()[:, None, None] * wc * wc, dim=0)
    return a, b, v


def reduce_abuv(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """``(A, B, V)`` for x (S, M, K), g (S, M, N), the sampled weights W
    (S, K, N), mu (K, N) and the log-prior cotangent g_p (S,). A CPU tensor
    runs the plain version; a CUDA tensor the kernel."""
    _check_prior(mixture, want_u)
    if x.device.type == "cpu":
        return reduce_abuv_plain(x, g, w, mu, g_p)
    return reduce_abuv_cuda(x, g, w, mu, g_p)


def reduce_abuv_anti_plain(x, g, w, mu, g_p):
    """Plain version (``_xla_reduce_anti`` for ``mixture=None``): the
    per-pair products in f32 from the operands as given, W's even members
    minus mu in f32. Returns ``(A, B, V)``, (K, N) f32 each."""
    S, M, K = x.shape
    N = mu.shape[1]
    x2 = x.reshape(S // 2, 2, M, K).float()
    g2 = g.reshape(S // 2, 2, M, N).float()
    dw0 = torch.bmm(x2[:, 0].transpose(1, 2), g2[:, 0])
    dw1 = torch.bmm(x2[:, 1].transpose(1, 2), g2[:, 1])
    wc = w[0::2].float() - mu[None]
    gp2 = g_p.reshape(S // 2, 2).float()
    gps = (gp2[:, 0] + gp2[:, 1])[:, None, None]
    a = torch.sum(dw0 + dw1, dim=0)
    b = torch.sum((dw0 - dw1) * wc, dim=0)
    v = torch.sum(gps * wc * wc, dim=0)
    return a, b, v


def reduce_abuv_anti(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """``(A, B, V)`` for x (S, M, K), g (S, M, N), the pair weights W
    (S, K, N), mu (K, N) and the log-prior cotangent g_p (S,). A CPU tensor
    runs the plain version; a CUDA tensor the kernel."""
    _check_prior(mixture, want_u)
    if x.device.type == "cpu":
        return reduce_abuv_anti_plain(x, g, w, mu, g_p)
    return reduce_abuv_anti_cuda(x, g, w, mu, g_p)


def reduce_abuv_anti_cuda(x, g, w, mu, g_p):
    """Launch ``bft_reduce_abuv_anti`` (csrc/fused_backward.cu)."""
    return _reduce_cuda(x, g, w, mu, g_p, antithetic=True)


def reduce_abuv_cuda(x, g, w, mu, g_p):
    """Launch ``bft_reduce_abuv`` (csrc/fused_backward.cu)."""
    return _reduce_cuda(x, g, w, mu, g_p, antithetic=False)


def _reduce_cuda(x, g, w, mu, g_p, antithetic: bool):
    req = common.require
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
    per16 = 16 // x.element_size()  # elements in a 16-byte copy
    x_vec = int(K % per16 == 0 and x.data_ptr() % 16 == 0)
    g_vec = int(N % per16 == 0 and g.data_ptr() % 16 == 0)
    name = "bft_reduce_abuv_anti" if antithetic else "bft_reduce_abuv"
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            x.data_ptr(), g.data_ptr(), w.data_ptr(), mu.data_ptr(),
            g_p.data_ptr(), a.data_ptr(), b.data_ptr(), v.data_ptr(),
            S, M, K, N, x_vec, g_vec, int(xt == "f32"), int(wt == "f32"),
            common.cuda_stream(x),
        )
    _build.check(err, name)
    tag = xt if xt == wt else f"{xt}x-{wt}w"
    (LAUNCHES if antithetic else INDEP_LAUNCHES).add((M, K, N, tag))
    return a, b, v


def finalize(a, b, v, rho, g_q):
    """``(dmu, drho)`` from the accumulators: the ``gaussian_on_mu`` branch
    of the reference's ``finalize`` (``dprior_mu`` is zero there)."""
    sigma = sigma_from_rho(rho)
    sum_gq = torch.sum(g_q)
    prior_eps = -v / (MOPED_PRIOR_SIGMA ** 2 * sigma)
    drho = (b / sigma + prior_eps - sum_gq / sigma) * torch.sigmoid(rho)
    return a, drho
