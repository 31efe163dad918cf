"""The combined Bayesian linear op: sampled matmul plus both log-probs.

Counterpart of ``bayeformers_tpu/ops/fused_linear.py::bayes_linear``
(``:1502-1605``), restricted in this slice to the serving estimator:
``antithetic=True`` with the frozen-MOPED prior centred on ``mu``
(``prior_on_mu``). For pair t (samples 2t, 2t+1) and eps from seed t:

    w[2t]     = mu + softplus(rho) * eps
    w[2t + 1] = 2 mu - w[2t]                       (interleave_antithetic)
    y[s]      = x[s] @ w[s]        (dot operands in x's dtype, f32 accumulation)
    log_q[s]  = log N(w[s]; mu, sigma^2).sum()
    log_p[s]  = log N(w[s]; mu, MOPED_PRIOR_SIGMA^2).sum()

:func:`bayes_linear` is the wrapper: a CPU tensor takes the plain version
:func:`bayes_linear_plain`; a CUDA tensor launches the hand-written kernel
(``csrc/bayes_linear.cu``) or raises. Other priors and the independent-draw
estimator come with the next slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from bayeformers_tpu_torch.core.distributions import LOG_SQRT_2PI, sigma_from_rho
from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA
from bayeformers_tpu_torch.ops import _build, common

LAUNCHES = common.LaunchCounter("bayes_linear_anti")
_BN = 64  # the kernel's column tile (csrc/bayes_linear.cu::BN)


def interleave_antithetic(w_half: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """(S/2, K, N) draws -> (S, K, N) antithetic pairs ``(w, 2 mu - w)`` at
    (2t, 2t+1)."""
    pair = torch.stack([w_half, 2.0 * mu[None] - w_half], dim=1)
    return pair.reshape((-1,) + tuple(w_half.shape[1:]))


def naive_from_w(x: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
                 rho: torch.Tensor):
    """Matmul and both log-probs from materialized weights (counterpart of
    ``_naive_from_w`` with the MOPED prior centred on mu). ``w`` is f32; the
    dot runs on ``w`` cast to x's dtype, accumulated in f32."""
    wd = w.to(x.dtype)
    y = torch.bmm(x.float(), wd.float()).to(x.dtype)
    sigma = sigma_from_rho(rho)
    eps = (w - mu[None]) / sigma[None]
    logq = torch.sum(
        -LOG_SQRT_2PI - torch.log(sigma)[None] - 0.5 * eps * eps, dim=(1, 2)
    )
    z = (w - mu[None]) / MOPED_PRIOR_SIGMA
    logp = torch.sum(
        -LOG_SQRT_2PI - math.log(MOPED_PRIOR_SIGMA) - 0.5 * z * z, dim=(1, 2)
    )
    return y, logq, logp


def sample_pair_weights(mu, rho, seeds_half=None, eps=None) -> torch.Tensor:
    """The (S, K, N) f32 antithetic weights of ``seeds_half`` on the unit
    stream, or of an explicit (S/2, K, N) ``eps``."""
    if eps is None:
        eps = common.unit_eps(seeds_half, tuple(mu.shape))
    w_half = mu[None] + sigma_from_rho(rho)[None] * eps
    return interleave_antithetic(w_half, mu)


def bayes_linear_plain(x, mu, rho, seeds_half=None, *, eps=None, w=None,
                       save_weights: bool = False):
    """Plain-torch version. The draw is, in order of precedence: an explicit
    (S, K, N) ``w``, an explicit (S/2, K, N) ``eps``, or the unit stream of
    ``seeds_half``; ``eps``/``w`` are the injection points for parity tests.
    Returns ``(y, log_q, log_p)``, plus W in x's dtype when
    ``save_weights``."""
    if w is None:
        w = sample_pair_weights(mu, rho, seeds_half, eps)
    y, lq, lp = naive_from_w(x, w, mu, rho)
    if save_weights:
        return y, lq, lp, w.to(x.dtype)
    return y, lq, lp


def _check_estimator(prior_on_mu: bool, antithetic: bool) -> None:
    if not (prior_on_mu and antithetic):
        raise NotImplementedError(
            "bayes_linear: this slice ports the antithetic estimator with the "
            "frozen-MOPED prior (prior_on_mu=True, antithetic=True); the "
            "independent-draw (`fused`) estimator and the mixture / separate "
            "prior_mu priors come with the next slices"
        )


def bayes_linear(x, mu, rho, seeds_half, *, prior_on_mu: bool = True,
                 antithetic: bool = True, save_weights: bool = False):
    """``(y, log_q, log_p)`` for x (S, M, K), mu/rho (K, N), seeds_half (S/2,).

    ``save_weights=True`` also returns the sampled pair W (S, K, N) in x's
    dtype (inference needs no residual; checks of the draw use it). A CPU
    tensor runs the plain version; a CUDA tensor the kernel."""
    _check_estimator(prior_on_mu, antithetic)
    if x.device.type == "cpu":
        return bayes_linear_plain(x, mu, rho, seeds_half,
                                  save_weights=save_weights)
    return bayes_linear_cuda(x, mu, rho, seeds_half, save_weights=save_weights)


def bayes_linear_cuda(x, mu, rho, seeds_half, *, save_weights: bool = False):
    """Launch ``bft_bayes_linear_anti`` (csrc/bayes_linear.cu)."""
    req = common.require
    req(x.is_cuda, f"bayes_linear kernel needs a CUDA tensor, got {x.device}")
    req(x.dtype == torch.bfloat16,
        f"bayes_linear kernel takes bf16 activations, got {x.dtype}")
    req(x.dim() == 3 and mu.dim() == 2, "x must be (S, M, K), mu (K, N)")
    S, M, K = x.shape
    N = mu.shape[1]
    req(mu.shape[0] == K and tuple(rho.shape) == (K, N),
        f"mu/rho {tuple(mu.shape)}/{tuple(rho.shape)} do not match K={K}")
    req(mu.dtype == torch.float32 and rho.dtype == torch.float32,
        "mu and rho must be float32")
    req(S % 2 == 0 and tuple(seeds_half.shape) == (S // 2,),
        f"antithetic needs an even S and S/2 seeds; S={S}, "
        f"seeds {tuple(seeds_half.shape)}")
    req(seeds_half.dtype == torch.int32, "seeds_half must be int32")
    for name, t in (("x", x), ("mu", mu), ("rho", rho), ("seeds", seeds_half)):
        req(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        req(t.is_contiguous(), f"{name} must be contiguous")
    req(S // 2 <= 1024, "at most 1024 antithetic pairs")
    lib = _build.library()
    n_tiles = -(-N // _BN)
    y = torch.empty((S, M, N), dtype=x.dtype, device=x.device)
    logq = torch.empty((S,), dtype=torch.float32, device=x.device)
    logp = torch.empty((S,), dtype=torch.float32, device=x.device)
    partials = torch.empty((S // 2, n_tiles, 2), dtype=torch.float32,
                           device=x.device)
    ls_part = torch.empty((n_tiles,), dtype=torch.float32, device=x.device)
    w = (torch.empty((S, K, N), dtype=x.dtype, device=x.device)
         if save_weights else None)
    x_vec = int(K % 8 == 0 and x.data_ptr() % 16 == 0)
    n_el = K * N
    with torch.cuda.device(x.device):
        err = lib.bft_bayes_linear_anti(
            x.data_ptr(), mu.data_ptr(), rho.data_ptr(), seeds_half.data_ptr(),
            y.data_ptr(), None if w is None else w.data_ptr(),
            partials.data_ptr(), ls_part.data_ptr(), logq.data_ptr(),
            logp.data_ptr(), S, M, K, N, x_vec, 1.0 / MOPED_PRIOR_SIGMA,
            n_el * LOG_SQRT_2PI,
            n_el * (LOG_SQRT_2PI + math.log(MOPED_PRIOR_SIGMA)),
            common.cuda_stream(x),
        )
    _build.check(err, "bft_bayes_linear_anti")
    LAUNCHES.add((M, K, N))
    if save_weights:
        return y, logq, logp, w
    return y, logq, logp
