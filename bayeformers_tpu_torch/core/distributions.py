"""Gaussian / scale-mixture log-density numerics for Bayes-by-Backprop.

Counterpart of ``bayeformers_tpu/core/distributions.py``: the posterior is a
mean-field Gaussian ``w = mu + softplus(rho) * eps``; the default prior is a
two-component zero-mean scale mixture. Plain functions on tensors.
"""
from __future__ import annotations

import math

import torch

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class _Softplus(torch.autograd.Function):
    """The softplus below with its exact derivative ``sigmoid(rho)``: torch's
    derivatives of ``clamp_min`` and ``abs`` at 0 would give 1 at
    ``rho = 0``, where MOPED puts every zero weight (zero biases above all),
    instead of ``sigmoid(0) = 1/2``."""

    @staticmethod
    def forward(ctx, rho):
        ctx.save_for_backward(rho)
        return sigma_from_rho(rho)

    @staticmethod
    def backward(ctx, g):
        (rho,) = ctx.saved_tensors
        return g * torch.sigmoid(rho)


def sigma_from_rho(rho: torch.Tensor) -> torch.Tensor:
    """``sigma = softplus(rho)`` in the ``logaddexp(rho, 0)`` form
    ``max(rho, 0) + log1p(exp(-|rho|))`` that ``jax.nn.softplus`` uses; the
    bayes_linear kernel evaluates the same expression. Differentiable, with
    derivative ``sigmoid(rho)``."""
    if torch.is_grad_enabled() and rho.requires_grad:
        return _Softplus.apply(rho)
    return torch.clamp_min(rho, 0.0) + torch.log1p(torch.exp(-torch.abs(rho)))


def inv_softplus(y: torch.Tensor) -> torch.Tensor:
    """Inverse of softplus: ``rho = log(expm1(y))``."""
    return torch.log(torch.expm1(y))


def gaussian_log_prob_from_eps(eps: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Posterior log-density of its own sample ``w = mu + sigma * eps``:
    ``(w - mu)^2 / (2 sigma^2) = eps^2 / 2``, so W is never needed."""
    return torch.sum(-LOG_SQRT_2PI - torch.log(sigma) - 0.5 * eps * eps)


def scale_mixture_log_prob(w: torch.Tensor, pi: float, sigma1: float,
                           sigma2: float) -> torch.Tensor:
    """Summed log-density of a two-component zero-mean Gaussian scale
    mixture, via ``logaddexp`` so it stays finite where the pdf underflows."""
    lp1 = -LOG_SQRT_2PI - math.log(sigma1) - 0.5 * (w / sigma1) ** 2
    lp2 = -LOG_SQRT_2PI - math.log(sigma2) - 0.5 * (w / sigma2) ** 2
    return torch.sum(torch.logaddexp(math.log(pi) + lp1, math.log1p(-pi) + lp2))
