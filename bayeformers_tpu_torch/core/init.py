"""MOPED empirical-Bayes initialisation (counterpart of
``bayeformers_tpu/core/init.py::moped_rho``)."""
from __future__ import annotations

import torch

from bayeformers_tpu_torch.core import distributions as dist


def moped_rho(w: torch.Tensor, delta: float) -> torch.Tensor:
    """``rho = softplus^-1(delta * |w|)`` in the ``log(expm1(.))`` form, with
    the ``-inf`` of exactly-zero (or underflowing) weights patched to 0."""
    rho = dist.inv_softplus(delta * torch.abs(w))
    return torch.where(torch.isneginf(rho), torch.zeros_like(rho), rho)
