"""Variational-parameter initialisation (counterpart of
``bayeformers_tpu/core/init.py``): the reference's uniform init and the
MOPED empirical-Bayes ``rho``."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from bayeformers_tpu_torch.core import distributions as dist


@dataclasses.dataclass(frozen=True)
class UniformInit:
    """Uniform init for ``(mu, rho)``: the reference's ``DEFAULT_UNIFORM =
    Uniform((-0.2, 0.2), (-5, -4))`` (an initial sigma of about
    softplus(-4.5) ~ 0.011).

    ``init(generator, shape)`` draws mu, then rho, from ``generator`` (a
    ``torch.Generator``) on the generator's device and returns them on
    ``device`` (default: the generator's), so one generator gives the same
    values on any device it is moved to."""

    mu_range: tuple[float, float] = (-0.2, 0.2)
    rho_range: tuple[float, float] = (-5.0, -4.0)

    def __call__(self, generator: torch.Generator, shape, dtype=torch.float32,
                 device: Optional[torch.device] = None):
        def uniform(lo, hi):
            u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                           device=generator.device)
            return (lo + (hi - lo) * u).to(device or generator.device)

        return uniform(*self.mu_range), uniform(*self.rho_range)


DEFAULT_UNIFORM = UniformInit()


def moped_rho(w: torch.Tensor, delta: float) -> torch.Tensor:
    """``rho = softplus^-1(delta * |w|)`` in the ``log(expm1(.))`` form, with
    the ``-inf`` of exactly-zero (or underflowing) weights patched to 0."""
    rho = dist.inv_softplus(delta * torch.abs(w))
    return torch.where(torch.isneginf(rho), torch.zeros_like(rho), rho)
