"""Prior specifications as plain config (counterpart of
``bayeformers_tpu/core/prior.py``).

- :class:`ScaleMixturePrior`: static ``(pi, sigma1, sigma2)``, default
  ``(0.5, e**0, e**-6)``;
- the MOPED Gaussian prior: mean = the pretrained weight, sigma =
  ``softplus(1.0)`` (:data:`MOPED_PRIOR_SIGMA`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from bayeformers_tpu_torch.core import distributions as dist

# softplus(1.0): the MOPED prior sigma
MOPED_PRIOR_SIGMA = math.log1p(math.e)


@dataclasses.dataclass(frozen=True)
class ScaleMixturePrior:
    """Two-component zero-mean Gaussian scale mixture."""

    pi: float = 0.5
    sigma1: float = 1.0             # e**0
    sigma2: float = math.exp(-6.0)  # e**-6

    def log_prob(self, w: torch.Tensor) -> torch.Tensor:
        return dist.scale_mixture_log_prob(w, self.pi, self.sigma1, self.sigma2)


DEFAULT_SCALE_MIXTURE = ScaleMixturePrior()


def moped_prior_log_prob(w: torch.Tensor, prior_mu: torch.Tensor, dim=None) -> torch.Tensor:
    """Gaussian prior centred on the pretrained weight, sigma = softplus(1),
    summed over every element or over ``dim``."""
    return dist.gaussian_log_prob(w, prior_mu, MOPED_PRIOR_SIGMA, dim=dim)
