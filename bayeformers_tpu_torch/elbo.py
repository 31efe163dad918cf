"""What serving needs of ``bayeformers_tpu/elbo.py``."""
from __future__ import annotations

import torch


def mc_logits_mean(logits: torch.Tensor) -> torch.Tensor:
    """Average predictions over the leading MC-sample axis."""
    return torch.mean(logits, dim=0)
