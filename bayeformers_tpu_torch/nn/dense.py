"""The layer that ``to_bayesian`` converts, shared by every port model.

``Dense`` is the port's counterpart of Flax's ``nn.Dense`` (the hand-built
Bayesian layers of ``bayeformers_tpu/nn/layers.py`` come with a later
slice): it holds ``kernel`` stored (in, out), the orientation that defines
the eps stream, and ``bias``. A converted model passes an ``mc`` (:class:`nn.fused.FusedMC`)
through its forward; a ``Dense`` given one dispatches to it.
"""
from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with ``kernel`` stored (in, out)."""

    def __init__(self, n_in: int, n_out: int, *, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(n_in, n_out, device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))
        self.path = ""  # the Flax path of this module, set by assign_paths

    def forward(self, x, mc=None):
        if mc is not None:
            return mc.dense(self, x)
        y = torch.matmul(x.float(), self.kernel.to(x.dtype).float())
        return (y.to(x.dtype) + self.bias.to(x.dtype))


def assign_paths(model: nn.Module) -> None:
    """Give every ``Dense`` its Flax path (``bert/pooler/dense``, ...)."""
    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            mod.path = name.replace(".", "/")
