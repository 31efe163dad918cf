"""The layers that ``to_bayesian`` converts, shared by every port model.

``Dense`` is the port's counterpart of Flax's ``nn.Dense`` (the hand-built
Bayesian layers of ``bayeformers_tpu/nn/layers.py`` come with a later
slice): it holds ``kernel`` stored (in, out), the orientation that defines
the eps stream, and ``bias``, or no bias with ``use_bias=False`` (Flax's
``nn.Dense(use_bias=False)``: every LLaMA-architecture projection). ``Conv1D`` is HF's ``FlaxConv1D`` (GPT-2's
projections): ``kernel`` stored (out, in), ``y = x @ kernel.T + bias``.
A converted model passes an ``mc`` (:class:`nn.fused.FusedMC` or another
tier's state) through its forward; a layer given one dispatches to it.
"""
from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with ``kernel`` stored (in, out); with
    ``use_bias=False`` there is no ``bias`` parameter (``self.bias`` is
    None) and ``y = x @ kernel``."""

    transposed = False  # the kernel is stored (in, out)

    def __init__(self, n_in: int, n_out: int, *, use_bias: bool = True, device=None):
        super().__init__()
        shape = (n_out, n_in) if self.transposed else (n_in, n_out)
        self.kernel = nn.Parameter(torch.empty(shape, device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device)) if use_bias else None
        self.path = ""  # the Flax path of this module, set by assign_paths

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` plus the frequentist bias in ``y``'s dtype (no bias: ``y``)."""
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def forward(self, x, mc=None):
        if mc is not None:
            return mc.dense(self, x)
        w = self.kernel.to(x.dtype).float()
        y = torch.matmul(x.float(), w.t() if self.transposed else w)
        return self.add_bias(y.to(x.dtype))


class Conv1D(Dense):
    """HF's ``FlaxConv1D`` (GPT-2's projections): ``y = x @ kernel.T +
    bias`` with ``kernel`` stored (out, in). The fused, flipout and LRT
    tiers define their draws on the transposed (in, out) view, as the JAX
    package's ``handle_dense(transposed=True)`` does; the naive tier draws
    in the stored orientation."""

    transposed = True


def assign_paths(model: nn.Module) -> None:
    """Give every layer that the tiers dispatch (each module with a
    ``path``: ``Dense``, ``Conv1D``, ``nn/conv.py::Conv``,
    ``models/bert.py::Embed``) its Flax path (``bert/pooler/dense``,
    ``transformer/h/0/attn/c_attn``, ...)."""
    for name, mod in model.named_modules():
        if hasattr(mod, "path"):
            mod.path = name.replace(".", "/")
