"""The port's ``Conv`` (Flax's ``nn.Conv``) and its im2col lowering.

``Conv`` keeps Flax's layout and attributes: ``kernel`` of shape
``(*kernel_size, cin, cout)`` (1-3 spatial dims), ``bias`` (cout) unless
``use_bias=False``, channels-last inputs ``(N, *spatial, cin)``, and
``strides``, ``padding`` (``"SAME"``, ``"VALID"``, ``"SAME_LOWER"``, an int
or one ``(lo, hi)`` pair a spatial dim), ``input_dilation``,
``kernel_dilation``, ``feature_group_count`` and ``mask`` (a kernel mask,
multiplied in) as Flax takes them.

Every convolution here is an im2col product, counterpart of the JAX
package's ``nn/fused.py::lower_conv`` (``:120-193``): :func:`im2col` forms
``lax.conv_general_dilated_patches``' patches, whose trailing feature dim
of ``cin * prod(kernel_size)`` is channel-major ``(cin, *kernel_size)``
(the order of ``torch.nn.functional.unfold``), the output positions in
Flax's channels-last order, and :func:`reorder` maps any leaf of the
kernel's shape (mu, rho, prior_mu) to the matching ``(K, cout)`` matrix.
So the frequentist forward and every tier's converted forward compute the
same ``patches @ reorder(kernel)`` (one ``torch.matmul`` here, the
Bayesian linear kernels in the fused tier), and the frequentist
backward's sums have a fixed order on the card, as a library convolution's
need not.

A converted ``Conv`` hands itself to the tier of the call (``mc.conv(self,
x)``), as a ``Dense`` does. :func:`lower_conv` raises, on any device, for
what the Bayesian lowering does not take, as the reference's does:
``feature_group_count > 1``, a kernel mask, an input of the wrong rank and
a padding other than the ones above.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

PADDINGS = ("SAME", "VALID", "SAME_LOWER")
Padding = Union[str, int, Sequence]


def _tup(v, nd: int) -> tuple[int, ...]:
    if v is None:
        return (1,) * nd
    if isinstance(v, int):
        return (v,) * nd
    return tuple(int(a) for a in v)


def explicit_pads(padding: Padding, in_sizes, eff_k, strides) -> list[tuple[int, int]]:
    """``(lo, hi)`` for each spatial dim, as ``lax.padtype_to_pads`` and
    Flax's ``canonicalize_padding`` give them: ``"SAME"`` pads ``max((out -
    1) stride + k_eff - n, 0)`` with the smaller half low (``"SAME_LOWER"``:
    high), ``out = ceil(n / stride)``; an int pads both ends. Another string
    raises ``NotImplementedError``."""
    nd = len(in_sizes)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in PADDINGS:
            raise NotImplementedError(f"padding={padding!r} is not supported (one of "
                                      f"{PADDINGS}, an int or (lo, hi) pairs)")
        if mode == "VALID":
            return [(0, 0)] * nd
        pads = []
        for n, k, s in zip(in_sizes, eff_k, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            lo, hi = total // 2, total - total // 2
            pads.append((lo, hi) if mode == "SAME" else (hi, lo))
        return pads
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    pads = [(p, p) if isinstance(p, int) else tuple(int(a) for a in p) for p in padding]
    if len(pads) != nd or any(len(p) != 2 for p in pads):
        raise NotImplementedError(f"padding={padding!r}: want one (lo, hi) pair for each "
                                  f"of {nd} spatial dims")
    return pads


def im2col(x: torch.Tensor, kernel_size, strides=None, padding: Padding = "SAME",
           input_dilation=None, kernel_dilation=None) -> torch.Tensor:
    """``(N, *spatial, C)`` -> the patches ``(N, *out_spatial, C *
    prod(kernel_size))``, features channel-major ``(C, *kernel_size)``:
    ``lax.conv_general_dilated_patches`` with channels-last dimension
    numbers. The input is dilated (zeros between its elements), padded (a
    negative pad crops), and each window's dilated taps are read."""
    nd = len(kernel_size)
    strides, lhs_dil, rhs_dil = (_tup(v, nd) for v in (strides, input_dilation,
                                                       kernel_dilation))
    if isinstance(padding, str) and any(d != 1 for d in lhs_dil):
        raise ValueError("string padding with input_dilation: pass explicit pads, "
                         "as lax.conv_general_dilated asks")
    eff_k = [(k - 1) * d + 1 for k, d in zip(kernel_size, rhs_dil)]
    pads = explicit_pads(padding, x.shape[1:-1], eff_k, strides)
    x = x.movedim(-1, 1)  # (N, C, *spatial)
    if any(d != 1 for d in lhs_dil):
        sizes = tuple((n - 1) * d + 1 for n, d in zip(x.shape[2:], lhs_dil))
        z = x.new_zeros(tuple(x.shape[:2]) + sizes)
        z[(slice(None), slice(None)) + tuple(slice(None, None, d) for d in lhs_dil)] = x
        x = z
    x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
    for i, (k, s) in enumerate(zip(eff_k, strides)):
        x = x.unfold(2 + i, k, s)  # (N, C, *out, *window)
    x = x[(Ellipsis,) + tuple(slice(None, None, d) for d in rhs_dil)]
    perm = [0, *range(2, 2 + nd), 1, *range(2 + nd, 2 + 2 * nd)]
    x = x.permute(perm)  # (N, *out, C, *k)
    return x.reshape(tuple(x.shape[:1 + nd]) + (-1,))


def reorder(a: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """A leaf of shape ``(*lead dims, *kernel_size, cin, cout)`` as the
    contiguous ``(*lead dims, K, cout)`` matrix of the channel-major patch
    features, ``K = cin * prod(kernel_size)``: the reference's
    ``moveaxis(a, -2, 0).reshape(K, cout)``, a draw axis or two kept in
    front (``lead``)."""
    out = a.movedim(-2, lead)
    return out.reshape(tuple(a.shape[:lead]) + (-1, a.shape[-1])).contiguous()


class Conv(nn.Module):
    """Flax's ``nn.Conv`` over channels-last inputs: ``kernel``
    ``(*kernel_size, cin // feature_group_count, cout)``, ``bias`` (cout)
    unless ``use_bias=False``."""

    def __init__(self, cin: int, features: int, kernel_size: Sequence[int], *,
                 strides=None, padding: Padding = "SAME", input_dilation=None,
                 kernel_dilation=None, feature_group_count: int = 1,
                 use_bias: bool = True, mask=None, device=None):
        super().__init__()
        self.kernel_size = tuple(int(k) for k in kernel_size)
        nd = len(self.kernel_size)
        if not 1 <= nd <= 3:
            raise ValueError(f"Conv takes 1-3 spatial dims, got kernel_size {kernel_size}")
        if cin % feature_group_count or features % feature_group_count:
            raise ValueError("feature_group_count must divide cin and features")
        self.kernel = nn.Parameter(torch.empty(
            self.kernel_size + (cin // feature_group_count, features), device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None
        self.strides = _tup(strides, nd)
        self.padding = padding
        self.input_dilation = _tup(input_dilation, nd)
        self.kernel_dilation = _tup(kernel_dilation, nd)
        self.feature_group_count = feature_group_count
        self.mask = mask
        self.path = ""  # the Flax path of this module, set by assign_paths

    def patches(self, x: torch.Tensor) -> torch.Tensor:
        """The im2col patches of ``x`` under this layer's windowing."""
        return im2col(x, self.kernel_size, self.strides, self.padding,
                      self.input_dilation, self.kernel_dilation)

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def forward(self, x, mc=None):
        if mc is not None:
            return mc.conv(self, x)
        w = self.kernel if self.mask is None else self.kernel * self.mask
        w = w.to(x.dtype).float()
        groups = self.feature_group_count
        cin = x.shape[-1] // groups
        ys = []
        for g in range(groups):  # Flax's feature groups: channel blocks
            xg = x[..., g * cin:(g + 1) * cin] if groups > 1 else x
            wg = w[..., g * w.shape[-1] // groups:(g + 1) * w.shape[-1] // groups]
            ys.append(torch.matmul(self.patches(xg).float(), reorder(wg)))
        y = ys[0] if groups == 1 else torch.cat(ys, dim=-1)
        return self.add_bias(y.to(x.dtype))


def lower_conv(mod: Conv, x: torch.Tensor) -> tuple[str, torch.Tensor, tuple[int, ...]]:
    """The im2col lowering of a converted ``Conv`` (the reference's
    ``lower_conv``): ``(kpath, patches, out_spatial)``, the conv being
    ``patches @ reorder(kernel)``. Raises ``NotImplementedError`` for what
    the Bayesian lowering does not take (a converted leaf must never run at
    mu with no KL term): ``feature_group_count > 1``, a kernel mask, an
    input that is not ``(N, *spatial, C)``, an unsupported padding."""
    kpath = mod.path + "/kernel"
    nd = mod.kernel.dim() - 2
    if mod.feature_group_count != 1:
        raise NotImplementedError(
            f"converted conv {kpath}: feature_group_count>1 has no Bayesian lowering "
            "here; exclude the layer from the conversion rules")
    if mod.mask is not None:
        raise NotImplementedError(
            f"converted conv {kpath}: kernel masks are not applied by the Bayesian "
            "im2col lowering; exclude the layer from the conversion rules")
    if x.dim() != nd + 2:
        raise NotImplementedError(
            f"converted conv {kpath}: expected batched (N, *spatial, C) input, got "
            f"ndim={x.dim()}")
    patches = mod.patches(x)  # raises for a padding that it does not take
    return kpath, patches, tuple(patches.shape[1:-1])

