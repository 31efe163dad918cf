"""Multi-head self-attention in the flat (N, L, H) layout.

Counterpart of ``bayeformers_tpu/ops/attention.py``: q/k/v arrive exactly as
the Bayesian linear op emits them and the output leaves in the layout the
out-projection consumes; head slicing happens inside the kernel. Semantics
follow HF BERT attention with the reference's one divergence: the score
accumulation and the softmax run in float32, while the dot operands stay in
the model dtype.

:func:`mha` is the wrapper, a ``torch.autograd.Function`` (:class:`MHA`)
as the reference's ``mha`` is a ``custom_vjp``: a CPU tensor takes the plain
versions :func:`mha_plain` (the counterpart of ``_mha_xla``) and
:func:`mha_bwd_plain` (the arithmetic of ``_bwd_kernel``); a CUDA tensor
launches ``csrc/mha.cu`` forward and ``csrc/mha_bwd.cu`` backward, or
raises. Both kernels take bf16 or f32 q/k/v (f32: true f32 products, the
dot operands in the stored dtype as in the reference), head widths 32 and
64 (:data:`HEAD_DIMS`; any other raises on a CUDA tensor), and any L: up
to :data:`ROWS_MAX_LEN` they keep whole score rows on chip, above it they
walk the keys in tiles with the same exact softmax.

The launch counters key each launch by ``(N, L, H, dtype, causal)``. The
reference runs two Pallas forwards of one function, the head-grouped #3
(``_fwd_kernel_stacked``) and the per-head #4 (``_fwd_kernel``), and picks
#4 where Pallas fits but no head group of 2 or more does
(:func:`pallas_route`, a copy of its VMEM model); the port's forward kernel
serves both, and a launch at a shape where the reference would take #4
counts in :data:`PER_HEAD_LAUNCHES` instead of :data:`LAUNCHES`.

``causal=True`` (the decoders) masks key j > query i with ``_mha_xla``'s
semantics (``attention.py:66-69``): ``where(j <= i, s + bias, NEG_BIG)``,
after the bias, a ``where`` and not an add. Bias-masked and causal-masked
scores then sit at the same ``NEG_BIG``, so a row whose every key is masked
(query 0 of a row whose first key is masked; a padded bucket row) comes out
uniform over all L keys, future keys included, as in the reference. The
backward follows the reference's ``_bwd_kernel`` (``attention.py:181``):
such a uniform row's dS reaches every key, future ones too, where XLA's
autodiff of ``_mha_xla`` (the JAX package's route off the TPU) gives the
causal-masked keys zero. The kernels mask in every pass and skip no key
tile above the diagonal (skipping would make the all-masked row uniform
over the causal prefix instead).
"""
from __future__ import annotations

import math

import torch

from bayeformers_tpu_torch.ops import _build, common

LAUNCHES = common.LaunchCounter("mha_fwd")
PER_HEAD_LAUNCHES = common.LaunchCounter("mha_fwd_per_head")
BWD_LAUNCHES = common.LaunchCounter("mha_bwd")
HEAD_DIMS = (32, 64)  # the kernels' head widths
ROWS_MAX_LEN = 512    # the longest L whose whole score rows the kernels keep
NEG_BIG = float(torch.finfo(torch.float32).min)

# the reference's VMEM model of its attention kernels (attention.py:246-314,
# its default limit, no BAYEFORMERS_VMEM_LIMIT_MB)
_NB, _VMEM_LIMIT, _TEMPS = 4, 14 * 1024 * 1024, 4 * 1024 * 1024


def _fits_nb(L: int, H: int, itemsize: int, n_arrays: int) -> bool:
    nb = _NB
    while nb >= 1:
        if n_arrays * nb * L * H * itemsize * 2 + _TEMPS <= _VMEM_LIMIT:
            return True
        nb //= 2
    return False


def pallas_route(L: int, H: int, n_heads: int, itemsize: int) -> str:
    """The reference's attention forward at a shape (``_mha_pallas_fwd`` and
    ``pallas_fits``, ``bayeformers_tpu/ops/attention.py:246-330``):
    ``"stacked"`` (#3) where a head group of 2 or more fits VMEM, else
    ``"per_head"`` (#4) where Pallas fits at all, else ``"xla"``."""
    if L % 8 or not (_fits_nb(L, H, itemsize, 5) and _fits_nb(L, H, itemsize, 8)):
        return "xla"
    for g in (g for g in range(n_heads, 1, -1) if n_heads % g == 0):
        nb = _NB
        while nb >= 1:
            if 4 * nb * L * H * itemsize * 2 + 2 * nb * g * L * L * 4 <= _VMEM_LIMIT:
                return "stacked"
            nb //= 2
    return "per_head"


def mask_to_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """(N, L) 1/0 keep-mask -> additive f32 bias (0 / finfo(f32).min)."""
    keep = attention_mask > 0
    return torch.where(
        keep, torch.zeros((), dtype=torch.float32, device=keep.device),
        torch.full((), NEG_BIG, dtype=torch.float32, device=keep.device),
    )


def causal_where(s: torch.Tensor) -> torch.Tensor:
    """``where(key <= query, s, NEG_BIG)`` over (..., L, L) f32 scores."""
    L = s.shape[-1]
    keep = torch.ones(L, L, dtype=torch.bool, device=s.device).tril()
    return torch.where(keep, s, torch.full((), NEG_BIG, dtype=s.dtype, device=s.device))


def mha_plain(q, k, v, bias, n_heads: int, causal: bool = False) -> torch.Tensor:
    """Plain version (``_mha_xla``): f32 scores and softmax, dot operands in
    the input dtype with f32 accumulation."""
    N, L, H = q.shape
    d = H // n_heads
    qh = q.reshape(N, L, n_heads, d).permute(0, 2, 1, 3).float()
    kh = k.reshape(N, L, n_heads, d).permute(0, 2, 1, 3).float()
    vh = v.reshape(N, L, n_heads, d).permute(0, 2, 1, 3).float()
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    scores = scores + bias[:, None, None, :].float()
    if causal:
        scores = causal_where(scores)
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p.to(q.dtype).float(), vh)
    return out.permute(0, 2, 1, 3).reshape(N, L, H).to(q.dtype)


def mha_bwd_plain(q, k, v, bias, g, n_heads: int, causal: bool = False):
    """Plain backward, written out as ``_bwd_kernel``: f32 scores and exact
    softmax P; P in the input dtype for dV = P^T g; dP = g V^T in f32;
    dS = P (dP - rowsum(dP P)) in f32, then the input dtype for
    dQ = dS K / sqrt(d) and dK = dS^T Q / sqrt(d); f32 accumulation."""
    N, L, H = q.shape
    d = H // n_heads
    scale = 1.0 / math.sqrt(d)
    dt = q.dtype

    def heads(t):
        return t.reshape(N, L, n_heads, d).permute(0, 2, 1, 3).float()

    def flat(t):
        return t.permute(0, 2, 1, 3).reshape(N, L, H).to(dt)

    qh, kh, vh, gh = heads(q), heads(k), heads(v), heads(g)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale + bias[:, None, None, :].float()
    if causal:
        s = causal_where(s)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = (p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    return flat(dq), flat(dk), flat(dv)


class MHA(torch.autograd.Function):
    """Attention with the reference's custom backward; ``plain`` runs the
    plain versions of both passes on the tensors' device."""

    @staticmethod
    def forward(ctx, q, k, v, bias, n_heads, causal, plain):
        ctx.save_for_backward(q, k, v, bias)
        ctx.n_heads, ctx.causal = n_heads, causal
        ctx.plain = plain or q.device.type == "cpu"
        return (mha_plain if ctx.plain else mha_cuda)(q, k, v, bias, n_heads, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        bwd = mha_bwd_plain if ctx.plain else mha_bwd_cuda
        dq, dk, dv = bwd(q, k, v, bias, g.contiguous(), ctx.n_heads, ctx.causal)
        return dq, dk, dv, None, None, None, None


def mha(q, k, v, bias, n_heads: int, *, causal: bool = False,
        plain: bool = False) -> torch.Tensor:
    """Self-attention over q/k/v (N, L, H) with an (N, L) key bias, causal
    (``key <= query``) with ``causal=True``; differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return MHA.apply(q, k, v, bias, n_heads, causal, plain)
    plain = plain or q.device.type == "cpu"
    return (mha_plain if plain else mha_cuda)(q, k, v, bias, n_heads, causal)


def _check_inputs(q, k, v, bias, n_heads: int, extra=()) -> str:
    """Raise on what the kernels do not take; returns q's dtype tag."""
    req = common.require
    req(q.is_cuda, f"mha kernel needs a CUDA tensor, got {q.device}")
    req(q.dim() == 3, "q/k/v must be (N, L, H)")
    N, L, H = q.shape
    tag = common.kernel_dtype(q, "mha")
    req(n_heads >= 1 and H % n_heads == 0 and H // n_heads in HEAD_DIMS,
        f"mha kernels take head widths {HEAD_DIMS}; H={H}, heads={n_heads} (wider "
        "heads: ROADMAP queue 2, the attention kernels' other head widths)")
    req(N >= 1 and L >= 1, f"mha kernels need N, L >= 1, got {(N, L)}")
    operands = (("k", k), ("v", v)) + tuple(extra)
    for name, t in operands:
        req(t.shape == q.shape and t.dtype == q.dtype,
            f"{name} must match q's shape and dtype")
    req(tuple(bias.shape) == (N, L) and bias.dtype == torch.float32,
        f"bias must be (N, L) float32, got {tuple(bias.shape)} {bias.dtype}")
    for name, t in (("q", q),) + operands + (("bias", bias),):
        req(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
        req(t.is_contiguous(), f"{name} must be contiguous")
        if name != "bias":
            req(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    return tag


def mha_cuda(q, k, v, bias, n_heads: int, causal: bool = False) -> torch.Tensor:
    """Launch ``bft_mha_fwd`` (csrc/mha.cu), the bf16 or the f32 instance,
    causal or not, whole-row or key-tiled; counted as #4 where the
    reference would take its per-head forward (:func:`pallas_route`)."""
    tag = _check_inputs(q, k, v, bias, n_heads)
    N, L, H = q.shape
    lib = _build.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.bft_mha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), N, L, H, n_heads, int(tag == "f32"), int(causal),
            common.cuda_stream(q),
        )
    _build.check(err, "bft_mha_fwd")
    per_head = pallas_route(L, H, n_heads, q.element_size()) == "per_head"
    (PER_HEAD_LAUNCHES if per_head else LAUNCHES).add((N, L, H, tag, causal))
    return out


def mha_bwd_cuda(q, k, v, bias, g, n_heads: int, causal: bool = False):
    """Launch ``bft_mha_bwd`` (csrc/mha_bwd.cu), the bf16 or the f32
    instance, causal or not: ``(dq, dk, dv)``."""
    tag = _check_inputs(q, k, v, bias, n_heads, extra=(("g", g),))
    N, L, H = q.shape
    lib = _build.library()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((3, N, n_heads, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.bft_mha_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), N, L, H, n_heads, int(tag == "f32"), int(causal),
            common.cuda_stream(q),
        )
    _build.check(err, "bft_mha_bwd")
    BWD_LAUNCHES.add((N, L, H, tag, causal))
    return dq, dk, dv
