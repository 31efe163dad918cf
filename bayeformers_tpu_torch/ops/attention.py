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
raises. Causal masking comes with the GPT-2 slice.
"""
from __future__ import annotations

import math

import torch

from bayeformers_tpu_torch.ops import _build, common

LAUNCHES = common.LaunchCounter("mha_fwd")
BWD_LAUNCHES = common.LaunchCounter("mha_bwd")
HEAD_DIM = 64   # the kernel's head width
MAX_LEN = 512   # BERT's max position; the kernel keeps whole score rows
NEG_BIG = float(torch.finfo(torch.float32).min)


def mask_to_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """(N, L) 1/0 keep-mask -> additive f32 bias (0 / finfo(f32).min)."""
    keep = attention_mask > 0
    return torch.where(
        keep, torch.zeros((), dtype=torch.float32, device=keep.device),
        torch.full((), NEG_BIG, dtype=torch.float32, device=keep.device),
    )


def mha_plain(q, k, v, bias, n_heads: int) -> torch.Tensor:
    """Plain version (``_mha_xla``): f32 scores and softmax, dot operands in
    the input dtype with f32 accumulation."""
    N, L, H = q.shape
    d = H // n_heads
    qh = q.reshape(N, L, n_heads, d).permute(0, 2, 1, 3).float()
    kh = k.reshape(N, L, n_heads, d).permute(0, 2, 1, 3).float()
    vh = v.reshape(N, L, n_heads, d).permute(0, 2, 1, 3).float()
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    scores = scores + bias[:, None, None, :].float()
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p.to(q.dtype).float(), vh)
    return out.permute(0, 2, 1, 3).reshape(N, L, H).to(q.dtype)


def mha_bwd_plain(q, k, v, bias, g, n_heads: int):
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
    def forward(ctx, q, k, v, bias, n_heads, plain):
        ctx.save_for_backward(q, k, v, bias)
        ctx.n_heads = n_heads
        ctx.plain = plain or q.device.type == "cpu"
        return (mha_plain if ctx.plain else mha_cuda)(q, k, v, bias, n_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        bwd = mha_bwd_plain if ctx.plain else mha_bwd_cuda
        dq, dk, dv = bwd(q, k, v, bias, g.contiguous(), ctx.n_heads)
        return dq, dk, dv, None, None, None


def mha(q, k, v, bias, n_heads: int, *, plain: bool = False) -> torch.Tensor:
    """Self-attention over q/k/v (N, L, H) with an (N, L) key bias;
    differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return MHA.apply(q, k, v, bias, n_heads, plain)
    plain = plain or q.device.type == "cpu"
    return (mha_plain if plain else mha_cuda)(q, k, v, bias, n_heads)


def _check_inputs(q, k, v, bias, n_heads: int, extra=()) -> None:
    req = common.require
    req(q.is_cuda, f"mha kernel needs a CUDA tensor, got {q.device}")
    req(q.dim() == 3, "q/k/v must be (N, L, H)")
    N, L, H = q.shape
    req(q.dtype == torch.bfloat16, f"mha kernel takes bf16, got {q.dtype}")
    req(H == n_heads * HEAD_DIM,
        f"mha kernel needs a head width of {HEAD_DIM}; H={H}, heads={n_heads}")
    req(1 <= L <= MAX_LEN, f"mha kernel takes 1 <= L <= {MAX_LEN}, got {L}")
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


def mha_cuda(q, k, v, bias, n_heads: int) -> torch.Tensor:
    """Launch ``bft_mha_fwd`` (csrc/mha.cu)."""
    _check_inputs(q, k, v, bias, n_heads)
    N, L, H = q.shape
    lib = _build.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.bft_mha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), N, L, H, n_heads, common.cuda_stream(q),
        )
    _build.check(err, "bft_mha_fwd")
    LAUNCHES.add((N, L, H))
    return out


def mha_bwd_cuda(q, k, v, bias, g, n_heads: int):
    """Launch ``bft_mha_bwd`` (csrc/mha_bwd.cu): ``(dq, dk, dv)``."""
    _check_inputs(q, k, v, bias, n_heads, extra=(("g", g),))
    N, L, H = q.shape
    lib = _build.library()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((3, N, n_heads, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.bft_mha_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), N, L, H, n_heads, common.cuda_stream(q),
        )
    _build.check(err, "bft_mha_bwd")
    BWD_LAUNCHES.add((N, L, H))
    return dq, dk, dv
