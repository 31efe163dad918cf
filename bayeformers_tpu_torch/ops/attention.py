"""Multi-head self-attention in the flat (N, L, H) layout.

Counterpart of ``bayeformers_tpu/ops/attention.py``: q/k/v arrive exactly as
the Bayesian linear op emits them and the output leaves in the layout the
out-projection consumes; head slicing happens inside the kernel. Semantics
follow HF BERT attention with the reference's one divergence: the score
accumulation and the softmax run in float32, while the dot operands stay in
the model dtype.

:func:`mha` is the wrapper: a CPU tensor takes the plain version
:func:`mha_plain` (the counterpart of ``_mha_xla``); a CUDA tensor launches
``csrc/mha.cu`` or raises.
"""
from __future__ import annotations

import math

import torch

from bayeformers_tpu_torch.ops import _build, common

LAUNCHES = common.LaunchCounter("mha_fwd")
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


def mha(q, k, v, bias, n_heads: int) -> torch.Tensor:
    """Self-attention over q/k/v (N, L, H) with an (N, L) key bias."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, bias, n_heads)
    return mha_cuda(q, k, v, bias, n_heads)


def mha_cuda(q, k, v, bias, n_heads: int) -> torch.Tensor:
    """Launch ``bft_mha_fwd`` (csrc/mha.cu)."""
    req = common.require
    req(q.is_cuda, f"mha kernel needs a CUDA tensor, got {q.device}")
    req(q.dim() == 3, "q/k/v must be (N, L, H)")
    N, L, H = q.shape
    req(q.dtype == torch.bfloat16, f"mha kernel takes bf16, got {q.dtype}")
    req(H == n_heads * HEAD_DIM,
        f"mha kernel needs a head width of {HEAD_DIM}; H={H}, heads={n_heads}")
    req(1 <= L <= MAX_LEN, f"mha kernel takes 1 <= L <= {MAX_LEN}, got {L}")
    for name, t in (("k", k), ("v", v)):
        req(t.shape == q.shape and t.dtype == q.dtype,
            f"{name} must match q's shape and dtype")
    req(tuple(bias.shape) == (N, L) and bias.dtype == torch.float32,
        f"bias must be (N, L) float32, got {tuple(bias.shape)} {bias.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        req(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
        req(t.is_contiguous(), f"{name} must be contiguous")
        if name != "bias":
            req(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
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
