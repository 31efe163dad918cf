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
dot operands in the stored dtype as in the reference), head widths 32, 64,
128 and 256 (:data:`HEAD_DIMS`; any other raises on a CUDA tensor), and
any L with the reference's exact softmax: the bf16 instances (wgmma fed by
TMA) keep whole score rows in registers up to L = 128 at widths up to 128
and walk key tiles of :func:`key_tile` keys above it (and at every L at
width 256); the f32 instances keep whole rows in shared memory up to
:func:`rows_max_len`. :func:`mha_tiled_plain` and
:func:`mha_bwd_tiled_plain` mirror the bf16 kernels' tiles in plain torch
for the tests; nothing on the card's path uses them.

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
causal-masked keys zero. The kernels mask in every pass. The bf16
instances skip a key tile above the diagonal of every row of a query tile
only where exp(NEG_BIG - m) is 0 in f32 on each of them (m the row's max
over its causal prefix): the skipped keys would add exactly zero, so no bit
changes, and a tile holding a row whose prefix is all masked walks all L
keys (skipping there would make that row uniform over its prefix instead).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from bayeformers_tpu_torch.ops import _build, common

LAUNCHES = common.LaunchCounter("mha_fwd")
PER_HEAD_LAUNCHES = common.LaunchCounter("mha_fwd_per_head")
BWD_LAUNCHES = common.LaunchCounter("mha_bwd")
HEAD_DIMS = (32, 64, 128, 256)  # the kernels' head widths
KEY_TILE = 128      # the bf16 kernels' key tile up to width 128: whole rows up to this L
ROWS_MAX_LEN = 512  # the f32 kernels' whole rows up to width 128: up to this L
BWD_QUERY_BLOCK = 128  # the bf16 backward's blocks (pass 1) and steps (pass 2) of query rows
NEG_BIG = float(torch.finfo(torch.float32).min)


def key_tile(d: int) -> int:
    """The bf16 kernels' key tile at head width ``d`` (``csrc/attention.cuh::
    key_tile``): 128, or 64 at 256, where O's and dQ's accumulators leave
    registers for the scores of 64 keys only."""
    return 64 if d >= 256 else KEY_TILE


def rows_max_len(d: int) -> int:
    """The longest L of the f32 kernels' whole-row design at head width
    ``d``: 512, or 256 at 256, where the q and k tiles take 133 KB of shared
    memory."""
    return 256 if d >= 256 else ROWS_MAX_LEN


def whole_rows(d: int, L: int) -> bool:
    """Whether the bf16 kernels hold whole score rows (one key tile, the
    backward in one pass) at head width ``d`` and length ``L``: up to L =
    128 at widths up to 128; width 256 walks the key tiles at every L."""
    return d <= 128 and L <= KEY_TILE


def dkv_tile(d: int) -> int:
    """The keys of a block of the bf16 backward's pass 2 at head width
    ``d``: 128, or 64 at widths 128 and 256, whose two warpgroups split the
    D columns of dV and dK (``csrc/mha_bwd.cu::mha_bwd_dkv_split``)."""
    return 64 if d >= 128 else KEY_TILE

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


@functools.lru_cache(maxsize=None)
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


def plain_attention(q, k, v, bias, n_heads: int, scale: bool = True) -> torch.Tensor:
    """Attention of (N, Lq, H) q over (N, Lk, H) k and v in plain torch,
    where the reference leaves attention to XLA (T5's, Whisper's, the
    KV-cache decode's): f32 scores, q scaled by ``d ** -0.5`` first unless
    ``scale=False`` (T5's unscaled logits), an additive f32 ``bias``
    broadcastable to (N, heads, Lq, Lk) or None, the softmax in f32, the
    probabilities in q's dtype, the product accumulated in f32."""
    N, Lq, H = q.shape
    d = H // n_heads
    qh = q.reshape(N, Lq, n_heads, d).float()
    if scale:
        qh = qh / math.sqrt(d)
    s = torch.einsum("nqhd,nkhd->nhqk", qh, k.reshape(N, k.shape[1], n_heads, d).float())
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1).to(q.dtype)
    ctx = torch.einsum("nhqk,nkhd->nqhd", p.float(), v.reshape(N, v.shape[1], n_heads, d).float())
    return ctx.reshape(N, Lq, H).to(q.dtype)


def cache_kv(cache, k, v):
    """A decode's KV cache ``(K, V, start)`` (each (B, max_len, ...)) with
    ``k`` and ``v`` (B, l, ...) written at positions ``[start, start + l)``:
    returns its keys and values up to ``start + l``."""
    kc, vc, start = cache
    end = start + k.shape[1]
    kc[:, start:end] = k
    vc[:, start:end] = v
    return kc[:, :end], vc[:, :end]


def cache_bias(key_mask: torch.Tensor, start: int, n_new: int,
               window: Optional[int] = None) -> torch.Tensor:
    """The f32 bias of ``n_new`` queries at cache positions ``[start,
    start + n_new)`` over the cache's first ``start + n_new`` keys: 0 where
    a key is real (``key_mask`` (B, >= start + n_new)), at or before the
    query and, with ``window``, no more than ``window`` before it; finfo.min
    elsewhere. (B, 1, n_new, start + n_new)."""
    end = start + n_new
    q = torch.arange(start, end, device=key_mask.device)[:, None]
    k = torch.arange(end, device=key_mask.device)[None, :]
    keep = k <= q
    if window is not None:
        keep = keep & (k >= q - window)
    keep = keep[None] & (key_mask[:, None, :end] > 0)
    return mask_to_bias(keep)[:, None]


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


QUERY_TILE = 64  # query rows of a bf16 kernel's warpgroup


def _heads(t, n_heads):
    N, L, H = t.shape
    return t.reshape(N, L, n_heads, H // n_heads).permute(0, 2, 1, 3).float()


def _tile_scores(qh, kh, bias, q0, q1, t, causal, kt=KEY_TILE):
    """The masked f32 scores of queries [q0, q1) and key tile ``t`` of
    ``kt`` keys (keys past L absent), as the kernels form them."""
    d, L = qh.shape[-1], kh.shape[2]
    k0, k1 = t * kt, min((t + 1) * kt, L)
    s = torch.matmul(qh[:, :, q0:q1], kh[:, :, k0:k1].transpose(-1, -2)) * (1.0 / math.sqrt(d))
    s = s + bias[:, None, None, k0:k1].float()
    if causal:
        above = (torch.arange(k0, k1, device=s.device)[None]
                 > torch.arange(q0, q1, device=s.device)[:, None])
        s = torch.where(above, torch.full((), NEG_BIG, device=s.device), s)
    return s


def _future_is_zero(m) -> torch.Tensor:
    """exp(NEG_BIG - m) == 0 in f32, per row: the keys past a row's causal
    prefix add exactly zero to it."""
    return torch.exp(NEG_BIG - m) == 0.0


def _prefix_tiles(q0, q1, n_tiles, causal, kt=KEY_TILE) -> int:
    return (q1 - 1) // kt + 1 if causal else n_tiles


def mha_tiled_plain(q, k, v, bias, n_heads: int, causal: bool = False):
    """The bf16 forward kernel's decomposition in plain torch (nothing on
    the card's path uses it): query tiles of :data:`QUERY_TILE` rows, key
    tiles of :func:`key_tile` keys; one tile of whole rows with the exact row
    softmax (:func:`whole_rows`), or the two walks (the row max and sum carried and rescaled,
    then P = exp(s - m) / l and O += P v), with the causal skip: a query
    tile walks the tiles of its causal prefix, then skips the tiles past it
    when exp(NEG_BIG - m) == 0 on every row. Returns ``(out, walked)``,
    ``walked[n, h, i]`` the key tiles that query tile i of head h of
    example n walked (in each walk)."""
    N, L, H = q.shape
    dt, d = q.dtype, H // n_heads
    kt = key_tile(d)
    qh, kh, vh = (_heads(t, n_heads) for t in (q, k, v))
    nt, nqt = -(-L // kt), -(-L // QUERY_TILE)
    out = torch.empty_like(qh)
    walked = torch.empty(N, n_heads, nqt, dtype=torch.int64)
    for i in range(nqt):
        q0, q1 = i * QUERY_TILE, min((i + 1) * QUERY_TILE, L)
        pre = _prefix_tiles(q0, q1, nt, causal, kt)
        live = torch.ones(N, n_heads, 1, 1, dtype=torch.bool, device=q.device)

        def pv(p, t):
            return torch.matmul(p.to(dt).float(), vh[:, :, t * kt:(t + 1) * kt])

        if whole_rows(d, L):
            s = _tile_scores(qh, kh, bias, q0, q1, 0, causal)
            e = torch.exp(s - s.amax(-1, keepdim=True))
            out[:, :, q0:q1] = pv(e * (1.0 / e.sum(-1, keepdim=True)), 0)
            walked[:, :, i] = 1
            continue
        m = torch.full((N, n_heads, q1 - q0, 1), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        for t in range(nt):
            if t == pre:  # the skip test, after the causal prefix
                live = ~_future_is_zero(m).all(2, keepdim=True)
            s = _tile_scores(qh, kh, bias, q0, q1, t, causal, kt)
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            ln = l * torch.exp(m - mn) + torch.exp(s - mn).sum(-1, keepdim=True)
            m, l = torch.where(live, mn, m), torch.where(live, ln, l)
        walked[:, :, i] = torch.where(live[..., 0, 0], nt, pre)
        o = torch.zeros_like(out[:, :, q0:q1])
        for t in range(nt):
            p = torch.exp(_tile_scores(qh, kh, bias, q0, q1, t, causal, kt) - m) * (1.0 / l)
            o = torch.where(live | (t < pre), o + pv(p, t), o)
        out[:, :, q0:q1] = o
    return out.permute(0, 2, 1, 3).reshape(N, L, H).to(dt), walked


def mha_bwd_tiled_plain(q, k, v, bias, g, n_heads: int, causal: bool = False):
    """The bf16 backward kernels' decomposition in plain torch (nothing on
    the card's path uses it). Where :func:`whole_rows` holds, one block per
    head: the exact softmax, D, dS, and the five products. Otherwise pass 1
    walks each block of :data:`BWD_QUERY_BLOCK` query rows over the key
    tiles of :func:`key_tile` keys twice (the row max, the sum l of exp(s -
    m) and the sum dd of exp(s - m) dP carried and rescaled, D = dd / l;
    then dS and dQ += dS k) with the forward's causal skip over the block's
    rows, and pass 2 walks each key tile of :func:`dkv_tile` keys over the
    query rows in steps of :data:`BWD_QUERY_BLOCK`, rebuilding P from pass
    1's statistics, skipping a step wholly before the tile where pass 1
    skipped. Returns ``(dq, dk, dv, walked)`` with ``walked["dq"][n, h, b]``
    the key tiles block b of query rows walked (in each walk) and
    ``walked["dkv"][n, h, t]`` the query steps key tile t walked."""
    N, L, H = q.shape
    dt, d = q.dtype, H // n_heads
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, gh = (_heads(t, n_heads) for t in (q, k, v, g))
    kt, kt2, qb = key_tile(d), dkv_tile(d), BWD_QUERY_BLOCK
    nt, nqb = -(-L // kt), -(-L // qb)
    dev = q.device

    def rows(t, a, b):
        return t[:, :, a:b]

    def keys(t, tile, width=kt):
        return t[:, :, tile * width:(tile + 1) * width]

    def flat(t):
        return t.permute(0, 2, 1, 3).reshape(N, L, H).to(dt)

    if whole_rows(d, L):
        s = _tile_scores(qh, kh, bias, 0, L, 0, causal)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
        dp = torch.matmul(gh, vh.transpose(-1, -2))
        ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
        dq = torch.matmul(ds, kh) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
        dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
        ones = torch.ones(N, n_heads, 1, dtype=torch.int64)
        return flat(dq), flat(dk), flat(dv), {"dq": ones, "dkv": ones}

    # pass 1: per block of query rows, the statistics, D and dQ
    stat_m, stat_l, stat_d = (torch.empty(N, n_heads, L, 1, device=dev) for _ in range(3))
    flags = torch.zeros(N, n_heads, nqb, dtype=torch.bool)
    walked_q = torch.empty(N, n_heads, nqb, dtype=torch.int64)
    dq = torch.empty_like(qh)
    for b in range(nqb):
        q0, q1 = b * qb, min((b + 1) * qb, L)
        pre = _prefix_tiles(q0, q1, nt, causal, kt)
        live = torch.ones(N, n_heads, 1, 1, dtype=torch.bool, device=dev)
        m = torch.full((N, n_heads, q1 - q0, 1), float("-inf"), device=dev)
        l, dd = torch.zeros_like(m), torch.zeros_like(m)
        for t in range(nt):
            if t == pre:
                live = ~_future_is_zero(m).all(2, keepdim=True)
            s = _tile_scores(qh, kh, bias, q0, q1, t, causal, kt)
            dp = torch.matmul(rows(gh, q0, q1), keys(vh, t).transpose(-1, -2))
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            e, alpha = torch.exp(s - mn), torch.exp(m - mn)
            ln = l * alpha + e.sum(-1, keepdim=True)
            ddn = dd * alpha + (e * dp).sum(-1, keepdim=True)
            m, l, dd = (torch.where(live, a, b) for a, b in ((mn, m), (ln, l), (ddn, dd)))
        flags[:, :, b] = ~live[..., 0, 0]
        walked_q[:, :, b] = torch.where(live[..., 0, 0], nt, pre)
        dsum = dd / l
        acc = torch.zeros(N, n_heads, q1 - q0, d, device=dev)
        for t in range(nt):
            s = _tile_scores(qh, kh, bias, q0, q1, t, causal, kt)
            dp = torch.matmul(rows(gh, q0, q1), keys(vh, t).transpose(-1, -2))
            ds = (torch.exp(s - m) / l * (dp - dsum)).to(dt).float()
            acc = torch.where(live | (t < pre), acc + torch.matmul(ds, keys(kh, t)), acc)
        dq[:, :, q0:q1] = acc * scale
        stat_m[:, :, q0:q1], stat_l[:, :, q0:q1], stat_d[:, :, q0:q1] = m, l, dsum

    # pass 2: per key tile, dK and dV over the query rows in steps
    nt2 = -(-L // kt2)
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    walked_kv = torch.empty(N, n_heads, nt2, dtype=torch.int64)
    for t in range(nt2):
        k0, k1 = t * kt2, min((t + 1) * kt2, L)
        ak = torch.zeros(N, n_heads, k1 - k0, d, device=dev)
        av = torch.zeros_like(ak)
        count = torch.zeros(N, n_heads, dtype=torch.int64)
        for step in range(nqb):
            q0, q1 = step * qb, min((step + 1) * qb, L)
            before = causal and (step + 1) * qb <= k0  # rows wholly before the tile
            skip = flags[:, :, step] if before else torch.zeros_like(flags[:, :, 0])
            s = _tile_scores(qh, kh, bias, q0, q1, t, causal, kt2)
            p = torch.exp(s - rows(stat_m, q0, q1)) / rows(stat_l, q0, q1)
            dp = torch.matmul(rows(gh, q0, q1), keys(vh, t, kt2).transpose(-1, -2))
            ds = (p * (dp - rows(stat_d, q0, q1))).to(dt).float()
            live = ~skip.to(dev)[..., None, None]
            av = torch.where(live, av + torch.matmul(p.to(dt).float().transpose(-1, -2),
                                                     rows(gh, q0, q1)), av)
            ak = torch.where(live, ak + torch.matmul(ds.transpose(-1, -2), rows(qh, q0, q1)), ak)
            count += ~skip
        dk[:, :, k0:k1], dv[:, :, k0:k1] = ak * scale, av
        walked_kv[:, :, t] = count
    return flat(dq), flat(dk), flat(dv), {"dq": walked_q, "dkv": walked_kv}


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
    """Raise on what the kernels do not take; returns q's dtype tag. The
    messages are formed only on failure (``common.require``)."""
    req = common.require
    req(q.dim() == 3, "q/k/v must be (N, L, H)")
    N, L, H = q.shape
    req(n_heads >= 1 and H % n_heads == 0 and H // n_heads in HEAD_DIMS,
        "mha kernels take head widths {}; H={}, heads={}: the other multiples of 8 "
        "that the reference takes (80, 96, ...) are not ported yet (ROADMAP queue 2, "
        "the attention kernels' other head widths)", HEAD_DIMS, H, n_heads)
    req(q.is_cuda, "mha kernel needs a CUDA tensor, got {}", q.device)
    tag = common.kernel_dtype(q, "mha")
    req(N >= 1 and L >= 1, "mha kernels need N, L >= 1, got {}", (N, L))
    operands = (("k", k), ("v", v)) + tuple(extra)
    for name, t in operands:
        req(t.shape == q.shape and t.dtype == q.dtype,
            "{} must match q's shape and dtype", name)
    req(tuple(bias.shape) == (N, L) and bias.dtype == torch.float32,
        "bias must be (N, L) float32, got {} {}", tuple(bias.shape), bias.dtype)
    for name, t in (("q", q),) + operands + (("bias", bias),):
        req(t.device == q.device, "{} is on {}, q on {}", name, t.device, q.device)
        req(t.is_contiguous(), "{} must be contiguous", name)
        req(name == "bias" or t.data_ptr() % 16 == 0, "{} must be 16-byte aligned", name)
    return tag


def mha_cuda(q, k, v, bias, n_heads: int, causal: bool = False) -> torch.Tensor:
    """Launch ``bft_mha_fwd`` (csrc/mha.cu), the bf16 or the f32 instance,
    causal or not, whole-row or key-tiled; counted as #4 where the
    reference would take its per-head forward (:func:`pallas_route`)."""
    tag = _check_inputs(q, k, v, bias, n_heads)
    N, L, H = q.shape
    lib = _build.library()
    out = torch.empty_like(q)
    with common.on_device(q):
        err = lib.bft_mha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), N, L, H, n_heads, int(tag == "f32"), int(causal),
            common.cuda_stream(q),
        )
    _build.check(err, "bft_mha_fwd")
    per_head = pallas_route(L, H, n_heads, q.element_size()) == "per_head"
    (PER_HEAD_LAUNCHES if per_head else LAUNCHES).add((N, L, H, tag, causal))
    return out


def bwd_stats_size(N: int, L: int, n_heads: int) -> int:
    """The backward's scratch in 4-byte words: each row's max, sum and D
    (f32), then each query block's causal-skip flag (int32), a block of
    :data:`BWD_QUERY_BLOCK` rows at every head width."""
    return 3 * N * n_heads * L + N * n_heads * -(-L // BWD_QUERY_BLOCK)


def mha_bwd_cuda(q, k, v, bias, g, n_heads: int, causal: bool = False):
    """Launch ``bft_mha_bwd`` (csrc/mha_bwd.cu), the bf16 or the f32
    instance, causal or not: ``(dq, dk, dv)``."""
    tag = _check_inputs(q, k, v, bias, n_heads, extra=(("g", g),))
    N, L, H = q.shape
    lib = _build.library()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = q.new_empty((bwd_stats_size(N, L, n_heads),), dtype=torch.float32)
    with common.on_device(q):
        err = lib.bft_mha_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), N, L, H, n_heads, int(tag == "f32"), int(causal),
            common.cuda_stream(q),
        )
    _build.check(err, "bft_mha_bwd")
    BWD_LAUNCHES.add((N, L, H, tag, causal))
    return dq, dk, dv
