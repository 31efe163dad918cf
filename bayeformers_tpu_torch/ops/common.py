"""Shared tiling constants and the absolute-unit eps stream.

Counterpart of ``bayeformers_tpu/ops/common.py`` (``unit_eps``,
``box_muller_pair``, ``uniform_from_bits``). The invariant is the same: the
standard normal for weight element (k, n) of draw s is a pure function of

    (seed[s], k_chunk = k // UNIT_K, col_strip = n // UNIT_N,
     k % UNIT_K, n % UNIT_N)

so any kernel, with any tiling, can rebuild any (UNIT_K, UNIT_N) unit, and a
sub-block drawn at a unit-aligned offset equals that slice of the full draw.

The bits come from Philox4x32-10 (Salmon et al., SC'11), keyed by
``(seed, unit_id)`` with ``unit_id = k_chunk * 2**16 + col_strip``. Inside a
unit, rows ``r`` and ``r + UNIT_K/2`` share one Box-Muller pair (cos branch
and sin branch), and columns ``c`` and ``c + 1`` (c even) share one Philox
call: counter ``((r * UNIT_N + c) >> 1, 0, 0, 0)``; column c takes output
words 0 and 1, column c + 1 words 2 and 3. Uniforms take the top 24 bits
plus half an ulp, so ``log(u1)`` is finite.

``csrc/eps.cuh`` is the device implementation of the same function; the
plain version here does the 32-bit arithmetic in int64 masked to 32 bits
(the 32x32->64 multiply is split into 16-bit halves so int64 never
overflows). The bits of the two are equal; the normals agree to a few ulps
(``log``/``sin``/``cos`` differ between math libraries). This stream does
not reproduce the JAX package's TPU or CPU bits, and need not: parity tests
feed both packages the same eps.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch

UNIT_K = 256
UNIT_N = 128
UNIT_STRIDE = 1 << 16  # unit id = k_chunk * stride + col_strip
TWO_PI = 2.0 * math.pi

_MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _mulhilo(m: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the constant ``m`` times uint32 words ``b``
    (held in int64), without overflowing int64."""
    p_lo = m * (b & 0xFFFF)   # < 2**48
    p_hi = m * (b >> 16)      # < 2**48
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi & _MASK32, lo


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 words (broadcasting)."""
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) -> float32 uniform in (0, 1]: top 24 bits scaled,
    offset by half an ulp off 0 (so ``log(u)`` is finite)."""
    u24 = (bits >> 8).to(torch.float32)
    return u24 * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def box_muller_pair(u1: torch.Tensor, u2: torch.Tensor):
    """Both Box-Muller outputs (cos and sin branch) in float32."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = torch.tensor(TWO_PI, dtype=torch.float32, device=u2.device) * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def philox_bits(seeds: torch.Tensor, k_idx: torch.Tensor, n_idx: torch.Tensor):
    """(bits1, bits2, is_sin) of the unit stream at absolute element
    coordinates: ``seeds`` (S,), ``k_idx`` (K,), ``n_idx`` (N,) int64 ->
    (S, K, N) int64 words and a (K, 1) bool row mask of the sin branch."""
    s = (seeds.to(torch.int64) & _MASK32)[:, None, None]
    k = k_idx[:, None]
    n = n_idx[None, :]
    unit = ((k // UNIT_K) * UNIT_STRIDE + n // UNIT_N) & _MASK32
    half = UNIT_K // 2
    r = (k % UNIT_K) % half
    pos = r * UNIT_N + n % UNIT_N
    ctr = (pos >> 1)[None]
    zero = torch.zeros_like(ctr)
    x0, x1, x2, x3 = philox4x32(ctr, zero, zero, zero, s, unit[None])
    odd = ((n % 2) == 1)[None]
    bits1 = torch.where(odd, x2, x0)
    bits2 = torch.where(odd, x3, x1)
    return bits1, bits2, (k % UNIT_K) >= half


def unit_offsets(offsets) -> tuple[int, int]:
    """The element offsets ``(k0, n0)`` of a weight shard within its whole
    layer (the reference's ``unit_offsets``), as two ints; None is (0, 0).
    They must be non-negative multiples of (UNIT_K, UNIT_N): the kernels draw
    by whole units, so only there does a shard draw exactly the slice of the
    whole layer's noise on every path. Anything else raises ValueError."""
    if offsets is None:
        return 0, 0
    k0, n0 = (int(v) for v in (offsets.tolist() if hasattr(offsets, "tolist") else offsets))
    if k0 < 0 or n0 < 0 or k0 % UNIT_K or n0 % UNIT_N:
        raise ValueError(f"unit_offsets {(k0, n0)} must be non-negative multiples of "
                         f"the eps units ({UNIT_K}, {UNIT_N})")
    return k0, n0


# The plain versions' working set: they take a weight of more elements than
# this in chunks (of rows, of draws), so that the plain Philox stream's
# int64 words and an f32 W stay a few GB at the published models' lm_heads
# (Gemma-2B: 10 draws of 2048 x 256000). Each element's arithmetic is the
# same in any chunk.
PLAIN_CHUNK_ELEMS = 1 << 27


def chunk_len(n: int, per_item: int) -> int:
    """How many of ``n`` items of ``per_item`` elements a plain version
    takes at once (:data:`PLAIN_CHUNK_ELEMS`), at least one."""
    return max(1, min(n, PLAIN_CHUNK_ELEMS // max(1, per_item)))


def chunk_cols(K: int, N: int, members: int) -> int:
    """The columns of a (K, N) weight that a plain version takes at once for
    ``members`` draws: all N within :data:`PLAIN_CHUNK_ELEMS`, else whole
    eps units of :data:`UNIT_N` columns (so that a column block draws its
    slice of the layer's noise at its unit offsets)."""
    if members * K * N <= PLAIN_CHUNK_ELEMS:
        return N
    return max(UNIT_N, PLAIN_CHUNK_ELEMS // (members * K) // UNIT_N * UNIT_N)


def unit_eps(seeds: torch.Tensor, shape: tuple[int, int],
             offsets: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """(S, K, N) float32 standard normals of the unit stream for a weight
    block whose [0, 0] corner sits at absolute element ``offsets`` (k0, n0),
    formed in chunks of rows (:func:`chunk_len`).

    Runs on ``seeds.device``; the bits are equal to ``csrc/eps.cuh``'s.
    """
    K, N = shape
    dev = seeds.device
    n_idx = torch.arange(N, dtype=torch.int64, device=dev) + int(offsets[1])
    out = torch.empty((seeds.shape[0], K, N), dtype=torch.float32, device=dev)
    rows = chunk_len(K, seeds.shape[0] * N)
    for r0 in range(0, K, rows):
        r1 = min(K, r0 + rows)
        k_idx = torch.arange(r0, r1, dtype=torch.int64, device=dev) + int(offsets[0])
        bits1, bits2, is_sin = philox_bits(seeds, k_idx, n_idx)
        z_cos, z_sin = box_muller_pair(uniform_from_bits(bits1),
                                       uniform_from_bits(bits2))
        out[:, r0:r1] = torch.where(is_sin[None], z_sin, z_cos)
    return out


class LaunchCounter:
    """How many times a wrapper launched its kernel, in all and per shape.

    The wrapper adds one where it launches the kernel and nowhere else, so
    a run can show that its main path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.by_shape: dict[tuple, int] = {}

    def add(self, shape: tuple) -> None:
        self.count += 1
        self.by_shape[shape] = self.by_shape.get(shape, 0) + 1

    def reset(self) -> None:
        self.count = 0
        self.by_shape = {}


KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def kernel_dtype(t: torch.Tensor, what: str) -> str:
    """The tag of ``t``'s dtype among the kernels' operand types (bf16 and
    f32); any other dtype raises."""
    tag = KERNEL_DTYPES.get(t.dtype)
    require(tag is not None,
            f"{what} kernel takes bf16 or float32 operands, got {t.dtype}")
    return tag


def tma_rows(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``(t, ld)`` for an operand that the kernels load by TMA: ``t`` itself
    when its rows are whole 16-byte chunks and it starts 16-byte aligned,
    else a copy whose rows are zero-padded to the next 16 bytes; ``ld`` is
    the row length of what is returned."""
    per = 16 // t.element_size()
    C = t.shape[-1]
    if C % per == 0 and t.data_ptr() % 16 == 0:
        return t, C
    ld = round_up(C, per)
    out = t.new_zeros(tuple(t.shape[:-1]) + (ld,))
    out[..., :C] = t
    return out, ld


def sm_count(t: torch.Tensor) -> int:
    """The number of streaming multiprocessors of ``t``'s card."""
    return _sm_count(t.device.index if t.device.index is not None
                     else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_device(t: torch.Tensor):
    """A context that makes ``t``'s card the current one (a no-op context
    when it is already)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def cuda_stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str, *args) -> None:
    """Raise ``ValueError`` unless ``cond`` holds (kernel input checks);
    the message is ``msg.format(*args)``, formed only on failure (the
    wrappers run on every layer of every step)."""
    if not cond:
        raise ValueError(msg.format(*args) if args else msg)
