"""The port's absolute-unit eps stream (bayeformers_tpu_torch/ops/common.py).

The plain-torch stream is held against an independent pure-Python-int
Philox4x32-10 here (same bits), against Random123's published known-answer
vectors, and against the unit-offset invariant of the JAX package's
``ops/common.py``: a sub-block drawn at a unit-aligned offset equals that
slice of the full draw.
"""
import math

import numpy as np
import pytest
import torch

from bayeformers_tpu_torch.ops import common
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

M32 = 0xFFFFFFFF


def philox_ref(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & M32
            k1 = (k1 + 0xBB67AE85) & M32
        p0 = 0xD2511F53 * c0
        p1 = 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0) & M32, p1 & M32, \
            ((p0 >> 32) ^ c3 ^ k1) & M32, p0 & M32
    return c0, c1, c2, c3


def ref_element(seed, k, n):
    """(bits1, bits2, z) of element (k, n) of the unit stream, in Python."""
    unit = ((k // 256) * (1 << 16) + n // 128) & M32
    r = (k % 256) % 128
    words = philox_ref(((r * 128 + n % 128) >> 1, 0, 0, 0), (seed & M32, unit))
    b1, b2 = (words[2], words[3]) if n % 2 else (words[0], words[1])
    u1 = (b1 >> 8) / 2**24 + 0.5 / 2**24
    u2 = (b2 >> 8) / 2**24 + 0.5 / 2**24
    rad = math.sqrt(-2.0 * math.log(u1))
    z = rad * (math.sin if k % 256 >= 128 else math.cos)(2 * math.pi * u2)
    return b1, b2, z


# Random123's kat_vectors for philox4x32_10
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,expected", KAT)
def test_philox_known_answers(ctr, key, expected):
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    out = common.philox4x32(*map(t, ctr), *map(t, key))
    assert tuple(int(o) for o in out) == expected
    assert philox_ref(ctr, key) == expected


@pytest.mark.parametrize("seed,offsets", [(0, (0, 0)), (5, (256, 128)),
                                          (2**31 - 1, (512, 0))])
def test_plain_stream_matches_python_philox(seed, offsets):
    K, N = 300, 130  # crosses a unit boundary in both directions
    k0, n0 = offsets
    seeds = torch.tensor([seed], dtype=torch.int32)
    b1, b2, _ = common.philox_bits(
        seeds, torch.arange(K) + k0, torch.arange(N) + n0)
    eps = common.unit_eps(seeds, (K, N), offsets)[0].numpy()
    rng = np.random.default_rng(seed % 1000)
    picks = list(zip(rng.integers(0, K, 400), rng.integers(0, N, 400)))
    picks += [(0, 0), (127, 127), (128, 0), (255, 129), (256, 128), (K - 1, N - 1)]
    for k, n in picks:
        rb1, rb2, z = ref_element(seed, k + k0, n + n0)
        assert int(b1[0, k, n]) == rb1 and int(b2[0, k, n]) == rb2, (k, n)
        # f32 log/sqrt/cos against float64: a few f32 ulps of |z| <= 6
        assert abs(float(eps[k, n]) - z) < 5e-6, (k, n, eps[k, n], z)


def test_unit_offset_invariant():
    seeds = torch.tensor([3, 99], dtype=torch.int32)
    full = common.unit_eps(seeds, (768, 384))
    for (k0, n0), (K, N) in [((256, 128), (512, 256)), ((512, 0), (256, 384)),
                             ((0, 256), (300, 100))]:
        sub = common.unit_eps(seeds, (K, N), (k0, n0))
        assert torch.equal(sub, full[:, k0:k0 + K, n0:n0 + N])


def test_eps_moments_and_seeds():
    draw = common.unit_eps(torch.tensor([42], dtype=torch.int32), (768, 768))
    assert abs(draw.mean().item()) < 0.01
    assert abs(draw.var().item() - 1.0) < 0.01
    again = common.unit_eps(torch.tensor([42], dtype=torch.int32), (768, 768))
    other = common.unit_eps(torch.tensor([43], dtype=torch.int32), (768, 768))
    assert torch.equal(draw, again)
    assert not torch.equal(draw, other)
    # the cos and sin halves of a unit are independent-looking normals
    c = torch.corrcoef(torch.stack([draw[0, :128].flatten(),
                                    draw[0, 128:256].flatten()]))[0, 1]
    assert abs(c.item()) < 0.03


def test_uniform_from_bits_stays_off_zero():
    u = common.uniform_from_bits(torch.tensor([0, M32, 1 << 31], dtype=torch.int64))
    assert u[0].item() == 2.0 ** -25  # half an ulp of the 24-bit grid
    assert u[1].item() <= 1.0         # 1 - 2^-25 rounds to 1.0 in f32
    assert torch.isfinite(torch.log(u)).all()
