"""The bf16 attention kernels' decomposition, in plain torch, on the CPU.

On the card the bf16 forward (``csrc/mha.cu``) walks key tiles of 128 for
each query tile of 64 rows (whole rows with the exact softmax up to L =
128, two walks above), and the backward (``csrc/mha_bwd.cu``) runs one block
per head up to L = 128 and two passes above; both skip the causal tiles
above the diagonal where exp(NEG_BIG - m) is 0 on every row of a query
tile. ``mha_tiled_plain`` and ``mha_bwd_tiled_plain`` walk the same tiles in
the same order with the same arithmetic and report the tiles they walked.
These tests hold them against ``mha_plain`` / ``mha_bwd_plain`` (f32 within
1e-6 of the largest entry, bf16 at the CPU gates of 2e-2) and against the
JAX package: the forward against ``_mha_xla`` and the head-grouped Pallas
forward ``_fwd_kernel_stacked`` (#3) in interpret mode, the backward
against the Pallas ``_bwd_kernel`` (#5) in interpret mode (1e-5 in f32, 2e-2
in bf16), at L = 128, 300 and 1024, head widths 32 and 64, causal or not,
with right-padded keys, a fully masked row, and a row whose first three
keys are masked: in causal attention its queries 0-2 see no live key, so
its first query tile mixes rows whose whole prefix is masked with normal
rows, and the skip must not fire there (those rows stay uniform over all L
keys), while it fires on the normal rows' tiles.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu.ops import attention as jat
from bayeformers_tpu_torch.ops import attention as at
from test_torch_gpt2 import _pallas
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

N, NH = 4, 2
JAX_TOLS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _inputs(L, H, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((N, L, H)).astype(np.float32) for _ in range(4))
    mask = np.ones((N, L), np.int32)
    mask[0, L - L // 3:] = 0  # right-padded keys
    mask[N - 2, :3] = 0       # queries 0-2 of a causal row see no live key
    mask[N - 1] = 0           # a fully masked row (a padded bucket row)
    return q, k, v, g, np.array(jat.mask_to_bias(jnp.asarray(mask)))


def _close(got, want, tol, rel_to_max=False):
    got = got.float().numpy()
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max())) if rel_to_max else tol
    np.testing.assert_allclose(got, want, atol=atol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("L", [128, 300, 1024])
def test_tiled_mirrors(L, d, causal, dtype):
    H = NH * d
    q, k, v, g, bias = _inputs(L, H, seed=L + d + causal)
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    tb = torch.from_numpy(bias)
    out, walked = at.mha_tiled_plain(tq, tk, tv, tb, NH, causal=causal)
    dq, dk, dv, wb = at.mha_bwd_tiled_plain(tq, tk, tv, tb, tg, NH, causal=causal)

    # against the plain versions
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    _close(out, at.mha_plain(tq, tk, tv, tb, NH, causal=causal), tol, True)
    for a, b in zip((dq, dk, dv), at.mha_bwd_plain(tq, tk, tv, tb, tg, NH, causal=causal)):
        _close(a, b, tol, True)

    # against the JAX package: _mha_xla, #3 and #5 in interpret mode
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jtol = JAX_TOLS[dtype]
    _close(out, jat._mha_xla(jq, jk, jv, jnp.asarray(bias), NH, causal), jtol)
    jb = jnp.asarray(bias)[:, None, :]
    _close(out, _pallas(functools.partial(jat._fwd_kernel_stacked, NH, causal, 2), 1,
                        jq, jk, jv, jb), jtol)
    grads = _pallas(functools.partial(jat._bwd_kernel, NH, causal), 3, jq, jk, jv, jb, jg)
    for a, b in zip((dq, dk, dv), grads):
        _close(a, b, jtol, True)

    # the fully masked row and the rows whose prefix is masked: uniform over
    # all L keys
    vbar = tv.float().mean(1)
    _close(out[N - 1], vbar[N - 1].expand(L, H), 2e-2 if dtype == torch.bfloat16 else 1e-5)
    if causal:
        _close(out[N - 2, :3], vbar[N - 2].expand(3, H),
               2e-2 if dtype == torch.bfloat16 else 1e-5)

    # the tiles walked, and the causal skip
    nt = -(-L // at.KEY_TILE)
    if not causal or nt == 1:
        assert (walked == nt).all() and (wb["dq"] == nt).all() and (wb["dkv"] == nt).all()
        return
    for w, rows in ((walked, at.QUERY_TILE), (wb["dq"], at.KEY_TILE)):
        # the forward's query tiles of 64 rows, the backward's blocks of 128
        pre = torch.tensor([(min(i * rows + rows, L) - 1) // at.KEY_TILE + 1
                            for i in range(-(-L // rows))])
        assert torch.equal(w[0], pre.expand(NH, -1))      # skips on every tile
        assert (w[N - 1] == nt).all()                     # all masked: never
        assert (w[N - 2, :, 0] == nt).all()               # the mixed tile: never
        assert torch.equal(w[N - 2, :, 1:], pre[1:].expand(NH, -1))
    steps = torch.arange(nt, 0, -1)  # key tile t: the query steps from t on
    assert torch.equal(wb["dkv"][0], steps.expand(NH, -1))
    assert (wb["dkv"][N - 1] == nt).all()
    # the mixed example's first step of 128 rows holds the mixed tile
    assert torch.equal(wb["dkv"][N - 2, :, 1:], (steps[1:] + 1).expand(NH, -1))
