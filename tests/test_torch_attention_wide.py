"""The attention kernels at head widths 128 and 256, in plain torch, on the CPU.

On the card the forward (#3, and #4's instance) and the backward (#5) take
head widths 128 (LLaMA-2, Mistral-7B) and 256 (Gemma) besides 32 and 64.
Their tiles change with the width (``csrc/attention.cuh::key_tile``,
``csrc/mha_bwd.cu::mha_bwd_dkv_split``): at 128 the forward keeps whole
rows up to L = 128 and walks key tiles of 128 above, the backward runs one
block per head up to L = 128 and two passes above, pass 2 over key tiles of
64 whose two warpgroups split the columns of dV and dK; at 256 the key tile
is 64 and both walk at every L. ``mha_tiled_plain`` and
``mha_bwd_tiled_plain`` mirror those tiles. These tests hold the mirrors
and the plain versions against each other (f32 within 1e-6 of the largest
entry, bf16 at 2e-2) and against the JAX package: ``_mha_xla``, the
head-grouped Pallas forward ``_fwd_kernel_stacked`` (#3), the per-head
``_fwd_kernel`` (#4) and ``_bwd_kernel`` (#5) in interpret mode (1e-5 in
f32, 2e-2 in bf16), at L = 128 and a key-tiled L = 320, causal or not, with
right-padded keys, a fully masked row and a row whose first three keys are
masked; and the tiles the mirrors walk, the causal skip included. A width
that stays unported (96) is refused with the message that names it.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu.ops import attention as jat
from bayeformers_tpu_torch.ops import attention as at
from test_torch_attention_tiles import _close, _inputs, JAX_TOLS, N, NH
from test_torch_gpt2 import _pallas
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _walked_fwd(L, rows, kt, causal, nt):
    """The key tiles each query tile of ``rows`` rows walks in the causal
    skip's normal case: its causal prefix."""
    if not causal:
        return torch.full((-(-L // rows),), nt)
    return torch.tensor([(min(i * rows + rows, L) - 1) // kt + 1 for i in range(-(-L // rows))])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("L", [128, 320])
def test_wide_mirrors(L, d, causal, dtype):
    H = NH * d
    q, k, v, g, bias = _inputs(L, H, seed=L + d + causal)
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    tb = torch.from_numpy(bias)
    out, walked = at.mha_tiled_plain(tq, tk, tv, tb, NH, causal=causal)
    dq, dk, dv, wb = at.mha_bwd_tiled_plain(tq, tk, tv, tb, tg, NH, causal=causal)

    # against the plain versions
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    ref = at.mha_plain(tq, tk, tv, tb, NH, causal=causal)
    _close(out, ref, tol, True)
    grads = at.mha_bwd_plain(tq, tk, tv, tb, tg, NH, causal=causal)
    for a, b in zip((dq, dk, dv), grads):
        _close(a, b, tol, True)

    # against the JAX package: _mha_xla, #3, #4 and #5 in interpret mode
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jtol = JAX_TOLS[dtype]
    _close(ref, jat._mha_xla(jq, jk, jv, jnp.asarray(bias), NH, causal), jtol)
    jb = jnp.asarray(bias)[:, None, :]
    for kernel in (functools.partial(jat._fwd_kernel_stacked, NH, causal, 2),
                   functools.partial(jat._fwd_kernel, NH, causal)):
        _close(out, _pallas(kernel, 1, jq, jk, jv, jb), jtol)
    jgrads = _pallas(functools.partial(jat._bwd_kernel, NH, causal), 3, jq, jk, jv, jb, jg)
    for a, b, c in zip((dq, dk, dv), grads, jgrads):
        _close(a, c, jtol, True)
        _close(b, c, jtol, True)

    # the fully masked row and the rows whose prefix is masked: uniform over
    # all L keys
    vbar = tv.float().mean(1)
    utol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    _close(out[N - 1], vbar[N - 1].expand(L, H), utol)
    if causal:
        _close(out[N - 2, :3], vbar[N - 2].expand(3, H), utol)

    # the tiles walked, and the causal skip
    kt, kt2, qb = at.key_tile(d), at.dkv_tile(d), at.BWD_QUERY_BLOCK
    nt, nqb = -(-L // kt), -(-L // qb)
    if at.whole_rows(d, L):
        assert nt == 1 and (walked == 1).all() and (wb["dq"] == 1).all()
        assert (wb["dkv"] == 1).all()
        return
    for w, rows in ((walked, at.QUERY_TILE), (wb["dq"], qb)):
        pre = _walked_fwd(L, rows, kt, causal, nt)
        assert torch.equal(w[0], pre.expand(NH, -1))      # skips on every tile
        assert (w[N - 1] == nt).all()                     # all masked: never
        assert (w[N - 2, :, 0] == nt).all()               # the mixed tile: never
        assert torch.equal(w[N - 2, :, 1:], pre[1:].expand(NH, -1))
    # key tile t of pass 2 skips the steps of 128 rows wholly before it
    before = torch.tensor([sum(causal and (s + 1) * qb <= t * kt2 for s in range(nqb))
                           for t in range(-(-L // kt2))])
    mixed = torch.tensor([sum(causal and s > 0 and (s + 1) * qb <= t * kt2
                              for s in range(nqb)) for t in range(-(-L // kt2))])
    assert torch.equal(wb["dkv"][0], (nqb - before).expand(NH, -1))
    assert (wb["dkv"][N - 1] == nqb).all()
    assert torch.equal(wb["dkv"][N - 2], (nqb - mixed).expand(NH, -1))


def test_unported_width_refused():
    """Width 96, which the reference takes, raises with the message that
    names the ported widths and the item that holds the rest, before any
    card is needed; the ported widths pass the width check (and then need
    a CUDA tensor)."""
    x = torch.zeros(2, 16, 192)
    bias = torch.zeros(2, 16)
    with pytest.raises(ValueError, match=r"head widths \(32, 64, 128, 256\); H=192, "
                                         r"heads=2: the other multiples of 8"):
        at.mha_cuda(x, x, x, bias, 2, causal=True)
    with pytest.raises(ValueError, match="ROADMAP queue 2"):
        at.mha_bwd_cuda(x, x, x, bias, x, 2)
    wide = torch.zeros(2, 16, 256)
    for heads in (1, 2, 4, 8):  # widths 256, 128, 64 and 32
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            at.mha_cuda(wide, wide, wide, bias, heads)
