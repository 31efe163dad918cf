"""The attention op's head-width-32 and long-sequence instances against the
JAX package, on the CPU.

On the card, ``mha_cuda`` and ``mha_bwd_cuda`` take head widths 32 and 64
and any L (key-tiled above L = 512); on the CPU their plain versions
stand in, and these tests hold those plain versions against the reference:

- head width 32 (the LLaMA families' tiny configurations) against the JAX
  package's own Pallas kernels in interpret mode, the head-grouped forward
  ``_fwd_kernel_stacked`` (#3), the per-head forward ``_fwd_kernel`` (#4)
  and the backward ``_bwd_kernel`` (#5), causal or not, with right-padded
  keys, a fully masked row and a first-key-masked row;
- #4 at the shape where the reference takes it (H = 128, four heads, L =
  1024), and the port's copy of the reference's VMEM model that picks #3,
  #4 or XLA (``pallas_route``) against the reference's own;
- L = 520 (a tail key tile on the card), where the reference runs
  ``_mha_xla``: the forward against it and the backward against
  ``jax.vjp`` of it, 1e-5 in f32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu.ops import attention as jat
from bayeformers_tpu_torch.ops import attention as at
from test_torch_gpt2 import _pallas
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TOLS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _inputs(N, L, H, seed, all_masked=True):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((N, L, H)).astype(np.float32) for _ in range(4))
    mask = np.ones((N, L), np.int32)
    mask[0, L - L // 3:] = 0  # right-padded keys
    if all_masked:
        mask[N - 1] = 0       # a fully masked row (a padded bucket row)
        mask[N - 2, 0] = 0    # the first key masked: query 0 sees no live key
    return q, k, v, g, np.array(jat.mask_to_bias(jnp.asarray(mask)))


def _jx(dtype, *arrays):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return [jnp.asarray(a, jdt) for a in arrays]


def _tt(dtype, *arrays):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_width_32_against_the_pallas_kernels(dtype, causal):
    """``mha_plain`` at head width 32 against #3 and #4 in interpret mode,
    ``mha_bwd_plain`` against #5, on every row (all-masked ones uniform)."""
    nh, tol = 4, TOLS[dtype]
    q, k, v, g, bias = _inputs(4, 24, 128, seed=1)
    jq, jk, jv, jg = _jx(dtype, q, k, v, g)
    jb = jnp.asarray(bias)[:, None, :]
    stacked = _pallas(functools.partial(jat._fwd_kernel_stacked, nh, causal, 2), 1,
                      jq, jk, jv, jb)
    per_head = _pallas(functools.partial(jat._fwd_kernel, nh, causal), 1, jq, jk, jv, jb)
    grads = _pallas(functools.partial(jat._bwd_kernel, nh, causal), 3, jq, jk, jv, jb, jg)
    tq, tk, tv, tg = _tt(dtype, q, k, v, g)
    tb = torch.from_numpy(bias)
    got = at.mha_plain(tq, tk, tv, tb, nh, causal=causal)
    for ref in (stacked, per_head):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)
    for a, b in zip(at.mha_bwd_plain(tq, tk, tv, tb, tg, nh, causal=causal), grads):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=tol, rtol=tol)
    vbar = tv.float().numpy().mean(1)
    np.testing.assert_allclose(got[3].float().numpy(), np.broadcast_to(vbar[3], (24, 128)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_head_forward_at_its_shape(dtype):
    """#4's shape: H = 128, four heads (d = 32), L = 1024, causal, where the
    reference's VMEM model finds no head group (``pallas_route``); the plain
    version against ``_fwd_kernel`` in interpret mode."""
    L, H, nh = 1024, 128, 4
    isz = 4 if dtype == torch.float32 else 2
    assert at.pallas_route(L, H, nh, isz) == "per_head"
    assert jat.pallas_fits(L, H, isz) and jat._pick_nb_stacked(L, H, nh, isz) is None
    q, k, v, _, bias = _inputs(2, L, H, seed=2, all_masked=False)
    jq, jk, jv = _jx(dtype, q, k, v)
    want = _pallas(functools.partial(jat._fwd_kernel, nh, True), 1, jq, jk, jv,
                   jnp.asarray(bias)[:, None, :])
    tq, tk, tv = _tt(dtype, q, k, v)
    got = at.mha_plain(tq, tk, tv, torch.from_numpy(bias), nh, causal=True)
    tol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_pallas_route_is_the_references():
    """The port's copy of the reference's route (the launch counters' #3 or
    #4) agrees with ``_pick_nb_stacked`` and ``pallas_fits`` over the
    families' shapes and lengths up to 4096."""
    for H, nh in ((128, 4), (128, 2), (768, 12), (512, 8)):
        for isz in (2, 4):
            for L in list(range(8, 4097, 56)) + [77, 197, 520, 1020]:
                if not jat.pallas_fits(L, H, isz):
                    want = "xla"
                elif jat._pick_nb_stacked(L, H, nh, isz) is not None:
                    want = "stacked"
                else:
                    want = "per_head"
                assert at.pallas_route(L, H, nh, isz) == want, (L, H, nh, isz)


@pytest.mark.parametrize("causal", [False, True])
def test_long_sequence_against_xla(causal):
    """L = 520 at H = 768 (head width 64), where the reference takes
    ``_mha_xla`` (the port's key-tiled instances on the card): the
    forward against it and the backward against ``jax.vjp`` of it, 1e-5 in
    f32 (rows with a live key: on an all-masked row XLA's autodiff and the
    reference's ``_bwd_kernel`` differ, the port follows the latter, pinned
    at head width 32 above)."""
    L, H, nh = 520, 768, 12
    assert at.pallas_route(L, H, nh, 4) == "xla" and L > at.ROWS_MAX_LEN
    q, k, v, g, bias = _inputs(2, L, H, seed=3, all_masked=False)
    jq, jk, jv, jg = _jx(torch.float32, q, k, v, g)
    jb = jnp.asarray(bias)
    want, vjp = jax.vjp(lambda a, b, c: jat._mha_xla(a, b, c, jb, nh, causal), jq, jk, jv)
    tq, tk, tv, tg = _tt(torch.float32, q, k, v, g)
    tb = torch.from_numpy(bias)
    got = at.mha_plain(tq, tk, tv, tb, nh, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for a, b in zip(at.mha_bwd_plain(tq, tk, tv, tb, tg, nh, causal=causal), vjp(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    # under autograd the op takes the same plain backward and counts no launch
    before = (at.LAUNCHES.count, at.PER_HEAD_LAUNCHES.count, at.BWD_LAUNCHES.count)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    at.mha(*leaves, tb, nh, causal=causal).backward(tg)
    for t, ref in zip(leaves, at.mha_bwd_plain(tq, tk, tv, tb, tg, nh, causal=causal)):
        assert torch.equal(t.grad, ref)
    assert (at.LAUNCHES.count, at.PER_HEAD_LAUNCHES.count, at.BWD_LAUNCHES.count) == before
