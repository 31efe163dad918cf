"""The port's flat-layout attention (plain versions) against the JAX
package: the forward against ``ops/attention.py::_mha_xla`` and the backward
against ``jax.vjp`` of ``ops/attention.py::mha``, including all-masked rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu.ops import attention as jat
from bayeformers_tpu_torch.ops import attention as at
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _inputs(N=4, L=16, H=128, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((N, L, H)).astype(np.float32) for _ in range(3))
    mask = np.ones((N, L), np.int32)
    mask[0, L - 5:] = 0   # padded keys
    mask[2] = 0           # a fully masked row (a padded bucket row)
    return q, k, v, mask


def test_mask_to_bias_matches_jax():
    _, _, _, mask = _inputs()
    got = at.mask_to_bias(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jat.mask_to_bias(jnp.asarray(mask))))
    assert got.min() == np.finfo(np.float32).min


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_mha_plain_matches_mha_xla(dtype, atol):
    q, k, v, mask = _inputs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    bias = np.asarray(jat.mask_to_bias(jnp.asarray(mask)))
    want = jat._mha_xla(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bias), 2)
    t = lambda a: torch.from_numpy(a).to(dtype)
    got = at.mha_plain(t(q), t(k), t(v), torch.from_numpy(bias), 2)
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=atol)
    # the fully masked row is finite and uniform over the keys
    row = got[2].float().numpy()
    assert np.isfinite(row).all()
    np.testing.assert_allclose(row, np.broadcast_to(
        t(v)[2].float().numpy().mean(0), row.shape), atol=atol, rtol=atol)


def test_wrapper_on_cpu_is_the_plain_version():
    q, k, v, mask = _inputs(seed=1)
    bias = at.mask_to_bias(torch.from_numpy(mask))
    t = torch.from_numpy
    before = at.LAUNCHES.count
    assert torch.equal(at.mha(t(q), t(k), t(v), bias, 2),
                       at.mha_plain(t(q), t(k), t(v), bias, 2))
    assert at.LAUNCHES.count == before


def test_kernel_wrapper_checks_inputs():
    q, k, v, mask = _inputs()
    bias = at.mask_to_bias(torch.from_numpy(mask))
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        at.mha_cuda(bf(q), bf(k), bf(v), bias, 2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_mha_bwd_plain_matches_jax_vjp(dtype, tol):
    q, k, v, mask = _inputs(seed=3)
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    bias = np.asarray(jat.mask_to_bias(jnp.asarray(mask)))
    _, vjp = jax.vjp(lambda a, b, c: jat.mha(a, b, c, jnp.asarray(bias), 2),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(g, jdt))
    t = lambda a: torch.from_numpy(a).to(dtype)
    got = at.mha_bwd_plain(t(q), t(k), t(v), torch.from_numpy(bias), t(g), 2)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == q.shape
        b = np.asarray(b, np.float32)
        # f32: the same arithmetic in another summation order; bf16: one
        # bf16 rounding of P and dS (and of the outputs) on either side
        np.testing.assert_allclose(a.float().numpy(), b, rtol=tol,
                                   atol=tol * np.abs(b).max(), err_msg=name)
        # the fully masked row 2 (uniform P) included, and finite
        assert np.isfinite(a.float().numpy()).all()


def test_function_backward_is_the_plain_backward():
    q, k, v, mask = _inputs(seed=5)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(q.shape).astype(np.float32))
    bias = at.mask_to_bias(torch.from_numpy(mask))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = at.BWD_LAUNCHES.count
    at.mha(qt, kt, vt, bias, 2).backward(g)
    want = at.mha_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v)), bias, g, 2)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        assert torch.equal(got, ref)
    assert at.BWD_LAUNCHES.count == before
    # and against autograd through the plain forward (f32)
    qa, ka, va = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    at.mha_plain(qa, ka, va, bias, 2).backward(g)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), (qa.grad, ka.grad, va.grad)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_bwd_kernel_wrapper_takes_no_cpu_tensor():
    q, k, v, mask = _inputs()
    bias = at.mask_to_bias(torch.from_numpy(mask))
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        at.mha_bwd_cuda(bf(q), bf(k), bf(v), bias, bf(q), 2)
