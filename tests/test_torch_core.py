"""The port's core numerics against the JAX package's (core/, nn/fused.py
helpers), on the same numpy inputs."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu.core import distributions as jdist
from bayeformers_tpu.core import init as jinit
from bayeformers_tpu.core import prior as jprior
from bayeformers_tpu.nn import fused as jfused
from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.core import init as init_lib
from bayeformers_tpu_torch.core import prior as prior_lib
from bayeformers_tpu_torch.nn import fused as fused_lib
from bayeformers_tpu_torch.nn import surgery
from bayeformers_tpu_torch.nn.dense import Dense
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _np(x):
    return np.asarray(x, np.float32)


def test_constants_match():
    assert dist.LOG_SQRT_2PI == jdist.LOG_SQRT_2PI
    assert prior_lib.MOPED_PRIOR_SIGMA == jprior.MOPED_PRIOR_SIGMA
    assert prior_lib.ScaleMixturePrior() == prior_lib.DEFAULT_SCALE_MIXTURE
    d = prior_lib.DEFAULT_SCALE_MIXTURE
    j = jprior.DEFAULT_SCALE_MIXTURE
    assert (d.pi, d.sigma1, d.sigma2) == (j.pi, j.sigma1, j.sigma2)


def test_sigma_from_rho_and_inverse():
    rho = np.linspace(-30, 30, 1001).astype(np.float32)
    np.testing.assert_allclose(
        dist.sigma_from_rho(torch.from_numpy(rho)).numpy(),
        _np(jdist.sigma_from_rho(jnp.asarray(rho))), rtol=1e-6)
    y = np.linspace(1e-4, 5.0, 500).astype(np.float32)
    np.testing.assert_allclose(
        dist.inv_softplus(torch.from_numpy(y)).numpy(),
        _np(jdist.inv_softplus(jnp.asarray(y))), rtol=1e-6, atol=1e-6)


def test_log_densities():
    rng = np.random.default_rng(0)
    eps = rng.standard_normal((64, 32)).astype(np.float32)
    sig = rng.uniform(0.01, 2.0, (64, 32)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32) * 0.1
    # f32 sums of 2048 terms in different orders
    np.testing.assert_allclose(
        dist.gaussian_log_prob_from_eps(torch.from_numpy(eps), torch.from_numpy(sig)).item(),
        float(jdist.gaussian_log_prob_from_eps(jnp.asarray(eps), jnp.asarray(sig))),
        rtol=1e-6)
    np.testing.assert_allclose(
        prior_lib.DEFAULT_SCALE_MIXTURE.log_prob(torch.from_numpy(w)).item(),
        float(jprior.DEFAULT_SCALE_MIXTURE.log_prob(jnp.asarray(w))), rtol=1e-6)


def test_moped_rho_matches_including_zero_patch():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((40, 24)).astype(np.float32) * 0.05
    w[0, :5] = 0.0
    w[1, :3] = 1e-45  # delta*|w| underflows to 0
    got = init_lib.moped_rho(torch.from_numpy(w), 0.05).numpy()
    want = _np(jinit.moped_rho(jnp.asarray(w), 0.05))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got[0, :5] == 0.0).all() and (got[1, :3] == 0.0).all()


def test_tile_untile_match_jax():
    x = np.arange(24, dtype=np.int32).reshape(3, 8)
    t = fused_lib.tile_samples(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jfused.tile_samples(jnp.asarray(x), 4)))
    u = fused_lib.untile_samples(t, 4)
    assert u.shape == (4, 3, 8)
    for s in range(4):
        np.testing.assert_array_equal(u[s].numpy(), x)


def test_derive_seed():
    a = fused_lib.derive_seed(7, 3, 1)
    assert a == fused_lib.derive_seed(7, 3, 1)
    assert 0 <= a < 2**31
    seen = {fused_lib.derive_seed(7, i, t) for i in range(50) for t in range(5)}
    assert len(seen) == 250
    assert fused_lib.derive_seed(8, 3, 1) != a


def test_check_converted_paths_seen():
    paths = ("a/kernel", "a/bias", "b/kernel")
    fused_lib.check_converted_paths_seen(paths, {"a/kernel", "b/kernel"}, "fused")
    with pytest.raises(NotImplementedError):
        fused_lib.check_converted_paths_seen(paths, {"a/kernel"}, "fused")
    with pytest.raises(NotImplementedError):
        jfused.check_converted_paths_seen(paths, {"a/kernel"}, "fused")


def test_to_bayesian_converts_any_model_of_dense_layers():
    """Surgery knows layers, not models: a two-layer MLP of ``Dense``
    converts with MOPED rho at Flax-style paths, in the JAX package's order."""
    mlp = torch.nn.Module()
    mlp.hidden = Dense(5, 4)
    mlp.out = Dense(4, 3)
    torch.nn.init.normal_(mlp.hidden.kernel, 0.0, 0.1)
    torch.nn.init.normal_(mlp.out.kernel, 0.0, 0.1)
    b = surgery.to_bayesian(mlp, delta=0.05, freeze=True)
    assert b.spec.paths == ("hidden/bias", "hidden/kernel", "out/bias", "out/kernel")
    assert mlp.out.path == "out"
    np.testing.assert_array_equal(
        b.rho["hidden/kernel"].numpy(),
        init_lib.moped_rho(mlp.hidden.kernel.detach(), 0.05).numpy())
    assert not mlp.hidden.kernel.requires_grad
