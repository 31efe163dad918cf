"""The hand-built ``BayesLinear`` of the port (``bayeformers_tpu_torch.nn``)
against the JAX package's (``bayeformers_tpu/nn/layers.py``) at the JAX
layer's own draws, injected into the port (``eps=``, ``bias_eps=``):
outputs at rtol 1e-5, log-probs at rtol 2e-5 (XLA's CPU reductions sum in
another order), gradients of a loss of both."""
import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.nn import layers as jlayers
from bayeformers_tpu.ops import sampled_linear as jsl
from bayeformers_tpu_torch import nn as bnn
from bayeformers_tpu_torch.nn import layers as layers_lib

jax.config.update("jax_platforms", "cpu")


class HandBuilt(jnn.Module):
    """The reference README's two-layer Bayesian MLP (``README.md:34-56``)."""

    sample_axis: bool = False

    @jnn.compact
    def __call__(self, x):
        x = jnn.relu(jlayers.BayesLinear(24, name="fc1", sample_axis=self.sample_axis)(x))
        return jlayers.BayesLinear(6, name="fc2", sample_axis=self.sample_axis)(x)


class PortHandBuilt(torch.nn.Module):
    def __init__(self, sample_axis=False):
        super().__init__()
        self.fc1 = bnn.BayesLinear(12, 24, sample_axis=sample_axis, generator=1)
        self.fc2 = bnn.BayesLinear(24, 6, sample_axis=sample_axis, generator=2)

    def forward(self, x, draws=None):
        kw = [{}, {}] if draws is None else draws
        return self.fc2(torch.relu(self.fc1(x, **kw[0])), **kw[1])


def _jax_run(sample_axis, x, key, params=None):
    """The JAX model's forward under ``key``, with the draws its layers made:
    each layer's kernel seeds (its call to ``bayes_linear``) and its bias eps
    (its call to ``jax.random.normal``), in call order."""
    net = HandBuilt(sample_axis=sample_axis)
    if params is None:
        params = net.init({"params": jax.random.key(0), "bayes": jax.random.key(1)},
                          x)["params"]
    seeds, normals, inside = [], [], []
    orig_bl, orig_normal = jlayers.ops_fused.bayes_linear, jax.random.normal

    def bayes_linear(xs, mu, rho, s, **kw):
        seeds.append(np.asarray(s))
        inside.append(True)  # its own normals are the kernel's eps
        try:
            return orig_bl(xs, mu, rho, s, **kw)
        finally:
            inside.pop()

    def normal(*a, **k):
        out = orig_normal(*a, **k)
        if not inside:
            normals.append(np.asarray(out))
        return out

    jlayers.ops_fused.bayes_linear = bayes_linear
    jax.random.normal = normal
    try:
        out, aux = jlayers.bayes_apply(net, {"params": params}, key, x)
    finally:
        jlayers.ops_fused.bayes_linear = orig_bl
        jax.random.normal = orig_normal
    return net, params, out, aux, seeds, normals


def _port_from(params, sample_axis):
    port = PortHandBuilt(sample_axis)
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            for leaf in ("mu", "rho", "bias_mu", "bias_rho"):
                getattr(getattr(port, name), leaf).copy_(
                    torch.from_numpy(np.asarray(params[name][leaf])))
    return port


def _draws(params, seeds, normals):
    return [{"eps": torch.from_numpy(np.asarray(jsl.naive_eps(
                jnp.asarray(s), params[name]["mu"].shape))),
             "bias_eps": torch.from_numpy(b)}
            for name, s, b in zip(("fc1", "fc2"), seeds, normals)]


def _inputs(sample_axis, seed=0):
    rng = np.random.default_rng(seed)
    shape = (3, 5, 12) if sample_axis else (5, 12)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("sample_axis", [False, True])
def test_forward_and_kl_match_jax(sample_axis):
    x = _inputs(sample_axis)
    _, params, out, aux, seeds, normals = _jax_run(sample_axis, jnp.asarray(x),
                                                   jax.random.key(2))
    assert len(seeds) == len(normals) == 2
    port = _port_from(params, sample_axis)
    y = port(torch.from_numpy(x), _draws(params, seeds, normals))
    kl = bnn.collect_kl(port)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-6)
    for k in ("log_prior", "log_variational_posterior"):
        assert kl[k].shape == aux[k].shape == ((3,) if sample_axis else (1,))
        np.testing.assert_allclose(kl[k].detach().numpy(), np.asarray(aux[k]), rtol=2e-5)


@pytest.mark.parametrize("sample_axis", [False, True])
def test_gradients_match_jax(sample_axis):
    """d(sum y + log_q - log_p) / d(mu, rho, bias) of both at the same draws."""
    x = _inputs(sample_axis, seed=1)
    key = jax.random.key(3)
    net, params, _, _, seeds, normals = _jax_run(sample_axis, jnp.asarray(x), key)
    draws = _draws(params, seeds, normals)

    def loss(p):
        out, aux = jlayers.bayes_apply(net, {"params": p}, key, jnp.asarray(x))
        return (jnp.sum(out) + jnp.sum(aux["log_variational_posterior"])
                - jnp.sum(aux["log_prior"]))

    jgrads = jax.grad(loss)(params)
    port = _port_from(params, sample_axis)
    y = port(torch.from_numpy(x), draws)
    kl = bnn.collect_kl(port)
    (y.sum() + kl["log_variational_posterior"].sum() - kl["log_prior"].sum()).backward()
    for name in ("fc1", "fc2"):
        for leaf in ("mu", "rho", "bias_mu", "bias_rho"):
            got = getattr(getattr(port, name), leaf).grad.numpy()
            want = np.asarray(jgrads[name][leaf])
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"{name}/{leaf}")


def test_init_ranges_and_generator():
    layer = bnn.BayesLinear(16, 32, generator=torch.Generator().manual_seed(0))
    assert layer.mu.shape == (16, 32) and layer.rho.shape == (16, 32)
    assert float(layer.mu.abs().max()) <= 0.2
    assert -5.0 <= float(layer.rho.min()) and float(layer.rho.max()) <= -4.0
    again = bnn.BayesLinear(16, 32, generator=0)
    assert torch.equal(layer.mu, again.mu) and torch.equal(layer.bias_rho, again.bias_rho)
    x = torch.ones(4, 16)
    a, _ = bnn.bayes_apply(layer, 10, x)
    b, _ = bnn.bayes_apply(layer, torch.Generator().manual_seed(10), x)
    c, kl = bnn.bayes_apply(layer, 11, x)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert a.shape == (4, 32) and kl["log_prior"].shape == (1,)
    # one call's draws: each call of a layer records its own terms
    d = layer(x, generator=10)
    assert torch.equal(d, a) and len(layer.kl_terms) == 1
    assert torch.equal(bnn.collect_kl(layer)["log_prior"], _["log_prior"])
    assert layer.kl_terms == []


def test_what_raises():
    layer = bnn.BayesLinear(4, 3)
    with pytest.raises(ValueError, match="generator"):
        layer(torch.ones(2, 4))
    with pytest.raises(ValueError, match="no Bayesian layers"):
        bnn.collect_kl(torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="no Bayesian layers"):
        bnn.bayes_apply(torch.nn.Linear(2, 2), 0, torch.ones(1, 2))
    with pytest.raises(ValueError):
        jlayers.collect_kl({})  # the JAX package's counterpart raises too


def test_no_bias_and_the_kernel_route():
    """``use_bias=False``; a CPU tensor runs the plain version of
    ``bayes_linear`` (a CUDA one launches kernels #7/#8 and #9 or raises)."""
    layer = bnn.BayesLinear(8, 10, use_bias=False, sample_axis=True, generator=5)
    assert not hasattr(layer, "bias_mu")
    x = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(0))
    y, kl = bnn.bayes_apply(layer, 7, x)
    gen = torch.Generator().manual_seed(7)
    seeds = torch.randint(0, 2**31 - 1, (2,), generator=gen).to(torch.int32)
    want = layers_lib.ops_fused.bayes_linear_plain(x, layer.mu, layer.rho, seeds,
                                                   mixture=layer.mixture)
    torch.testing.assert_close(y, want[0], rtol=0, atol=0)
    torch.testing.assert_close(kl["log_prior"], want[2], rtol=0, atol=0)
