"""Convolutions under ``CONV_RULE`` in the port against the JAX package, on
the CPU in f32.

The reference's two conv nets (``tests/test_conv.py``: ``TinyCNN``, a
strided SAME conv and a dilated VALID conv, and the Whisper-shaped
``TinyCNN1D``) are built in Flax and, from the port's ``Conv`` and
``Dense``, under the same names; the JAX package's conversion
(``to_bayesian(..., rules=(*DEFAULT_RULES, CONV_RULE))``, frozen MOPED,
MOPED with a trainable mu, random init) is carried over with
``from_jax_params(model=...)``. Held: the im2col patches and ``reorder``
against the JAX package's ``lower_conv`` (equal), the rule's paths, the
sigma -> 0 limit of every tier, and each tier at the JAX package's own
draws (``tests/test_torch_estimators.py::check_against_jax``: outputs 1e-4,
log-probs or KL 2e-5 relative, gradients 1e-4 of each leaf's largest
entry): the fused tier under both estimators, flipout, local
reparameterization and the naive tier (``TinyCNN1D`` here, ``TinyCNN``
under each conversion in ``tests/test_torch_conv_tiers.py`` and
``tests/test_torch_conv_estimators.py``). And the reference's refusals.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu.nn import fused as jfused
from bayeformers_tpu_torch.nn.conv import Conv, reorder
from bayeformers_tpu_torch.nn.dense import Dense, assign_paths
from test_torch_estimators import CONVERSIONS, check_against_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

JAX_RULES = (*bf.DEFAULT_RULES, bf.CONV_RULE)
RULES = (*bt.DEFAULT_RULES, bt.CONV_RULE)
S = 4


class JTinyCNN(fnn.Module):
    """The reference's ``TinyCNN`` (``tests/test_conv.py:22-35``)."""

    @fnn.compact
    def __call__(self, x):  # (N, 8, 8, 3)
        x = fnn.Conv(4, (3, 3), strides=(2, 2), padding="SAME", name="c0")(x)
        x = fnn.Conv(4, (2, 2), padding="VALID", kernel_dilation=(2, 2), name="c1")(
            fnn.relu(x))
        return fnn.Dense(5, name="head")(x.reshape((x.shape[0], -1)))


class JTinyCNN1D(fnn.Module):
    """The reference's ``TinyCNN1D`` (``tests/test_conv.py:38-47``)."""

    @fnn.compact
    def __call__(self, x):  # (N, 16, 3)
        x = fnn.gelu(fnn.Conv(4, (3,), padding=((1, 1),), name="c0")(x))
        x = fnn.gelu(fnn.Conv(4, (3,), strides=(2,), padding=((1, 1),), name="c1")(x))
        return fnn.Dense(3, name="head")(x.reshape((x.shape[0], -1)))


class TinyCNN(torch.nn.Module):
    """The port's ``TinyCNN``: (N, 8, 8, 3) -> 5 logits."""

    def __init__(self):
        super().__init__()
        self.c0 = Conv(3, 4, (3, 3), strides=(2, 2), padding="SAME")
        self.c1 = Conv(4, 4, (2, 2), padding="VALID", kernel_dilation=(2, 2))
        self.head = Dense(16, 5)
        assign_paths(self)

    def forward(self, x, mc=None):
        x = self.c1(torch.relu(self.c0(x, mc)), mc)
        return self.head(x.reshape(x.shape[0], -1), mc)


class TinyCNN1D(torch.nn.Module):
    """The port's ``TinyCNN1D``: (N, 16, 3) -> 3 logits, Flax's tanh GELU."""

    def __init__(self):
        super().__init__()
        self.c0 = Conv(3, 4, (3,), padding=((1, 1),))
        self.c1 = Conv(4, 4, (3,), strides=(2,), padding=((1, 1),))
        self.head = Dense(32, 3)
        assign_paths(self)

    def forward(self, x, mc=None):
        x = F.gelu(self.c0(x, mc), approximate="tanh")
        x = F.gelu(self.c1(x, mc), approximate="tanh")
        return self.head(x.reshape(x.shape[0], -1), mc)


NETS = {"2d": (JTinyCNN, TinyCNN, (4, 8, 8, 3), 5), "1d": (JTinyCNN1D, TinyCNN1D, (3, 16, 3), 3)}


def images(net, seed=0):
    shape = NETS[net][2]
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def jax_net(net):
    """The Flax net's apply function and its parameters, zero leaves moved
    to 0.01 (MOPED's sigma of a zero weight is softplus(0)), as the
    reference's tests keep them."""
    module = NETS[net][0]()
    params = module.init(jax.random.key(0), jnp.asarray(images(net)))["params"]
    params = jax.tree.map(lambda a: jnp.where(a == 0, jnp.full_like(a, 0.01), a), params)
    return (lambda p, x: module.apply({"params": p}, x)), params


def carry(bmodel, bp, model):
    spec = bmodel.spec
    return bt.from_jax_params(
        flatten_dict(bp.params, sep="/"), {p: np.asarray(r) for p, r in bp.rho.items()},
        prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
        prior=(spec.prior.pi, spec.prior.sigma1, spec.prior.sigma2),
        moped=spec.moped, frozen=spec.frozen, device="cpu", model=model)


@functools.lru_cache(maxsize=None)
def pair(net, conversion):
    """(conversion, the JAX BayesianModel, its BayesParams, the port's)."""
    apply_fn, params = jax_net(net)
    kw = CONVERSIONS[conversion] if isinstance(conversion, str) else dict(conversion)
    bmodel, bp = bf.to_bayesian(apply_fn, params, rules=JAX_RULES, **kw)
    name = conversion if isinstance(conversion, str) else "frozen-moped"
    return name, bmodel, bp, carry(bmodel, bp, NETS[net][1]())


# (spatial, kernel, strides, padding, kernel dilation, input dilation):
# TinyCNN's and TinyCNN1D's convs, the reference's lax cases
# (tests/test_conv.py:68-73), SAME_LOWER, explicit and negative pads with
# input dilation, and a 3-D conv
CASES = (
    ((8, 8), (3, 3), (2, 2), "SAME", (1, 1), None),
    ((4, 4), (2, 2), (1, 1), "VALID", (2, 2), None),
    ((16,), (3,), (2,), ((1, 1),), (1,), None),
    ((9, 10), (3, 4), (2, 2), "SAME", (1, 1), None),
    ((9, 10), (3, 4), (1, 2), "VALID", (2, 1), None),
    ((11,), (3,), (2,), "SAME", (1,), None),
    ((11,), (3,), (2,), "SAME_LOWER", (1,), None),
    ((7, 6), (2, 3), (1, 2), ((1, 2), (0, -1)), (1, 2), (2, 1)),
    ((5, 4, 6), (2, 2, 3), (1, 2, 1), 1, (1, 1, 2), None),
)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[3]}")
def test_lower_conv_matches_jax(case):
    """The port's im2col patches and ``reorder`` equal the JAX package's
    ``lower_conv`` (channel-major features, Flax's output order), and the
    port's frequentist ``Conv`` gives Flax's output within 1e-5."""
    spatial, ksize, strides, padding, kdil, idil = case
    x = np.random.default_rng(len(spatial)).normal(size=(2,) + spatial + (3,))
    x = x.astype(np.float32)
    mod = fnn.Conv(5, ksize, strides=strides, padding=padding, kernel_dilation=kdil,
                   input_dilation=idil)
    params = mod.init(jax.random.key(1), x)["params"]
    want = np.asarray(mod.apply({"params": params}, x))
    got = {}

    def probe(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Conv):
            _, mu, order, patches, _ = jfused.lower_conv(context.module, args[0])
            got["patches"], got["w"] = np.asarray(patches), np.asarray(order(mu))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(probe):
        mod.apply({"params": params}, x)
    conv = Conv(3, 5, ksize, strides=strides, padding=padding, kernel_dilation=kdil,
                input_dilation=idil)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(np.asarray(params["kernel"])))
        conv.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
        patches = conv.patches(torch.from_numpy(x))
        y = conv(torch.from_numpy(x))
    np.testing.assert_array_equal(patches.numpy(), got["patches"])
    np.testing.assert_array_equal(reorder(conv.kernel.detach()).numpy(), got["w"])
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("conv", [{"feature_group_count": 2}, {"mask": True}])
def test_grouped_and_masked_conv_match_flax(conv):
    """The frequentist ``Conv`` with Flax's feature groups or a kernel mask
    (the configurations the Bayesian lowering refuses) gives Flax's
    output within 1e-5."""
    x = np.random.default_rng(3).normal(size=(2, 9, 4)).astype(np.float32)
    mask = np.ones((3, 4, 6), np.float32)
    mask[1, :, ::2] = 0.0
    kw = {"mask": jnp.asarray(mask)} if "mask" in conv else conv
    mod = fnn.Conv(6, (3,), **kw)
    params = mod.init(jax.random.key(2), x)["params"]
    want = np.asarray(mod.apply({"params": params}, x))
    port = Conv(4, 6, (3,), **({"mask": torch.from_numpy(mask)} if "mask" in conv else conv))
    with torch.no_grad():
        port.kernel.copy_(torch.from_numpy(np.array(params["kernel"])))
        port.bias.copy_(torch.from_numpy(np.array(params["bias"])))
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("net", list(NETS))
def test_conv_rule_paths_match_jax(net):
    """``find_convertible_paths`` and ``to_bayesian(rules=...)`` give the JAX
    package's paths in its order: the default rules leave the convs
    frequentist, ``CONV_RULE`` converts their kernels and biases."""
    _, params = jax_net(net)
    model = NETS[net][1]()
    for jrules, rules in ((bf.DEFAULT_RULES, bt.DEFAULT_RULES), (JAX_RULES, RULES)):
        want = bf.find_convertible_paths(params, jrules)
        assert bt.find_convertible_paths(model, rules) == want
        assert bt.to_bayesian(NETS[net][1](), delta=0.05, rules=rules).spec.paths == want
    assert {"c0/kernel", "c0/bias", "c1/kernel", "c1/bias"} <= set(
        bt.find_convertible_paths(model, RULES))
    assert not any(p.startswith("c") for p in bt.find_convertible_paths(model))


@pytest.mark.parametrize("net", list(NETS))
def test_conv_sigma0_parity_all_tiers(net):
    """MOPED delta -> 0: every tier reproduces the frequentist forward
    through the converted convs (the reference's 1e-3)."""
    apply_fn, params = jax_net(net)
    _, bmodel, bp, port = pair(net, (("delta", 1e-6), ("freeze", True)))
    x = images(net)
    freq = np.asarray(apply_fn(params, x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(port.model(xt).numpy(), freq, rtol=1e-5, atol=1e-5)
        for fn in (port.mc_apply, port.mc_apply_fused, port.mc_apply_flipout,
                   port.mc_apply_lrt):
            out, aux = fn(0, 2, xt)
            assert out.shape == (2,) + freq.shape
            np.testing.assert_allclose(out[0].numpy(), freq, rtol=1e-3, atol=1e-3)
            assert all(torch.isfinite(v).all() for v in aux.values())


@pytest.mark.parametrize("estimator", ["antithetic", "flipout", "local", "naive"])
def test_conv1d_tier_matches_jax(estimator):
    """``TinyCNN1D`` (explicit pads, a strided 1-D conv) under frozen MOPED
    in each tier at the JAX package's draws."""
    check_against_jax(pair("1d", "frozen-moped"), estimator, {"x": images("1d", 1)}, (3, 3),
                      n_samples=S)


class _Grouped(torch.nn.Module):
    def __init__(self, **conv):
        super().__init__()
        self.g = Conv(4, 4, (3,), **conv)
        assign_paths(self)

    def forward(self, x, mc=None):
        return self.g(x, mc)


class _ConvTranspose(torch.nn.Module):
    """A transposed conv's parameter group, (k, cin, cout) and a bias, which
    the shape-only ``CONV_RULE`` matches (as it matches Flax's
    ``nn.ConvTranspose``) but no tier dispatches."""

    def __init__(self):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.randn(3, 3, 4) * 0.3)
        self.bias = torch.nn.Parameter(torch.full((4,), 0.01))

    def forward(self, x):
        w = self.kernel.permute(1, 2, 0)  # (cin, cout, k)
        return F.conv_transpose1d(x.transpose(1, 2), w, self.bias).transpose(1, 2)


class _TransposeNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.ConvTranspose_0 = _ConvTranspose()
        self.Dense_0 = Dense(4, 2)
        torch.nn.init.normal_(self.Dense_0.kernel, 0.0, 0.3)
        assign_paths(self)

    def forward(self, x, mc=None):
        return self.Dense_0(self.ConvTranspose_0(x).mean(dim=1), mc)


@pytest.mark.parametrize("what", ["feature_group_count", "mask", "ndim", "padding"])
def test_unsupported_conv_raises(what):
    """The reference's refusals (``lower_conv``): a grouped conv, a kernel
    mask, an input of the wrong rank and a padding the lowering does not
    take raise ``NotImplementedError`` in every tier instead of running
    the converted leaf at mu with no KL term."""
    conv = {"feature_group_count": {"feature_group_count": 2},
            "mask": {"mask": torch.ones(3, 4, 4)},
            "padding": {"padding": "CIRCULAR"}}.get(what, {})
    model = _Grouped(**conv)
    torch.nn.init.normal_(model.g.kernel, 0.0, 0.3)
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True, rules=RULES)
    assert "g/kernel" in bmodel.spec.paths
    x = torch.zeros((2, 8, 4) if what != "ndim" else (8, 4))
    for fn in (bmodel.mc_apply_fused, bmodel.mc_apply_flipout, bmodel.mc_apply_lrt,
               bmodel.mc_apply):
        with pytest.raises(NotImplementedError, match=what if what != "ndim" else "ndim="):
            fn(0, 2, x)


def test_converted_conv_transpose_raises():
    """A leaf that ``CONV_RULE`` converts but no tier dispatches (a
    transposed conv's group: the reference's ``nn.ConvTranspose``) has the
    JAX package's paths and raises in the fused, flipout and LRT tiers
    (``check_converted_paths_seen``), where running it at mu would
    silently bias the ELBO."""

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(2)(fnn.ConvTranspose(4, (3,))(x).mean(axis=1))

    x = np.random.default_rng(0).normal(size=(2, 8, 3)).astype(np.float32)
    params = Net().init(jax.random.key(0), x)["params"]
    want = bf.find_convertible_paths(params, JAX_RULES)
    bmodel = bt.to_bayesian(_TransposeNet(), delta=0.05, freeze=True, rules=RULES)
    assert bmodel.spec.paths == want
    assert "ConvTranspose_0/kernel" in want
    for fn in (bmodel.mc_apply_fused, bmodel.mc_apply_flipout, bmodel.mc_apply_lrt):
        with pytest.raises(NotImplementedError, match="never"):
            fn(0, 2, torch.from_numpy(x))
