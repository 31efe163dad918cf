"""Embedding tables under ``EMBEDDING_RULE`` in the port against the JAX
package, on the CPU in f32: the reference's ``EmbNet`` (``tests/
test_fused.py:150-196``, ``tests/test_lrt.py:158-185``: an ``Embed(11,
8)`` averaged into a ``Dense(4)``), built in Flax and from the port's
``Embed`` and ``Dense`` under the same names, converted by the JAX
package's ``to_bayesian(rules=(*DEFAULT_RULES, EMBEDDING_RULE))`` and
carried over with ``from_jax_params(model=...)``.

Held at the JAX package's own draws (``tests/test_torch_estimators.py::
check_against_jax``: outputs 1e-4, log-probs or KL 2e-5 relative,
gradients 1e-4 of each leaf's largest entry): the fused tier's sampled
tables (``sampled_weights``, pairs for antithetic draws) with their
log-probs at the tables and the gradients into mu and rho, LRT's
per-occurrence noise, the naive tier's per-sample tables; flipout raises
as the reference's does. A tiny BERT's tables are in
``tests/test_torch_embed_bert.py``.
"""
import functools

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu_torch.models.bert import Embed
from bayeformers_tpu_torch.nn.dense import Dense, assign_paths
from test_torch_conv import carry
from test_torch_estimators import CONVERSIONS, check_against_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

JAX_RULES = (*bf.DEFAULT_RULES, bf.EMBEDDING_RULE)
RULES = (*bt.DEFAULT_RULES, bt.EMBEDDING_RULE)
S, B, L = 4, 5, 7


class JEmbNet(fnn.Module):
    @fnn.compact
    def __call__(self, ids):
        x = fnn.Embed(num_embeddings=11, features=8, name="emb")(ids)
        return fnn.Dense(4, name="out")(x.mean(axis=1))


class EmbNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = Embed(11, 8)
        self.out = Dense(8, 4)
        assign_paths(self)

    def forward(self, ids, mc=None):
        return self.out(self.emb(ids, mc).mean(dim=1), mc)


def ids(seed=0):
    return np.random.default_rng(seed).integers(0, 11, (B, L)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def pair(conversion):
    """(conversion, the JAX BayesianModel, its BayesParams, the port's):
    the EmbNet's parameters with zero leaves at 0.01, as the reference's
    LRT test keeps them."""
    module = JEmbNet()
    params = module.init(jax.random.key(0), ids())["params"]
    params = jax.tree.map(lambda a: np.where(a == 0, np.float32(0.01), a), params)
    bmodel, bp = bf.to_bayesian(lambda p, ids: module.apply({"params": p}, ids), params,
                                rules=JAX_RULES, **CONVERSIONS[conversion])
    return conversion, bmodel, bp, carry(bmodel, bp, EmbNet())


def test_embedding_rule_paths_match_jax():
    """``EMBEDDING_RULE`` converts the table, the default rules do not; the
    paths and their order are the JAX package's."""
    _, bmodel, _, port = pair("moped-trainable")
    assert bmodel.spec.paths == port.spec.paths == ("emb/embedding", "out/bias",
                                                    "out/kernel")
    assert bt.find_convertible_paths(EmbNet(), RULES) == bmodel.spec.paths
    assert bt.find_convertible_paths(EmbNet()) == ("out/bias", "out/kernel")


@pytest.mark.parametrize("estimator,conversion",
                         [(e, c) for e in ("antithetic", "fused") for c in CONVERSIONS])
def test_fused_embedding_matches_jax(estimator, conversion):
    """The fused tier's tables, log-probs and gradients at the JAX package's
    draws; where mu trains, its gradient and rho's reach the table."""
    check_against_jax(pair(conversion), estimator, {"ids": ids(1)}, (B, 4), n_samples=S)


def test_fused_embedding_grads_reach_mu_and_rho():
    """The reference's ``test_fused_embedding_grads_flow``: the sampled
    tables are differentiable end to end, into mu and rho."""
    _, _, _, port = pair("moped-trainable")
    named = dict((n, t) for n, t, _ in port.trainable_parameters())
    for t in named.values():
        t.grad = None
    out, aux = port.mc_apply_fused(1, 2, torch.from_numpy(ids()).long())
    loss = torch.sum(out ** 2) + 1e-4 * torch.sum(
        aux["log_variational_posterior"] - aux["log_prior"])
    loss.backward()
    for name in ("rho/emb/embedding", "params/emb/embedding"):
        g = named[name].grad
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0, name


@pytest.mark.parametrize("estimator,conversion",
                         [(e, c) for e in ("local", "naive") for c in CONVERSIONS])
def test_embedding_tiers_match_jax(estimator, conversion):
    """LRT (each occurrence its own noise, the table's KL a kernel leaf's)
    and the naive tier (each sample's whole table) at the JAX package's
    draws."""
    check_against_jax(pair(conversion), estimator, {"ids": ids(1)}, (B, 4), n_samples=S)


def test_flipout_refuses_converted_embedding():
    """Flipout has no embedding handler in the reference: a converted table
    raises there (``check_converted_paths_seen``), and in the port."""
    _, bmodel, bp, port = pair("frozen-moped")
    with pytest.raises(NotImplementedError, match="emb/embedding"):
        bmodel.mc_apply_flipout(bp, jax.random.key(0), 2, ids())
    with pytest.raises(NotImplementedError, match="emb/embedding"):
        port.mc_apply_flipout(0, 2, torch.from_numpy(ids()).long())


def test_lrt_embedding_sigma0_matches_lookup():
    """The reference's ``test_lrt_embedding``: at MOPED delta 1e-5 the LRT
    lookup reproduces the deterministic one."""
    module = JEmbNet()
    params = module.init(jax.random.key(0), ids())["params"]
    params = jax.tree.map(lambda a: np.where(a == 0, np.float32(0.01), a), params)
    bmodel, bp = bf.to_bayesian(lambda p, x: module.apply({"params": p}, x), params,
                                delta=1e-5, freeze=True, rules=JAX_RULES)
    port = carry(bmodel, bp, EmbNet())
    freq = np.asarray(module.apply({"params": params}, ids()))
    out, aux = port.mc_apply_lrt(1, 3, torch.from_numpy(ids()).long())
    np.testing.assert_allclose(out[1].detach().numpy(), freq, rtol=1e-3, atol=1e-4)
    assert torch.isfinite(aux["kl"])
