"""The port's LLaMA-architecture families (LLaMA, Mistral, Gemma) against
the JAX package, on the CPU in f32.

Tiny Flax models (``bayeformers_tpu/models/llama.py``, seed 0: two layers,
hidden 128, four heads over two kv heads, head width 32, vocab 1024) are
carried over with ``from_jax_params`` and the port's ``LlamaConfig``: the
frequentist logits against the stock Flax ``apply`` (1e-4, right-padded
keys and a first-key-masked row), Mistral's window narrower than the
sequence against the stock banded attention, the converted paths (2 x 7
kernels and ``lm_head``, no biases, embeddings or norms), the sigma -> 0
limit of the fused, naive and local tiers, and ``mc_apply_fused`` at the
JAX package's own draws under both estimators and the three conversions
(logits 1e-4, log-probs 2e-5 relative), which covers rotary, GQA's k/v
repetition after rotary and Gemma's quirks through the tiers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu.models import llama as jllama
from bayeformers_tpu_torch.models import llama as llama_lib
from test_torch_bert import _jax_hook
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, B, L = 4, 3, 16
FAMILIES = ("llama", "mistral", "gemma")
CONVERSIONS = {"frozen-moped": {"delta": 0.05, "freeze": True},
               "moped-trainable": {"delta": 0.05},
               "random-init": {"rng": jax.random.key(5)}}


def _batch(seed=0, L_=L):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, (B, L_)).astype(np.int32)
    mask = np.ones((B, L_), np.int32)
    mask[1, 10:] = 0  # right padding
    mask[2, 0] = 0    # the first key masked
    return ids, mask


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _config(bundle, family):
    return llama_lib.LlamaConfig.from_dict(family, bundle.config.to_dict())


def _port(bundle, family, bp=None, spec=None, **kw):
    """The port's model on the Flax weights (``bp``: a converted tree)."""
    if bp is None:
        return bt.from_jax_params(flatten_dict(bundle.params, sep="/"), {}, moped=False,
                                  frozen=False, config=_config(bundle, family),
                                  device="cpu", **kw)
    return bt.from_jax_params(
        flatten_dict(bp.params, sep="/"), {p: np.asarray(r) for p, r in bp.rho.items()},
        prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
        prior=(spec.prior.pi, spec.prior.sigma1, spec.prior.sigma2),
        moped=spec.moped, frozen=spec.frozen, config=_config(bundle, family),
        device="cpu", **kw)


_BUNDLES = {}


def _bundle(family, **overrides):
    key = (family,) + tuple(sorted(overrides.items()))
    if key not in _BUNDLES:
        _BUNDLES[key] = jllama.build_llama_family(family, size="tiny", seed=0, **overrides)
    return _BUNDLES[key]


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_stock_flax(family):
    """The port's model on the Flax weights gives the stock module's logits
    (f32, 1e-4); its parameter names are the Flax paths, and a fresh port
    build has the same tree."""
    bundle = _bundle(family)
    port = _port(bundle, family)
    ids, mask = _batch(1)
    want = bundle.apply_fn(bundle.params, jnp.asarray(ids), jnp.asarray(mask))
    got = port.model(_t(ids), _t(mask))
    assert got.shape == (B, L, 1024)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    fresh = bt.build_llama_family(family, "tiny", seed=0, device="cpu")
    assert {n.replace(".", "/") for n, _ in fresh.named_parameters()} == set(
        flatten_dict(bundle.params, sep="/"))


def test_mistral_window_matches_stock():
    """Mistral with a window narrower than the sequence: the stock banded
    attention (the frequentist logits 1e-4) and the fused tier at the JAX
    draws against the JAX package's, whose attention handler declines there
    (logits 1e-4); the port's mha is never called on that path."""
    bundle = _bundle("mistral", sliding_window=5)
    ids, mask = _batch(2)
    port = _port(bundle, "mistral")
    want = bundle.apply_fn(bundle.params, jnp.asarray(ids), jnp.asarray(mask))
    calls = []
    orig = llama_lib.ops_attention.mha

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    llama_lib.ops_attention.mha = counting
    try:
        got = port.model(_t(ids), _t(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
        bmodel, bp = bf.to_bayesian(bundle.apply_fn, bundle.params, delta=0.05, freeze=True)
        bport = _port(bundle, "mistral", bp, bmodel.spec)
        key = jax.random.key(3)
        out, _ = bmodel.mc_apply_fused(bp, key, S, input_ids=jnp.asarray(ids),
                                       attention_mask=jnp.asarray(mask), antithetic=True)
        logits, _ = bport.mc_apply_fused(0, S, _t(ids), _t(mask), antithetic=True,
                                         eps_hook=_jax_hook(bmodel, key))
        np.testing.assert_allclose(logits.numpy(), np.asarray(out), atol=1e-4)
        assert not calls, "the banded path must not run mha"
        # a window that does not bite takes mha
        port.model(_t(ids[:, :5]), _t(mask[:, :5]))
        assert len(calls) == 2
    finally:
        llama_lib.ops_attention.mha = orig


@pytest.mark.parametrize("family", FAMILIES)
def test_conversion_paths(family):
    """2 x 7 kernels and ``lm_head``, no biases, embeddings or norms, in the
    JAX package's order; the port's own ``to_bayesian`` finds the same."""
    bundle = _bundle(family)
    bmodel, bp = bf.to_bayesian(bundle.apply_fn, bundle.params, delta=0.05, freeze=True)
    port = _port(bundle, family, bp, bmodel.spec)
    assert len(port.spec.paths) == 2 * 7 + 1
    assert port.spec.paths == bmodel.spec.paths
    assert all(p.endswith("kernel") for p in port.spec.paths)
    assert not any("embed_tokens" in p or "norm" in p for p in port.spec.paths)
    fresh = bt.to_bayesian(bt.build_llama_family(family, "tiny", seed=0, device="cpu"),
                           delta=0.05, freeze=True)
    assert fresh.spec.paths == port.spec.paths
    assert fresh.rho["model/layers/0/self_attn/k_proj/kernel"].shape == (128, 64)


@pytest.mark.parametrize("family", FAMILIES)
def test_sigma0_tiers_reproduce_the_frequentist_forward(family):
    """sigma -> 0 (MOPED delta 1e-4, zero weights nudged to 0.01): the fused
    tier under both estimators, the naive and the local tiers reproduce the
    frequentist logits (2e-3, as ``tests/test_llama.py``)."""
    net = bt.build_llama_family(family, "tiny", seed=0, device="cpu")
    with torch.no_grad():
        for p in net.parameters():
            p.masked_fill_(p == 0, 0.01)
    ids, mask = (_t(a) for a in _batch(4))
    freq = net(ids, mask).detach().numpy()
    bmodel = bt.to_bayesian(net, delta=1e-4, freeze=True)
    outs = {"fused": bmodel.mc_apply_fused(1, 2, ids, mask)[0],
            "antithetic": bmodel.mc_apply_fused(1, 2, ids, mask, antithetic=True)[0],
            "naive": bmodel.mc_apply(1, 2, ids, mask)[0],
            "local": bmodel.mc_apply_lrt(1, 2, ids, mask)[0]}
    for name, out in outs.items():
        assert out.shape == (2, B, L, 1024)
        np.testing.assert_allclose(out[0].detach().numpy(), freq, rtol=2e-3, atol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("family,conversion,antithetic", [
    ("llama", "frozen-moped", True), ("llama", "frozen-moped", False),
    ("mistral", "moped-trainable", True), ("gemma", "random-init", True)])
def test_fused_mc_apply_matches_jax(family, conversion, antithetic):
    """``mc_apply_fused`` at the JAX package's draws (every leaf drawn once,
    the JAX GQA handler's rotary and k/v repetition against the port's):
    logits 1e-4, log-probs 2e-5 relative."""
    bundle = _bundle(family)
    bmodel, bp = bf.to_bayesian(bundle.apply_fn, bundle.params, **CONVERSIONS[conversion])
    port = _port(bundle, family, bp, bmodel.spec)
    key = jax.random.key(7)
    ids, mask = _batch()
    out, aux = bmodel.mc_apply_fused(bp, key, S, input_ids=jnp.asarray(ids),
                                     attention_mask=jnp.asarray(mask), save_weights=False,
                                     antithetic=antithetic)
    drawn = []
    logits, taux = port.mc_apply_fused(0, S, _t(ids), _t(mask), antithetic=antithetic,
                                       eps_hook=_jax_hook(bmodel, key, drawn))
    assert sorted(p for p, _ in drawn) == sorted(bmodel.spec.paths)
    np.testing.assert_allclose(logits.numpy(), np.asarray(out), atol=1e-4)
    for k in ("log_variational_posterior", "log_prior"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(aux[k]), rtol=2e-5,
                                   err_msg=f"{family} {conversion} {k}")
