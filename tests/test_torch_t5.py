"""The T5 encoder-decoder in the port against the JAX package, on the CPU in
f32.

The JAX package's tiny T5 (``build_t5(size="tiny")``: 2 + 2 blocks, 64 wide,
4 heads of 16, relu FFN, the head tied to ``shared``) is converted by its
``to_bayesian`` and carried over with ``from_jax_params``, which reads the
config from the tree. Held here: the conversion's paths under the default
rules (2 x 6 + 2 x 10 bias-free kernels) and ``EMBEDDING_RULE``, the
frequentist logits of the relu and gated-gelu FFNs with a padded source
row (1e-4), ``shift_right`` and the synthetic batch, and the family
dispatch. One ELBO objective's gradients against ``jax.grad`` are in
``tests/test_torch_t5_train.py``; the tiers at the JAX package's draws in
``tests/test_torch_t5_fused.py``, ``_naive.py``, ``_flipout.py``,
``_lrt.py`` and, under ``EMBEDDING_RULE``, ``_embed.py``, ``_embed_naive.py``
and ``_embed_lrt.py`` (one test process each, so that each stays short).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu.models import t5 as jt5
from bayeformers_tpu_torch.models import families
from bayeformers_tpu_torch.models import t5 as tt5
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

B, SRC, TGT, VOCAB = 2, 12, 8, 512
JAX_RULES = {"default": bf.DEFAULT_RULES, "embedding": (*bf.DEFAULT_RULES, bf.EMBEDDING_RULE)}
RULES = {"default": bt.DEFAULT_RULES, "embedding": (*bt.DEFAULT_RULES, bt.EMBEDDING_RULE)}


@functools.lru_cache(maxsize=None)
def bundle(ff="relu", layers=2):
    return jt5.build_t5(size="tiny", seed=0, feed_forward_proj=ff, num_layers=layers)


@functools.lru_cache(maxsize=None)
def pair(rules="default", delta=0.05, ff="relu", layers=2):
    """(name, the JAX BayesianModel, its BayesParams, the port's), frozen
    MOPED at ``delta``, with ``layers`` blocks in each stack (the tiers'
    tests take one, which keeps the JAX side's compiles short)."""
    b = bundle(ff, layers)
    bmodel, bp = bf.to_bayesian(b.apply_fn, b.params, delta=delta, freeze=True,
                                rules=JAX_RULES[rules])
    port = bt.from_jax_params(flatten_dict(bp.params, sep="/"),
                              {p: np.asarray(r) for p, r in bp.rho.items()}, device="cpu")
    return "frozen-moped", bmodel, bp, port


@functools.lru_cache(maxsize=None)
def port_model(ff="relu", layers=2):
    """The port's T5 on the JAX package's frequentist weights."""
    return bt.from_jax_params(flatten_dict(bundle(ff, layers).params, sep="/"), {},
                              device="cpu").model


def batch(seed=0, pad=True):
    """The reference's copy task, the second source row padded from 9 on."""
    b = {k: np.array(v) for k, v in jt5.synthetic_seq2seq_batch(
        np.random.default_rng(seed), B, SRC, TGT, VOCAB).items()}
    if pad:
        b["attention_mask"][1, 9:] = 0
    return b


def tensors(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


@pytest.mark.parametrize("rules", list(RULES))
def test_t5_paths_match_jax(rules):
    """The default rules convert the 32 projection kernels and nothing
    else; ``EMBEDDING_RULE`` adds ``shared`` and the two bias tables. The
    port's rules give the JAX package's paths in its order."""
    want = bf.find_convertible_paths(bundle().params, JAX_RULES[rules])
    assert bt.find_convertible_paths(port_model(), RULES[rules]) == want
    fresh = bt.build_t5(size="tiny", seed=1, device="cpu", dtype=torch.float32)
    assert bt.to_bayesian(fresh, delta=0.05, rules=RULES[rules]).spec.paths == want
    tables = [p for p in want if p.endswith("/embedding")]
    if rules == "default":
        assert len(want) == 2 * 6 + 2 * 10 and all(p.endswith("kernel") for p in want)
        assert not tables
    else:
        assert len(tables) == 3 and "shared/embedding" in tables


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_t5_frequentist_logits_match_flax(ff):
    """The port's T5 on the JAX package's weights gives Flax's logits (the
    decoder ids shifted from the labels, a padded source row), both FFNs;
    the config read from the tree."""
    b = batch(1)
    want = np.asarray(bundle(ff).apply_fn(bundle(ff).params, **b))
    got = port_model(ff)(**tensors(b))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)
    cfg = port_model(ff).config
    assert (cfg.d_model, cfg.d_kv, cfg.num_heads, cfg.num_layers, cfg.is_gated_act) == (
        64, 16, 4, 2, ff != "relu")


def test_t5_shift_right_and_batch_match_jax():
    """``shift_right`` (start id, ``-100`` to pad) and the synthetic batch's
    draws equal the JAX package's."""
    labels = np.random.default_rng(0).integers(0, 50, (3, 7)).astype(np.int32)
    labels[1, 2] = labels[2, 5] = -100
    hf = jnp.asarray(labels)
    import transformers.models.t5.modeling_flax_t5 as flax_t5

    want = np.asarray(flax_t5.shift_tokens_right(hf, 0, 0))
    got = tt5.shift_right(torch.from_numpy(labels), 0, 0).numpy()
    np.testing.assert_array_equal(got, want)
    a = jt5.synthetic_seq2seq_batch(np.random.default_rng(4), 3, 10, 6, 100)
    b = tt5.synthetic_seq2seq_batch(np.random.default_rng(4), 3, 10, 6, 100)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k])


def test_t5_build_model_dispatch():
    """``build_model`` dispatches T5 names in the reference's order: t5-small
    by default (its published config), the tiny preset by ``size``."""
    model = families.build_model("t5-small", size="tiny", seed=0, device="cpu",
                                 dtype=torch.float32)
    assert isinstance(model, tt5.T5ForConditionalGeneration)
    assert model.config.d_model == 64
    small = tt5.T5Config(**tt5.T5_SMALL_KWARGS)
    assert (small.d_model, small.d_kv, small.num_heads, small.d_ff, small.num_layers,
            small.vocab_size, small.tie_word_embeddings) == (512, 64, 8, 2048, 6, 32128, True)
    with pytest.raises(ValueError, match="decoder_input_ids or labels"):
        model(torch.ones(1, 4, dtype=torch.long))
