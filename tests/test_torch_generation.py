"""Posterior-predictive generation (``bayeformers_tpu_torch/generation.py``)
against the JAX package and HF's Flax ``generate``, on the CPU in f32.

Held here on tiny GPT-2 (the T5 and LLaMA decodes in
``tests/test_torch_generation_models.py``): ``_majority_and_agreement``
equal to the JAX package's on random arrays; greedy ``mc_generate`` under
one fixed weight set (every rho at -200, so each draw is mu exactly) equal,
token for token, to Flax ``generate`` on the same weights, with an
``eos_token_id`` that one row emits, so that the row is padded after it;
the KV-cache decode's tokens equal to a decode that recomputes the whole
prefix, its logits within 1e-4 (GPT-2 here, with Gemma's and Mistral's
cache; left-padded prompts in ``tests/test_torch_generation_padded.py``); delta -> 0 draws that all agree with the
frequentist decode; sampling deterministic per seed and diverse across
seeds; Whisper raising, as the reference cannot decode it.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu_torch as bt
from bayeformers_tpu import generation as jgen
from bayeformers_tpu.models import gpt2 as jgpt2
from bayeformers_tpu_torch import generation
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

L0, NEW = 6, 8


@functools.lru_cache(maxsize=None)
def bundle():
    return jgpt2.build_gpt2(size="tiny", seed=0)


def fixed(model):
    """A conversion whose every draw is mu: rho at -200, sigma = 0 in f32."""
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True)
    for r in bmodel.rho.values():
        r.fill_(-200.0)
    return bmodel


def port(b, **kw):
    return bt.from_jax_params(flatten_dict(b.params, sep="/"), {}, device="cpu", **kw).model


def prompt(vocab, seed=1):
    return np.random.default_rng(seed).integers(2, vocab, (2, L0)).astype(np.int32)


def check_against_flax(b, model, ids, eos_at=(1, 2), mask=None):
    """Greedy ``mc_generate`` of a fixed weight set against Flax
    ``generate`` with an eos id that row ``eos_at[0]`` emits at its step
    ``eos_at[1]``: equal tokens, that row padded after it; the cache's
    decode against the recomputing one. ``mask``: the prompt's attention
    mask (a left-padded row), given to both."""
    bmodel = fixed(model)
    first = generation.mc_generate(model, bmodel, 2, ids, mask,
                                   max_new_tokens=NEW)["sequences"]
    assert (first[0] == first[1]).all()
    start = 1 if model.generation == "seq2seq" else L0
    row, step = eos_at
    eos = int(first[0, row, start + step])
    out = generation.mc_generate(model, bmodel, 1, ids, mask, max_new_tokens=NEW,
                                 eos_token_id=eos, output_scores=True)
    again = generation.mc_generate(model, bmodel, 1, ids, mask, max_new_tokens=NEW,
                                   eos_token_id=eos, use_cache=False, output_scores=True)
    np.testing.assert_array_equal(out["sequences"], again["sequences"])
    np.testing.assert_allclose(out["scores"], again["scores"], rtol=0, atol=1e-4)
    cfg = b.config
    pad = cfg.pad_token_id or cfg.eos_token_id or 0
    kw = {} if mask is None else {"attention_mask": jnp.asarray(mask)}
    want = np.asarray(b.hf_model.generate(jnp.asarray(ids), params=b.params,
                                          max_length=L0 + NEW, do_sample=False,
                                          pad_token_id=pad, eos_token_id=eos, **kw).sequences)
    got = out["sequences"][0]
    np.testing.assert_array_equal(got, want)
    after = got[row, start + step + 1:]
    assert after.size and (after == pad).all(), got
    return got


def test_majority_and_agreement_matches_jax():
    seqs = np.random.default_rng(0).integers(0, 3, (5, 3, 7))
    for a, b in zip(generation._majority_and_agreement(seqs),
                    jgen._majority_and_agreement(seqs)):
        np.testing.assert_array_equal(a, b)


def test_gpt2_greedy_matches_flax_generate():
    check_against_flax(bundle(), port(bundle()), prompt(1024))


def test_gpt2_sigma0_draws_agree_with_frequentist():
    """MOPED delta -> 0 (1e-5, zero leaves at 0.01 as the reference's test
    has them): every draw greedy-decodes the frequentist continuation, the
    prompt carried through, agreement 1 everywhere."""
    model = port(bundle())
    with torch.no_grad():
        for p in model.parameters():
            p.masked_fill_(p == 0, 0.01)
    ids = prompt(1024, 0)
    freq = generation.mc_generate(model, fixed(model), 1, ids, max_new_tokens=NEW)
    out = generation.mc_generate(model, bt.to_bayesian(model, delta=1e-5, freeze=True), 3, ids,
                                 max_new_tokens=NEW)
    assert out["sequences"].shape == (3, 2, L0 + NEW) and out["prompt_len"] == L0
    for s in range(3):
        np.testing.assert_array_equal(out["sequences"][s], freq["sequences"][0])
    assert (out["agreement"] == 1.0).all()
    np.testing.assert_array_equal(out["majority"], freq["sequences"][0])


def test_gpt2_sampling_per_seed_and_epistemic_diversity():
    """``do_sample`` is deterministic per seed and differs across seeds; a
    fat posterior (delta 0.5) disagrees across greedy draws."""
    model = port(bundle())
    ids = prompt(1024, 2)
    bmodel = bt.to_bayesian(model, delta=1e-5, freeze=True)
    kw = dict(max_new_tokens=NEW, do_sample=True, temperature=5.0, top_k=50)
    a = generation.mc_generate(model, bmodel, 3, ids, seed=1, **kw)["sequences"]
    np.testing.assert_array_equal(a, generation.mc_generate(model, bmodel, 3, ids, seed=1,
                                                            **kw)["sequences"])
    assert not np.array_equal(a, generation.mc_generate(model, bmodel, 3, ids, seed=2,
                                                        **kw)["sequences"])
    assert any(not np.array_equal(a[s, :, L0:], a[0, :, L0:]) for s in (1, 2))
    fat = generation.mc_generate(model, bt.to_bayesian(model, delta=0.5, freeze=True), 4, ids,
                                 max_new_tokens=NEW)
    gen = fat["sequences"][:, :, L0:]
    assert any(not np.array_equal(gen[s], gen[0]) for s in range(1, 4))
    assert fat["agreement"].shape == (2, L0 + NEW)


@pytest.mark.parametrize("family", ["gemma", "mistral"])
def test_llama_families_cache_matches_recompute(family):
    """Gemma (its embedding scale) and Mistral (its band, which does not
    bind at these lengths): the KV cache's tokens equal the recomputing
    decode's, logits within 1e-4, under two distinct draws."""
    model = bt.build_llama_family(family, "tiny", seed=0, device="cpu")
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True)
    ids = prompt(1024, 3)
    kw = dict(max_new_tokens=NEW, output_scores=True, eos_token_id=-1)
    a = generation.mc_generate(model, bmodel, 2, ids, **kw)
    b = generation.mc_generate(model, bmodel, 2, ids, use_cache=False, **kw)
    np.testing.assert_array_equal(a["sequences"], b["sequences"])
    np.testing.assert_allclose(a["scores"], b["scores"], rtol=0, atol=1e-4)
    assert not np.array_equal(a["sequences"][0], a["sequences"][1])


def test_whisper_generation_raises():
    model = bt.build_whisper(seed=0, device="cpu", dtype=torch.float32)
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True)
    with pytest.raises(ValueError, match="Whisper"):
        generation.mc_generate(model, bmodel, 2, np.zeros((2, 16, 48), np.float32))
