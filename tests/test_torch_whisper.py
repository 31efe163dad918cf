"""The Whisper speech-to-text model in the port against the JAX package, on
the CPU in f32.

The JAX package's tiny Whisper (``build_whisper()``: 16 mel bins, 48
feature frames stemmed to 24 positions, 2 + 2 layers 64 wide in heads of
32, the head tied to the token table) is carried over with
``from_jax_params(config=WhisperConfig.from_hf(...))``. Held here: the
conversion's paths under the default rules (22 + 36: every attention
projection, ``k_proj`` bias-free, and the MLPs), ``CONV_RULE`` (the two
stems) and ``EMBEDDING_RULE`` (the three tables), the frequentist logits
(1e-4) and every tier's in the sigma -> 0 limit (2e-3), the synthetic
batch and the reference test's teacher-forced loss, and the published
widths of ``WHISPER_BASE_KWARGS``. The tiers at the JAX
package's draws are in ``tests/test_torch_whisper_fused.py``,
``_naive.py``, ``_flipout.py``, ``_lrt.py`` and, under ``EMBEDDING_RULE``,
``_embed.py``, ``_embed_naive.py`` and ``_embed_lrt.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu.models import whisper as jwhisper
from bayeformers_tpu_torch.models import whisper as twhisper
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

B = 2
JAX_RULES = {"default": bf.DEFAULT_RULES, "conv": (*bf.DEFAULT_RULES, bf.CONV_RULE),
             "embedding": (*bf.DEFAULT_RULES, bf.EMBEDDING_RULE)}
RULES = {"default": bt.DEFAULT_RULES, "conv": (*bt.DEFAULT_RULES, bt.CONV_RULE),
         "embedding": (*bt.DEFAULT_RULES, bt.EMBEDDING_RULE)}


@functools.lru_cache(maxsize=None)
def bundle(layers=2):
    return jwhisper.build_whisper(seed=0, encoder_layers=layers, decoder_layers=layers)


def config(layers=2):
    return twhisper.WhisperConfig.from_hf(bundle(layers).config.to_dict())


@functools.lru_cache(maxsize=None)
def pair(rules="default", delta=0.05, layers=2):
    """(name, the JAX BayesianModel, its BayesParams, the port's), frozen
    MOPED at ``delta`` with the zero leaves at 0.01 (the reference test's
    patch), ``layers`` layers a tower (the tiers' tests take one)."""
    import jax

    b = bundle(layers)
    params = jax.tree.map(lambda a: jnp.where(a == 0, jnp.full_like(a, 0.01), a), b.params)
    bmodel, bp = bf.to_bayesian(b.apply_fn, params, delta=delta, freeze=True,
                                rules=JAX_RULES[rules])
    port = bt.from_jax_params(flatten_dict(bp.params, sep="/"),
                              {p: np.asarray(r) for p, r in bp.rho.items()}, device="cpu",
                              config=config(layers))
    return "frozen-moped", bmodel, bp, port


def batch(seed=0, layers=2) -> dict:
    """Features and decoder ids of the reference's synthetic speech task."""
    b = jwhisper.synthetic_speech_batch(np.random.default_rng(seed), B, bundle(layers).config)
    return {"input_features": np.array(b["input_features"]),
            "decoder_input_ids": np.array(b["decoder_input_ids"])}


def tensors(b):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in b.items()}


@pytest.mark.parametrize("rules", list(RULES))
def test_whisper_paths_match_jax(rules):
    """The default rules convert 22 + 36 leaves (``k_proj`` has no bias);
    ``CONV_RULE`` adds both stems' kernel and bias, ``EMBEDDING_RULE`` the
    three tables. The port's rules give the JAX package's paths in its
    order."""
    want = bf.find_convertible_paths(bundle().params, JAX_RULES[rules])
    model = bt.build_whisper(seed=1, device="cpu", dtype=torch.float32)
    assert bt.find_convertible_paths(model, RULES[rules]) == want
    enc = [p for p in want if p.startswith("model/encoder/layers")]
    dec = [p for p in want if p.startswith("model/decoder/layers")]
    assert (len(enc), len(dec)) == (22, 36)
    extra = sorted(set(want) - set(enc) - set(dec))
    if rules == "conv":
        assert extra == [f"model/encoder/conv{i}/{k}" for i in (1, 2) for k in ("bias", "kernel")]
    elif rules == "embedding":
        assert extra == ["model/decoder/embed_positions/embedding",
                         "model/decoder/embed_tokens/embedding",
                         "model/encoder/embed_positions/embedding"]
    else:
        assert not extra and not any(p.endswith("k_proj/bias") for p in want)


def test_whisper_frequentist_logits_match_flax():
    """The port's Whisper on the JAX package's weights gives Flax's logits
    (the conv stems, the sinusoid table, causal decoder, tied head)."""
    _, _, bp, port = pair()
    b = batch(1)
    want = np.asarray(bundle().apply_fn(bp.params, **b))
    got = port.model(**tensors(b))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)
    fresh = bt.build_whisper(seed=0, device="cpu", dtype=torch.float32)
    # f32 sin and cos of f32 angles up to 23 rad, whose exp() may differ by
    # an ulp between XLA and torch: a few 1e-7 of the angle
    np.testing.assert_allclose(
        fresh.model.encoder.embed_positions.embedding.numpy(),
        np.asarray(bundle().params["model"]["encoder"]["embed_positions"]["embedding"]),
        rtol=0, atol=4e-6)


def test_whisper_sigma0_parity_all_tiers():
    """MOPED delta -> 0 with the stems converted: every tier gives the
    frequentist logits (the reference's 2e-3)."""
    _, _, bp, port = pair("conv", 1e-5)
    b = batch(4)
    freq = np.asarray(bundle().apply_fn(bp.params, **b))
    with torch.no_grad():
        for fn in (port.mc_apply_fused, port.mc_apply, port.mc_apply_lrt,
                   port.mc_apply_flipout):
            out, aux = fn(0, 2, **tensors(b))
            np.testing.assert_allclose(out[0].numpy(), freq, rtol=2e-3, atol=2e-3)
            assert all(torch.isfinite(v).all() for v in aux.values())


def test_whisper_batch_and_loss_match_jax():
    """The synthetic batch's draws and the reference test's teacher-forced
    CE (``tests/test_whisper.py:19-24``) on the S-averaged logits."""
    a = jwhisper.synthetic_speech_batch(np.random.default_rng(3), 3, bundle().config)
    b = twhisper.synthetic_speech_batch(np.random.default_rng(3), 3, config())
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k])
    logits = np.random.default_rng(0).normal(size=(2, 3, 16, 128)).astype(np.float32)
    ids = b["decoder_input_ids"]
    lp = np.asarray(jnp.mean(jnp.asarray(logits), 0))[:, :-1]
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    want = -np.take_along_axis(lp, ids[:, 1:, None], -1).sum()
    got, _ = twhisper.teacher_forced_loss(torch.from_numpy(logits),
                                          {"decoder_input_ids": torch.from_numpy(ids)})
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_whisper_published_widths_and_shape_checks():
    """``WHISPER_BASE_KWARGS`` is openai/whisper-base's config; the forward
    refuses features of another length and too many decoder ids, as the
    Flax module does."""
    cfg = twhisper.WhisperConfig(**twhisper.WHISPER_BASE_KWARGS)
    assert (cfg.d_model, cfg.encoder_layers, cfg.decoder_layers, cfg.encoder_attention_heads,
            cfg.encoder_ffn_dim, cfg.vocab_size, cfg.num_mel_bins, cfg.max_source_positions,
            cfg.max_target_positions) == (512, 6, 6, 8, 2048, 51865, 80, 1500, 448)
    model = bt.build_whisper(seed=0, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="input_features"):
        model(torch.zeros(1, 16, 40), torch.ones(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="max_target_positions"):
        model(torch.zeros(1, 16, 48), torch.ones(1, 17, dtype=torch.long))
    with pytest.raises(ValueError, match="size='tiny'"):
        bt.build_whisper(size="base", device="cpu")
