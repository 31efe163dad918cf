"""The CLIP dual encoder in the port against the JAX package, on the CPU in
f32.

The JAX package's tiny CLIP (``build_clip()``: two 2-layer towers 64 wide
with 32-wide heads, a 32-pixel image in 16 patches of 8, projections to
32) is converted by its ``to_bayesian`` and carried over with
``from_jax_params(config=CLIPConfig.from_hf(...))``. Held: the conversion's
scope (both towers' Dense and the projections; with ``CONV_RULE`` and
``EMBEDDING_RULE`` the bias-free patch conv and the three tables, the
JAX package's paths in its order), the frequentist similarity logits
(the fused tier at the JAX package's draws in
``tests/test_torch_clip_fused.py``), sigma -> 0 in every tier,
``untile_samples`` with extra axes and ``clip_contrastive_loss`` against
the JAX package's, and a contrastive ELBO step through
``make_elbo_train_step``.
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
from bayeformers_tpu.models import clip as jclip
from bayeformers_tpu.nn import fused as jfused
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.models import clip as tclip
from bayeformers_tpu_torch.nn import fused as tfused
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

B = 4
ALL_RULES = ((*bf.DEFAULT_RULES, bf.CONV_RULE, bf.EMBEDDING_RULE),
             (*bt.DEFAULT_RULES, bt.CONV_RULE, bt.EMBEDDING_RULE))


@functools.lru_cache(maxsize=None)
def bundle():
    return jclip.build_clip(seed=0)


@functools.lru_cache(maxsize=None)
def pair(delta=0.05):
    """(name, the JAX BayesianModel, its BayesParams, the port's), frozen
    MOPED at ``delta``, zero leaves at 0.01 as the reference's test keeps
    them."""
    b = bundle()
    params = jax.tree.map(lambda a: jnp.where(a == 0, jnp.full_like(a, 0.01), a), b.params)
    bmodel, bp = bf.to_bayesian(b.apply_fn, params, delta=delta, freeze=True)
    port = bt.from_jax_params(flatten_dict(bp.params, sep="/"),
                              {p: np.asarray(r) for p, r in bp.rho.items()}, device="cpu",
                              config=tclip.CLIPConfig.from_hf(b.config.to_dict()))
    return "frozen-moped", bmodel, bp, port


def batch(seed=0):
    """Ids with a padded tail in one row, and pixels."""
    b = jclip.synthetic_clip_batch(np.random.default_rng(seed), B, 8, 32, 128)
    mask = np.ones((B, 8), np.int32)
    mask[1, 6:] = 0
    return {"input_ids": np.array(b["input_ids"]), "pixel_values": np.array(b["pixel_values"]),
            "attention_mask": mask}


def test_clip_conversion_scope_matches_jax():
    """The default rules convert both towers' Dense (2 x 2 layers x 6,
    kernel and bias) and the two bias-free projections; the patch conv,
    tables, class embedding, LayerNorms and ``logit_scale`` stay
    frequentist. With the conv and embedding rules too, the port's paths
    are the JAX package's."""
    _, bmodel, _, port = pair()
    paths = bmodel.spec.paths
    assert len(paths) == 2 * 2 * 6 * 2 + 2
    assert bt.find_convertible_paths(port.model) == paths
    assert not any(k in p for p in paths for k in ("patch_embedding", "logit_scale",
                                                   "layer_norm", "embeddings/"))
    want = bf.find_convertible_paths(bundle().params, ALL_RULES[0])
    assert bt.find_convertible_paths(port.model, ALL_RULES[1]) == want
    assert "vision_model/embeddings/patch_embedding/kernel" in want
    assert "text_model/embeddings/token_embedding/embedding" in want


def test_clip_frequentist_logits_match_flax():
    """The port's CLIP on the JAX package's weights gives Flax's
    ``logits_per_image`` (padded text, the causal mask, EOS pooling)."""
    _, _, bp, port = pair()
    x = batch(1)
    want = np.asarray(bundle().apply_fn(bp.params, **x))
    got = port.model(**{k: torch.from_numpy(v) for k, v in x.items()})
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)


def test_clip_sigma0_parity_all_tiers():
    """MOPED delta -> 0: every tier, untiled by ``untile_axes=(1,)``, gives
    the frequentist similarity (the reference's 2e-3; its delta 1e-5, since
    the temperature amplifies weight jitter)."""
    _, _, bp, port = pair(1e-5)
    x = batch(2)
    freq = np.asarray(bundle().apply_fn(bp.params, **x))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.no_grad():
        for fn in (port.mc_apply_fused, port.mc_apply, port.mc_apply_lrt,
                   port.mc_apply_flipout):
            out, aux = fn(0, 2, untile_axes=(1,), **t)
            assert out.shape == (2, B, B)
            np.testing.assert_allclose(out[0].numpy(), freq, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("extra", [(), (1,), (2,), (1, 2)])
def test_untile_samples_matches_jax(extra):
    """``untile_samples`` keeps each sample's diagonal block of every extra
    tiled axis, as the JAX package's does."""
    S, shape = 3, [6, 4, 5]
    for ax in extra:
        shape[ax] *= S
    a = np.random.default_rng(0).normal(size=(S * 2,) + tuple(shape[1:])).astype(np.float32)
    want = np.asarray(jfused.untile_samples(jnp.asarray(a), S, extra))
    got = tfused.untile_samples(torch.from_numpy(a), S, extra)
    np.testing.assert_array_equal(got.numpy(), want)


def test_clip_contrastive_loss_matches_jax():
    logits = np.random.default_rng(0).normal(size=(6, 6)).astype(np.float32) * 3
    want = float(jclip.clip_contrastive_loss(jnp.asarray(logits)))
    got = tclip.clip_contrastive_loss(torch.from_numpy(logits)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_clip_contrastive_elbo_step():
    """The step factory with CLIP's inputs and ``untile_axes=(1,)``: the
    summed contrastive loss of the S-averaged similarity, finite over two
    steps, frozen mu unchanged, rho moved. The steps move the model in
    place, so it takes its own copy, not the shared ``pair()`` that
    ``test_torch_clip_fused.py`` holds against the JAX package when both
    files run in one process."""
    _, _, _, port = pair.__wrapped__()
    named = port.trainable_parameters()
    opt = training.adamw_with_decay_groups(1e-3, 0.0, training.default_no_decay).init(named)

    def loss_fn(out, b):
        return tclip.clip_contrastive_loss(out.mean(0)), {}

    step = training.make_elbo_train_step(
        port, opt, 2, 10, loss_fn=loss_fn, input_keys=tclip.CLIPModel.input_keys,
        estimator="antithetic", untile_axes=(1,))
    x = {k: torch.from_numpy(v) for k, v in batch(3).items()}
    kernel = port.model.text_projection.kernel.clone()
    rho = port.rho["text_projection/kernel"].clone()
    for i in range(2):
        assert torch.isfinite(step(i, x)["loss"])
    assert torch.equal(kernel, port.model.text_projection.kernel)
    assert not torch.equal(rho, port.rho["text_projection/kernel"])
