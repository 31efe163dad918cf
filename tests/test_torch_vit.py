"""The ViT image classifier in the port against the JAX package, on the CPU
in f32.

The JAX package's ViT-tiny (``build_vit(size="tiny")``: 32-pixel images in
16 patches of 8, 17 positions, head width 64) is converted by its
``to_bayesian`` under the default rules and with ``CONV_RULE`` (the patch
projection Bayesian too) and carried over with ``from_jax_params``, whose
widths come from the Flax conv kernel and the position table. Held: the
conversion's paths under both rule sets, the frequentist logits, the fused
tier at the JAX package's draws (with the patch conv converted and the
sigma -> 0 limit of every tier in ``tests/test_torch_vit_conv.py``) (logits 1e-4, log-probs 2e-5 relative,
the gradients of the ELBO objective's two parts 1e-4 of each leaf's
largest entry: ``tests/test_torch_estimators.py::check_against_jax``), the
family dispatch, and the reference's
four-phase mini recipe (``tests/test_vit.py:93-146``) on the port alone.
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
from bayeformers_tpu.models import vit as jvit
from bayeformers_tpu_torch import elbo, training
from bayeformers_tpu_torch.models import families
from bayeformers_tpu_torch.models import vit as tvit
from test_torch_estimators import check_against_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

JAX_RULES = {"default": bf.DEFAULT_RULES, "conv": (*bf.DEFAULT_RULES, bf.CONV_RULE)}
RULES = {"default": bt.DEFAULT_RULES, "conv": (*bt.DEFAULT_RULES, bt.CONV_RULE)}


@functools.lru_cache(maxsize=None)
def bundle():
    return jvit.build_vit(size="tiny", n_labels=2, seed=0)


@functools.lru_cache(maxsize=None)
def pair(rules, delta=0.05):
    """(name, the JAX BayesianModel, its BayesParams, the port's), frozen
    MOPED at ``delta`` on ViT-tiny with its zero leaves at 0.01."""
    b = bundle()
    params = jax.tree.map(lambda a: jnp.where(a == 0, jnp.full_like(a, 0.01), a), b.params)
    bmodel, bp = bf.to_bayesian(b.apply_fn, params, delta=delta, freeze=True,
                                rules=JAX_RULES[rules])
    port = bt.from_jax_params(flatten_dict(bp.params, sep="/"),
                              {p: np.asarray(r) for p, r in bp.rho.items()}, device="cpu")
    return "frozen-moped", bmodel, bp, port


def pixels(n=3, seed=0):
    return np.array(jvit.synthetic_image_batch(np.random.default_rng(seed), n, 32)[
        "pixel_values"])


@pytest.mark.parametrize("rules", list(RULES))
def test_vit_paths_match_jax(rules):
    """Every Dense converts (2 layers x 6 and the classifier, kernel and
    bias); the patch projection only under ``CONV_RULE``; the CLS token,
    position embeddings and LayerNorms never. The port's rules give the
    JAX package's paths in its order."""
    _, bmodel, _, port = pair(rules)
    want = bmodel.spec.paths
    assert len(want) == 2 * 6 * 2 + 2 + (2 if rules == "conv" else 0)
    assert bt.find_convertible_paths(port.model, RULES[rules]) == want
    fresh = bt.build_vit(size="tiny", seed=1, device="cpu", dtype=torch.float32)
    assert bt.to_bayesian(fresh, delta=0.05, rules=RULES[rules]).spec.paths == want
    assert not any(k in p for p in want for k in ("cls_token", "position_embeddings",
                                                  "layernorm"))


def test_vit_frequentist_logits_match_flax():
    """The port's ViT on the JAX package's weights gives Flax's logits (its
    config read from the tree: patch 8, image 32, 128 wide, 2 layers)."""
    _, _, bp, port = pair("default")
    px = pixels(seed=1)
    want = np.asarray(bundle().apply_fn(bp.params, px))
    got = port.model(torch.from_numpy(px))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)
    cfg = port.model.config
    assert (cfg.patch_size, cfg.image_size, cfg.hidden_size, cfg.num_hidden_layers,
            cfg.num_attention_heads) == (8, 32, 128, 2, 2)


def test_vit_fused_matches_jax():
    """The fused tier's antithetic pairs (the attention handler with a zero
    bias) at the JAX package's draws: logits, log-probs and the ELBO
    objective's gradients (the patch conv's im2col under ``CONV_RULE`` in
    ``tests/test_torch_vit_conv.py``)."""
    check_against_jax(pair("default"), "antithetic", {"pixel_values": pixels()}, (3, 2),
                      n_samples=4)


def test_vit_build_model_dispatch():
    """``build_model`` dispatches ViT names in the reference's order; the
    model takes pixels only."""
    model = families.build_model("google/vit-base-patch16-224", size="tiny", seed=0,
                                 device="cpu", dtype=torch.float32)
    assert isinstance(model, tvit.ViTForImageClassification)
    assert families.input_keys(model) == ("pixel_values",)
    assert not families.uses_token_type_ids(model)
    base = tvit.ViTConfig(num_labels=1000, **tvit.VIT_BASE_KWARGS)
    assert (base.num_patches + 1, base.hidden_size, base.num_hidden_layers) == (197, 768, 12)


def test_vit_four_phase_recipe():
    """The reference's mini recipe on separable images: a frequentist train
    beats chance, MOPED keeps the accuracy, and ELBO steps through
    ``make_elbo_train_step(input_keys=("pixel_values",))`` keep the loss
    finite and the frozen mu bit-identical."""
    torch.manual_seed(0)
    model = bt.build_vit(size="tiny", seed=0, device="cpu", dtype=torch.float32)
    data = tvit.synthetic_image_batch(np.random.default_rng(0), 32, 32)
    X, y = torch.from_numpy(data["pixel_values"]), torch.from_numpy(data["labels"])
    opt = training.adamw_with_decay_groups(1e-3, 0.0, training.default_no_decay).init(
        training.model_parameters(model, training.default_no_decay))
    for _ in range(60):
        opt.zero_grad()
        elbo.cross_entropy_sum(model(X), y).backward()
        opt.step()
    model.requires_grad_(False)
    with torch.no_grad():
        acc_freq = (model(X).argmax(-1) == y).float().mean().item()
    assert acc_freq > 0.8, acc_freq
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True)
    with torch.no_grad():
        out, _ = bmodel.mc_apply(1, 4, X)
    acc, _ = elbo.accuracy_and_std(out, y)
    assert abs(float(acc) - acc_freq) < 0.15
    mu_before = model.classifier.kernel.clone()
    bopt = training.adamw_with_decay_groups(1e-3, 0.0, training.default_no_decay).init(
        bmodel.trainable_parameters())
    step = training.make_elbo_train_step(bmodel, bopt, 2, 1, input_keys=("pixel_values",))
    for i in range(5):
        m = step(2 + i, {"pixel_values": X, "labels": y})
        assert torch.isfinite(m["loss"])
    assert torch.equal(mu_before, model.classifier.kernel)
