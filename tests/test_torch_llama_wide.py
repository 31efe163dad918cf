"""The LLaMA families at head widths 256 (Gemma) and 128 (Mistral) against
the JAX package, on the CPU in f32.

The published models whose widths the card serves, ``google/gemma-2b`` (8
heads of 256 over one kv head) and ``mistralai/Mistral-7B-v0.1`` (heads of
128), cut to tiny widths that keep their heads: Gemma ``tiny`` with
``head_dim=256`` and one kv head (a GQA repeat of 4), Mistral ``tiny`` at
hidden 256 in two heads of 128 with ``rms_norm_eps=1e-5`` (both at twice
the head width in positions, :data:`WIDE`). Each Flax model,
converted by ``to_bayesian(delta=0.05, freeze=True)``, is carried over with
``from_jax_params``; ``mc_apply_fused`` runs in both packages at the JAX
package's own draws (logits 1e-4, log-probs 2e-5 relative), and so does one
antithetic ELBO objective with the LM loss and its backward (every gradient
within 1e-4 of its leaf's largest entry). The published configurations
themselves (``models/llama.py::PUBLISHED``) are checked for the head widths
and the GQA groups they give.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
from bayeformers_tpu import elbo as jelbo
from bayeformers_tpu.models import llama as jllama
from bayeformers_tpu.workloads import gpt2_lm as jlm
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.models import llama as llama_lib
from bayeformers_tpu_torch.workloads import gpt2_lm
from test_torch_bert import _jax_hook
from test_torch_llama import _batch, _port, _t
from test_torch_training import _hook
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, N_BATCHES = 4, 7
# max_position_embeddings at twice the head width: the stock rotary table
# (``create_sinusoidal_positions``, which the port copies) keeps only the
# first max_position_embeddings of its 2 d columns, so the tiny presets'
# 128 positions would cut a head of 128 or 256
WIDE = {"gemma-w256": ("gemma", dict(head_dim=256, num_key_value_heads=1,
                                     max_position_embeddings=512), 256),
        "mistral-w128": ("mistral", dict(hidden_size=256, num_attention_heads=2,
                                         num_key_value_heads=2, rms_norm_eps=1e-5,
                                         max_position_embeddings=256,
                                         sliding_window=256), 128)}
_MODELS = {}


def _converted(name):
    """(the Flax bundle, the JAX BayesianModel and its params, the port's model)."""
    if name not in _MODELS:
        family, overrides, _ = WIDE[name]
        bundle = jllama.build_llama_family(family, size="tiny", seed=0, **overrides)
        bmodel, bp = bf.to_bayesian(bundle.apply_fn, bundle.params, delta=0.05, freeze=True)
        _MODELS[name] = bundle, bmodel, bp
    bundle, bmodel, bp = _MODELS[name]
    return bundle, bmodel, bp, _port(bundle, WIDE[name][0], bp, bmodel.spec)


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_mc_apply_matches_jax(name):
    """The antithetic fused forward at the JAX draws: the head width reaches
    rotary, the GQA repeat and attention; logits 1e-4, log-probs 2e-5
    relative."""
    bundle, bmodel, bp, port = _converted(name)
    assert port.model.config.attn_head_dim == WIDE[name][2]
    key = jax.random.key(11)
    ids, mask = _batch()
    out, aux = bmodel.mc_apply_fused(bp, key, S, input_ids=jnp.asarray(ids),
                                     attention_mask=jnp.asarray(mask), save_weights=False,
                                     antithetic=True)
    drawn = []
    logits, taux = port.mc_apply_fused(0, S, _t(ids), _t(mask), antithetic=True,
                                       eps_hook=_jax_hook(bmodel, key, drawn))
    assert sorted(p for p, _ in drawn) == sorted(bmodel.spec.paths)
    np.testing.assert_allclose(logits.numpy(), np.asarray(out), atol=1e-4)
    for k in ("log_variational_posterior", "log_prior"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(aux[k]), rtol=2e-5, err_msg=k)


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_elbo_gradients_match_jax(name):
    """One antithetic ELBO objective with the LM loss and its backward at
    the JAX draws: the loss 2e-5 relative, every gradient (rho, the
    embedding, the RMSNorm weights) within 1e-4 of its leaf's largest
    entry."""
    bundle, bmodel, bp, port = _converted(name)
    key = jax.random.key(13)
    ids = _batch(3)[0]

    def objective(bparams):
        out, aux = bmodel.mc_apply_fused(bparams, key, S, input_ids=jnp.asarray(ids),
                                         antithetic=True)
        nll, _ = jlm.lm_loss(out, {"input_ids": jnp.asarray(ids)})
        return jelbo.elbo_loss(nll, aux["log_prior"], aux["log_variational_posterior"],
                               N_BATCHES)

    jloss, jgrads = jax.jit(jax.value_and_grad(objective))(bp)
    named = port.trainable_parameters()
    hook = _hook(bmodel, [[key]])
    loss, _ = training.elbo_objective(
        training.pick_mc(port, True, "antithetic"), 0, S,
        {"input_ids": torch.from_numpy(ids).long()}, N_BATCHES, gpt2_lm.lm_loss,
        ("input_ids",), eps_hook=lambda *a: hook(0, *a))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-5)
    jflat = flatten_dict(jgrads.params, sep="/")
    for n, t, _ in named:
        kind, path = n.split("/", 1)
        want = np.asarray(jgrads.rho[path] if kind == "rho" else jflat[path])
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=n)


@pytest.mark.parametrize("name,width,group", [("gemma-2b-w256", 256, 8),
                                              ("mistral-7b-w128", 128, 4)])
def test_published_widths(name, width, group):
    """The published configurations give the head widths and GQA groups of
    the models they name, on the port's config (the JAX package's builder
    takes the same overrides)."""
    family, overrides = llama_lib.PUBLISHED[name]
    cfg = llama_lib.llama_config(family, "base", num_hidden_layers=2, **overrides)
    assert cfg.attn_head_dim == width
    assert cfg.num_attention_heads // cfg.num_key_value_heads == group
    assert cfg.num_attention_heads * width == {"gemma": 2048, "mistral": 4096}[family]
    assert cfg.max_position_embeddings == 1024 and cfg.num_hidden_layers == 2
