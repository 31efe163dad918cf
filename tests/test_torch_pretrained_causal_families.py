"""``pretrained=DIR`` for Mistral and Gemma (``build_llama_family`` and
``build_model``) against the JAX package's ``build_llama_family(family,
pretrained=DIR)`` on one random tiny HF model of each, written by
``transformers`` in PyTorch and Flax (as ``test_torch_pretrained_causal.py``
does for GPT-2 and LLaMA): f32 logits at 1e-4. Gemma's config ties its head
to the token table by default (its ``config.json`` then leaves
``tie_word_embeddings`` out and its safetensors file holds no
``lm_head``); the untied Gemma loads its own ``lm_head``."""
import numpy as np
import pytest

from test_torch_pretrained import write_checkpoint
from test_torch_pretrained_causal import LLAMA_KW, built_models, jax_logits, port_logits
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

GEMMA_KW = dict(LLAMA_KW, head_dim=16)
SPECS = {
    "mistral": ("MistralConfig", "MistralForCausalLM", "FlaxMistralForCausalLM",
                dict(LLAMA_KW, sliding_window=32)),
    "gemma": ("GemmaConfig", "GemmaForCausalLM", "FlaxGemmaForCausalLM", GEMMA_KW),
    "gemma-untied": ("GemmaConfig", "GemmaForCausalLM", "FlaxGemmaForCausalLM",
                     dict(GEMMA_KW, tie_word_embeddings=False)),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {k: write_checkpoint(root, k, spec=v) for k, v in SPECS.items()}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_logits_match_jax(checkpoints, name):
    family = name.split("-")[0]
    want = jax_logits(family, checkpoints[name])
    for model in built_models(family, checkpoints[name]):
        assert model.config.tie_word_embeddings == (name == "gemma")
        assert hasattr(model, "lm_head") == (name != "gemma")
        np.testing.assert_allclose(port_logits(model), want, rtol=0, atol=1e-4)
