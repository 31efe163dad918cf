"""``pretrained=DIR`` for GPT-2 and LLaMA (``bayeformers_tpu_torch/
pretrained.py::load_family``, behind ``build_gpt2``, ``build_llama_family``
and ``build_model``) against the JAX package's ``build_gpt2(pretrained=DIR)``
and ``build_llama_family("llama", pretrained=DIR)``: one directory holds the
PyTorch file (safetensors) and the Flax file of the same random tiny HF
model, written by ``transformers`` (``tests/test_torch_pretrained.py::
write_checkpoint``), and both packages' f32 logits agree at 1e-4, through
each build function; GPT-2's tied head reads ``wte``, its ``Conv1D`` weights are
stored (in, out); a base model's checkpoint (``GPT2Model``'s names, with its
attention-mask buffers) loads the same; a missing, an unexpected and a
misshaped tensor each raise, naming it. Mistral and Gemma (tied and untied)
are in ``tests/test_torch_pretrained_causal_families.py``."""
import json

import numpy as np
import pytest
import torch

from bayeformers_tpu.models import gpt2 as jgpt2
from bayeformers_tpu.models import llama as jllama
from bayeformers_tpu_torch import pretrained
from bayeformers_tpu_torch.models import families
from bayeformers_tpu_torch.models import gpt2 as tgpt2
from bayeformers_tpu_torch.models import llama as tllama
from test_torch_pretrained import write_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

VOCAB = 96
LLAMA_KW = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32)
SPECS = {
    "gpt2": ("GPT2Config", "GPT2LMHeadModel", "FlaxGPT2LMHeadModel",
             dict(vocab_size=VOCAB, n_embd=32, n_layer=2, n_head=2, n_positions=32)),
    "llama": ("LlamaConfig", "LlamaForCausalLM", "FlaxLlamaForCausalLM", LLAMA_KW),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {k: write_checkpoint(root, k, spec=v) for k, v in SPECS.items()}


def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (2, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    return ids, mask


def jax_logits(family, path):
    bundle = (jgpt2.build_gpt2(pretrained=path) if family == "gpt2"
              else jllama.build_llama_family(family, pretrained=path))
    return np.asarray(bundle.apply_fn(bundle.params, *batch()))


def port_logits(model):
    with torch.no_grad():
        return model(*(torch.from_numpy(a).long() for a in batch())).numpy()


def built_models(family, path):
    own = (tgpt2.build_gpt2(pretrained=path, device="cpu") if family == "gpt2"
           else tllama.build_llama_family(family, pretrained=path, device="cpu"))
    via = families.build_model(family, task="causal-lm", pretrained=path, device="cpu",
                               dtype=torch.float32)
    return own, via


@pytest.mark.parametrize("family", sorted(SPECS))
def test_logits_match_jax(checkpoints, family):
    want = jax_logits(family, checkpoints[family])
    for model in built_models(family, checkpoints[family]):
        np.testing.assert_allclose(port_logits(model), want, rtol=0, atol=1e-4)


def copy_dir(src, dst, state):
    dst.mkdir()
    (dst / "config.json").write_text(open(f"{src}/config.json").read())
    torch.save(state, dst / "pytorch_model.bin")
    return str(dst)


def test_gpt2_base_model_checkpoint(checkpoints, tmp_path):
    """``GPT2Model``'s names (no ``transformer.``) with the attention-mask
    buffers of older files, as a ``.bin``: the same logits."""
    src = checkpoints["gpt2"]
    state = {k.removeprefix("transformer."): v
             for k, v in pretrained.read_state_dict(src).items()}
    state["h.0.attn.bias"] = torch.tril(torch.ones(1, 1, 32, 32))
    state["h.0.attn.masked_bias"] = torch.tensor(-1e4)
    path = copy_dir(src, tmp_path / "base", state)
    model = tgpt2.build_gpt2(pretrained=path, device="cpu")
    np.testing.assert_allclose(port_logits(model), jax_logits("gpt2", src), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("family,fault,match", [
    ("gpt2", "missing", "missing tensors.*transformer.h.1.mlp.c_fc.kernel"),
    ("gpt2", "unexpected", "unexpected tensors.*extra"),
    ("gpt2", "misshaped", "c_attn.weight has shape"),
    ("llama", "missing", "missing tensors.*lm_head.kernel"),
    ("llama", "unexpected", "unexpected tensors.*extra"),
    ("llama", "misshaped", "q_proj.weight has shape"),
])
def test_bad_tensor_raises(checkpoints, tmp_path, family, fault, match):
    src = checkpoints[family]
    state = pretrained.read_state_dict(src)
    if fault == "missing":
        del state["transformer.h.1.mlp.c_fc.weight" if family == "gpt2" else "lm_head.weight"]
    elif fault == "unexpected":
        state["model.layers.0.extra.weight" if family == "llama"
              else "transformer.h.0.extra.weight"] = torch.zeros(2, 2)
    else:
        name = ("transformer.h.0.attn.c_attn.weight" if family == "gpt2"
                else "model.layers.0.self_attn.q_proj.weight")
        state[name] = state[name][:, :-1]
    path = copy_dir(src, tmp_path / fault, state)
    with pytest.raises(ValueError, match=match):
        families.build_model(family, task="causal-lm", pretrained=path, device="cpu")


def test_other_family_raises(checkpoints):
    with pytest.raises(ValueError, match="model_type 'llama', not 'gpt2'"):
        tgpt2.build_gpt2(pretrained=checkpoints["llama"], device="cpu")
    cfg = json.load(open(f"{checkpoints['gpt2']}/config.json"))
    assert cfg["model_type"] == "gpt2"
