"""``pretrained=DIR`` for T5 (``bayeformers_tpu_torch/pretrained.py::
load_family``) against the JAX package's ``build_t5(pretrained=DIR)``: one
directory holds the PyTorch file (safetensors) and the Flax file of the
same random tiny HF model, written by ``transformers``
(``tests/test_torch_pretrained.py::write_checkpoint``), and both packages'
logits agree at 1e-4 in f32, tied (v1.0, relu) and untied (``lm_head``,
gated-gelu as v1.1 has it). A tensor the port does not hold raises, naming
it. Whisper is in ``tests/test_torch_pretrained_whisper.py``.
"""
import numpy as np
import pytest
import torch

from bayeformers_tpu.models import t5 as jt5
from bayeformers_tpu_torch import pretrained
from bayeformers_tpu_torch.models import t5 as tt5
from test_torch_pretrained import write_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

T5_KW = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
             decoder_start_token_id=0)
SPECS = {
    "t5": ("T5Config", "T5ForConditionalGeneration", "FlaxT5ForConditionalGeneration",
           T5_KW),
    "t5-untied": ("T5Config", "T5ForConditionalGeneration", "FlaxT5ForConditionalGeneration",
                  dict(T5_KW, tie_word_embeddings=False, feed_forward_proj="gated-gelu")),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {k: write_checkpoint(root, k, spec=v) for k, v in SPECS.items()}


@pytest.mark.parametrize("name", ["t5", "t5-untied"])
def test_t5_pretrained_logits_match_jax(checkpoints, name):
    path = checkpoints[name]
    bundle = jt5.build_t5(pretrained=path)
    b = {k: np.array(v) for k, v in jt5.synthetic_seq2seq_batch(
        np.random.default_rng(0), 2, 9, 5, 128).items()}
    b["attention_mask"][0, 7:] = 0
    want = np.asarray(bundle.apply_fn(bundle.params, **b))
    model = tt5.build_t5(pretrained=path, device="cpu", dtype=torch.float32)
    assert model.config.tie_word_embeddings == (name == "t5")
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v).long() for k, v in b.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_unknown_tensor_raises(checkpoints, tmp_path):
    src = checkpoints["t5"]
    state = pretrained.read_state_dict(src)
    state["encoder.block.0.layer.0.SelfAttention.extra.weight"] = torch.zeros(2, 2)
    d = tmp_path / "extra"
    d.mkdir()
    (d / "config.json").write_text(open(f"{src}/config.json").read())
    torch.save(state, d / "pytorch_model.bin")
    with pytest.raises(ValueError, match="SelfAttention.extra"):
        pretrained.load_pretrained(str(d), device="cpu")
