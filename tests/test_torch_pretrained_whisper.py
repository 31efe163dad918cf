"""``pretrained=DIR`` for Whisper (``bayeformers_tpu_torch/pretrained.py::
load_family``) against the JAX package's ``build_whisper(pretrained=DIR)``:
one directory holds the PyTorch file (safetensors) and the Flax file of the
same random tiny HF model, written by ``transformers``
(``tests/test_torch_pretrained.py::write_checkpoint``), and both packages'
logits agree at 1e-4 in f32; the conv stems map from PyTorch's (out, in,
k) to Flax's (k, in, out), and the tied ``proj_out`` is the token table.
"""
import numpy as np
import pytest
import torch

from bayeformers_tpu.models import whisper as jwhisper
from bayeformers_tpu_torch import pretrained
from test_torch_pretrained import write_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SPECS = {
    "whisper": ("WhisperConfig", "WhisperForConditionalGeneration",
                "FlaxWhisperForConditionalGeneration",
                dict(vocab_size=96, num_mel_bins=8, d_model=32, encoder_layers=1,
                     encoder_attention_heads=2, encoder_ffn_dim=64, decoder_layers=1,
                     decoder_attention_heads=2, decoder_ffn_dim=64, max_source_positions=12,
                     max_target_positions=10, pad_token_id=0, bos_token_id=1,
                     eos_token_id=2, decoder_start_token_id=1)),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {k: write_checkpoint(root, k, spec=v) for k, v in SPECS.items()}


def test_whisper_pretrained_logits_match_jax(checkpoints):
    path = checkpoints["whisper"]
    bundle = jwhisper.build_whisper(pretrained=path)
    b = jwhisper.synthetic_speech_batch(np.random.default_rng(0), 2, bundle.config)
    feats, ids = np.array(b["input_features"]), np.array(b["decoder_input_ids"])
    want = np.asarray(bundle.apply_fn(bundle.params, feats, ids))
    model = pretrained.load_pretrained(path, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)

