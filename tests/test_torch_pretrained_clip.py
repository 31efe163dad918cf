"""``pretrained=DIR`` for CLIP (``bayeformers_tpu_torch/pretrained.py::
load_family``) against the JAX package's ``build_clip(pretrained=DIR)``:
one directory holds the PyTorch file (safetensors) and the Flax file of the
same random tiny HF model, written by ``transformers``
(``tests/test_torch_pretrained.py::write_checkpoint``), and both packages'
similarity logits agree at 1e-4 in f32 (the bias-free patch convolution
mapped from PyTorch's (out, in, kh, kw) to Flax's (kh, kw, in, out); the
position-id buffers skipped); a missing tensor raises, naming it. ViT is
in ``tests/test_torch_pretrained_vit.py``.
"""
import numpy as np
import pytest
import torch

from bayeformers_tpu.models import clip as jclip
from bayeformers_tpu_torch import pretrained
from bayeformers_tpu_torch.models import clip as tclip
from test_torch_pretrained import write_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SPECS = {
    "clip": ("CLIPConfig", "CLIPModel", "FlaxCLIPModel",
             dict(text_config=dict(hidden_size=32, intermediate_size=64,
                                   num_hidden_layers=1, num_attention_heads=2,
                                   vocab_size=64, max_position_embeddings=16),
                  vision_config=dict(hidden_size=32, intermediate_size=64,
                                     num_hidden_layers=1, num_attention_heads=2,
                                     image_size=16, patch_size=8),
                  projection_dim=16)),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {k: write_checkpoint(root, k, spec=v) for k, v in SPECS.items()}


def test_clip_pretrained_logits_match_jax(checkpoints):
    path = checkpoints["clip"]
    bundle = jclip.build_clip(pretrained=path)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 63, (3, 7)).astype(np.int32)
    ids[:, -1] = 63
    px = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(bundle.apply_fn(bundle.params, input_ids=ids, pixel_values=px))
    model = tclip.build_clip(pretrained=path, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_missing_tensor_raises(checkpoints, tmp_path):
    src = checkpoints["clip"]
    state = pretrained.read_state_dict(src)
    del state["visual_projection.weight"]
    d = tmp_path / "missing"
    d.mkdir()
    (d / "config.json").write_text(open(f"{src}/config.json").read())
    torch.save(state, d / "pytorch_model.bin")
    with pytest.raises(ValueError, match="visual_projection.kernel"):
        pretrained.load_pretrained(str(d), device="cpu")
