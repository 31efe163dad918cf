"""``pretrained=DIR`` for ViT (``bayeformers_tpu_torch/pretrained.py::
load_family``) against the JAX package's ``build_vit(pretrained=DIR)``: one
directory holds the PyTorch file (safetensors) and the Flax file of the
same random tiny HF model, written by ``transformers``
(``tests/test_torch_pretrained.py::write_checkpoint``), and both packages'
logits agree at 1e-4 in f32. The patch convolution maps from PyTorch's
(out, in, kh, kw) to Flax's (kh, kw, in, out); asked for another label
count, the port keeps the trunk and makes a new classifier from the seed.
CLIP is in ``tests/test_torch_pretrained_clip.py``.
"""
import numpy as np
import pytest
import torch

from bayeformers_tpu.models import vit as jvit
from bayeformers_tpu_torch.models import vit as tvit
from test_torch_pretrained import write_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SPECS = {
    "vit": ("ViTConfig", "ViTForImageClassification", "FlaxViTForImageClassification",
            dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=64, image_size=16, patch_size=4)),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {k: write_checkpoint(root, k, spec=v) for k, v in SPECS.items()}


def test_vit_pretrained_logits_match_jax(checkpoints):
    path = checkpoints["vit"]
    bundle = jvit.build_vit(pretrained=path, n_labels=3)
    px = np.array(jvit.synthetic_image_batch(np.random.default_rng(0), 2, 16, 3)[
        "pixel_values"])
    want = np.asarray(bundle.apply_fn(bundle.params, px))
    model = tvit.build_vit(pretrained=path, n_labels=3, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    other = tvit.build_vit(pretrained=path, n_labels=5, seed=1, device="cpu",
                           dtype=torch.float32)
    assert other.classifier.kernel.shape == (32, 5)
    assert torch.equal(other.vit.embeddings.cls_token, model.vit.embeddings.cls_token)

