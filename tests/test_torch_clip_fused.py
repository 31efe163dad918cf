"""Tiny CLIP's fused tier against the JAX package at its own draws, on the
CPU in f32 (``tests/test_torch_clip.py`` has the conversion): antithetic
pairs under frozen MOPED, the (S B_img, S B_txt) similarity untiled to each
sample's block by ``untile_axes=(1,)``; logits 1e-4, log-probs 2e-5
relative, the gradients of the ELBO objective's two parts 1e-4 of each
leaf's largest entry (``tests/test_torch_estimators.py::check_against_jax``).
"""
import numpy as np

from test_torch_clip import B, batch, pair
from test_torch_estimators import check_against_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_clip_fused_matches_jax():
    """The fused tier's antithetic pairs at the JAX package's draws, the
    (S B_img, S B_txt) similarity untiled to each sample's block."""
    x = {k: v.astype(np.int64) if k != "pixel_values" else v for k, v in batch().items()}
    check_against_jax(pair(), "antithetic", x, (B, B), n_samples=4, untile_axes=(1,))
