"""Tiny Whisper's fused tier against the JAX package at its own draws, on
the CPU in f32, one layer a tower, with the conv stems converted
(``CONV_RULE``; ``tests/test_torch_whisper.py`` has the conversion): the
antithetic pairs under frozen MOPED (logits 1e-4, log-probs 2e-5 relative,
the gradients of the ELBO objective's two parts 1e-4 of each leaf's
largest entry: ``tests/test_torch_estimators.py::check_against_jax``).
"""
from test_torch_estimators import check_against_jax
from test_torch_whisper import B, batch, pair
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_whisper_conv_fused_matches_jax():
    """Every Dense and both 1-D stems (im2col, K = 3 x 16 and 3 x 64)
    through the fused tier's antithetic pairs, the attention plain."""
    check_against_jax(pair("conv", layers=1), "antithetic", batch(2, 1), (B, 16, 128),
                      n_samples=2)

