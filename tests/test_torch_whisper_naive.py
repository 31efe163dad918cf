"""Tiny Whisper's naive tier against the JAX package's vmap of whole draws
at its own draws, on the CPU in f32, one layer a tower, the conv stems
converted (``tests/test_torch_whisper.py`` has the conversion): logits
1e-4, log-probs 2e-5 relative, the gradients 1e-4 of each leaf's largest
entry (``tests/test_torch_estimators.py::check_against_jax``).
"""
from test_torch_estimators import check_against_jax
from test_torch_whisper import B, batch, pair
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_whisper_naive_matches_jax():
    check_against_jax(pair("conv", layers=1), "naive", batch(2, 1), (B, 16, 128), n_samples=2)
