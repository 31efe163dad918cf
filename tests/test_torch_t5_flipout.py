"""Tiny T5 under flipout against the JAX
package at its own draws, on the CPU in f32, one block a stack
(``tests/test_torch_t5.py`` has the conversion): logits 1e-4, the KL 2e-5
relative, the gradients of the ELBO objective's two parts 1e-4 of each
leaf's largest entry (``tests/test_torch_estimators.py::check_against_jax``).
Every T5 projection is bias-free, so only kernels are drawn.
"""
from test_torch_estimators import check_against_jax
from test_torch_t5 import B, TGT, VOCAB, batch, pair
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_t5_flipout_matches_jax():
    check_against_jax(pair(layers=1), "flipout", batch(3), (B, TGT, VOCAB), n_samples=2)
