"""Tiny T5's tiers against the JAX package at its own draws, on the CPU in
f32 (``tests/test_torch_t5.py`` has the conversion; one block a stack): the
fused tier's antithetic pairs under frozen MOPED (logits 1e-4,
log-probs 2e-5 relative, the gradients of the ELBO objective's two parts
1e-4 of each leaf's largest entry:
``tests/test_torch_estimators.py::check_against_jax``; the naive tier and
the sigma -> 0 limit of every tier in ``tests/test_torch_t5_naive.py``).
"""
from test_torch_estimators import check_against_jax
from test_torch_t5 import B, TGT, VOCAB, batch, pair
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_t5_fused_matches_jax():
    """Every q/k/v/o and wi/wo kernel through the fused tier's antithetic
    pairs, the attention plain (the reference's fused tier does not
    intercept T5's), at the JAX package's draws."""
    check_against_jax(pair(layers=1), "antithetic", batch(3), (B, TGT, VOCAB), n_samples=2)

