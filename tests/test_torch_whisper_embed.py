"""Tiny Whisper with its three tables converted (``EMBEDDING_RULE``: the
encoder's sinusoid positions, the decoder's tokens and positions) against
the JAX package, on the CPU in f32, one layer a tower.

What the JAX package's tiers do with these tables, found on the CPU and
matched here: the encoder's positions are one lookup of ``arange(24)``
shared by every example, which its fused and LRT tiers split across the
draws (``ids.reshape(S, -1)``: each draw gives a chunk of rows, every
sample sees the same mix), under ``stop_gradient`` (no gradient reaches the
table but through its log-probs); an S that does not divide the 24
positions raises; the tied head reads the token table's mu; flipout raises.
The naive tier (``_embed_naive.py``) and LRT with the refusals
(``_embed_lrt.py``) are held in their own files; all at the JAX package's
draws
(``tests/test_torch_estimators.py::check_against_jax``).
"""
from test_torch_estimators import check_against_jax
from test_torch_whisper import B, batch, pair
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_whisper_embed_fused_matches_jax():
    check_against_jax(pair("embedding", layers=1), "antithetic", batch(2, 1), (B, 16, 128),
                      n_samples=2)

