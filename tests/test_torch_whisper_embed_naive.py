"""Tiny Whisper with its tables converted (``EMBEDDING_RULE``) under the
naive tier against the JAX package's vmap of whole draws, on the CPU in
f32, one layer a tower: every lookup, the shared encoder positions and the
tied head included, reads its own sample's table
(``nn/naive.py::embed_unbatched``, ``tied_table``);
``tests/test_torch_whisper_embed.py`` has the other tiers.
"""
from test_torch_estimators import check_against_jax
from test_torch_whisper import B, batch, pair
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_whisper_embed_naive_matches_jax():
    check_against_jax(pair("embedding", layers=1), "naive", batch(2, 1), (B, 16, 128),
                      n_samples=2)
