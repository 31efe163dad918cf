"""A tiny BERT's embedding tables under ``EMBEDDING_RULE`` in the fused tier's independent draws under random init (the tables' mu trains),
against the JAX package at its own draws, on the CPU in f32
(``tests/test_torch_embed_bert.py`` has the conversion).
"""
from test_torch_embed_bert import pair
from test_torch_estimators import _batch, check_against_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_bert_embeddings_fused_matches_jax():
    """Logits 1e-4, log-probs 2e-5 relative, gradients 1e-4 of each leaf's
    largest entry (``check_against_jax``)."""
    check_against_jax(pair("random-init"), "fused", _batch(), n_samples=4)
