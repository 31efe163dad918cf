"""Tiny T5 with its three tables converted (``EMBEDDING_RULE``: ``shared``
and the two ``relative_attention_bias`` tables) against the JAX package,
on the CPU in f32, one block a stack.

What the JAX package's tiers do with these tables, found on the CPU and
matched here: its fused and LRT tiers intercept each lookup and split the
ids across the draws (``ids.reshape(S, -1)``), so the bias tables' (Lq,
Lk) buckets, which are not batch-shaped, take one chunk of rows from each
draw and every sample sees that same mix, and an S that does not divide
Lq Lk raises (a ``TypeError`` there, a ``ValueError`` here); the tied head
reads ``shared``'s mu; flipout has no embedding handler and raises (held
in ``_embed_naive.py``; the S refusal in ``_embed_lrt.py``). The naive tier (a vmap
of whole draws) looks every table up in its own sample's draw, the tied
head included (``tests/test_torch_t5_embed_naive.py``). Held at the JAX package's draws:
``tests/test_torch_estimators.py::check_against_jax`` (logits 1e-4,
log-probs 2e-5 relative, gradients 1e-4 of each leaf's largest entry).
"""
from test_torch_estimators import check_against_jax
from test_torch_t5 import B, TGT, VOCAB, batch, pair
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_t5_embed_fused_matches_jax():
    """The fused tier's antithetic pairs with the tables drawn whole
    (``sampled_weights``), the buckets split across the draws."""
    check_against_jax(pair("embedding", layers=1), "antithetic", batch(3), (B, TGT, VOCAB),
                      n_samples=2)

