"""Tiny T5 with its tables converted (``EMBEDDING_RULE``) under the naive
tier against the JAX package's vmap of whole draws, on the CPU in f32, one
block a stack: every lookup, the (Lq, Lk) bias buckets and the tied head
included, reads its own sample's table (``nn/naive.py::embed_unbatched``,
``tied_table``); and flipout, which has no embedding handler, raising in
both packages (``tests/test_torch_t5_embed.py`` has the other tiers).
"""
import jax
import pytest

from test_torch_estimators import check_against_jax
from test_torch_t5 import B, TGT, VOCAB, batch, pair, tensors
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_t5_embed_naive_matches_jax():
    check_against_jax(pair("embedding", layers=1), "naive", batch(3), (B, TGT, VOCAB),
                      n_samples=2)


def test_t5_embed_flipout_refuses_tables():
    """Flipout raises for the converted tables in both packages, naming
    them."""
    _, bmodel, bp, port = pair("embedding", layers=1)
    b = batch(3)
    with pytest.raises(NotImplementedError, match="shared/embedding"):
        # traced only: the refusal comes before any compile
        jax.jit(lambda p: bmodel.mc_apply_flipout(p, jax.random.key(0), 2, **b))(bp)
    with pytest.raises(NotImplementedError, match="shared/embedding"):
        port.mc_apply_flipout(0, 2, **tensors(b))
