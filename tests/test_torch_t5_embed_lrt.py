"""Tiny T5 with its tables converted (``EMBEDDING_RULE``) under local
reparameterization against the JAX package at its draws, on the CPU in
f32, one block a stack: each looked-up row its own Gaussian, the bias
buckets split across the draws as the reference's ``handle_embed`` splits
them, the tied head at mu; and an S that does not divide the buckets
raising in both packages (``tests/test_torch_t5_embed.py`` has the other
tiers, ``_embed_naive.py`` flipout's refusal).
"""
import jax
import pytest

from test_torch_estimators import check_against_jax
from test_torch_t5 import B, TGT, VOCAB, batch, pair, tensors
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_t5_embed_lrt_matches_jax():
    check_against_jax(pair("embedding", layers=1), "local", batch(3), (B, TGT, VOCAB),
                      n_samples=2)



def test_t5_embed_s_must_divide_the_buckets():
    """An S that does not divide the decoder's 8 x 8 buckets raises in both
    packages (the JAX package's reshape, the port's check)."""
    _, bmodel, bp, port = pair("embedding", layers=1)
    b = batch(3)
    with pytest.raises(TypeError, match="reshape"):
        # traced only: the refusal comes before any compile
        jax.jit(lambda p: bmodel.mc_apply_fused(p, jax.random.key(0), 3, **b))(bp)
    for fn in (port.mc_apply_fused, port.mc_apply_lrt):
        with pytest.raises(ValueError, match="S=3 must divide"):
            fn(0, 3, **tensors(b))
