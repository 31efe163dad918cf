"""Tiny Whisper with its tables converted (``EMBEDDING_RULE``) under local
reparameterization against the JAX package at its draws, on the CPU in
f32, one layer a tower: each looked-up row its own Gaussian, the encoder's
shared positions split across the draws as the reference's
``handle_embed`` splits them, the tied head at mu; and the refusals both
packages share: flipout has no embedding handler, and an S that does not
divide the 24 encoder positions raises
(``tests/test_torch_whisper_embed.py`` has the other tiers).
"""
import jax
import pytest

from test_torch_estimators import check_against_jax
from test_torch_whisper import B, batch, pair, tensors
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_whisper_embed_lrt_matches_jax():
    check_against_jax(pair("embedding", layers=1), "local", batch(2, 1), (B, 16, 128),
                      n_samples=2)


def test_whisper_embed_refusals_match_jax():
    """Flipout raises for the converted tables; S = 5 does not divide the
    24 encoder positions and raises in both packages."""
    _, bmodel, bp, port = pair("embedding", layers=1)
    b = batch(2, 1)
    with pytest.raises(NotImplementedError, match="embed_tokens"):
        port.mc_apply_flipout(0, 2, **tensors(b))
    with pytest.raises(TypeError, match="reshape"):
        # traced only: the refusal comes before any compile
        jax.jit(lambda p: bmodel.mc_apply_lrt(p, jax.random.key(0), 5, **b))(bp)
    for fn in (port.mc_apply_fused, port.mc_apply_lrt):
        with pytest.raises(ValueError, match="S=5 must divide"):
            fn(0, 5, **tensors(b))
