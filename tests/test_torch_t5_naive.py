"""Tiny T5's naive tier (per-sample weights) against the JAX package's vmap
of whole draws at its own draws, on the CPU in f32, one block a stack
(``tests/test_torch_t5.py`` has the conversion): logits 1e-4, log-probs
2e-5 relative, the gradients of the ELBO objective's two parts 1e-4 of each
leaf's largest entry (``tests/test_torch_estimators.py::check_against_jax``);
and the sigma -> 0 limit of every tier against the frequentist logits.
"""
import numpy as np
import torch

from test_torch_estimators import check_against_jax
from test_torch_t5 import B, TGT, VOCAB, batch, bundle, pair, tensors
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_t5_naive_matches_jax():
    check_against_jax(pair(layers=1), "naive", batch(3), (B, TGT, VOCAB), n_samples=2)


def test_t5_sigma0_parity_all_tiers():
    """MOPED delta -> 0: every tier gives the frequentist logits (the
    reference's 2e-3)."""
    _, _, bp, port = pair(delta=1e-5, layers=1)
    b = batch(4)
    freq = np.asarray(bundle(layers=1).apply_fn(bp.params, **b))
    with torch.no_grad():
        for fn in (port.mc_apply_fused, port.mc_apply, port.mc_apply_lrt,
                   port.mc_apply_flipout):
            out, aux = fn(0, 2, **tensors(b))
            assert out.shape == (2, B, TGT, VOCAB)
            np.testing.assert_allclose(out[0].numpy(), freq, rtol=2e-3, atol=2e-3)
            assert all(torch.isfinite(v).all() for v in aux.values())
