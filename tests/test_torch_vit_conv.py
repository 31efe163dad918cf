"""ViT-tiny with its patch projection converted (``CONV_RULE``) in the
port against the JAX package, on the CPU in f32 (``tests/test_torch_vit.py``
has the conversion): the fused tier under both estimators at the JAX
package's draws, and the sigma -> 0 limit of every tier.
"""
import numpy as np
import pytest
import torch

from test_torch_estimators import check_against_jax
from test_torch_vit import bundle, pair, pixels
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("estimator", ["antithetic", "fused"])
def test_vit_conv_fused_matches_jax(estimator):
    """The fused tier (the attention handler with a zero bias, the patch
    conv's im2col under ``CONV_RULE``) at the JAX package's draws: logits,
    log-probs and the ELBO objective's gradients."""
    check_against_jax(pair("conv"), estimator, {"pixel_values": pixels()}, (3, 2), n_samples=4)


def test_vit_sigma0_parity_all_tiers():
    """MOPED delta -> 0 with the patch conv converted: every tier gives the
    frequentist logits (the reference's 2e-3)."""
    _, bmodel, bp, port = pair("conv", 1e-5)
    px = pixels(4)
    freq = np.asarray(bundle().apply_fn(bp.params, px))
    with torch.no_grad():
        for fn in (port.mc_apply_fused, port.mc_apply, port.mc_apply_lrt,
                   port.mc_apply_flipout):
            out, aux = fn(0, 2, torch.from_numpy(px))
            np.testing.assert_allclose(out[0].numpy(), freq, rtol=2e-3, atol=2e-3)
            assert all(torch.isfinite(v).all() for v in aux.values())
