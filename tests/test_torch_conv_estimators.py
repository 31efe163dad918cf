"""``TinyCNN`` under ``CONV_RULE`` in flipout and local reparameterization, under each
conversion (frozen MOPED, MOPED with a trainable mu, random init), against
the JAX package at its own draws, on the CPU in f32
(``tests/test_torch_conv.py`` has the nets and the carry-over).
"""
import pytest

from test_torch_conv import S, images, pair
from test_torch_estimators import CONVERSIONS, check_against_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("estimator,conversion",
                         [(est, conv) for est in ('flipout', 'local') for conv in CONVERSIONS])
def test_conv_tier_matches_jax(estimator, conversion):
    """``TinyCNN`` at the JAX package's draws (``check_against_jax``:
    outputs 1e-4, log-probs or KL 2e-5 relative, gradients 1e-4 of each
    leaf's largest entry): the fused tier's draw on the channel-major (K,
    cout) view, the naive tier's on the stored (kh, kw, cin, cout) leaf,
    flipout's and LRT's KL on the stored leaf."""
    check_against_jax(pair("2d", conversion), estimator, {"x": images("2d", 1)}, (4, 5),
                      n_samples=S)
