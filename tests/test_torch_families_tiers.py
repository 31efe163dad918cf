"""Flipout and local reparameterization on ALBERT's attention handler,
against the JAX package on the CPU in f32: tiny ALBERT with its one layer
called twice, frozen MOPED (``tests/test_torch_estimators.py::
check_against_jax``: logits 1e-4, the KL 2e-5 relative, the gradients of
the logits' and of the KL part each leaf within 1e-4 of its largest
entry). The naive tier, flipout and local on DistilBERT's handler are in
``tests/test_torch_families_tiers_distilbert.py``.
"""
import pytest

from test_torch_estimators import B, L, check_against_jax
from test_torch_families import convert_pair, family_batch, inputs_of
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("estimator", ["flipout", "local"])
def test_estimator_on_albert_matches_jax(estimator):
    bundle, bmodel, bp, port = convert_pair("albert-base-v2")
    batch = inputs_of(family_batch(bundle, Bn=B, Ln=L))
    check_against_jax(("frozen-moped", bmodel, bp, port), estimator, batch, (B, 2))
