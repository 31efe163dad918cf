"""Electra in the port against the JAX package, on the CPU in f32, in the
two pairings of conversion and estimator that ``tests/test_torch_families*.py``
leave out: frozen MOPED with independent draws, random init with
antithetic pairs (``test_torch_families.py::check_family``: logits 1e-4,
log-probs 2e-5 relative, each trained leaf's ELBO gradient within 1e-4 of
its largest entry).
"""
import pytest

from test_torch_families import check_family
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("conversion,antithetic", [("frozen-moped", False),
                                                   ("random-init", True)])
def test_electra_crossed_pairings_match_jax(conversion, antithetic):
    check_family("electra-base", conversion, antithetic)
