"""ALBERT in the port against the JAX package, on the CPU in f32
(``tests/test_torch_families.py`` has the helpers): its one layer called
twice, so that each shared leaf's draw, KL term and summed gradient are
held against the JAX package's tied-module handling: frozen MOPED with
antithetic pairs, random init with independent draws.
"""
import pytest

from test_torch_families import check_family
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("conversion,antithetic", [("frozen-moped", True),
                                                   ("random-init", False)])
def test_albert_matches_jax(conversion, antithetic):
    check_family("albert-base-v2", conversion, antithetic)
