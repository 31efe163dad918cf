"""The port's test files share one fixture: torch on one thread.

Each ``tests/test_torch_*.py`` imports :func:`one_torch_thread`, a
module-scoped autouse fixture. The port's plain eps stream is many small
int64 ops, which slow down by orders of magnitude when several test
workers each spin a full set of OpenMP threads on the same cores.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread while the importing module runs, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
