"""The benchmark's own tests. They run on the CPU at tiny sizes; a test
marked ``card`` needs an NVIDIA card and skips inside the test without
one. Run them from the repository's root:

    python -m pytest portbench/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without "
        "one (python -m pytest portbench/tests -m card, on the card)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
