"""Tests of the benchmark harness. Those marked `card` need a CUDA card
and skip without one; the check is made inside the `card` fixture, never
while a module is imported. Run from the repository's root:

    python3 -m pytest portbench/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where there is none)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
