"""pytest settings of the benchmark's own tests (``pytest h100bench/tests``).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them when no CUDA device is there; the decision is
made inside the fixture, never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
