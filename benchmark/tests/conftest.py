"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
repository's root.  Tests marked ``gpu`` need an NVIDIA card and skip
without one; whether there is a card is decided inside a fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (CUDA/Triton kernels); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda:0")
