"""The benchmark's tests: ``python -m pytest gpu_bench/tests -q``.

Tests of code that runs only on the card carry the ``chip`` marker and
skip here, inside the ``chip`` fixture, with a reason."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (run on the card)")


@pytest.fixture
def chip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
