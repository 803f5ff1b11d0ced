"""The benchmark's own tests (not collected by the repository's test run):
``python -m pytest perfbench/tests -q``. Tests marked ``gpu`` run the
benchmark on a card and skip elsewhere."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: runs the benchmark on a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark's runs on the chip")
    return torch.cuda.get_device_name(0)
