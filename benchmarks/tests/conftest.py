"""Settings of the benchmark's own tests: the `cuda` marker, and the
fixture that decides at run time, never at import, whether a card is
present."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc (skips without a card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no NVIDIA card: the benchmark's runs need one")
    return torch.device("cuda", 0)
