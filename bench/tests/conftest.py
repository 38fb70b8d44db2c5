"""The benchmark's tests: ``python -m pytest bench/tests -q`` from the root
of the checkout. Tests that need the card carry the ``chip`` marker and
decide inside a fixture whether there is one."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA GPU (runs on the card only)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda:0")
