"""The harness's tests: on the CPU, with the tests that need a CUDA card
marked ``cuda`` and skipped inside the ``card`` fixture without one.

    python -m pytest perfbench/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA card; skips without one')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs need one")
    return torch.device('cuda', 0)
