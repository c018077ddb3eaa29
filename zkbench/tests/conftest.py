"""The benchmark's own tests: the harness on the CPU (toy cells in a
temporary copy of BENCHMARK.json and zkbench/) and, with the marker
``cuda``, the control at each cell's size on the card.

  python3 -m pytest -p no:cacheprovider -q zkbench/tests          (the CPU)
  python3 -m pytest -p no:cacheprovider -q zkbench/tests -m cuda  (the card)
"""

import os
import sys

import pytest
import torch

ZKBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(ZKBENCH)
for p in (ROOT, ZKBENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the control runs at the cells' own sizes)")
    return torch.device("cuda")
