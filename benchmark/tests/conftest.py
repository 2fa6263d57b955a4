"""pytest settings of the benchmark's own tests: the `cuda` marker, and
one torch thread (several test workers on a few cores spin against each
other otherwise)."""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the benchmark's kernels run "
        "on the card only); skips without one")
