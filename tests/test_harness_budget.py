"""The test harness's CPU budget for torch: one thread in every process
that imports tests/torch_parity.py, as every tier-1 worker does."""

import torch

import tests.torch_parity  # noqa: F401


def test_torch_runs_on_one_thread():
    assert torch.get_num_threads() == 1
