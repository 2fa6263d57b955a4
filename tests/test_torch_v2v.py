"""V2V on the CPU (`ops/v2v_cuda.py`): the trace's counters name the V2V
wrapper; the column split covers N in whole tiles and fills the card where
the work allows; no kernel off the card. The plain version against the
JAX package (and that a CPU tensor launches nothing) is in
tests/test_torch_sim.py; the kernel against the plain version on the card
in tests/test_torch_v2v_cuda.py."""

import pytest
import torch

from swarm_tpu_torch import trace
from swarm_tpu_torch.ops import v2v_cuda

H100_SMS = 132


def test_launch_counts_name_the_v2v_wrapper():
    counts = trace._launch_counts()
    assert counts["v2v_stats"] == v2v_cuda.v2v_stats.launches_by_form
    assert {"free_raster", "room_raster", "beam_raster"} <= set(counts)


@pytest.mark.parametrize("n", (1, 2, 1000, 2049, 16384, 32768, 65536))
def test_column_split_covers_n_and_fills_the_card(n):
    cols, splits = v2v_cuda.split_columns(n, H100_SMS)
    assert cols % v2v_cuda.TILE == 0
    assert (splits - 1) * cols < n <= splits * cols
    row_blocks = -(-n // v2v_cuda.BLOCK_ROWS)
    tiles = -(-n // v2v_cuda.TILE)
    target = v2v_cuda.BLOCKS_PER_SM * H100_SMS
    blocks = row_blocks * splits
    if cols == v2v_cuda.TILE:                 # one tile a split: all the
        assert blocks == row_blocks * tiles <= target   # blocks there are
    else:                                     # near the target
        assert target // 2 < blocks <= target + row_blocks


def test_no_kernel_off_the_card():
    with pytest.raises(ValueError):
        v2v_cuda.v2v_stats(torch.zeros((4, 2), device="meta"),
                           torch.ones((4,), dtype=torch.bool, device="meta"))
