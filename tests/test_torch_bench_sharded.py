"""`python -m swarm_tpu_torch.bench_sharded` (the port's
tools/bench_sharded.py) on gloo ranks: the swarm preset at 8 agents, 2
timed steps, in a world of one rank and a world of two, each its own
`torchrun --standalone`; the writes are equal across the worlds (the
tool's own assertion, which it checks too)."""

import re

from swarm_tpu_torch import bench_sharded
from tests.torch_parity import torch_one_thread  # noqa: F401


def test_bench_sharded_writes_equal_across_worlds(capsys):
    bench_sharded.main(["--agents", "8", "--steps", "2", "--worlds", "1,2",
                        "--device", "cpu"])
    text = capsys.readouterr().out
    writes = {int(w): int(c) for w, c in re.findall(
        r"world=\s*(\d+)\s+[\d.]+ ms/step\s+writes=(\d+)", text)}
    assert sorted(writes) == [1, 2], text
    assert writes[1] == writes[2] > 0
    assert f"OK: identical writes across world sizes {writes[1]}" in text
