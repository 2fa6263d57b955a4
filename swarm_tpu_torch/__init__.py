"""swarm_tpu_torch — the PyTorch / CUDA port of `swarm_tpu`.

The JAX package `swarm_tpu` is the reference; this package mirrors its
layout and function names (`swarm_tpu_torch/models/ekf.py::ekf_step_batch`
is the counterpart of `swarm_tpu/models/ekf.py::ekf_step_batch`) and is held
against it by `tests/test_torch_*.py`. It imports torch and numpy, never
jax and nothing of `swarm_tpu`: what it needs of the JAX package it keeps as
its own copy (`config.py`, the config dataclasses). Its entry points
allocate on the CUDA card unless the caller names another device.

Ported so far: the deployable fused step (`engine.sim.sim_step` on
`presets.deployable`) with the anchored scan merge, on both raster paths:
the per-agent window kernel (`_free_kernel`, pack8 + in-kernel endpoints,
`csrc/free_raster.cu`) and the room-tile kernel (`_room_kernel`, per-beam
pack16, `csrc/room_raster.cu`), each a hand-written CUDA kernel wrapped in
`ops/`; and the exploration path (`presets.coverage`, `enable_targets`):
the window kernel's pack16 form without the ring on the wrapped 4-way fan
and the sweep, the exact endpoint scatter, frontiers (`ops/frontier.py`)
and target assignment (`coord/assign.py`); and the sharded engine on
`torch.distributed`, one process per device (`parallel/`: the
"replicated", "rows" and "tiles" decompositions, the window kernel's band
and tile forms). What is not ported yet is listed in ROADMAP.md.
"""

from swarm_tpu_torch import _device  # noqa: F401  (sets the TF32 policy)
