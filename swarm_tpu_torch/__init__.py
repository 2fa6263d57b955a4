"""swarm_tpu_torch — the PyTorch / CUDA port of `swarm_tpu`.

The JAX package `swarm_tpu` is the reference; this package mirrors its
layout, its function names and its import surface
(`swarm_tpu_torch/models/ekf.py::ekf_step_batch` is the counterpart of
`swarm_tpu/models/ekf.py::ekf_step_batch`, and `from swarm_tpu_torch.models
import sense_4way` of `from swarm_tpu.models import sense_4way`), and is
held against it by `tests/test_torch_*.py`. It imports torch and numpy,
never jax and nothing of `swarm_tpu`: what it needs of the JAX package it
keeps as its own copy (`config.py`, the config dataclasses). Its entry
points allocate on the CUDA card unless the caller names another device.
Importing it builds nothing: each kernel is built at its first launch.

Every module of the JAX package has its counterpart here, name by name
(`tests/test_torch_surface.py`; the few JAX-only names are listed there
with their counterparts):
  geom     — world geometry, batched and room-culled ray casting;
  models   — the per-robot firmware models (EKF, navigation FSM, sensors
             with the three-ping median, odometry, the servo scan and the
             velocity-command receiver, landmarks) on tensors with any
             leading batch axes;
  proto    — wire formats and session CSVs; native — the C++ oracle and
             codec;
  ops      — the rasters: the three Pallas kernels as hand-written CUDA
             (`csrc/free_raster.cu`, `room_raster.cu`, `exact_raster.cu`,
             wrapped in `ops/*_cuda.py`), the torch tiers, Bresenham,
             frontiers;
  slam     — loop closure, scan matching, the pose-graph solvers (their
             normal equations summed in a fixed order on every device),
             map merging, session refinement;
  coord    — heartbeat, territory zones, frontier assignment;
  engine   — the fused swarm step, the replay and frame ingest,
             checkpoints;
  sim      — synthetic sessions; render — the map renderer and PNG writer;
  parallel — the sharded engine and solvers on `torch.distributed`, one
             process per device;
  server   — the live UDP server and scan bridge; cli — the session
             runner, playback and protocol tools.
"""

from swarm_tpu_torch import _device  # noqa: F401  (sets the TF32 policy)
from swarm_tpu_torch.config import (  # noqa: F401
    EngineConfig,
    GridConfig,
    NavConfig,
    NoiseConfig,
    SlamConfig,
    SwarmConfig,
)
