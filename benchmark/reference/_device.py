"""Device and dtype policy of the port.

TF32 is off for every float32 matrix product and convolution: the JAX EKF
pins `Precision.HIGHEST` on its products (swarm_tpu/models/ekf.py:83-131)
so that the 6x6 covariance is never propagated at reduced precision, and
the port keeps that contract on the card (cuDNN would otherwise run
float32 convolutions in TF32 by default).

Every public function of the port takes its tensors, or an explicit
`device`, and allocates on that device; nothing moves data implicitly. The
entry points that build state from nothing (`presets.deployable`,
`engine.sim.make_agent_params`, `engine.sim.no_faults`) default to the
card: with no device named they allocate on `cuda`, and with no card they
fail at that first allocation. There is no silent CPU fallback; callers
that want the CPU (the tests) say so.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device=None) -> torch.device:
    """`device` as a torch.device; `cuda` when it is None."""
    return torch.device("cuda" if device is None else device)


def describe(dev) -> tuple:
    """(platform, name) of a torch.device for a tool's record: ("gpu", the
    card's name) on CUDA, else the device type twice."""
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev)
    return dev.type, dev.type


def div(x, c: float):
    """x / c as an IEEE division. The divisor goes in as a device tensor:
    PyTorch's CUDA division by a Python scalar multiplies by its reciprocal
    instead (ROADMAP C8), which can differ in the last bit from the kernels'
    division and from the same division on the CPU."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def recip32(c: float) -> float:
    """float32(1 / float32(c)). The reference engine runs under jit, where
    XLA turns a division by a constant into a multiplication by this
    (ROADMAP C15); the port multiplies by it where the reference divides
    by a constant."""
    return float(np.float32(1.0) / np.float32(c))
