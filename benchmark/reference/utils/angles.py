"""Angle helpers shared across the port (swarm_tpu/utils/angles.py)."""

from __future__ import annotations

import math

import torch


def jmod(x: torch.Tensor, y: float) -> torch.Tensor:
    """Floored modulo with the sign of `y`, computed as `jnp.mod` computes
    it: an exact `fmod`, then one add of `y` where the remainder's sign
    differs from the divisor's. (`x - y * floor(x / y)` rounds twice and
    can differ in the last bit.)"""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


def wrap_pi(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi] — closed form, as swarm_tpu.utils.angles."""
    return jmod(theta + math.pi, 2.0 * math.pi) - math.pi


def degrees(x: torch.Tensor) -> torch.Tensor:
    """`jnp.degrees`: one multiply by float32(180/pi)."""
    return x * (180.0 / math.pi)


def radians(x: torch.Tensor) -> torch.Tensor:
    """`jnp.radians`: one multiply by float32(pi/180)."""
    return x * (math.pi / 180.0)


def linspace_f32(start: float, stop: float, n: int, device=None):
    """`jnp.linspace(start, stop, n, dtype=float32)` as JAX computes it:
    start*(1-step) + stop*step with step = iota/(n-1) in float32, and the
    last entry exactly stop."""
    lo = torch.tensor(start, dtype=torch.float32, device=device)
    hi = torch.tensor(stop, dtype=torch.float32, device=device)
    if n == 1:
        return lo.reshape(1)
    div = n - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    return torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])
