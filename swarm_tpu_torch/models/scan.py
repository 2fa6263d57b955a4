"""Servo-scan sensing (swarm_tpu/models/scan.py): the 181-point sweep
(-90..+90 deg relative to heading) as one batched exact ray cast."""

from __future__ import annotations

import math

import torch

from swarm_tpu_torch.config import SensorConfig
from swarm_tpu_torch.geom.world import cast_rays
from swarm_tpu_torch.models.sensors import (SensorNoise, walls_for_rays,
                                            apply_ultrasonic_noise)
from swarm_tpu_torch.utils.angles import linspace_f32

SCAN_RAYS = 181


def scan_angles(n_rays: int = SCAN_RAYS, dtype=torch.float32, device=None):
    """Relative beam angles, -90 deg first, as `jnp.linspace(-pi/2, pi/2,
    n)` computes them in float32."""
    return linspace_f32(-math.pi / 2, math.pi / 2, n_rays, device).to(dtype)


def sense_scan_true(pose_true, walls, n_rays: int = SCAN_RAYS):
    """Noise-free sweep distances from true poses [N, 3] -> [N, R]."""
    rel = scan_angles(n_rays, pose_true.dtype, pose_true.device)
    world = pose_true[:, 2:3] + rel
    origins = pose_true[:, None, :2].expand(*world.shape, 2)
    return cast_rays(origins, world, walls_for_rays(walls))


def sense_scan(noise: SensorNoise, pose_true, walls,
               n_rays: int = SCAN_RAYS, cfg: SensorConfig = SensorConfig()):
    """Sweep with the ultrasonic noise model applied per beam."""
    return apply_ultrasonic_noise(
        noise, sense_scan_true(pose_true, walls, n_rays), cfg)
