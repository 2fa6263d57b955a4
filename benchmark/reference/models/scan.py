"""Servo-scan sensing and the velocity-command receiver
(swarm_tpu/models/scan.py): the 181-point sweep (-90..+90 deg relative to
heading) as one batched exact ray cast, and `cmd_vel_drive`, the CMD1
receiver's differential mapping with its 500 ms dead-man stop
(esp32_firmware/src/main.cpp:153-174)."""

from __future__ import annotations

import math

import torch

from benchmark.reference.config import SensorConfig
from benchmark.reference.geom.world import cast_rays
from benchmark.reference.models.sensors import (SensorNoise, walls_for_rays,
                                            apply_ultrasonic_noise)
from benchmark.reference.utils.angles import linspace_f32

SCAN_RAYS = 181
SCAN_FOV = math.pi                   # -90..+90 deg


def scan_angles(n_rays: int = SCAN_RAYS, dtype=torch.float32, device=None):
    """Relative beam angles, -90 deg first, as `jnp.linspace(-pi/2, pi/2,
    n)` computes them in float32."""
    return linspace_f32(-SCAN_FOV / 2, SCAN_FOV / 2, n_rays,
                        device).to(dtype)


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


def cmd_vel_drive(linear_x, angular_z, last_cmd_age_s,
                  deadman_s: float = 0.5, wheel_base_half: float = 0.15,
                  pwm_scale: float = 510.0):
    """CMD1 -> per-wheel PWM with the dead-man stop (main.cpp:153-174):
    left = linear - angular * 0.15, right = linear + angular * 0.15, times
    510, clipped to +-255 and truncated toward zero; a command older than
    500 ms stops both wheels (an age of exactly 0.5 s still drives).
    Returns (pwm_left, pwm_right) int32."""
    left = torch.clamp((linear_x - angular_z * wheel_base_half) * pwm_scale,
                       -255.0, 255.0)
    right = torch.clamp((linear_x + angular_z * wheel_base_half) * pwm_scale,
                        -255.0, 255.0)
    alive = last_cmd_age_s <= deadman_s
    zero = torch.zeros_like(left)
    return (torch.where(alive, left, zero).to(torch.int32),
            torch.where(alive, right, zero).to(torch.int32))
