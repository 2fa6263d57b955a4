"""4-way ultrasonic sensing: exact ray cast from the TRUE pose + noise
(swarm_tpu/models/sensors.py), and the firmware's three-ping median with
its 4.0 m timeout sentinel (`sense_4way_median3`).

The noise is an input. `jax.random` draws cannot be reproduced by torch, so
the port's sensing takes its draws as a `SensorNoise` of tensors shaped like
the readings: the JAX step's draws in the parity tests, or
`draw_sensor_noise` from an explicit `torch.Generator` in a run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from swarm_tpu_torch.config import SensorConfig
from swarm_tpu_torch.geom.world import cast_rays


class SensorNoise(NamedTuple):
    """Per-reading draws of the reference noise model (shape of the
    readings)."""
    gauss: torch.Tensor    # standard normal
    spur_u: torch.Tensor   # uniform [0, 1): the spurious reading's value
    spur_p: torch.Tensor   # uniform [0, 1): compared to spurious_prob


def draw_sensor_noise(generator: torch.Generator, shape,
                      device) -> SensorNoise:
    return SensorNoise(
        gauss=torch.randn(shape, generator=generator, device=device),
        spur_u=torch.rand(shape, generator=generator, device=device),
        spur_p=torch.rand(shape, generator=generator, device=device))


def draw_median3_noise(generator: torch.Generator, shape,
                       device) -> SensorNoise:
    """The draws of `sense_4way_median3`: three pings' SensorNoise, each
    leaf with a leading [3] axis."""
    pings = [draw_sensor_noise(generator, shape, device) for _ in range(3)]
    return SensorNoise(*(torch.stack(leaf) for leaf in zip(*pings)))


def walls_for_rays(walls):
    """[N, S, 4] per-agent walls gain a ray axis; a shared [S, 4] set
    broadcasts as it is."""
    return walls if walls.dim() == 2 else walls[:, None]


def sense_true(pose_true, walls, cfg: SensorConfig = SensorConfig()):
    """Noise-free 4-ray distances from true poses [N, 3] -> [N, 4]
    ordered (front, left, back, right)."""
    angles = torch.tensor(cfg.angles, dtype=pose_true.dtype,
                          device=pose_true.device)
    world_angles = pose_true[:, 2:3] + angles
    origins = pose_true[:, None, :2].expand(*world_angles.shape, 2)
    return cast_rays(origins, world_angles, walls_for_rays(walls))


def apply_ultrasonic_noise(noise: SensorNoise, true_dist,
                           cfg: SensorConfig = SensorConfig()):
    """Reference noise model on top of true distances: Gaussian sigma,
    spurious uniform(lo, hi) readings with probability spurious_prob,
    floor. The uniform is scaled as `jax.random.uniform` scales it."""
    noisy = true_dist + cfg.noise_sigma * noise.gauss
    lo = torch.tensor(cfg.spurious_lo, dtype=true_dist.dtype,
                      device=true_dist.device)
    hi = torch.tensor(cfg.spurious_hi, dtype=true_dist.dtype,
                      device=true_dist.device)
    spurious = torch.maximum(lo, noise.spur_u * (hi - lo) + lo)
    noisy = torch.where(noise.spur_p < cfg.spurious_prob, spurious, noisy)
    return torch.clamp_min(noisy, cfg.floor)


def sense_4way(noise: SensorNoise, pose_true, walls,
               cfg: SensorConfig = SensorConfig()):
    """Full sensing step: exact cast + reference noise. [N, 4] metres."""
    return apply_ultrasonic_noise(noise, sense_true(pose_true, walls, cfg),
                                  cfg)


def sense_4way_median3(noise, pose_true, walls,
                       cfg: SensorConfig = SensorConfig()):
    """Firmware-style sensing (AgentFirmware_Bot1.ino:239-253): three noisy
    pings per channel, their median, and a reading beyond the sonar's
    envelope reported as the timeout sentinel (`cfg.timeout_sentinel`).
    noise: three SensorNoise, or one whose leaves have a leading [3] axis
    (`draw_median3_noise`). Returns [N, 4] metres."""
    if isinstance(noise, SensorNoise):
        noise = [SensorNoise(*leaves) for leaves in zip(*noise)]
    true_dist = sense_true(pose_true, walls, cfg)
    pings = torch.stack([apply_ultrasonic_noise(n, true_dist, cfg)
                         for n in noise])
    med = torch.median(pings, dim=0).values
    return torch.where(med > cfg.timeout_sentinel,
                       torch.full_like(med, cfg.timeout_sentinel), med)
