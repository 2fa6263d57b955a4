"""Odometry models: drift integration, encoder counts, yaw quantisation
and the firmware's dead reckoning (swarm_tpu/models/odometry.py), batched
over agents.

The drift noise is an input (`DriftNoise`, standard normals per agent): the
JAX step's own draws in the parity tests, `draw_drift_noise` in a run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from swarm_tpu_torch._device import div
from swarm_tpu_torch.config import NoiseConfig
from swarm_tpu_torch.utils.angles import degrees, wrap_pi


class OdomState(NamedTuple):
    """Drifted (estimated) pose integrator state, [N] leaves."""
    x_est: torch.Tensor
    y_est: torch.Tensor
    yaw_est: torch.Tensor
    encoder_total: torch.Tensor   # int32
    prev_x_est: torch.Tensor      # previous emit position (encoder baseline)
    prev_y_est: torch.Tensor


class DriftNoise(NamedTuple):
    """Standard normals per agent for one drift step."""
    n_t: torch.Tensor    # translation noise
    n_r: torch.Tensor    # yaw noise while moving
    n_s: torch.Tensor    # yaw noise while turning in place


def draw_drift_noise(generator: torch.Generator, n: int,
                     device) -> DriftNoise:
    return DriftNoise(*(torch.randn((n,), generator=generator, device=device)
                        for _ in range(3)))


def odom_init(x0, y0, yaw0) -> OdomState:
    return OdomState(
        x_est=x0.clone(), y_est=y0.clone(), yaw_est=yaw0.clone(),
        encoder_total=torch.zeros(x0.shape, dtype=torch.int32,
                                  device=x0.device),
        prev_x_est=x0.clone(), prev_y_est=y0.clone())


def drift_integrate(noise: DriftNoise, state: OdomState, d_trans, d_rot,
                    trans_scale, yaw_bias_per_m,
                    cfg: NoiseConfig = NoiseConfig()) -> OdomState:
    """One drift-integration step from a TRUE motion delta: moving
    (d_trans > 1 mm) scales + perturbs translation and adds the per-metre
    yaw bias + noise; turning in place (|d_rot| > 0.01) perturbs yaw only;
    still is exact. Midpoint integration along yaw_new - d_rot_noisy/2."""
    moving = d_trans > 1e-3
    turning = torch.abs(d_rot) > 0.01
    zero = torch.zeros_like(d_trans)

    d_trans_noisy = d_trans * trans_scale + torch.where(
        moving, cfg.trans_noise_sigma * noise.n_t, zero)
    d_trans_noisy = torch.clamp_min(d_trans_noisy, 0.0)

    rot_noise_moving = d_trans * yaw_bias_per_m + \
        cfg.yaw_noise_sigma * noise.n_r
    rot_noise_turning = cfg.yaw_noise_sigma_turning * noise.n_s
    d_rot_noisy = d_rot + torch.where(
        moving, rot_noise_moving,
        torch.where(turning, rot_noise_turning, zero))

    yaw_new = wrap_pi(state.yaw_est + d_rot_noisy)
    heading = yaw_new - d_rot_noisy / 2.0
    x_new = state.x_est + d_trans_noisy * torch.cos(heading)
    y_new = state.y_est + d_trans_noisy * torch.sin(heading)
    return state._replace(x_est=x_new, y_est=y_new, yaw_est=yaw_new)


def encoder_emit(state: OdomState, cfg: NoiseConfig = NoiseConfig()):
    """Accumulate encoder ticks from the estimated displacement since the
    last telemetry emit. Returns (new_state, encoder_total)."""
    d = torch.sqrt((state.x_est - state.prev_x_est) ** 2 +
                   (state.y_est - state.prev_y_est) ** 2)
    ticks = torch.clamp_min((d / cfg.encoder_m_per_tick).to(torch.int32), 0)
    total = state.encoder_total + ticks
    new = state._replace(encoder_total=total,
                         prev_x_est=state.x_est, prev_y_est=state.y_est)
    return new, total


def quantize_yaw_deg(yaw_rad, step_deg: float = 15.0):
    """Reported yaw quantised to the commanded-turn grid, in degrees.
    torch.round is round-half-to-even, like jnp.round and Python's round."""
    return torch.round(degrees(yaw_rad) / step_deg) * step_deg


def firmware_odometry_step(x, y, yaw_cmd, encoder_counts,
                           cm_per_groove: float = 21.0 / 20.0):
    """Firmware dead reckoning: encoder ticks -> metres along the COMMANDED
    yaw, not the IMU yaw, so that gyro drift stays out of it
    (AgentFirmware_Bot1.ino:269-281, 704-707). Negative counts move
    nothing. Returns (x, y, metres)."""
    m = div(torch.clamp_min(encoder_counts, 0).to(torch.float32)
            * cm_per_groove, 100.0)
    return x + m * torch.cos(yaw_cmd), y + m * torch.sin(yaw_cmd), m
