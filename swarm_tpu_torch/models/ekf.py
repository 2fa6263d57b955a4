"""6-state EKF in the SoA form the engine calls (swarm_tpu/models/ekf.py
`ekf_predict_batch`, `ekf_update_batch`, `ekf_step_batch`).

State [x, y, theta, v, omega, bias_omega] for N agents: mean [N, 6],
covariance [N, 6, 6], last update time [N]. The sparse Jacobian products are
written out as row and column combinations over [N, 6] slices (exact
float32, no matrix product), so no precision pin is needed here; TF32 is
off anyway (_device.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from swarm_tpu_torch.config import EkfConfig
from swarm_tpu_torch.utils.angles import wrap_pi

IDX_X, IDX_Y, IDX_THETA, IDX_V, IDX_OMEGA, IDX_BIAS = 0, 1, 2, 3, 4, 5
STATE_DIM = 6


class EkfState(NamedTuple):
    x: torch.Tensor       # [N, 6] mean
    P: torch.Tensor       # [N, 6, 6] covariance
    last_t: torch.Tensor  # [N] seconds


def ekf_init(x0: torch.Tensor, t0: float = 0.0) -> EkfState:
    """Batched initial state from means x0 [N, 6] (P = I, ref ekf.cpp:7)."""
    n = x0.shape[0]
    eye = torch.eye(STATE_DIM, dtype=x0.dtype, device=x0.device)
    return EkfState(x=x0.clone(), P=eye.expand(n, -1, -1).clone(),
                    last_t=torch.full((n,), t0, dtype=x0.dtype,
                                      device=x0.device))


def ekf_predict_batch(state: EkfState, omega_measured, t,
                      cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Gyro-driven predict (ref ekf.cpp:26-68); dt <= 0 is a no-op."""
    x, P, last_t = state
    dt = t - last_t
    valid = dt > 0.0
    dt = torch.where(valid, dt, torch.zeros_like(dt))

    theta = x[:, IDX_THETA]
    v = x[:, IDX_V]
    bias = x[:, IDX_BIAS]
    omega_c = omega_measured - bias
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)

    x_new = torch.stack([
        x[:, IDX_X] + v * cos_t * dt,
        x[:, IDX_Y] + v * sin_t * dt,
        wrap_pi(theta + omega_c * dt),
        x[:, IDX_V],
        omega_c,
        x[:, IDX_BIAS]], dim=-1)

    # F = I + {(0,2): a, (0,3): b, (1,2): c, (1,3): d, (2,5): e,
    #          row 4 = -e5} — ref ekf.cpp:55-65.
    a = (-v * sin_t * dt)[:, None]
    b = (cos_t * dt)[:, None]
    c = (v * cos_t * dt)[:, None]
    d = (sin_t * dt)[:, None]
    e = (-dt)[:, None]

    fp = torch.stack([
        P[:, 0, :] + a * P[:, 2, :] + b * P[:, 3, :],
        P[:, 1, :] + c * P[:, 2, :] + d * P[:, 3, :],
        P[:, 2, :] + e * P[:, 5, :],
        P[:, 3, :],
        -P[:, 5, :],
        P[:, 5, :]], dim=1)
    g = torch.stack([
        fp[:, :, 0] + a * fp[:, :, 2] + b * fp[:, :, 3],
        fp[:, :, 1] + c * fp[:, :, 2] + d * fp[:, :, 3],
        fp[:, :, 2] + e * fp[:, :, 5],
        fp[:, :, 3],
        -fp[:, :, 5],
        fp[:, :, 5]], dim=2)
    q = torch.tensor(cfg.q_diag, dtype=x.dtype, device=x.device)
    eye = torch.eye(STATE_DIM, dtype=x.dtype, device=x.device)
    P_new = g + q[None, None, :] * eye[None]

    return EkfState(
        x=torch.where(valid[:, None], x_new, x),
        P=torch.where(valid[:, None, None], P_new, P),
        last_t=torch.where(valid, t, last_t))


def ekf_update_batch(state: EkfState, v_meas, omega_meas,
                     cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Encoder (v, omega) update (ref ekf.cpp:70-92): closed-form 2x2
    innovation inverse, K and (I - KH)P as outer products over agents."""
    x, P, last_t = state
    r0, r1 = cfg.r_odom_diag
    iv, iw = IDX_V, IDX_OMEGA

    s00 = P[:, iv, iv] + r0
    s01 = P[:, iv, iw]
    s10 = P[:, iw, iv]
    s11 = P[:, iw, iw] + r1
    det = s00 * s11 - s01 * s10
    inv00, inv01 = s11 / det, -s01 / det
    inv10, inv11 = -s10 / det, s00 / det

    pht0 = P[:, :, iv]
    pht1 = P[:, :, iw]
    k0 = pht0 * inv00[:, None] + pht1 * inv10[:, None]
    k1 = pht0 * inv01[:, None] + pht1 * inv11[:, None]

    innov0 = v_meas - x[:, iv]
    innov1 = omega_meas - x[:, iw]
    x_new = x + k0 * innov0[:, None] + k1 * innov1[:, None]

    khp = k0[:, :, None] * P[:, iv, None, :] + \
        k1[:, :, None] * P[:, iw, None, :]
    return EkfState(x=x_new, P=P - khp, last_t=last_t)


def ekf_step_batch(state: EkfState, omega_meas, v_meas, t,
                   cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Fused predict-then-update, the firmware's per-loop sequence."""
    return ekf_update_batch(
        ekf_predict_batch(state, omega_meas, t, cfg), v_meas, omega_meas, cfg)
