"""6-state EKF (swarm_tpu/models/ekf.py): the firmware's per-robot filter
(`ekf_predict`, `ekf_update`, `ekf_pose`, `ekf_quaternion_z_w`) and the
SoA form the engine calls (`ekf_predict_batch`, `ekf_update_batch`,
`ekf_step_batch`).

State [x, y, theta, v, omega, bias_omega]: mean [..., 6], covariance
[..., 6, 6], last update time [...]. One robot is the case without a batch
axis; the per-robot functions take any leading axes, so the reference's
`jax.vmap` of them is a plain call on a batch. They propagate the
covariance through the dense Jacobian, `jac P jac^T + Q`, as the reference
does at `Precision.HIGHEST`; the products are written as elementwise sums
over the 6-wide axes, so they run in float32 whatever the TF32 setting.
The batched SoA form writes the sparse Jacobian products out as row and
column combinations over [N, 6] slices; it differs from the per-robot
form in addition order only (swarm_tpu/models/ekf.py:139-145).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference._device import default_device
from benchmark.reference.config import EkfConfig
from benchmark.reference.utils.angles import wrap_pi

IDX_X, IDX_Y, IDX_THETA, IDX_V, IDX_OMEGA, IDX_BIAS = 0, 1, 2, 3, 4, 5
STATE_DIM = 6


class EkfState(NamedTuple):
    x: torch.Tensor       # [..., 6] mean
    P: torch.Tensor       # [..., 6, 6] covariance
    last_t: torch.Tensor  # [...] seconds


def ekf_init(x0=None, t0: float = 0.0, dtype=torch.float32,
             device=None) -> EkfState:
    """Initial state (P = I, ref ekf.cpp:7): one robot at the origin when
    x0 is None, else the means x0 [..., 6] (one robot [6], a swarm [N, 6]).
    It lives on x0's device when x0 is a tensor, else on `device` (the card
    when none is named)."""
    dev = x0.device if isinstance(x0, torch.Tensor) and device is None \
        else default_device(device)
    x = torch.zeros((STATE_DIM,), dtype=dtype, device=dev) if x0 is None \
        else torch.as_tensor(x0, dtype=dtype, device=dev).clone()
    eye = torch.eye(STATE_DIM, dtype=dtype, device=dev)
    return EkfState(x=x, P=eye.expand(x.shape + (STATE_DIM,)).clone(),
                    last_t=torch.full(x.shape[:-1], t0, dtype=dtype,
                                      device=dev))


def _q_matrix(cfg: EkfConfig, dtype, device=None):
    return torch.diag(torch.tensor(cfg.q_diag, dtype=dtype, device=device))


def _matmul(a, b):
    """a [..., i, j] @ b [..., j, k] as an elementwise product summed over
    j in float32 (no TF32 on any device, no global setting touched)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def ekf_predict(state: EkfState, omega_measured, t,
                cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Gyro-driven predict step (ref ekf.cpp:26-68) on [..., 6] states.
    omega_measured: gyro-z (rad/s), boot-calibrated as the firmware does;
    the filter still estimates the residual bias in state[5]. dt <= 0 is
    an exact no-op, last_t included (ref ekf.cpp:30-31)."""
    x, P, last_t = state
    dtype, dev = x.dtype, x.device
    t = torch.as_tensor(t, dtype=dtype, device=dev)
    omega_measured = torch.as_tensor(omega_measured, dtype=dtype, device=dev)
    dt = t - last_t
    valid = dt > 0.0
    dt = torch.where(valid, dt, torch.zeros_like(dt))

    theta = x[..., IDX_THETA]
    v = x[..., IDX_V]
    omega_c = omega_measured - x[..., IDX_BIAS]
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    x_new = torch.stack([
        x[..., IDX_X] + v * cos_t * dt,
        x[..., IDX_Y] + v * sin_t * dt,
        wrap_pi(theta + omega_c * dt),
        x[..., IDX_V],
        omega_c,
        x[..., IDX_BIAS]], dim=-1)

    # Analytic Jacobian, ref ekf.cpp:55-65.
    one, zero = torch.ones_like(dt), torch.zeros_like(dt)
    jac = torch.stack([
        torch.stack([one, zero, -v * sin_t * dt, cos_t * dt, zero, zero], -1),
        torch.stack([zero, one, v * cos_t * dt, sin_t * dt, zero, zero], -1),
        torch.stack([zero, zero, one, zero, zero, -dt], -1),
        torch.stack([zero, zero, zero, one, zero, zero], -1),
        torch.stack([zero, zero, zero, zero, zero, -one], -1),
        torch.stack([zero, zero, zero, zero, zero, one], -1)], dim=-2)
    P_new = _matmul(_matmul(jac, P), jac.transpose(-1, -2)) + \
        _q_matrix(cfg, dtype, dev)

    return EkfState(x=torch.where(valid[..., None], x_new, x),
                    P=torch.where(valid[..., None, None], P_new, P),
                    last_t=torch.where(valid, t, last_t))


def ekf_update(state: EkfState, v_meas, omega_meas,
               cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Encoder (v, omega) measurement update (ref ekf.cpp:70-92) on
    [..., 6] states: S = H P H^T + R is the (v, omega) block of P plus R,
    inverted in closed form; K = P H^T S^-1; P = (I - K H) P."""
    x, P, last_t = state
    dtype, dev = x.dtype, x.device
    r0, r1 = cfg.r_odom_diag
    iv, iw = IDX_V, IDX_OMEGA

    s00 = P[..., iv, iv] + r0
    s01 = P[..., iv, iw]
    s10 = P[..., iw, iv]
    s11 = P[..., iw, iw] + r1
    det = s00 * s11 - s01 * s10
    s_inv = torch.stack([torch.stack([s11 / det, -s01 / det], -1),
                         torch.stack([-s10 / det, s00 / det], -1)], dim=-2)
    pht = torch.stack([P[..., :, iv], P[..., :, iw]], dim=-1)   # [..., 6, 2]
    K = _matmul(pht, s_inv)                                    # [..., 6, 2]

    innov = torch.stack([torch.as_tensor(v_meas, dtype=dtype, device=dev)
                         - x[..., iv],
                         torch.as_tensor(omega_meas, dtype=dtype, device=dev)
                         - x[..., iw]], dim=-1)
    x_new = x + _matmul(K, innov[..., None])[..., 0]

    # K H is [6, 6] with only the (v, omega) columns non-zero.
    KH = torch.zeros(K.shape[:-1] + (STATE_DIM,), dtype=dtype, device=dev)
    KH[..., :, iv] = K[..., :, 0]
    KH[..., :, iw] = K[..., :, 1]
    eye = torch.eye(STATE_DIM, dtype=dtype, device=dev)
    return EkfState(x=x_new, P=_matmul(eye - KH, P), last_t=last_t)


def ekf_pose(state: EkfState):
    """(x, y, theta, v, omega): the firmware's getOdom() without the ROS
    message wrapper (ekf.cpp:94-116)."""
    x = state.x
    return (x[..., IDX_X], x[..., IDX_Y], x[..., IDX_THETA], x[..., IDX_V],
            x[..., IDX_OMEGA])


def ekf_quaternion_z_w(state: EkfState):
    """Planar quaternion (z, w) as the reference publishes it
    (ekf.cpp:108-110)."""
    half = state.x[..., IDX_THETA] / 2.0
    return torch.sin(half), torch.cos(half)


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
