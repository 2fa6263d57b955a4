"""Navigation FSM: the firmware's 6-state controller as one branch-free
step over [N] agents (swarm_tpu/models/nav.py `nav_step`).

Every state's outcome is computed element-wise and selected by the current
state code; per-agent parameters pick the wall side, speed and return
style.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.config import NavConfig
from benchmark.reference.utils.angles import degrees, radians, wrap_pi

FOLLOW = 0
CORNER_ROUND = 1
TURN_TO_WALL = 2
AVOID_FRONT = 3
GO_TO_TARGET = 4
RETURN_HOME_STRAIGHT = 5

NAV_STATE_NAMES = ("FOLLOW", "CORNER_ROUND", "TURN_TO_WALL", "AVOID_FRONT",
                   "GO_TO_TARGET", "RETURN_HOME_STRAIGHT")

RETURN_STYLE_STRAIGHT = 0
RETURN_STYLE_GOHOME = 1
RETURN_STYLE_PROXIMITY = 2


class NavState(NamedTuple):
    """Batched [N] navigation state."""
    state: torch.Tensor            # int32 code
    corner_elapsed_s: torch.Tensor
    returning_home: torch.Tensor   # bool
    has_target: torch.Tensor       # bool
    target_x: torch.Tensor
    target_y: torch.Tensor
    target_age_s: torch.Tensor
    mission_complete: torch.Tensor  # bool


class NavParams(NamedTuple):
    wall_side: torch.Tensor     # +1 left-wall follower, -1 right
    motor_pwm: torch.Tensor
    return_style: torch.Tensor  # RETURN_STYLE_* int32
    home_x: torch.Tensor
    home_y: torch.Tensor


class NavCommand(NamedTuple):
    turn_cmd_rad: torch.Tensor
    drive_m: torch.Tensor
    steer_rad: torch.Tensor
    moving: torch.Tensor         # bool


def nav_init(n: int, device=None) -> NavState:
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    f = torch.zeros((n,), dtype=torch.bool, device=device)
    return NavState(
        state=torch.zeros((n,), dtype=torch.int32, device=device),
        corner_elapsed_s=z, returning_home=f, has_target=f.clone(),
        target_x=z.clone(), target_y=z.clone(), target_age_s=z.clone(),
        mission_complete=f.clone())


def _applied_turn_deg(deg, cfg: NavConfig):
    """The 15 -> 22 degree hardcoded calibration (ino:347-349)."""
    return torch.where(deg == cfg.turn_bite_deg,
                       torch.full_like(deg, cfg.turn_15_applied_deg), deg)


def nav_step(nav: NavState, params: NavParams, ranges_m, est_pose,
             total_distance, zone_box, has_zone, dt_s,
             cfg: NavConfig = NavConfig()):
    """One navigate() tick for every agent. ranges_m [N, 4] (front, left,
    back, right); est_pose [N, 3]; zone_box [N, 4]; has_zone [N] bool.
    Returns (new NavState, NavCommand)."""
    front_cm = ranges_m[:, 0] * 100.0
    left_cm = ranges_m[:, 1] * 100.0
    right_cm = ranges_m[:, 3] * 100.0
    side = params.wall_side.to(front_cm.dtype)
    wall_cm = torch.where(side > 0, left_cm, right_cm)

    x, y, yaw = est_pose[:, 0], est_pose[:, 1], est_pose[:, 2]
    st = nav.state
    zero = torch.zeros_like(front_cm)

    def code(c):
        return torch.full_like(st, c)

    v_mps = params.motor_pwm.to(front_cm.dtype) * cfg.pwm_to_mps
    drive_burst_m = v_mps * cfg.drive_tick_s
    bite = radians(_applied_turn_deg(
        torch.full_like(front_cm, cfg.turn_bite_deg), cfg))

    # v1 proximity mission check (before the switch)
    dist_home = torch.sqrt((x - params.home_x) ** 2 +
                           (y - params.home_y) ** 2)
    v1_done = (~nav.mission_complete) & \
        (params.return_style == RETURN_STYLE_PROXIMITY) & \
        (total_distance > cfg.min_travel_distance_m) & \
        (dist_home < cfg.return_threshold_m)

    # return-home injection (before the switch)
    inj_cond = (~nav.returning_home) & (~nav.mission_complete) & \
        (total_distance > cfg.return_home_min_travel_m) & \
        (torch.abs(x - params.home_x) < cfg.return_home_x_window_m)
    inj_straight = inj_cond & (params.return_style == RETURN_STYLE_STRAIGHT)
    inj_gohome = inj_cond & (params.return_style == RETURN_STYLE_GOHOME)
    inj = inj_straight | inj_gohome

    # territory override (highest priority)
    lx = x + cfg.zone_lookahead_m * torch.cos(yaw)
    ly = y + cfg.zone_lookahead_m * torch.sin(yaw)
    m = cfg.zone_margin_m
    in_zone = has_zone & \
        (lx > zone_box[:, 0] - m) & (lx < zone_box[:, 2] + m) & \
        (ly > zone_box[:, 1] - m) & (ly < zone_box[:, 3] + m)
    zone_override = in_zone & (~inj) & (~nav.mission_complete)

    front_blocked = front_cm < cfg.front_block_cm
    wall_lost = wall_cm > cfg.wall_lost_cm
    wall_close = wall_cm < cfg.wall_too_close_cm
    wall_far = wall_cm > cfg.wall_too_far_cm

    # FOLLOW
    f_next = torch.where(front_blocked, code(AVOID_FRONT),
                         torch.where(wall_lost, code(CORNER_ROUND),
                                     code(FOLLOW)))
    f_drive = torch.where(front_blocked | wall_lost, zero, drive_burst_m)
    steer_mag = cfg.steer_pwm_delta * 2 * cfg.diff_pwm_to_rad_s * \
        cfg.drive_tick_s
    f_steer = torch.where(wall_close, -side * steer_mag,
                          torch.where(wall_far, side * steer_mag, zero))
    f_steer = torch.where(front_blocked | wall_lost, zero, f_steer)

    # CORNER_ROUND
    c_elapsed_done = nav.corner_elapsed_s >= cfg.corner_burst_s
    c_next = torch.where(front_blocked, code(AVOID_FRONT),
                         torch.where(~wall_lost, code(FOLLOW),
                                     torch.where(c_elapsed_done,
                                                 code(TURN_TO_WALL),
                                                 code(CORNER_ROUND))))
    c_drive = torch.where(front_blocked | ~wall_lost | c_elapsed_done,
                          zero, v_mps * cfg.corner_burst_s)

    # TURN_TO_WALL: 15-degree bites toward the wall
    t_next = torch.where(~wall_lost, code(FOLLOW),
                         torch.where(front_blocked, code(AVOID_FRONT),
                                     code(TURN_TO_WALL)))
    t_turn = torch.where(~wall_lost | front_blocked, zero, side * bite)

    # AVOID_FRONT: bites away from the wall until the front clears
    front_clear = front_cm >= cfg.front_clear_cm
    target_fresh = nav.has_target & (nav.target_age_s < cfg.target_timeout_s)
    a_next = torch.where(front_clear,
                         torch.where(target_fresh, code(GO_TO_TARGET),
                                     code(FOLLOW)),
                         code(AVOID_FRONT))
    a_turn = torch.where(front_clear, zero, -side * bite)

    # GO_TO_TARGET
    tdx = nav.target_x - x
    tdy = nav.target_y - y
    dist_t = torch.sqrt(tdx ** 2 + tdy ** 2)
    expired = (~nav.has_target) | (nav.target_age_s > cfg.target_timeout_s)
    reached = dist_t < cfg.target_reached_radius_m
    heading_err = wrap_pi(torch.atan2(tdy, tdx) - yaw)
    err_deg = torch.abs(degrees(heading_err))
    need_turn = err_deg > cfg.turn_bite_deg
    turn_deg = torch.clamp(torch.floor(err_deg), 5.0, 30.0)
    g_turn_cmd = torch.sign(heading_err) * radians(
        _applied_turn_deg(turn_deg, cfg))
    g_next = torch.where(expired | reached, code(FOLLOW),
                         torch.where(front_blocked, code(AVOID_FRONT),
                                     code(GO_TO_TARGET)))
    g_drive = torch.where(expired | reached | front_blocked | need_turn,
                          zero, drive_burst_m)
    g_turn = torch.where(expired | reached | front_blocked, zero,
                         torch.where(need_turn, g_turn_cmd, zero))
    g_done = reached & nav.returning_home & \
        (params.return_style == RETURN_STYLE_GOHOME)
    g_drop_target = expired | reached

    # RETURN_HOME_STRAIGHT
    r_done = front_blocked
    r_next = code(RETURN_HOME_STRAIGHT)
    r_drive = torch.where(r_done, zero, drive_burst_m)

    def sel(fv, cv, tv, av, gv, rv):
        return torch.where(st == FOLLOW, fv,
               torch.where(st == CORNER_ROUND, cv,
               torch.where(st == TURN_TO_WALL, tv,
               torch.where(st == AVOID_FRONT, av,
               torch.where(st == GO_TO_TARGET, gv, rv)))))

    next_state = sel(f_next, c_next, t_next, a_next, g_next, r_next)
    drive_m = sel(f_drive, c_drive, zero, zero, g_drive, r_drive)
    steer = sel(f_steer, zero, zero, zero, zero, zero)
    turn_cmd = sel(zero, zero, t_turn, a_turn, g_turn, zero)

    mission_done = nav.mission_complete | v1_done | \
        ((st == RETURN_HOME_STRAIGHT) & r_done) | \
        ((st == GO_TO_TARGET) & g_done)

    # corner timer: reset on entry, advance while bursting
    corner_elapsed = torch.where(
        (st == CORNER_ROUND) & ~c_elapsed_done & wall_lost & ~front_blocked,
        nav.corner_elapsed_s + cfg.corner_burst_s, nav.corner_elapsed_s)
    corner_elapsed = torch.where(
        (next_state == CORNER_ROUND) & (st != CORNER_ROUND),
        zero, corner_elapsed)

    has_target = nav.has_target & ~((st == GO_TO_TARGET) & g_drop_target)

    # overrides, highest priority last: zone, then return-home injection
    zturn = -side * radians(torch.full_like(front_cm,
                                            cfg.zone_avoid_turn_deg))
    next_state = torch.where(zone_override, code(FOLLOW), next_state)
    turn_cmd = torch.where(zone_override, zturn, turn_cmd)
    drive_m = torch.where(zone_override, zero, drive_m)
    steer = torch.where(zone_override, zero, steer)

    inj_turn = -2.0 * radians(torch.full_like(front_cm,
                                              cfg.turn_15_applied_deg))
    next_state = torch.where(inj_straight, code(RETURN_HOME_STRAIGHT),
                             next_state)
    turn_cmd = torch.where(inj_straight, inj_turn, turn_cmd)
    drive_m = torch.where(inj_straight, zero, drive_m)
    steer = torch.where(inj_straight, zero, steer)

    next_state = torch.where(inj_gohome, code(GO_TO_TARGET), next_state)
    target_x = torch.where(inj_gohome, params.home_x, nav.target_x)
    target_y = torch.where(inj_gohome, params.home_y, nav.target_y)
    has_target = has_target | inj_gohome
    target_age = torch.where(inj_gohome, zero, nav.target_age_s + dt_s)

    returning = nav.returning_home | inj

    # mission-complete freeze; v1 proximity completion stops the same tick
    frozen = nav.mission_complete | v1_done
    next_state = torch.where(frozen, st, next_state).to(torch.int32)
    drive_m = torch.where(frozen, zero, drive_m)
    turn_cmd = torch.where(frozen, zero, turn_cmd)
    steer = torch.where(frozen, zero, steer)

    new_nav = NavState(
        state=next_state, corner_elapsed_s=corner_elapsed,
        returning_home=returning, has_target=has_target,
        target_x=target_x, target_y=target_y, target_age_s=target_age,
        mission_complete=mission_done)
    cmd = NavCommand(turn_cmd_rad=turn_cmd, drive_m=drive_m, steer_rad=steer,
                     moving=(drive_m > 0) | (torch.abs(turn_cmd) > 0))
    return new_nav, cmd



def assign_target(nav: NavState, target_xy, mask):
    """A server target arrives (the firmware's TARG handler, present but
    disabled in the reference system, enabled behind the engine's
    `enable_targets`): take it and switch to GO_TO_TARGET unless avoiding
    an obstacle or done. target_xy [N, 2] in the agent's odometry frame,
    mask [N] bool."""
    take = mask & (nav.state != AVOID_FRONT) & ~nav.mission_complete
    go = torch.full_like(nav.state, GO_TO_TARGET)
    return nav._replace(
        has_target=nav.has_target | take,
        target_x=torch.where(take, target_xy[..., 0], nav.target_x),
        target_y=torch.where(take, target_xy[..., 1], nav.target_y),
        target_age_s=torch.where(take, torch.zeros_like(nav.target_age_s),
                                 nav.target_age_s),
        state=torch.where(take, go, nav.state))
