"""Typed configuration tree for the swarm engine — the port's own copy of
`swarm_tpu/config.py` (the JAX package's config tree), so that the port
imports nothing of the JAX package.

Field names, defaults and comments are the reference module's, held equal
to it field by field by tests/test_torch_config.py. One difference:
`GridConfig.lo_dtype` returns a torch dtype. `convert.config_from` rebuilds
this tree from any object with the same fields (a JAX-package config).

The reference scatters configuration across compile-time #defines forked per
robot (AgentFirmware_Bot1/AgentFirmware_Bot1.ino:11-60 vs
AgentFirmware_Bot2/AgentFirmware_Bot2.ino:20-50), module-level constants on the
server (server_nodes/dual_bot_mapper.py:56-103), and argparse flags
(dual_bot_mapper.py:714-719). Here everything is one frozen dataclass tree;
per-agent variation (wall side, speed, start pose) is expressed as *batched
arrays* in `AgentParams`, not forked source files.

All defaults are the reference's values, cited to the reference project's
file:line.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Occupancy grid geometry. Ref: server_nodes/dual_bot_mapper.py:86-94."""

    size: int = 200                # 200x200 cells
    resolution: float = 0.05       # 5 cm / cell
    origin_x: float = -5.0         # world X of cell (0, 0)
    origin_y: float = -5.0
    # Cell states (tri-state parity view). Ref: dual_bot_mapper.py:92-94.
    unknown: int = -1
    free: int = 0
    occupied: int = 100
    # Log-odds internal view (TPU-native path; the reference is tri-state only).
    logodds_hit: float = 0.85
    logodds_miss: float = -0.4
    logodds_clamp: float = 10.0
    # Grid storage dtype: "float32" (default) or "bfloat16". bf16 halves
    # the HBM footprint (a 16,384^2 float32 grid is 1 GB — the r2 scaling
    # ceiling); evidence is still ACCUMULATED in f32 inside the kernels
    # and rounded on store, so the tri-state view stays equivalent within
    # one evidence quantum (|hit|=0.85 => bf16 ulp <= 0.0625 below 16).
    # Supported by the fused engine tiers; the sharded decompositions and
    # the room kernel keep f32.
    logodds_dtype: str = "float32"

    @property
    def extent(self) -> float:
        return self.size * self.resolution

    @property
    def lo_dtype(self):
        """torch dtype of the log-odds grid."""
        import torch
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.logodds_dtype]


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """4-way ultrasonic model.

    Trust window: dual_bot_mapper.py:57-58. Noise model:
    simulation_tools/generate_fake_dual_session.py:100-108. Sensor mount
    angles (front/left/back/right): generate_fake_dual_session.py:59-64 and
    dual_bot_mapper.py:61-66. Firmware timeout sentinel 4.0 m:
    AgentFirmware_Bot1/AgentFirmware_Bot1.ino:239.
    """

    max_range: float = 1.20
    min_range: float = 0.05
    noise_sigma: float = 0.035          # metres
    spurious_prob: float = 0.06
    spurious_lo: float = 0.02
    spurious_hi: float = 2.5
    floor: float = 0.01                 # max(0.01, reading)
    timeout_sentinel: float = 4.0       # no-echo reading
    # ESP-NOW V2V radio model. The reference has TWO v2v semantics: the
    # sim generator reports distance-to-other-bot in cm
    # (generate_fake_dual_session.py:466) while the firmware reports a
    # received-broadcast COUNT — `v2v_packet_received_total++` per ESP-NOW
    # callback (AgentFirmware_Bot1.ino:211-215), fed by SensorNode
    # broadcasting at 20 Hz (SensorNode/SensorNode.ino:37-70). The count
    # personality (AgentParams.v2v_count) accrues broadcast_hz * dt per
    # live transmitter within radio range.
    v2v_range_m: float = 10.0
    v2v_broadcast_hz: float = 20.0
    # Relative mount angles, radians: front, left, back, right.
    angles: Tuple[float, float, float, float] = (
        0.0, math.pi / 2, math.pi, -math.pi / 2)


@dataclasses.dataclass(frozen=True)
class NavConfig:
    """Navigation FSM parameters. Ref: AgentFirmware_Bot1.ino:46-60, 372-373,
    90-94, 74-79, 202-203, 426-434, 347-349."""

    obstacle_threshold_m: float = 0.30
    safe_distance_m: float = 0.50
    motor_speed: int = 205
    turn_speed: int = 215
    wall_target_cm: float = 25.0
    wall_too_close_cm: float = 15.0
    wall_too_far_cm: float = 50.0
    wall_lost_cm: float = 80.0
    front_block_cm: float = 30.0
    front_clear_cm: float = 35.0
    corner_round_ms: float = 600.0
    target_timeout_s: float = 10.0
    target_reached_radius_m: float = 0.30
    zone_margin_m: float = 0.20
    zone_lookahead_m: float = 0.30
    zone_avoid_turn_deg: float = 30.0
    min_travel_distance_m: float = 1.6   # v1 firmware mission gate (:98)
    return_threshold_m: float = 0.50     # v1 RETURN_THRESHOLD (:99)
    return_home_min_travel_m: float = 2.5   # Bot1 return injection (:426)
    return_home_x_window_m: float = 0.35
    # The 15-degree turn command physically produces ~22 degrees on the real
    # robot; the firmware bakes this in (AgentFirmware_Bot1.ino:347-349).
    turn_15_applied_deg: float = 22.0
    turn_bite_deg: float = 15.0
    # Landmark detector thresholds — firmware uses cm (AgentFirmware_Bot1.ino
    # :152-169), the sim generator uses 0.30 m / max-range
    # (generate_fake_dual_session.py:113-129). Both supported.
    lm_close_cm: float = 40.0
    lm_open_cm: float = 80.0
    lm_sim_close_m: float = 0.30
    # Differential-drive motion mapping (sim dynamics for the PWM commands the
    # firmware issues; the real robot's L298N + LEDC stack,
    # AgentFirmware_Bot1/motor_control.cpp:21-68, is modelled, not ported).
    pwm_to_mps: float = 0.0012          # 205 PWM -> ~0.25 m/s
    steer_pwm_delta: int = 50           # P-control band delta (ino:469-472)
    # Yaw rate per PWM of wheel differential: +/-50 PWM for a 300 ms burst
    # arcs the displacement ~0.2 rad (≈12 mm lateral per burst — the same
    # correction rate as the scenario generator's wiggle controller,
    # generate_fake_dual_session.py:289). The arc is a displacement-heading
    # bias only; persistent heading changes only via turn().
    diff_pwm_to_rad_s: float = 0.0067
    drive_tick_s: float = 0.3           # FOLLOW drive burst (ino:477)
    settle_tick_s: float = 0.1          # post-drive settle (ino:479)
    corner_burst_s: float = 0.6         # CORNER_ROUND burst (ino:373)


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Loop closure + pose graph. Ref: dual_bot_mapper.py:96-99."""

    closure_radius_m: float = 0.60
    min_poses_between: int = 30
    closure_correction: float = 0.5
    # The reference matches incoming landmarks against ALL stored
    # landmarks (dual_bot_mapper.py:294), but its two bots map DISJOINT
    # server-frame halves (the separation offset, :851-852), so matching
    # is effectively same-agent. In shared-frame swarm worlds the
    # cross-agent positional snap drags agents' differently-drifted
    # frames together and measurably degrades trajectory accuracy
    # (tools/bench_accuracy.py); True restricts matching to the storing
    # agent and leaves cross-agent alignment to the scan-merge layer.
    closure_same_agent_only: bool = False
    landmark_capacity: int = 4096       # ring buffer (ref list is unbounded)
    # Pose-graph Gauss-Newton (north-star upgrade beyond the reference).
    gn_iterations: int = 10
    gn_damping: float = 1e-3
    # Correlative scan matching (replaces map_merger.py ICP, :45-62).
    scanmatch_window_cells: int = 16    # +/- search window in cells
    scanmatch_angles: int = 17          # rotation hypotheses (odd => 0 incl.)
    scanmatch_angle_range: float = 0.35  # +/- radians
    # sparse rotation budget: top-K occupied cells splatted per hypothesis
    # (occupied mass beyond K is dropped from matching — a room-sized
    # local map has a few hundred occupied cells)
    scanmatch_points: int = 2048
    # In-engine continuous merge (engine.merge_every cadence): each agent's
    # current scan matched against a window of the global map
    # (slam/livemerge.py — the TPU-native form of map_merger.py's
    # continuously re-aligning ICP node).
    merge_window_cells: int = 64        # local splat image side
    merge_search_cells: int = 8         # +/- translation search (cells)
    merge_angles: int = 11              # rotation hypotheses
    # +/- range must cover the 15-deg yaw quantisation (+/-0.13 rad) of
    # the REPORTED yaw plus residual drift; sub-step parabolic
    # refinement (scanmatch) resolves below the 0.04 rad spacing
    merge_angle_range: float = 0.20     # +/- radians
    merge_damping: float = 0.5          # correction damping (ref closure 0.5)
    # Fraction of the yaw correction accumulated into the persistent
    # per-agent state. The reported yaw carries a +/-7.5 deg QUANTISATION
    # oscillation (generate_fake_dual_session.py:468) on top of slow yaw
    # drift; the full correction is always applied to the CURRENT step's
    # raster (scan inserted aligned), but accumulating the oscillating
    # part would inject noise into future steps — default 0.
    merge_yaw_damping: float = 0.0
    # Rotating merge chunk: each merge event matches only this many
    # agents (round-robin over the fleet) — the reference merger aligns
    # ONE incoming submap at a time (map_merger.py:35-62), not the whole
    # fleet at once, and the full-fleet batched match dominated the step
    # at swarm scale (76 ms/event at 1024 agents, r2). <= 0 or >= n, or
    # a size that doesn't divide the fleet/shard evenly, merges everyone.
    merge_chunk: int = 128
    merge_fitness_min: float = 0.6      # map_merger.py:52-56 rejection gate
    merge_min_points: int = 16          # trusted-hit floor (4-way can't merge)
    # PEAK-DISTINCTNESS verification (r5, beyond the reference's fitness
    # gate): a match is `distinct` only when its raw correlation peak
    # beats every hypothesis >= merge_distinct_radius cells away
    # (any rotation) by margin x n_points. The r4 forensics measured
    # 21-31% of fitness-VERIFIED merge events to be false matches,
    # clustering in symmetric rooms and wall-hugging scans — exactly the
    # geometries where the translation score is flat or multi-modal, so
    # fitness (inlier fraction) passes while the peak is ambiguous.
    # `distinct` gates the FIX STREAM (frame-tracker innovations +
    # logged merge_ok observations feeding offline calibration), never
    # the bounded persistent increments — a false increment is clamped
    # and recoverable, a false innovation/fix poisons the estimators.
    # 0 = off (every verified match counts as distinct).
    merge_distinct_margin: float = 0.0
    merge_distinct_radius: int = 3
    # Separate margin for the LOGGED fix stream (merge_ok -> offline
    # calibration observations), thresholding the same raw peak gap
    # (WindowMatch.distinct_gap). 0 = log every verified event (the r4
    # behavior). Kept independent of merge_distinct_margin because the
    # r5 64-agent run measured the 0.05 tracker margin passing only
    # 9/6449 events — correct for gating online innovations (ambiguous
    # peaks must not steer the tracker) but starvation for the offline
    # robust calibration, whose IRLS absorbs false fixes by design.
    merge_distinct_log_margin: float = 0.0
    merge_inlier_radius_cells: int = 2  # inlier radius for fitness
    merge_prior_weight: float = 0.15    # zero-motion prior (aperture fix +
    #                                     false-correction suppression)
    # Absolute scale (rad) of the rotation prior inside the matcher
    # (scanmatch theta_prior_scale): rotations pay
    # prior_weight * n_pts * (theta/scale)^2. At 0.1 a true 0.1 rad frame
    # error is systematically SHRUNK toward 0 in the measured ddtheta —
    # safe for translation-only correction (the r1-r3 default) but it
    # starves the persistent yaw tracker (merge_yaw_damping > 0) of
    # signal; yaw-tracking presets raise it.
    merge_theta_prior_scale: float = 0.1
    # ANCHOR-map matching (beyond the reference): matching against the
    # LIVE map has no restoring force — the map itself migrates with the
    # drifting fleet (free-space carving erodes early wall evidence and
    # repaints it at drifted poses), so corrections chase the drift and
    # the coupled system random-walks (tools/bench_accuracy.py: merge-only
    # late ATE 1.34 m vs 0.39 m raw over 2k steps). With merge_anchor the
    # server freezes each cell's FIRST confident evidence into a second
    # grid and the scan matcher scores against it (falling back to the
    # live map where unanchored) — early evidence carries the least
    # drift, so corrections pull every agent back toward the anchored
    # early-epoch frame instead of confirming the migration.
    merge_anchor: bool = False
    merge_anchor_thresh: float = 1.7    # |log-odds| to freeze (2 hits)
    # Per-event clamp on the PERSISTENT correction increment: a single
    # mismatched window (aperture tie broken wrong, sparse early map)
    # can otherwise jump an agent's frame by the full search range in
    # one event — the wrong frame then freezes into the anchor and
    # self-confirms (observed: one agent jumped 0.5 m at ~step 80 and
    # stayed offset). Bounded increments keep any bad match recoverable
    # by the next good one. The raster-pose correction for THIS step's
    # insert is deliberately NOT clamped: clamping it inserts residually
    # offset evidence whose ghost walls self-confirm on the next match
    # (measured: a 0.34 m slip stalls at ~0.26 m instead of recovering).
    merge_max_step_m: float = 0.15
    merge_max_step_rad: float = 0.05
    # Escalating re-acquisition (VERDICT r3 item 2): after this many
    # CONSECUTIVE failed/railing merge events for an agent (failed = in
    # the matched chunk but fitness-rejected; railing = matched but the
    # persistent increment hit merge_max_step_*), the agent's next merge
    # event re-matches with a WIDER rotation capture range
    # (merge_recover_angle_range over merge_recover_angles hypotheses —
    # the observed escape mode is yaw drift outrunning the +/-0.2 rad
    # default: the 15->22 deg turn quirk piles ~0.12 rad per bite) and,
    # on success, persists the correction under the wider
    # merge_recover_max_step_* clamps so the frame genuinely re-acquires
    # instead of crawling back at merge_max_step_m per event. Rotation-
    # only widening leaves the window FOOTPRINT unchanged, so the
    # sharded decompositions' static containment proofs are untouched.
    # 0 = disabled (default; the deployable preset enables it).
    merge_recover_after: int = 0
    merge_recover_angles: int = 33
    merge_recover_angle_range: float = 0.60
    merge_recover_max_step_m: float = 0.40
    merge_recover_max_step_rad: float = 0.50
    # Absolute scale of the wide pass's rotation prior (scanmatch
    # theta_prior_scale): at the steady-state 0.1, a true 0.4 rad frame
    # error pays 16x prior_weight x n_pts and can never win the argmax.
    merge_recover_theta_prior_scale: float = 0.3
    # TRANSLATION re-acquisition (r4): the wide pass also tries the
    # match at 8 window placements offset by this ring radius — an
    # agent whose level error exceeded the +/-merge_search_cells
    # capture (0.4 m) is otherwise unrecoverable no matter how many
    # rotation hypotheses are searched (measured: a capture-escaped
    # soak agent frozen at ~1.1 m for 4000 steps). Effective capture
    # becomes +/-(offset + search) ~ 0.95 m. Cond-gated with the rest
    # of the wide pass: healthy fleets never pay. 0 disables offsets.
    merge_recover_offset_m: float = 0.55
    # wide-pass adoptions need a higher fitness than the 0.6 accept
    # floor: 9 placements x 33 rotations in a symmetric room is a lot
    # of chances for a plausible false re-acquisition
    merge_recover_fit_min: float = 0.7
    # Online per-agent yaw-RATE bias estimator (VERDICT r4 item 1): the
    # dominant swarm-scale drift mode is a per-meter yaw bias
    # (generate_fake_dual_session.py:414,444 — +/-0.008 rad/m), a frame
    # ROTATION that grows with distance; the level-only persistent
    # correction (merge_dyaw) cannot track it, so the frame error ramps
    # until it outruns the matcher's +/-merge_angle_range capture. Each
    # verified merge's residual ddtheta divided by the distance travelled
    # since that agent's last verified merge IS a noisy observation of the
    # remaining rate error; an exponential update (gain merge_bias_alpha)
    # integrates it into a per-agent rad/m estimate applied as continuous
    # feed-forward (ryaw += rate x distance-since-rebase). Integral
    # action: the estimate converges to the TRUE bias even though the
    # matcher's rotation prior systematically shrinks each ddtheta, and
    # the +/-7.5 deg reported-yaw quantisation oscillation (the reason
    # merge_yaw_damping defaults to 0) is zero-mean over distance and
    # averages out. 0 = disabled.
    merge_bias_alpha: float = 0.0
    merge_bias_max: float = 0.02        # |rad/m| clamp on the estimate
    merge_bias_min_dist: float = 0.25   # m floor on the observation window
    # Extrapolation bound (metres) on the feed-forward: ff = rate x
    # min(dist-since-rebase, this). Between verified events the window
    # is ~merge_every x step_len (~1 m), far below the bound, so the
    # feed-forward is unaffected in normal operation; but an agent whose
    # merges stop verifying (escaped capture, occluded room) would
    # otherwise keep integrating a possibly-wrong rate without any
    # observation to correct it — a railed estimate (0.02 rad/m) turns
    # a recoverable escape into an unbounded frame spin. Bounding the
    # lever caps the worst-case open-loop contribution at
    # merge_bias_max x merge_bias_ff_max_m radians.
    merge_bias_ff_max_m: float = 4.0
    # P term of the PI loop: fraction of the DEBIASED residual persisted
    # into merge_dyaw per verified event (unlike merge_yaw_damping, the
    # quantisation oscillation has been subtracted, so persisting it
    # doesn't inject the +/-7.5 deg noise); the I term alone is unstable
    # (level observation integrated as a rate rails the estimate).
    merge_bias_level_damp: float = 0.5
    merge_bias_level_cap: float = 0.10  # rad per-event level-step clamp
    # Online per-agent FRAME tracker (VERDICT r4 item 1, the mechanism
    # that works where the yaw-rate estimator above measurably did not —
    # see NOTES_r4.md forensics): the server estimates each agent's
    # reported-frame rotation theta and velocity scale from the
    # POSITION-fix innovations, which carry a ~merge-interval lever arm
    # (|path| ~1.6 m vs ~0.1 m fix noise), instead of the rotation
    # matcher's dilation-blind ddtheta. Model: D_rep = s_rep R(e) D_true
    # per step, so the server applies D_corr = s_hat R(-theta_hat) D_rep
    # continuously (every step, [N] vector math), which corrects drift
    # at the SOURCE rate — the event matcher then only trims residuals,
    # and its capture range / persistent clamp never bind. At each
    # verified merge event the residual r against the accumulated
    # corrected path a observes both errors in closed form:
    #   delta_theta = -cross(a, r)/|a|^2,  delta_scale = dot(a, r)/|a|^2
    # (first-order exact; derivation in slam/livemerge.py). 0 = off.
    merge_frame_gain: float = 0.0
    merge_frame_scale_gain: float = 0.1   # innovation gain on the scale
    # min lever arm |a| for a SUB-WINDOW to enter the accumulators
    merge_frame_min_path_m: float = 0.4
    # accumulated lever (metres, squared internally) at which the
    # estimates update: one window is noise-dominated (the matcher's
    # 2-cell dilation plateau puts ~0.1 m on each residual against a
    # ~2 cm/window drift signal — measured sign-agreement 48%), so
    # windows accumulate until sqrt(dacc) reaches this; noise falls as
    # 1/sqrt(windows) while the drift signal is constant
    merge_frame_inno_path_m: float = 2.0
    # per-step teleport guard on the reported delta: a respawn/packet gap
    # must not enter the velocity correction or the path accumulator
    merge_frame_max_step_m: float = 1.0
    # rad, APPLIED theta step clamp per event: must exceed the per-window
    # drift growth (bias_max x window path ~ 0.03 rad) so acquisition
    # tracks, while bounding the damage of any one corrupted innovation
    merge_frame_inno_clamp: float = 0.05
    # |s_hat - 1| bound: the reference's translation-scale biases are
    # +/-0.2% (generate_fake_dual_session.py:407-444); 2x margin without
    # letting a run of false matches rail the velocity (measured: a 6%
    # rail alone costs ~6 cm/m of position error)
    merge_frame_scale_clamp: float = 0.004
    # innovations (NOT corrections) require this fitness — false matches
    # in symmetric rooms cluster at the 0.6 accept floor, and one biased
    # innovation poisons the estimate for many events
    merge_frame_fit_min: float = 0.7
    # TURN gate: innovate only on windows whose reported QUANTIZED yaw
    # did not change. The raster/matcher frame uses the firmware's
    # 15-degree-grid yaw; its +/-7.5-degree residual biases each match
    # by ~q x scan-centroid-radius (0.1-0.25 m). The bias is CONSTANT
    # between turns (the leftover carry differences it away) but STEPS
    # at every turn — a spike of ~0.2 m against a ~2 cm/window drift
    # signal, riding exactly on turn events. Skipping those windows
    # drops the corrupted minority; the rate feed-forward carries the
    # estimate through them. (rad; 0 disables the gate)
    merge_frame_turn_gate: float = 0.01
    # Starvation override for the turn gate (r5): accept a turn-gated
    # window after this many CONSECUTIVE turn-gate discards. An agent
    # that turns at nearly every merge window never passes the gate,
    # accumulates no innovations, and can outrun the sharded evidence
    # band. Measured tradeoff at starve=4: the 181-ray 2000-step
    # deployable-density soak drops 149 -> 126 band escapes, while the
    # 64-agent accuracy preset pays ~0.02 m online late ATE (0.594 ->
    # 0.617 — the accepted windows carry the quantized-yaw spike the
    # gate exists to drop). Default 0 (accuracy-first; the escape
    # envelope holds under 1% of agent-steps either way and the runtime
    # guard drops out-of-band evidence loudly); containment-first
    # deployments on banded/tiled grids set 3-5.
    merge_frame_turn_starve: int = 0
    # second-order loop: per-meter frame-yaw RATE estimate (the drift
    # model's actual parameter, +/-0.008 rad/m) learned from the applied
    # theta steps, fed forward continuously (theta += rate x step
    # distance) so theta needs no per-event kick to track growth
    merge_frame_rate_gain: float = 0.05
    # |rad/m| clamp: the reference's bias is 0.008; leaving 2.5x
    # headroom let a railed rate overshoot theta by 50% between
    # innovations (measured runaway at 0.02) — 0.010 bounds the
    # overshoot at 25% while still covering the true rate
    merge_frame_rate_max: float = 0.010
    # Stationarity damping on event CORRECTIONS (tracker on only): an
    # agent that has not moved since its last verified event re-matches
    # the SAME scan against the same map — near-zero new information,
    # but in a symmetric room the repeated false match ratchets the
    # correction toward the false attractor ~0.15 m per event
    # (measured: a parked soak agent's error crept 0.82 -> 1.13 m
    # through the 1.0 m band budget). Drift cannot accrue without
    # motion, so parked corrections are DAMPED by still_damp (a hard
    # gate was measured to also block genuine healing of parked error
    # at short horizons: 4 agents x 400 steps late ATE 0.22 vs 0.20
    # with the tracker otherwise on). still_m: metres of corrected path
    # since the last verified event below which the damping applies.
    merge_frame_still_m: float = 0.05
    merge_frame_still_damp: float = 0.25
    # Scan projection de-rotates by theta QUANTIZED to this step (rad).
    # Continuous de-rotation couples the estimate into its own
    # observation: a theta error rotates the projected scan, the
    # matcher's zero-rotation prior makes the TRANSLATION absorb the
    # rotation bias (~theta_err x scan radius, comparable to the drift
    # signal), and the innovation loop can lock onto a wrong theta
    # (measured: 3/8 agents wrong-sign/2x at 8 agents x 800 steps).
    # Quantized de-rotation keeps the scan's residual rotation inside
    # the matcher's +/-merge_angle_range capture (where its rotation
    # SEARCH, not the translation, compensates), changes rarely, and
    # each change gates the window's innovation exactly like a turn.
    merge_frame_derot_quant: float = 0.1
    # Freeze window (steps): cells may enter the anchor only this early.
    # Without a cutoff the anchor slowly ACCRETES ghost walls painted at
    # drifted poses later in the run (they become confident, freeze, and
    # then legitimise the drift they encode) — the observed slow ratchet
    # in long soaks. 0 = no limit. Bounded rooms are fully observed
    # within a few hundred steps, so that is the natural setting for
    # long runs.
    merge_anchor_freeze_steps: int = 0
    # SCAN-MATCHED closure measurements (beyond the reference): a
    # landmark revisit constrains relative pose only to the corner-
    # approach spread (~0.3 m — the landmark "position" is the robot's
    # pose at detection, slam/closure.py), which is why zero-measurement
    # closure edges cannot beat raw odometry at short horizons
    # (tools/bench_accuracy.py weight sweep). With closure_scanmatch the
    # landmark ring also stores the detecting robot's SCAN + yaw, and
    # when a closure fires the current scan is correlatively matched
    # against the stored one (slam/closurematch.py) — the logged edge
    # then carries a cm-level SE(2) measurement + fitness that the
    # offline refiners (slam/refine.py, slam/joint.py) weight highly.
    # Off by default: it adds per-step matcher work at the closure
    # cadence and the swarm preset's online mechanism is the anchored
    # merge; accuracy-focused runs turn it on.
    closure_scanmatch: bool = False
    closure_match_search: int = 16      # +/- cells (0.8 m: the 0.6 m
    #                                     closure radius + drift slack)
    closure_match_angles: int = 13
    closure_match_angle_range: float = 0.35  # relative-yaw DRIFT range —
    #                                     both scans project through their
    #                                     est world yaw, so only the drift
    #                                     error needs searching
    closure_match_window: int = 128     # inner cells (6.4 m at 5 cm —
    #                                     must contain the match range)
    # trust range for MATCHING (not rastering): the reference's 1.2 m
    # ultrasonic projection band starves the matcher in room-scale
    # worlds (median 5 trusted points per stored scan vs 102 at 3 m —
    # measured); the servo sweep itself ranges to 4 m
    # (AgentFirmware_Bot1.ino:239 sentinel), so matching trusts further
    # than evidence insertion does
    closure_match_max_range: float = 3.0
    # measurement-context scoring: the merge stage's conservative
    # settings (2-cell dilation plateau + strong zero-motion prior)
    # deliberately bias corrections toward zero for closed-loop
    # stability; an EDGE MEASUREMENT wants the unbiased peak, so the
    # closure matcher sharpens the plateau and weakens the prior
    # (aperture ties still resolve to zero)
    closure_match_inlier_radius: int = 1
    closure_match_prior_weight: float = 0.02
    # matcher batch chunk: the im2col patch tensor is ~70 MB per pair at
    # these window settings, so closure batches match in lax.map chunks
    # of this size (peak temp = chunk windows) instead of one flat vmap
    # that would reserve tens of GB at swarm agent counts
    closure_match_chunk: int = 8
    # per-step measurement budget: a closure step gathers the <= budget
    # packets that actually CLOSED and matches only those (scattering
    # results back), instead of running the masked matcher over the
    # whole fleet — at swarm agent counts a single closing agent would
    # otherwise pay N windows. Closures beyond the budget in one step
    # log unmeasured (fit -1); the revisit re-fires later.
    closure_match_budget: int = 8
    # weights the refiners give a fitness-gated measured edge (x, y,
    # theta) vs the coincidence fallback (refine.py's (4, 4, 0))
    closure_meas_weight: tuple = (50.0, 50.0, 10.0)
    # RENDEZVOUS cross-agent closures (our extension; 0 = off =
    # reference behavior). The reference's same-type + 0.6 m rule
    # structurally cannot fire across agents in swarm worlds: opposite-
    # wall followers pass the same corners >= 0.8 m apart and see
    # mirrored landmark TYPES (measured — 0 cross edges in 600 steps of
    # the 4-agent world). With a radius here, another agent's stored
    # landmark within it matches regardless of type or time gap (the
    # agents' frames drift independently, so even same-time edges are
    # informative), and the scan-match verification + fitness gate
    # replaces the type heuristic as the false-match filter. Requires
    # closure_scanmatch (unverified cross edges would be ~radius-grade
    # noise). Batched path only.
    closure_cross_radius_m: float = 0.0
    # PROXIMITY-PAIR rendezvous (r5, VERDICT r4 item 2). The landmark-
    # coincidence rendezvous above yields ~14 verified edges per 64
    # agents x 2000 steps — both agents must detect landmarks near the
    # same spot AND clear the global min_poses_between cooldown, so the
    # collaborative back-end starves. This mechanism needs no landmarks:
    # each closure step, up to closure_pair_budget CLOSEST pairs of live
    # agents within closure_cross_radius_m get their CURRENT scans
    # matched scan-to-scan (slam/closurematch.py — agent j's sweep
    # splatted as the window, agent i's matched into it), and a
    # fitness-verified match logs a measured cross-agent edge between
    # their current nodes. Same-time edges ARE informative: the agents'
    # frames drift independently, so the SE(2) measurement couples their
    # drifts directly. Per-agent rate limit: an agent participates in at
    # most one attempted pair per closure_pair_cooldown node indices
    # (~cooldown/N steps), keeping the log diverse and the match budget
    # honest. 0 = off. Requires closure_scanmatch + cross radius.
    closure_pair_budget: int = 0
    closure_pair_cooldown: int = 512


@dataclasses.dataclass(frozen=True)
class CoordConfig:
    """Heartbeat / zones / frontiers. Ref: dual_bot_mapper.py:82-84, 101-103."""

    heartbeat_timeout_s: float = 5.0
    zone_interval_s: float = 2.0
    target_interval_s: float = 3.0
    frontier_min_cluster: int = 3
    frontier_separation_m: float = 1.0
    max_frontiers: int = 64             # fixed-capacity centroid list
    # At/above this agent count (with room_boxes available) the engines
    # use coord.assign.greedy_assign_rooms — R rounds of vectorized
    # per-room greedy instead of the N-iteration sequential scan (launch
    # latency ~5 ms/event at 1024 agents). Below it the exact
    # reference-order scan runs (small-scale bench numbers stay pinned).
    assign_rooms_min_agents: int = 128


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Odometry drift + channel imperfection models.

    Ref: generate_fake_dual_session.py:395-453 (drift), :460-473 (encoder,
    yaw quantisation, duplicates), :505 (bot-2 timestamp jitter).
    """

    trans_scale_bias: float = 0.002     # +/- 0.2 % per-agent scale error
    trans_noise_sigma: float = 0.003
    yaw_bias_per_m: float = 0.008       # rad per metre, sign per agent
    yaw_noise_sigma: float = 0.002
    yaw_noise_sigma_turning: float = 0.005
    encoder_m_per_tick: float = 0.0107
    yaw_quantize_deg: float = 15.0
    duplicate_prob: float = 0.05
    dt_lo: float = 0.45
    dt_hi: float = 0.65
    time_jitter_s: float = 0.08


@dataclasses.dataclass(frozen=True)
class EkfConfig:
    """6-state EKF noise. Ref: AgentFirmware_Bot1/ekf.cpp:11-12."""

    q_diag: Tuple[float, ...] = (0.01, 0.01, 0.01, 0.1, 0.1, 0.001)
    r_odom_diag: Tuple[float, float] = (0.05, 0.05)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-level knobs: batching, buffers, dtype policy."""

    max_packets_per_frame: int = 20     # ref: dual_bot_mapper.py:816
    pose_capacity: int = 8192           # ring buffer for pose nodes
    path_capacity: int = 8192           # per-agent path ring buffer
    cloud_capacity: int = 2048          # per-agent per-sensor point cloud
    dtype: str = "float32"
    parity_mode: bool = True            # tri-state last-write-wins raster
    # Throughput-path raster: "line" = per-ray Bresenham scatter-add
    # (bit-comparable cells to the reference); "beam" = polar inverse
    # sensor model (ops/beam_raster.py — scatter-free, the fast path).
    raster_mode: str = "line"
    use_pallas: bool = False            # beam raster via the Pallas kernel
    compute_frontiers: bool = True      # frontier detection at the 3 s cadence
    # Servo-scan variant (esp32_firmware/src/main.cpp): if > 0, each agent
    # additionally sweeps this many beams (-90..+90 deg) per step and the
    # sweep rasters into the grid — the 181-ray LaserScan path.
    scan_rays: int = 0
    # Room-block raster (geom.world.make_tiled_rooms layouts only): > 0 =
    # rooms per tile row; the beam fast path then uses the BlockSpec-
    # pipelined per-tile kernel instead of per-agent windows.
    room_tile_per_row: int = 0
    # Beam fast path tuning: range-table group count (gather loop length)
    # and whether endpoint hits are applied (exact sparse scatter).
    # 0 (default) = PER-BEAM EXACT carve — the kernel's packed unrolled
    # sweep matches the exact inverse sensor model cell-for-cell
    # (5.1e8 cells/s on-chip at 1024 agents / 181 rays). > 0 = grouped
    # turbo tier: ~3.3x faster (1.7e9 at groups=8) but the group-min
    # carve under-fills sector interiors (free-space IoU vs exact
    # plateaus ~0.83 even with the weak tail — measured, r2).
    beam_groups: int = 0
    endpoint_hits: bool = True
    # Weak-evidence tail: carve miss*this from the group-min to the group-
    # MEAN range (fills the annulus the group-min carve leaves unknown;
    # free-space IoU vs the exact per-beam model 0.75 -> ~0.9+). 0 = off.
    beam_tail_weight: float = 0.25
    # In-kernel endpoint painting (hits on the group-min ring, trusted-
    # fraction weighted): cheaper than the exact scatter, placement
    # blurred to the sector's nearest wall. Overrides endpoint_hits.
    kernel_endpoints: bool = False
    # Per-beam kernel range table as 8-bit quads (4 beams/int32 word):
    # halves the gather sweep cost that dominates the VPU-bound kernel
    # (r4 roofline) at <= 1/8-cell (6 mm) range quantization vs the
    # 16-bit default's 1/512 cell. Single-chip fused-engine knob; the
    # sharded decompositions keep the 16-bit packing (their XLA-tier
    # bit-equality contracts quantize at 1/256 cell).
    beam_pack8: bool = False
    # In-engine merge cadence: every `merge_every` steps each agent's scan
    # is matched against the global map and the correction folded into its
    # ingest pose + this step's raster (slam/livemerge.py; reference runs
    # its merger continuously, map_merger.py:35-62). 0 = off. Needs
    # scan_rays > 0 (4 ultrasonic points are below merge_min_points).
    merge_every: int = 0
    # Raster the 4-way ultrasonics in addition to the servo scan. The
    # reference scan-variant firmware maps with the lidar ONLY
    # (esp32_firmware/src/main.cpp has no ultrasonic raster), so False is
    # the faithful setting when scan_rays > 0; the 4-way readings still
    # drive the nav FSM either way.
    raster_4way: bool = True


@dataclasses.dataclass(frozen=True)
class SwarmConfig:
    """Top-level config tree."""

    n_agents: int = 2
    grid: GridConfig = dataclasses.field(default_factory=GridConfig)
    sensors: SensorConfig = dataclasses.field(default_factory=SensorConfig)
    nav: NavConfig = dataclasses.field(default_factory=NavConfig)
    slam: SlamConfig = dataclasses.field(default_factory=SlamConfig)
    coord: CoordConfig = dataclasses.field(default_factory=CoordConfig)
    noise: NoiseConfig = dataclasses.field(default_factory=NoiseConfig)
    ekf: EkfConfig = dataclasses.field(default_factory=EkfConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)

    def replace(self, **kw) -> "SwarmConfig":
        return dataclasses.replace(self, **kw)
