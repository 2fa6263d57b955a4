"""SLAM accuracy of the port: trajectory error and map-vs-true-walls for
every correction tier, the counterpart of tools/bench_accuracy.py.

    python -m swarm_tpu_torch.accuracy [--agents 64] [--steps 2000]
        [--chunk 250] [--device cuda] [--json out.json]
        [--unary-weight 25] [--unary-theta-weight 4] [--distinct 0]
        [--reloc-distinct 0] [--log-distinct 0] [--pair-budget 8]

The closed-loop engine runs the tool's multi-room world at the reference
drift rates (scale bias +-0.2 %, yaw bias -/+0.008 rad/m) in its four
variants (`presets.accuracy`): raw (no pose corrections, scan-matched
closure edges logged), ref_closures (the reference's damped landmark
snap), merge_anchored (the anchored scan merge, closure edges logged) and
ref_closures+merge. The offline tiers then refine the logged trajectories:
refined and joint (pose-graph GN over the raw run with its own edges;
joint couples agents through verified cross edges), the anchored tiers
(the merge_anchored run's verified fixes as unary factors), the
calibrated tiers (a per-agent yaw-rate bias and scale fitted to those
fixes, plain, robust and re-localized against the anchor map) and the GN
tiers on each calibrated chain. Metrics, as the tool's: ate_mean_m /
ate_late_m (mean position error over the run / its last 10 %), wall_p50 /
wall_p90 (cells from each occupied cell to the nearest true wall),
wall_iou (against the walls dilated by one cell).

Noise comes from one CPU `torch.Generator` per variant (seed 0 for
each, as the tool starts each variant from the same key), drawn by
`engine.sim.draw_step_noise` and moved to the run's device, so the card
and the CPU see the same noise. The merge_anchored variant also keeps every
step's sweep, cast with the step's own drawn sweep noise on the pre-step
true pose: the sweep the step sensed. The maps of the calibrated and GN
tiers are rastered again from the refined poses by the XLA beam tier
(`ops/beam_raster.beam_raster_reference`), as the tool does.

The JSON has the tool's keys ("agents", "steps", "platform", "drift",
"variants" with one entry per tier) and a "timing" entry: steps/s per
variant and the seconds of each offline tier.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from swarm_tpu_torch._device import default_device

TIERS = ("raw", "ref_closures", "merge_anchored", "ref_closures+merge",
         "refined", "joint", "calibrated", "calibrated_robust",
         "calibrated_reloc", "anchored_gn", "anchored_joint",
         "calibrated_gn", "calibrated_joint", "reloc_gn", "reloc_joint")

LOG_KEYS = ("err", "sx", "sy", "yq", "tx", "ty", "lm", "ncl", "nmg",
            "syaw", "ex", "ey", "eyaw", "mok", "mfit")


def true_wall_mask(walls, grid_cfg):
    """Wall segments -> boolean [S, S] cell mask (samples every res/4
    along each segment)."""
    res = grid_cfg.resolution
    s = grid_cfg.size
    mask = np.zeros((s, s), bool)
    for x0, y0, x1, y1 in np.asarray(walls, np.float64):
        length = float(np.hypot(x1 - x0, y1 - y0))
        k = max(2, int(length / (res / 4)) + 1)
        ts = np.linspace(0.0, 1.0, k)
        xs = x0 + ts * (x1 - x0)
        ys = y0 + ts * (y1 - y0)
        cx = np.floor((xs - grid_cfg.origin_x) / res).astype(np.int64)
        cy = np.floor((ys - grid_cfg.origin_y) / res).astype(np.int64)
        ok = (cx >= 0) & (cx < s) & (cy >= 0) & (cy < s)
        mask[cy[ok], cx[ok]] = True
    return mask


def dilate(mask, it=1):
    """4-neighbour dilation, `it` times (wrapping at the edges, as the
    tool's)."""
    m = mask.copy()
    for _ in range(it):
        m = (m | np.roll(m, 1, 0) | np.roll(m, -1, 0)
             | np.roll(m, 1, 1) | np.roll(m, -1, 1))
    return m


def wall_metrics(occ, wall_mask, max_d=12):
    """p50 / p90 distance (cells) of occupied cells to the true walls, and
    the IoU against the 1-cell-dilated wall set."""
    if occ.sum() == 0:
        return {"wall_p50": float("nan"), "wall_p90": float("nan"),
                "wall_iou": 0.0, "occ_cells": 0}
    reached = wall_mask.copy()
    dist = np.full(occ.shape, np.inf)
    dist[wall_mask] = 0.0
    for k in range(1, max_d + 1):
        grown = dilate(reached, 1)
        newly = grown & ~reached
        dist[newly & occ] = np.minimum(dist[newly & occ], k)
        reached = grown
        if (dist[occ] < np.inf).all():
            break
    dd = dist[occ]
    dd = np.where(np.isinf(dd), max_d, dd)
    wall1 = dilate(wall_mask, 1)
    inter = (occ & wall1).sum()
    union = (occ | wall1).sum()
    return {"wall_p50": float(np.percentile(dd, 50)),
            "wall_p90": float(np.percentile(dd, 90)),
            "wall_iou": float(inter / max(union, 1)),
            "occ_cells": int(occ.sum())}


def run_variant(cfg, walls, params, rooms, steps: int, chunk: int,
                collect_scans: bool, generator: torch.Generator):
    """A rollout of `steps` steps (whole chunks) collecting, per step, the
    tool's observables: pose error, the server-frame (srv) and raw
    estimate (est) poses, the reported yaw, the true position, landmark,
    closures, merges, the merge fixes; with `collect_scans` the step's
    sweeps. Noise is drawn from `generator` (on any device) and moved to
    the params' device. Returns (dict of step-major numpy arrays, final
    state)."""
    from swarm_tpu_torch.engine.sim import (draw_step_noise, make_sim_step,
                                            sim_init)
    from swarm_tpu_torch.models.scan import sense_scan

    dev = params.home_x.device
    n, r = cfg.n_agents, cfg.engine.scan_rays
    wg, roa = rooms
    walls_agent = wg[roa.long()]
    step = make_sim_step(cfg, walls, params, generator, walls_grouped=wg,
                         room_of_agent=roa)
    state = sim_init(cfg, params)
    keys = LOG_KEYS + (("scan",) if collect_scans else ())
    host = {k: [] for k in keys}
    for _ in range(steps // chunk):
        rows = {k: [] for k in keys}
        for _ in range(chunk):
            noise = draw_step_noise(generator, n, r, generator.device)
            noise = type(noise)(*(None if x is None else
                                  type(x)(*(f.to(dev) for f in x))
                                  for x in noise))
            s2, m = step(state, noise)
            out = (m.pose_err, m.srv_x, m.srv_y, m.yaw_q,
                   state.pose_true[:, 0] + params.x_offset,
                   state.pose_true[:, 1], m.landmark, m.closures, m.merges,
                   m.srv_yaw, m.est_x, m.est_y, m.est_yaw, m.merge_ok,
                   m.merge_fit)
            if collect_scans:
                out = out + (sense_scan(noise.scan, state.pose_true,
                                        walls_agent, r, cfg.sensors),)
            for k, v in zip(keys, out):
                rows[k].append(v)
            state = s2
        for k in keys:
            host[k].append(torch.stack(rows[k]).cpu().numpy())
    return {k: np.concatenate(v, axis=0) for k, v in host.items()}, state


def ate(err, late_frac=0.1):
    """(mean, mean over the last `late_frac` of the steps)."""
    t = len(err)
    k = max(1, int(t * late_frac))
    return float(err.mean()), float(err[-k:].mean())


def reraster_from_poses(poses, scans, cfg, chunk=100, device=None):
    """Every step's sweeps re-projected from the given poses [T, N, 3]
    (server frame) into a fresh log-odds grid by the XLA beam tier
    (`beam_raster_reference`), scans [T, N, R]; `chunk` steps go to the
    device at a time. Returns the grid [S, S] as numpy."""
    from swarm_tpu_torch.ops.beam_raster import (BeamSpec,
                                                 beam_raster_reference,
                                                 beams_from_scan,
                                                 reach_cells)
    device = default_device(device)
    spec = BeamSpec.scan(scans.shape[-1])
    reach = reach_cells(cfg)
    lo = torch.zeros((cfg.grid.size, cfg.grid.size), dtype=torch.float32,
                     device=device)
    t = len(poses)
    assert t % chunk == 0 or chunk > t
    for i in range(0, t, chunk):
        pc = torch.as_tensor(np.asarray(poses[i:i + chunk], np.float32),
                             device=device)
        sc = torch.as_tensor(np.asarray(scans[i:i + chunk], np.float32),
                             device=device)
        for pose, s in zip(pc, sc):
            db, tb = beams_from_scan(s, cfg.sensors.max_range,
                                     cfg.sensors.min_range)
            lo, _ = beam_raster_reference(lo, pose[:, :2], pose[:, 2], db,
                                          tb, spec, cfg.grid, reach=reach)
    return lo.cpu().numpy()


def _rounded(d):
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in d.items()}


def closure_log(state):
    """The final closure ring's edges as the tools read them: (lm node,
    node, agent 1-based, meas [C, 3], fit [C]) numpy."""
    cl = state.srv.closure
    c = min(int(cl.cl_count), cl.cl_node.shape[0])

    def h(x):
        return x[:c].cpu().numpy()
    meas = np.stack([h(cl.cl_mx), h(cl.cl_my), h(cl.cl_mth)], axis=-1)
    return (h(cl.cl_lm_node), h(cl.cl_node), h(cl.cl_agent) + 1, meas,
            h(cl.cl_fit))


def worlds(n_agents: int, device=None, pair_budget: int = 8,
           distinct: float = 0.0, log_distinct: float = 0.0):
    """{variant: (cfg, walls, params, rooms)}, `presets.accuracy` for each
    of the four variants."""
    from swarm_tpu_torch import presets

    device = default_device(device)
    return {name: presets.accuracy(n_agents, name, device=device,
                                   pair_budget=pair_budget,
                                   distinct=distinct,
                                   log_distinct=log_distinct)
            for name in presets.ACCURACY_VARIANTS}


def run_variants(variant_worlds, steps: int, chunk: int, log=print):
    """The online variants of `variant_worlds` ({variant: world}, as
    `worlds` gives them). Returns (results {variant: metrics}, logs
    {variant: (log, state)}, seconds {variant: s}). Noise is drawn on the
    CPU from a generator seeded 0 per variant, so a run on the card sees
    the noise of the same run on the CPU."""
    from swarm_tpu_torch.ops.raster import tri_state_view

    base_cfg, walls = variant_worlds["raw"][:2]
    wall_mask = true_wall_mask(walls.cpu().numpy(), base_cfg.grid)
    results, logs, seconds = {}, {}, {}
    for name, (cfg, walls, params, rooms) in variant_worlds.items():
        gen = torch.Generator().manual_seed(0)
        t0 = time.perf_counter()
        lg, state = run_variant(cfg, walls, params, rooms, steps, chunk,
                                collect_scans=(name == "merge_anchored"),
                                generator=gen)
        seconds[name] = time.perf_counter() - t0
        a_mean, a_late = ate(lg["err"])
        occ = (tri_state_view(state.srv.logodds, cfg.grid) ==
               cfg.grid.occupied).cpu().numpy()
        results[name] = {"ate_mean_m": round(a_mean, 4),
                         "ate_late_m": round(a_late, 4),
                         "closures": int(lg["ncl"].sum()),
                         "merges": int(lg["nmg"].sum()),
                         **_rounded(wall_metrics(occ, wall_mask))}
        logs[name] = (lg, state)
        log(f"{name:16s} ATE mean {a_mean:.3f} m | late {a_late:.3f} m | "
            f"wall p90 {results[name]['wall_p90']} | "
            f"IoU {results[name]['wall_iou']} | "
            f"closures {results[name]['closures']} "
            f"merges {results[name]['merges']} | "
            f"{len(lg['err']) / seconds[name]:.2f} steps/s")
    return results, logs, seconds


def session_from_log(lg, xk, yk, yawk):
    """A variant's logged poses (keys xk, yk, yawk of `run_variant`'s
    log) as the offline tiers' session dict (step-major rows, 1-based
    agents, the tool's layout)."""
    t_steps, n = lg[xk].shape
    return {"t": np.repeat(np.arange(t_steps, dtype=np.float64) * 0.4, n),
            "agent": np.tile(np.arange(1, n + 1), t_steps),
            "x": lg[xk].reshape(-1), "y": lg[yk].reshape(-1),
            "yaw_deg": np.degrees(lg[yawk].reshape(-1)),
            "landmark": lg["lm"].reshape(-1)}


def offline_tiers(logs, base_world, device=None, unary_weight=25.0,
                  unary_theta_weight=4.0, reloc_distinct=0.0, log=print,
                  solved=None):
    """Every offline tier on the variants' logs (the tool's recipe and
    order), solved with the config of `base_world` (the raw variant's
    world). Returns (results {tier: metrics}, seconds {tier: s}). With a
    dict `solved`, every pose-graph tier's pose dicts are left in it (for
    comparisons)."""
    import dataclasses

    from swarm_tpu_torch.ops.raster import tri_state_view
    from swarm_tpu_torch.slam.calibrate import (calibrate_chains,
                                                calibrate_reloc)
    from swarm_tpu_torch.slam.joint import joint_refine_session
    from swarm_tpu_torch.slam.refine import refine_session

    device = default_device(device)
    base_cfg, walls, params, _ = base_world
    wall_mask = true_wall_mask(walls.cpu().numpy(), base_cfg.grid)
    results, seconds = {}, {}

    lg, state = logs["raw"]
    t_steps, n = lg["sx"].shape
    session = session_from_log(lg, "sx", "sy", "yq")
    closures = closure_log(state)
    true_x, true_y = lg["tx"].reshape(-1), lg["ty"].reshape(-1)

    def offline_ate(refined, tx=None, ty=None):
        tx = true_x if tx is None else tx
        ty = true_y if ty is None else ty
        errs = np.zeros(t_steps * n, np.float64)
        for r in refined.values():
            idx = r["idx"]
            errs[idx] = np.hypot(r["poses"][:, 0] - tx[idx],
                                 r["poses"][:, 1] - ty[idx])
        return ate(errs.reshape(t_steps, n).mean(axis=1))

    t0 = time.perf_counter()
    refined = refine_session(session, closures=closures, cfg=base_cfg,
                             device=device)
    seconds["refined"] = time.perf_counter() - t0
    a_mean, a_late = offline_ate(refined)
    n_edges = int(sum(len(r["closures"]) for r in refined.values()))
    n_meas = int(sum(r.get("measured", 0) for r in refined.values()))
    results["refined"] = {"ate_mean_m": round(a_mean, 4),
                          "ate_late_m": round(a_late, 4),
                          "closures_used": n_edges,
                          "measured_edges": n_meas}
    log(f"{'refined':16s} ATE mean {a_mean:.3f} m | late {a_late:.3f} m "
        f"({n_edges} closure edges, {n_meas} scan-measured) | "
        f"{seconds['refined']:.2f} s")

    t0 = time.perf_counter()
    joint = joint_refine_session(session, closures=closures, cfg=base_cfg,
                                 device=device)
    seconds["joint"] = time.perf_counter() - t0
    a_mean, a_late = offline_ate(joint)
    comp_inter = {tuple(r["component"]): r["inter_edges"]
                  for r in joint.values()}
    results["joint"] = {"ate_mean_m": round(a_mean, 4),
                        "ate_late_m": round(a_late, 4),
                        "components": sorted(len(c) for c in comp_inter),
                        "inter_edges": int(sum(comp_inter.values()))}
    log(f"{'joint':16s} ATE mean {a_mean:.3f} m | late {a_late:.3f} m "
        f"(components {results['joint']['components']}, "
        f"{results['joint']['inter_edges']} verified cross edges) | "
        f"{seconds['joint']:.2f} s")
    if solved is None:
        solved = {}
    solved["refined"], solved["joint"] = refined, joint

    # the merge_anchored run's verified fixes as absolute observations
    lg_m, state_m = logs["merge_anchored"]
    session_m = session_from_log(lg_m, "ex", "ey", "eyaw")
    closures_m = closure_log(state_m)
    uw = np.array([unary_weight, unary_weight, unary_theta_weight],
                  np.float32)
    unary = {}
    n_obs = 0
    for a in range(n):
        idx = np.nonzero(lg_m["mok"][:, a])[0]
        if len(idx) == 0:
            continue
        z = np.stack([lg_m["sx"][idx, a], lg_m["sy"][idx, a],
                      lg_m["syaw"][idx, a]], -1).astype(np.float32)
        unary[a + 1] = (idx.astype(np.int64), z, np.tile(uw, (len(idx), 1)))
        n_obs += len(idx)
    true_xm, true_ym = lg_m["tx"].reshape(-1), lg_m["ty"].reshape(-1)

    def tier_map_metrics(refined):
        poses = np.stack([lg_m["ex"], lg_m["ey"], lg_m["eyaw"]],
                         axis=-1).astype(np.float32)
        for a, r in refined.items():
            poses[:, a - 1, :] = r["poses"]
        lo = reraster_from_poses(poses, lg_m["scan"], base_cfg,
                                 chunk=min(100, t_steps), device=device)
        occ = (tri_state_view(torch.from_numpy(lo), base_cfg.grid) ==
               base_cfg.grid.occupied).numpy()
        return _rounded(wall_metrics(occ, wall_mask))

    def chain_dict(cal):
        return {a + 1: {"poses": np.stack(
                            [cal["x"][:, a], cal["y"][:, a],
                             cal["yaw"][:, a]], -1).astype(np.float32),
                        "idx": np.arange(t_steps) * n + a}
                for a in range(n)}

    x_off = params.x_offset.cpu().numpy()
    cal_args = (lg_m["ex"] + x_off[None, :], lg_m["ey"], lg_m["eyaw"],
                lg_m["mok"], lg_m["sx"], lg_m["sy"])
    t0 = time.perf_counter()
    cal = calibrate_chains(*cal_args, device=device)
    seconds["calibrated"] = time.perf_counter() - t0
    cal_dict = chain_dict(cal)
    a_mean, a_late = offline_ate(cal_dict, true_xm, true_ym)
    results["calibrated"] = {
        "ate_mean_m": round(a_mean, 4), "ate_late_m": round(a_late, 4),
        "bias_hat_mean_abs": round(float(np.abs(cal["bias"]).mean()), 5),
        "merge_obs": n_obs, **tier_map_metrics(cal_dict)}
    log(f"{'calibrated':16s} ATE mean {a_mean:.3f} m | late {a_late:.3f} m "
        f"| IoU {results['calibrated']['wall_iou']} (|bias| mean "
        f"{results['calibrated']['bias_hat_mean_abs']}) | "
        f"{seconds['calibrated']:.2f} s")

    t0 = time.perf_counter()
    cal_r = calibrate_chains(*cal_args, robust_c=0.25, irls_rounds=2,
                             device=device)
    seconds["calibrated_robust"] = time.perf_counter() - t0
    cal_r_dict = chain_dict(cal_r)
    a_mean, a_late = offline_ate(cal_r_dict, true_xm, true_ym)
    results["calibrated_robust"] = {
        "ate_mean_m": round(a_mean, 4), "ate_late_m": round(a_late, 4),
        "merge_obs": n_obs, **tier_map_metrics(cal_r_dict)}
    log(f"{'calibrated_robust':16s} ATE mean {a_mean:.3f} m | "
        f"late {a_late:.3f} m | "
        f"IoU {results['calibrated_robust']['wall_iou']} | "
        f"{seconds['calibrated_robust']:.2f} s")

    reloc_cfg = base_cfg.replace(slam=dataclasses.replace(
        base_cfg.slam, merge_search_cells=16,
        merge_distinct_margin=reloc_distinct))
    t0 = time.perf_counter()
    cal2, mask2, fx2, fy2 = calibrate_reloc(
        *cal_args, state_m.srv.anchor.cpu().numpy(), lg_m["scan"],
        reloc_cfg, rounds=2, every=16, device=device)
    seconds["calibrated_reloc"] = time.perf_counter() - t0
    cal2_dict = chain_dict(cal2)
    a_mean, a_late = offline_ate(cal2_dict, true_xm, true_ym)
    n_obs2 = int(mask2.sum())
    results["calibrated_reloc"] = {
        "ate_mean_m": round(a_mean, 4), "ate_late_m": round(a_late, 4),
        "reloc_obs": n_obs2,
        "bias_hat_mean_abs": round(float(np.abs(cal2["bias"]).mean()), 5),
        **tier_map_metrics(cal2_dict)}
    log(f"{'calibrated_reloc':16s} ATE mean {a_mean:.3f} m | "
        f"late {a_late:.3f} m | "
        f"IoU {results['calibrated_reloc']['wall_iou']} "
        f"({n_obs2} reloc fixes) | {seconds['calibrated_reloc']:.2f} s")

    # unary factors from the re-localized fixes (position only)
    uw2 = np.array([unary_weight, unary_weight, 0.0], np.float32)
    unary2 = {}
    for a in range(n):
        idx = np.nonzero(mask2[:, a])[0]
        if len(idx) == 0:
            continue
        z2 = np.stack([fx2[idx, a], fy2[idx, a], np.zeros(len(idx))],
                      -1).astype(np.float32)
        unary2[a + 1] = (idx.astype(np.int64), z2,
                         np.tile(uw2, (len(idx), 1)))
    session_r = dict(session_m, x=cal2["x"].reshape(-1).astype(np.float64),
                     y=cal2["y"].reshape(-1).astype(np.float64),
                     yaw_deg=np.degrees(cal2["yaw"].reshape(-1)))
    session_c = dict(session_m, x=cal["x"].reshape(-1).astype(np.float64),
                     y=cal["y"].reshape(-1).astype(np.float64),
                     yaw_deg=np.degrees(cal["yaw"].reshape(-1)))
    for tier_name, solver, sess, un in (
            ("anchored_gn", refine_session, session_m, unary),
            ("anchored_joint", joint_refine_session, session_m, unary),
            ("calibrated_gn", refine_session, session_c, unary),
            ("calibrated_joint", joint_refine_session, session_c, unary),
            ("reloc_gn", refine_session, session_r, unary2),
            ("reloc_joint", joint_refine_session, session_r, unary2)):
        t0 = time.perf_counter()
        ref_t = solver(sess, closures=closures_m, cfg=base_cfg, unary=un,
                       device=device)
        seconds[tier_name] = time.perf_counter() - t0
        solved[tier_name] = ref_t
        a_mean, a_late = offline_ate(ref_t, true_xm, true_ym)
        results[tier_name] = {"ate_mean_m": round(a_mean, 4),
                              "ate_late_m": round(a_late, 4),
                              "merge_obs": n_obs,
                              **tier_map_metrics(ref_t)}
        extra = ""
        if tier_name.endswith("_joint"):
            comp_inter = {tuple(r["component"]): r["inter_edges"]
                          for r in ref_t.values()}
            results[tier_name]["inter_edges"] = int(
                sum(comp_inter.values()))
            results[tier_name]["components"] = sorted(
                len(cmp) for cmp in comp_inter)
            extra = f", {results[tier_name]['inter_edges']} cross edges"
        log(f"{tier_name:16s} ATE mean {a_mean:.3f} m | late {a_late:.3f} m "
            f"| IoU {results[tier_name]['wall_iou']} ({n_obs} merge "
            f"observations{extra}) | {seconds[tier_name]:.2f} s")
    return results, seconds


def run(n_agents: int = 64, steps: int = 2000, chunk: int = 250,
        device=None, unary_weight: float = 25.0,
        unary_theta_weight: float = 4.0, distinct: float = 0.0,
        reloc_distinct: float = 0.0, log_distinct: float = 0.0,
        pair_budget: int = 8, log=print):
    """Every variant and tier; returns the JSON dict."""
    device = default_device(device)
    chunk = min(chunk, steps)
    variant_worlds = worlds(n_agents, device, pair_budget, distinct,
                            log_distinct)
    results, logs, sec_v = run_variants(variant_worlds, steps, chunk,
                                        log=log)
    tiers, sec_t = offline_tiers(
        logs, variant_worlds["raw"], device, unary_weight,
        unary_theta_weight, reloc_distinct, log=log)
    results.update(tiers)
    done = (steps // chunk) * chunk
    return {"agents": n_agents, "steps": steps,
            "platform": "gpu" if device.type == "cuda" else device.type,
            "drift": {"scale": "+/-0.2%", "yaw": "-/+0.008 rad/m"},
            "variants": results,
            "timing": {"steps_per_s": {k: done / v
                                       for k, v in sec_v.items()},
                       "offline_s": sec_t}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    ap.add_argument("--unary-weight", type=float, default=25.0)
    ap.add_argument("--unary-theta-weight", type=float, default=4.0)
    ap.add_argument("--distinct", type=float, default=0.0)
    ap.add_argument("--reloc-distinct", type=float, default=0.0)
    ap.add_argument("--log-distinct", type=float, default=0.0)
    ap.add_argument("--pair-budget", type=int, default=8)
    a = ap.parse_args(argv)
    out = run(a.agents, a.steps, a.chunk, a.device, a.unary_weight,
              a.unary_theta_weight, a.distinct, a.reloc_distinct,
              a.log_distinct, a.pair_budget,
              log=lambda s: print(s, flush=True))
    print(json.dumps(out))
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
