"""Session runner CLI (swarm_tpu/cli/run_session.py) — the reference's
`python dual_bot_mapper.py` / `generate_fake_dual_session.py` entry points
(MULTI_AGENT_SETUP_GUIDE.md:63-77; simulation_tools/README.md:7-12) in one
tool, on the port. Produces a reference-schema session directory
(telemetry.csv, pointcloud.csv, slam_closures.csv, derived clouds, plus
events.jsonl) with map.png and metrics.json.

Presets:
  dual_bot           closed-loop fused engine, 2 agents, bedroom
  dual_bot_scripted  scripted scenario generator -> CSV -> replay engine
                     (the reference's configs[0] acceptance path)
  swarm              N-agent multi-room closed-loop run (--agents)

Noise comes from one `torch.Generator` seeded with --seed on the run's
device (the JAX tool's `PRNGKey(seed)`); --checkpoint stores its state
with the final SimState, and --resume restores both.

Usage: python -m swarm_tpu_torch.cli.run_session --preset dual_bot --out DIR
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _flatten_rollout_telemetry(ms, n_agents: int):
    """Stacked StepMetrics [T, ...] -> packet arrays ordered (step, agent),
    rows filtered to alive agents (an offline agent sends no packets)."""
    t = _np(ms.t)                              # [T]
    T = len(t)
    alive = _np(ms.alive).reshape(T, n_agents)

    def flat(a, extra=()):
        return _np(a).reshape((T * n_agents,) + tuple(extra))

    mask = alive.reshape(-1)
    return dict(
        t=np.repeat(t, n_agents)[mask],
        agent=np.tile(np.arange(1, n_agents + 1), T)[mask],
        x=flat(ms.srv_x)[mask], y=flat(ms.srv_y)[mask],
        yaw=flat(ms.yaw_q)[mask],
        encoder=flat(ms.encoder)[mask], v2v=flat(ms.v2v)[mask],
        dist4=flat(ms.dist_m, (4,))[mask],
        landmark=flat(ms.landmark)[mask],
        hits=flat(ms.hits, (4, 2))[mask],
        hit_valid=flat(ms.hit_valid, (4,))[mask])


def _write_events(out_dir: str, ms, n_agents: int) -> str:
    """Structured event stream (events.jsonl) — the reference's tagged
    console lines ([SLAM] LOOP CLOSURE, [HEARTBEAT] transitions,
    dual_bot_mapper.py:320-322, 811-812) as durable JSONL."""
    t = _np(ms.t)
    closures = _np(ms.closures)
    online = _np(ms.online)
    mission = _np(ms.mission_done)
    path = os.path.join(out_dir, "events.jsonl")
    with open(path, "w") as f:
        prev_online = None
        prev_mission = 0
        for i in range(len(t)):
            if closures[i]:
                f.write(json.dumps({
                    "t": round(float(t[i]), 3), "event": "loop_closure",
                    "count": int(closures[i])}) + "\n")
            if prev_online is not None and online[i] != prev_online:
                f.write(json.dumps({
                    "t": round(float(t[i]), 3), "event": "heartbeat",
                    "online": int(online[i]), "agents": n_agents}) + "\n")
            if mission[i] != prev_mission:
                f.write(json.dumps({
                    "t": round(float(t[i]), 3), "event": "mission_complete",
                    "done": int(mission[i])}) + "\n")
            prev_online = online[i]
            prev_mission = mission[i]
    return path


def _closures_from_state(closure):
    n = min(int(closure.cl_count), closure.cl_node.shape[0])
    return tuple(_np(f[:n]) for f in (closure.cl_lm_node, closure.cl_node,
                                     closure.cl_dx, closure.cl_dy))


def run_closed_loop(args):
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.checkpoint import (GENERATOR_KEY,
                                                   load_generator,
                                                   load_pytree, save_pytree)
    from swarm_tpu_torch.engine.sim import (make_sim_step, run_steps,
                                            sim_init, total_writes_value)
    from swarm_tpu_torch.ops.raster import tri_state_view
    from swarm_tpu_torch.proto.csvio import write_session
    from swarm_tpu_torch.render import render_map, save_png

    dev = torch.device(args.device)
    if args.preset == "swarm":
        cfg, walls, params, rooms = presets.swarm(args.agents, device=dev)
    else:
        cfg, walls, params, rooms = presets.dual_bot(
            separation=args.separation, frontiers=not args.no_frontiers,
            device=dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    st = sim_init(cfg, params)
    if args.resume:
        st = load_pytree(args.resume, st)
        if GENERATOR_KEY in np.load(args.resume).files:
            load_generator(args.resume, gen)
        print(f"[RESUME] from {args.resume} at t={float(st.t):.1f}s "
              f"step={int(st.step)}")
    t0 = time.time()
    # the session owns `st`: the donated step, no copy in the timed run
    step = make_sim_step(cfg, walls, params, gen, donate=True,
                         enable_targets=args.enable_targets,
                         walls_grouped=rooms[0], room_of_agent=rooms[1])
    final, ms = run_steps(step, st, args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.time() - t0

    if args.checkpoint:
        save_pytree(args.checkpoint, final, generator=gen)
        print(f"[CHECKPOINT] saved {args.checkpoint}")

    rows = _flatten_rollout_telemetry(ms, cfg.n_agents)
    write_session(args.out, rows["t"], rows["agent"], rows["x"], rows["y"],
                  rows["yaw"], rows["encoder"], rows["v2v"], rows["dist4"],
                  rows["landmark"], hits_xy=rows["hits"],
                  hit_valid=rows["hit_valid"],
                  closures=_closures_from_state(final.srv.closure))
    _write_events(args.out, ms, cfg.n_agents)

    grid = (final.srv.grid if cfg.engine.parity_mode
            else tri_state_view(final.srv.logodds, cfg.grid))
    img = render_map(
        grid, cfg.grid, scale=max(1, 1024 // cfg.grid.size),
        points_xy=rows["hits"].reshape(-1, 2),
        points_agent=np.repeat(rows["agent"] - 1, 4),
        points_valid=rows["hit_valid"].reshape(-1),
        paths_xy=np.stack([rows["x"], rows["y"]], -1),
        paths_agent=rows["agent"] - 1,
        poses=np.stack([_np(ms.srv_x)[-1], _np(ms.srv_y)[-1],
                        _np(ms.yaw_q)[-1]], -1),
        zones=final.srv.zone_boxes,
        zones_active=final.srv.zone_active,
        frontiers=final.srv.frontier_centroids,
        n_frontiers=int(final.srv.n_frontiers))
    save_png(img, os.path.join(args.out, "map.png"))

    metrics = {
        "preset": args.preset, "agents": cfg.n_agents, "steps": args.steps,
        "elapsed_s": round(elapsed, 3),
        "steps_per_s": round(args.steps / elapsed, 2),
        "total_cell_writes": total_writes_value(final.srv.total_writes),
        "closures": int(_np(ms.closures).sum()),
        "online_at_end": int(_np(ms.online)[-1]),
        "mission_done": int(_np(ms.mission_done)[-1]),
        "mean_pose_err_m": float(_np(ms.pose_err)[-1]),
        "packets": int(len(rows["t"])),
    }
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics))
    return final, metrics


def run_scripted(args):
    from swarm_tpu_torch.config import SwarmConfig
    from swarm_tpu_torch.engine.replay import replay_session
    from swarm_tpu_torch.engine.sim import total_writes_value
    from swarm_tpu_torch.proto.csvio import (load_session,
                                             packet_stream_from_telemetry,
                                             write_session)
    from swarm_tpu_torch.render import render_map, save_png
    from swarm_tpu_torch.sim.scenario import generate_dual_session

    dev = torch.device(args.device)
    cfg = SwarmConfig(n_agents=2)
    res = generate_dual_session(seed=args.seed, cfg=cfg, device=dev)
    write_session(args.out, res.t, res.agent, res.x, res.y, res.yaw_q,
                  res.encoder, res.v2v, res.dist4, res.landmark)

    sess = load_session(args.out)
    stream = packet_stream_from_telemetry(sess, device=dev)
    t0 = time.time()
    state, outs = replay_session(
        stream, cfg, offsets=torch.zeros(2, dtype=torch.float32, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.time() - t0

    img = render_map(
        state.grid, cfg.grid, scale=4,
        points_xy=outs.hits.reshape(-1, 2),
        points_agent=stream.agent.repeat_interleave(4),
        points_valid=outs.hit_valid.reshape(-1),
        paths_xy=torch.stack([outs.rx, outs.ry], -1),
        paths_agent=stream.agent)
    save_png(img, os.path.join(args.out, "map.png"))

    refined_stats = None
    if args.optimize:
        from swarm_tpu_torch.slam.refine import (refine_session,
                                                 reraster_session)

        sess = load_session(args.out)
        refined = refine_session(sess, cfg=cfg, device=dev)
        grid_opt, _ = reraster_session(sess, refined, cfg, device=dev)
        save_png(render_map(torch.as_tensor(grid_opt, device=dev), cfg.grid,
                            scale=4),
                 os.path.join(args.out, "map_refined.png"))
        refined_stats = {
            a: len(r["closures"]) for a, r in refined.items()}

    metrics = {
        "preset": args.preset, "packets": int(len(res.t)),
        "replay_elapsed_s": round(elapsed, 3),
        "total_cell_writes": total_writes_value(state.total_writes),
        "closures": int(state.closure.cl_count),
        "refined_closures_per_agent": refined_stats,
    }
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics))
    return state, metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="dual_bot",
                    choices=["dual_bot", "dual_bot_scripted", "swarm"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--agents", type=int, default=64, help="swarm preset")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--separation", type=float, default=5.0,
                    help="Bot2 x offset (dual_bot_mapper.py --separation)")
    ap.add_argument("--enable-targets", action="store_true",
                    help="enable the commented-out frontier TARG path "
                         "(dual_bot_mapper.py:959-996)")
    ap.add_argument("--optimize", action="store_true",
                    help="scripted preset: pose-graph-refine the session "
                         "and emit map_refined.png")
    ap.add_argument("--no-frontiers", action="store_true")
    ap.add_argument("--checkpoint", default=None,
                    help="save the final SimState (and the noise "
                         "generator's state) to this .npz")
    ap.add_argument("--resume", default=None,
                    help="load the initial SimState (and the generator "
                         "state, when stored) from this .npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.preset == "dual_bot_scripted":
        return run_scripted(args)
    return run_closed_loop(args)


if __name__ == "__main__":
    main()
