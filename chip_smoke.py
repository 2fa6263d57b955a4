"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card
    python3 chip_smoke.py --group faults      # the build and one group

With no arguments every phase runs, in order. `--group NAME` runs the
build and one group of phases, each with all its checks and shapes:
kernels (2-3), paths (4-12), sharded (13-15, 30-32), modes (16-21),
accuracy (22), server (23-29, 33-34), tools (35-41), donation (42),
faults (43); it
prints the records of the kernels that group held or launched (the
numbers of a group that did not run are null) and the same last line.
The count of kernel records is checked on a full run only.

Phases (any failure exits non-zero; nothing is caught and then passed):
  1. build the three raster kernels (swarm_tpu_torch/csrc/free_raster.cu,
     room_raster.cu and exact_raster.cu) and the roofline's float32 probe
     (fp32_probe.cu) from the checkout, one nvcc each, started together;
     print each build time, and per instance of the
     window, room and exact-raster kernels its registers and spilled bytes
     (ptxas) and its resident blocks per SM (CUDA's occupancy calculator);
  2. each kernel, in each of its per-beam forms, vs its plain torch version
     at the shapes of the path that runs it: 1024 agents in the tiled
     4096^2 world, preset start poses with random headings, noisy readings
     (181-beam sweeps, or the 4-way ultrasonics for the wrapped fan), plus
     an overlap case on a grid pre-filled near +-clamp (window kernel: 64
     agents around one point; room kernel: both agents of every room within
     a few cells of each other), so the per-agent clip order (and on a bf16
     grid the per-agent rounding) decides cells, and a NaN case (the
     overlap case's agents on such a grid with 1% NaN and 1% -0.0 cells:
     the clip keeps a NaN, as jnp.clip does). The window kernel's 16
     instances: pack8 / pack16 table x with / without the endpoint ring x
     the 181-beam scan / the wrapped 4-way fan x a float32 / bfloat16 grid;
     the room kernel's four forms: with / without the ring x scan / wrapped
     fan. Maps BIT-EQUAL (bit for bit: a -0.0 against a +0.0 counts),
     counts equal. Timed: the launch call on prepared operands (CUDA
     events, median of 20: the record's `ms`, its measure from the first
     kernel on), the kernel alone on the device (the mean of 20 launches'
     CUDA kernel times from torch.profiler: `device_ms`), the wrapper with
     its preparation, the plain version. The bound (`bound_ms`) is the
     work this run's inputs need: the covered cells read once and the
     cells whose bits the call changes written once, plus the operands;
     beside it the covered bound (`covered_bound_ms`, the records' earlier
     bound: every covered cell read and written, every strip cell
     evaluated) and the cells the kernel evaluates (its evaluation boxes,
     beam_raster_cuda.evaluation_box). The slice's form (pack8 + ring on
     bf16) also at the slice's shapes (32,768 agents on 23,296^2, the
     plain version in agent chunks);
  3. the slice: bench.py --agents 32768 --grid-dtype bfloat16
     (presets.deployable(32768, grid_dtype="bfloat16")): one warm-up step,
     the counters set to 0, 65 steps (bench.py's 400 cut to fit the time
     limit), the counters read: pack8-ring-bf16 launched once per step and
     nothing else, every step writes, merges at steps 15, 31, 47 and 63,
     all agents online, poses finite; steps/s, applied cells/s (an int64
     sum), peak memory; then 17 more steps split on the device timeline
     into raster, merge, sensing and the rest;
  4. the window path: presets.deployable(1024) (merge every 16 steps) ->
     sim_init -> 1 warm-up step -> timed steps, with every kernel launch
     counter set to 0 just before and read just after: the window kernel
     launched once per step (pack8-ring) and the room kernel never, every
     step writes, merges > 0, all 1024 agents online, poses finite;
  5. the room path: presets.deployable(1024, room_kernel=True), the same
     checks with the roles of the two kernels swapped (pack16-ring), and one
     merge event's time (a 128-agent chunk matched through
     scan_merge_recover), and the matcher on that chunk with its
     translation scoring as the port runs it (one grouped conv2d) and in the
     JAX package's im2col form (bmm over unfolded patches, the reference
     `_scores_im2col`);
  6. the exploration path: presets.coverage(1024, frontiers=True) with
     targets, 201 steps: the window kernel twice per step (pack16 on the
     4-way fan, then on the sweep) and the room kernel never, 26 frontier
     events with frontiers found from step 8 on, targets assigned, every
     step writes, all agents online, poses finite; steps/s, device step
     medians with and without a frontier event, the endpoint scatter's
     time per fan, peak memory, coverage of the reachable cells;
  7. the ultrasonic-only path: presets.deployable(1024, scan_rays=0), 101
     steps, one pack8 + ring launch on the 4-way fan per step;
  8. each entry point of the exploration path through sim_rollout at
     1024 agents for 17 steps (coverage with and without frontier targets,
     bench.py --frontiers, bench.py --scan-rays 0), its launches per form
     checked;
  9. every other single-chip bench.py raster flag row (--no-pack8,
     --exact-endpoints, --scan-rays 0, --grid-dtype bfloat16 and
     --room-kernel in the combinations WINDOW_ROWS and ROOM_ROWS list)
     through sim_rollout at 1024 agents for 17 steps: exactly its form
     launched once per step, the other kernel never, every step writes;
     --room-kernel --grid-dtype bfloat16 raises ValueError (sim_init, and
     the room wrapper on a card grid);
 10. bf16 against f32: the 1024-agent window path on each grid dtype, same
     seed, 33 steps: tri-state agreement over explored cells >= 0.98;
 11. reference checks at 8 agents: both deployable paths over the same 34
     steps (two merge events) and the bf16 window path over 17 (one merge
     event) on the card and on the CPU (plain rasters) from the same state
     and noise (online equal, writes within 1%, tri-state maps on >= 99% of
     explored cells; merge counts of both sides printed, and equal on bf16;
     any merge decision that differs reported with the match fitness on
     both sides), and the exploration path over 17 steps (three frontier
     events; writes within 1%, maps on >= 99%, frontier counts equal);
 12. the grouped tier (bench.py --beam-groups N): each of the window
     kernel's 8 grouped instances (ring x scan / wrapped fan x float32 /
     bfloat16 grid) and the room kernel's 4 grouped forms (ring x fan) vs
     its plain version at 1024 agents in the world of the flags that launch
     it, main, overlap and NaN case, as in phase 2 (maps BIT-EQUAL; the
     counts, sums of fractions that both sides sum exactly in double,
     equal), 181 beams in 16 groups too (ROADMAP C1); the r1 exact raster
     (csrc/exact_raster.cu, no engine path calls it) on the scan and the
     wrapped 4-way fan, maps BIT-EQUAL to its plain version (torch.sin on
     the card) on the main, overlap, dirty-tile (no tile clean: values
     beyond +-clamp, -0.0) and NaN cases, its evaluated cells (the boxes,
     exact_raster_cuda.evaluation_box) printed, the kernel's sinf
     against torch.sin on the main case's residuals, and its entry point
     driven over 17 sensed frames per fan; the grouped paths
     (presets.deployable(1024, beam_groups=8), with and without
     room_kernel=True), 201 steps each with the counters set to 0 just
     before: grouped-ring launched once per step on the path's own kernel
     and the other never, every step writes, merges > 0, all agents
     online, poses finite; then 17 steps split on the device timeline on
     each of the four 1024-agent paths, and the grouped paths' steps/s,
     applied cells/s, raster share of the device step and peak memory
     beside the per-beam paths'; every grouped bench.py flag row
     (GROUPED_WINDOW_ROWS, GROUPED_ROOM_ROWS, C1_ROW) through sim_rollout
     for 17 steps, each launching exactly its form; and card vs CPU at 8 agents
     on both grouped paths over 34 steps, as in phase 11;
 13. the sharded engine's band and tile forms of the window kernel (every
     f32 form its body reaches: pack16 or grouped table x ring on / off x
     scan / wrapped fan), each vs its plain version at 1024 agents on
     4096^2: the main path's one-rank windows (the band (0, 4096) and the
     [4160, 4352] tile window of a 1x1 rank grid, all 1024 agents), the
     four 1024-row bands of a 4-rank "rows" layout (256 agents each) and
     the four [2112, 2304] tile windows of a 2x2 "tiles" layout
     (presets.tile_blocks(2, 2, 4096)), all with negative offsets and the
     grid-edge guard where a tile meets the grid's edge, plus an overlap
     case; maps BIT-EQUAL, counts equal; timed and bounded as in phase 2
     at the one-rank windows;
 14. the sharded engine (parallel/sharded.py) on a one-rank NCCL group at
     1024 agents on presets.deployable's world: "replicated", "rows" and
     "tiles" (1x1), each a warm-up step and 65 timed steps with the
     counters set to 0 just before: one launch per step of the
     decomposition's form (pack16-ring, -band, -tile) and no other, every
     step writes, merges > 0, all agents online, no band escape, finite
     poses; steps/s, peak memory and a 17-step split on the device
     timeline (sensing, raster, merge, zones, collectives, rest); one
     more step's raster inputs through the kernel and its plain version at
     the path's window and on the whole grid (bit-equal; the cells the
     float shift moves counted, ROADMAP C22); "rows" BIT-EQUAL to
     "replicated" (maps, writes, poses), "tiles" compared with it (poses
     equal, decisions within 1e-4 of the explored cells, applied cells
     within 1e-5); then every
     other band and tile form through the sharded body's bench.py flag rows
     (BAND_ROWS), 17 steps each;
 15. parallel/dryrun.py at world size 1 on the card, as its own process;
 16. every raster mode of the fused engine, which no raster kernel serves
     (the XLA beam tier, the line and parity rasters are torch code): the
     untiled world's bench.py rows at 1024 agents (presets.untiled on
     3840^2: --raster line, --no-pallas, --no-pallas --grid-dtype
     bfloat16), each a warm-up step, the counters set to 0, 65 steps
     (merges at 15, 31, 47, 63), the counters read: no raster kernel
     launched, every step writes, merges at every event, all agents
     online, poses finite; steps/s, applied cells/s, peak memory, the
     ordered add's deepest layer, a 17-step split;
 17. the profiling mode (raster_mode="off") on the same world, 17 steps:
     writes 0, grid and log-odds bit-unchanged; each row's raster share;
 18. the parity path: presets.dual_bot() for 200 steps (FREE > 500,
     OCCUPIED > 20 cells, both agents online, closures printed), the
     untiled world in parity mode without a sweep at 1024 agents for 33
     steps and a 17-step split (the sequential closure's time); the swarm
     preset (run_session --preset swarm) at 64 agents for 201 steps;
 19. the yaw-rate bias (merge_bias_alpha=0.1) on presets.deployable(1024)
     for 33 steps: the estimate finite, nonzero for some agent;
 20. card against CPU on the same inputs at the untiled world's
     1024-agent shapes: parity_raster, the line raster and the ordered add
     of the XLA tier's own deltas BIT-EQUAL (NaN payloads aside), the XLA
     tier decision-equal on both fans and grid dtypes, the line raster and
     the XLA tier run twice bit-identical;
 21. card against CPU at 8 agents (phase 11's bar) on the line raster, the
     XLA tier (f32, bf16), the parity mode (untiled, dual_bot), the
     profiling mode and the bias;
 22. offline SLAM: tools/bench_accuracy.py's path through the port's
     counterpart (swarm_tpu_torch.accuracy) at the tool's width, 64 agents
     on its 1024^2 world, 500 steps (the tool's 2000 cut to fit the time
     limit; 2 chunks of 250). First the window kernel's pack16 (the
     181-beam sweep) and pack16-wrapped (the 4-way fan) forms at that
     world's shapes, held bit-equal to their plain versions as in phase 2
     and timed. Then the four online variants (raw, ref_closures,
     merge_anchored, ref_closures+merge) with the kernel launch counters
     set to 0 just before and read just after (both fans through those
     two forms once per step each, the room kernel never), then every
     offline tier (refined, joint, calibrated, calibrated_robust,
     calibrated_reloc and the six GN tiers); per tier ATE mean and late,
     wall IoU and p90, closures, merges, measured and cross edges;
     steps/s per variant and the seconds of each offline tier. It
     requires measured closure edges (cl_fit >= 0) in raw and
     merge_anchored, a verified cross edge, every tier finite. The raw
     session's graphs (refined: per-agent chains of 500 nodes with their
     closures, the structured solver; joint: with the cross edges) are
     then solved again on the CPU from the same logs: positions within
     1e-3 m and yaws within 1e-3 rad (as angles) of the card's. Then 64
     more steps of the raw variant on the device timeline: the
     closure's and the matcher's share of the step. Last, the card
     against the CPU at 4 agents over 24 steps on the same noise (the
     accuracy module draws it on the CPU), every variant and tier built
     with the rendezvous radius widened to 6.5 m (the pair matcher runs) and
     the fitness gate at 0.3 (some pairs verify, online and offline
     alike): in raw and merge_anchored, closure nodes and agents exact,
     at least one measured edge, measurements and fitness within 1e-4;
     at least one verified cross edge in the joint tier and one merge fix
     in the anchored tier; the refined, joint, anchored_gn and
     anchored_joint poses within 1e-3 (m, rad);
 23. the mapping server's replay (engine/replay.py; run_session's scripted
     sequence without the PNG render): generate_dual_session(seed=42) with
     its sensor casts on the card (held against the CPU's: the scripted
     arrays exact, dist4 within 1e-5 m, landmark and v2v flips counted),
     write_session / load_session through a temporary directory,
     packet_stream_from_telemetry, replay_session (the closed form: one
     host read per closure window): closures, corrected poses and writes
     equal to the same functions' CPU run, the grid bit-equal to it (or
     differing only in cells that rays traced apart by an ulp of cos or
     sin touch, ROADMAP C26, counted) and bit-equal to the port's native
     oracle (`update_ray` on the same corrected rays in order); packets/s
     and the closure windows; refine_session (poses within 1e-3 of the
     CPU's) and reraster_session (its grid against the CPU's as above);
     then tools/bench_serve.py's swarm (64 agents, its packet ring for
     20,480 packets) replayed as it is and with landmarks drawn from the
     dual session's (ids 2 and 5 on 19.6% of the packets): packets/s,
     closure windows, and each against a CPU replay of the same stream as
     above (closures, closed flags, grid); then each with closure
     windows of 64 to 4096 packets in place of replay.WINDOW (256), every
     result unchanged;
 24. serving: ingest_frame at 1024 agents, 64 frames of 2048 packets
     (tools/bench_serve.py's --max-packets) packed by the port's
     pack_quasar_v2_batch (the wire's agent byte carries (a % 255) + 1,
     the agent index rides beside it; landmarks drawn from the dual
     session's) and parsed by its native
     parse_telemetry_buffer: frames/s and packets/s of the ingest, of the
     codec on the host and of both with the copies; the grid against a
     CPU run of the same frames as in phase 23, closures equal, all 1024
     agents online, every packet counted;
 25. the pose-graph solvers on a one-rank NCCL group (parallel/solve.py;
     BASELINE.json configs[4]): make_sharded_solver over 1024 graphs of
     64 nodes, dense and structured, batched against one graph after
     another on the first 16 (poses within 1e-4) and against the CPU's
     batch on all 1024 (1e-3, yaws as angles; ROADMAP C31), the summed
     final cost from the all-reduce; make_trajectory_sharded_gn on a
     4096-node chain against structured_gn (1e-3), its cost falling
     below a fifth;
 26. the live server's real loop on loopback (server/live.py through
     swarm_tpu_torch.bench_serve: its 4096-packet ring from the native
     sendmmsg blaster, burst 64, 500 us apart; the recvmmsg drain, the
     native codec, the throughput ingest on the card, fps uncapped,
     frames of up to 2048 packets) at 64 and at 255 agents (the wire's
     most), LIVE_SECONDS each: packets/s, frames, applied/offered; every
     applied frame's columns and stamp recorded and applied again by a
     CPU server: closures equal, the grid bit-equal or differing only in
     cells of rays traced apart (as in phase 23), every agent heard;
 27. the parity ingest: the dual session's 698 datagrams over loopback,
     20 to a frame (the reference's budget), drained with the native
     codec and applied packet by packet on the card, each frame stamped
     with its last packet's time; the frames again on the CPU, as in 26;
 28. run_session in its three presets into a temporary directory:
     dual_bot (200 steps) and swarm (64 agents, 100 steps) on the card,
     dual_bot_scripted on the card and on the CPU (session files equal,
     metrics equal but for the timing); each map.png (the standard-
     library PNG writer) read back by the script's own reader;
 29. checkpoint / resume through run_session: 100 steps with
     --checkpoint, 100 with --resume, every leaf bit-equal to phase 28's
     200 straight steps (the noise generator's state rides in the
     checkpoint). Phases 23-29 launch no raster kernel (the counters set
     to 0 before each and read after);
 30. the sharded engine's XLA fast tier (presets.deployable(1024) with
     use_pallas=False: free_raster_reference per fan on a fresh window
     plus the exact endpoint delta) on a one-rank NCCL group in
     "replicated", "rows" and "tiles": the counters set to 0, one warm-up
     step and 33 timed steps, the counters read: no raster kernel
     launched, every step writes, merges at steps 15 and 31 and at no
     other, all agents online, no band escape, poses finite; steps/s,
     peak memory, a 17-step split (sensing, raster, merge, zones,
     collectives, rest); "rows" and "tiles" BIT-EQUAL to "replicated"
     (maps, writes, poses); then the window kernel without the ring
     (exact_endpoints=True) on the same world, seed and steps: the writes
     ratio within (0.9, 1.1) and tri-state decisions differing in at most
     1% of the explored cells, the raster part of both steps printed;
 31. the line scatter (raster_mode="line": the 4-way rays, then the
     sweep's, through logodds_delta's ordered sum) in the three
     decompositions, one warm-up and 16 timed steps (a merge at step 15),
     the same checks, "rows" and "tiles" BIT-EQUAL to "replicated" and
     "replicated" run twice BIT-IDENTICAL; then `python -m
     swarm_tpu_torch.bench_sharded --agents 1024 --steps 20` (the swarm
     preset on world 1) as its own process, which must exit 0;
 32. card against CPU at 8 agents over 34 steps (phase 11's bar): the XLA
     tier on "replicated" and "tiles" and the line scatter on
     "replicated", NCCL against gloo on the same noise; then
     parallel/dryrun.py at world size 1 on the card with its sections for
     the swarm preset, the XLA tier and the line scatter in each
     decomposition and the XLA tier against the kernel without the ring.
     Phases 30-32 launch no raster kernel on their main paths;
 33. the firmware-faithful per-robot API (models/, geom/, slam/closure) at
     1024 robots on presets.deployable's tiled rooms for 100 ticks of
     0.05 s, every input made on the host: sense_4way_median3 against each
     robot's room (three pings, their median, the 4.0 m sentinel),
     cast_rays_grouped BIT-EQUAL to sense_true's cast (closed rooms),
     detect_landmark_fw, cmd_vel_drive, firmware_odometry_step and the
     EKF's ekf_predict / ekf_update on [1024, 6] states; then 512
     packets (64 robots at 8 ticks) through closure_add_pose one by one,
     BIT-EQUAL to closure_add_poses_seq batch by batch in every field and
     decision; all of it again on the CPU from the same draws: PWM,
     closure decisions and integers equal, landmark codes equal but where
     a reading lies within 1e-5 of a threshold, floats within 1e-5 (the
     EKF's yaw as an angle), the sentinel exact; the card's time a tick
     and a packet;
 34. the pose-graph solvers summed in a fixed order (ROADMAP C43): each
     assembly site on a pile-up graph (256 nodes, 28 of 32 closures and 6
     of 16 unary factors on one node) from the CPU's addends, the
     former scatter-add form twice on the card (bits apart between runs
     and against the CPU, reported: the finding per site) and the plans'
     form (BIT-EQUAL to the CPU and between runs); then phase 25's 1024
     graphs (dense and structured batches) and the pile-up graph (dense
     and structured, with the unary factors) solved twice on the card:
     the runs BIT-IDENTICAL, the card within 1e-3 of the CPU (yaws as
     angles), final costs within rtol 1e-3. Phases 33-34 launch no raster
     kernel;
 35. bench.py on the port, `python -m swarm_tpu_torch.bench` at its
     defaults (1024 agents, a warm chunk and 2 timed chunks of 200 steps,
     the reconciliation's 131 steps, the merge probe), called in this
     process through its `main` with the counters set to 0 just before
     and read just after: pack8-ring launched once a step and the room
     kernel never, the fresh ratio above 0.6, merges, a finite merge
     event; then `--room-kernel --steps 50 --chunks 1`: pack16-ring of
     the room kernel once a step and the window kernel never;
 36. `bench_coverage --agents 64 --steps 300 --chunk 100` (the coverage
     tool's own configuration, 64 agents on 1024^2): both variants'
     coverage > 0, pack16 and pack16-wrapped once a step each;
 37. `bench_merge --inner 16`: three finite times; the 1024-node graph
     solved dense and structured on the card and on the CPU: poses within
     1e-3 (dense) and 5e-3 (structured: float32 sets this graph's solve
     to ~1e-3, ROADMAP C44), yaws as angles, final costs within rtol 1e-3;
 38. `profile_step --agents 1024 --inner 16 --reps 1`: all 18 rows timed
     on the device and on the host, the step split's rest >= 0, the
     counted steps' launches (the window kernel once a step);
 39. `roofline`: csrc/fp32_probe.cu BIT-EQUAL to its torch chain, the
     deployable window kernel's share of its bound in (0, 1.05];
 40. `quality_onchip --steps 300 --turbo`: IoU and wall p90 of the pack16,
     pack8 and grouped tiers against the exact tier;
 41. `proto_phase_quality`: the static and phase-rotated rows. Each
     tool prints its own lines and JSON, and its seconds;
 42. donation at the engines' boundary, the launch counters set to 0
     just before and read just after: on presets.deployable(1024) (the
     window path, pack8-ring) and with room_kernel=True (pack16-ring),
     17 steps of make_sim_step(donate=False) and of donate=True from
     clones of one state on the same noise, (a) states (grids, poses, the
     closure ring) and StepMetrics BIT-IDENTICAL after every step, (b)
     every state passed to the donate=False step unchanged in every byte
     against a clone taken before; (c) two sim_rollouts of 17 steps from
     one state object BIT-IDENTICAL, the state unchanged; (d) the sharded
     step on a one-rank NCCL group in "replicated" and "tiles", (a) and
     (b), and the unsharded state handed to shard_state unchanged; the
     extra peak memory of a donate=False step against a donated one and
     of sim_rollout against the donated steps; at the slice
     (presets.deployable(32768, grid_dtype="bfloat16")) the peak of a
     one-step sim_rollout beyond one donated step's and the time of its
     copy of the grid; every launch of the phase checked (each step its
     form once) and added to its form's record;
 43. the fault-injection path (the reference's stuck-bot fault and
     heartbeat failover) and frames that lack agents, under a kill
     schedule (agent 0 dead at steps 2-14, 63 others at steps 2-16: past
     the 5 s timeout, across the merge step 15, all back by step 17):
     FAULT_STEPS steps at 1024 agents of the window path (pack8-ring), the
     room path (pack16-ring), the exploration path (presets.coverage with
     targets, pack16 and pack16-wrapped, frontier steps 8 and 16) and the
     sharded step on a one-rank NCCL group ("replicated", pack16-ring, and
     "tiles", pack16-ring-tile), the counters set to 0 just before each
     and read just after: each form once a step; the online count falls
     by the killed agents after the timeout and is whole again at the
     end; dead agents' reported poses stay put and they paint nothing;
     "tiles" equal to "replicated" at the decision bars (ROADMAP C22). At
     8 agents, both fused paths on the card and on the CPU from one state
     and noise under the same schedule: every step's writes, closures,
     merges and online count equal, 0 tri-state cells apart.
     `ingest_frame` at 1024 agents on FAULT_FRAMES frames 0.4 s apart,
     each missing ~10% of the agents and the killed block missing from
     frames 1-15: card = CPU (grid, closure log, per-row flags and
     corrections, counts, online), the block offline after the timeout
     and back. The room kernel on a layout whose rooms overflow the tile
     grid (ROADMAP C11) bit-equal to its plain version. The launches of
     the 1024-agent runs add to their forms' records.
The line before the last two is the per-kernel JSON record (one entry per
kernel form, `free_raster[<form>]` / `room_raster[<form>]` /
`exact_raster[<fan>]`; pack16 and pack16-wrapped at 64 agents on 1024^2,
the accuracy path's and bench_coverage's shapes, are the records
`free_raster[pack16-64-agents]` and `[pack16-wrapped-64-agents]`), then
the card's name and power limit; the last line is {"ok": true, "device":
{...}}. A record's `launches` counts the launches of the paths at its
shapes: the window path's pack8-ring and the room path's pack16-ring add
phase 35's, 42's and 43's, pack16-ring and pack16-ring-tile add phase 42's
and 43's, pack8-ring-bf16 phase 42's, pack16 and pack16-wrapped (1024
agents) phase 43's. The line before the records gives the
run's seconds.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

from swarm_tpu_torch.bench_coverage import reachable_mask
from swarm_tpu_torch.profile_step import median as _median
from swarm_tpu_torch.profile_step import sharded_parts as _sharded_parts
from swarm_tpu_torch.profile_step import step_split as _step_split
from swarm_tpu_torch.roofline import bound as _bound
from swarm_tpu_torch.roofline import box_cells as _box_cells
from swarm_tpu_torch.roofline import card as _card
from swarm_tpu_torch.roofline import covered_cells as _covered_cells
from swarm_tpu_torch.roofline import device_ms, needed_bytes

N_AGENTS = 1024
SLICE_AGENTS = 32768         # bench.py --agents 32768 --grid-dtype bfloat16
SLICE_STEPS = 65             # bench.py's 400 steps, cut to fit the limit
SPLIT_STEPS = 17             # the slice's step split (one merge step)
PLAIN_CHUNK = 1024           # the plain raster at the slice's size, per call
FLAG_STEPS = 17              # one merge event (step 15)
BF16_CMP_STEPS = 33
TIMED_STEPS = 200
REF_AGENTS = 8
REF_STEPS = 34
EXPLORE_REF_STEPS = 17       # three frontier events (steps 0, 8, 16)
COVERAGE_AGENTS = 64         # tools/bench_coverage.py's default
ULTRASONIC_STEPS = 101
ENTRY_STEPS = 17             # three frontier events (steps 0, 8, 16)
SEED = 0
# operations per cell evaluation of either raster kernel, counted from
# csrc/raster_common.cuh `polar` (~50: the radius, the atan2 polynomial,
# the bin, the crossing count) plus the table lookup, the carve, the ring,
# the painted count and the clipped apply (~30)
OPS_PER_CELL = 80
# the exact raster (csrc/exact_raster.cu): the radius and the atan2
# polynomial (~30), the floor-mod wrap and the beam bin (~10), the sine
# (~20), the on-beam, near, free and hit tests, the select and the clipped
# apply (~30)
OPS_PER_CELL_EXACT = 90
GROUPED_STEPS = TIMED_STEPS                  # the grouped paths' timed steps
EXACT_FRAMES = 17            # sensed frames through the exact raster's entry


def _median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _ab_ms(first, second, reps_first: int, reps_second: int):
    """Medians of two functions timed in turns first, second, second,
    first; returns (min of first's, min of second's, all four)."""
    first(), second()
    a1 = _median_ms(first, reps_first)
    b1 = _median_ms(second, reps_second)
    b2 = _median_ms(second, reps_second)
    a2 = _median_ms(first, reps_first)
    return min(a1, a2), min(b1, b2), (a1, b1, b2, a2)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _changed_cells(launch, g) -> int:
    """The cells whose bits one call of `launch` changes on the grid `g`
    as it is now; `g` is restored after."""
    g0 = g.clone()
    launch()
    torch.cuda.synchronize()
    n = _n_differ(g, g0)
    g.copy_(g0)
    return n


def _bounds(elem: int, covered: int, changed: int, operand_bytes: int,
            ops_per_cell: int, evaluated: int):
    """The record's bounds for a raster on this run's inputs. `bound_ms`:
    the work the function needs, the covered cells (the union of the
    windows) read once, the cells whose bits it changes written once and
    evaluated, the operands read and the counts written once.
    `covered_bound_ms`: the records' earlier bound, kept for comparison:
    every covered cell read and written once, every cell of the fan-bbox
    strips (`evaluated`) evaluated. Returns (the bounds, the needed
    bytes)."""
    n_bytes = needed_bytes(elem, covered, changed, operand_bytes)
    bound, bound_by = _bound(n_bytes, changed * ops_per_cell)
    covered_bound = _bound(2 * elem * covered + operand_bytes,
                           evaluated * ops_per_cell)[0]
    return dict(bound_ms=bound, bound_by=bound_by,
                covered_bound_ms=covered_bound), n_bytes


def _timed(worst, t_kernel, t_plain, runs, t_wrapper, t_device, bounds,
           n_bytes, changed):
    """A timed raster form's record and the timing part of its line. `ms`
    is the launch call on prepared operands (CUDA events, median of 20:
    host gap, the wrapper's fill and sum, the kernel; the records' measure
    from the first kernel on), `device_ms` the kernel alone
    (`roofline.device_ms`)."""
    text = (f"launch call {t_kernel:.4f} ms (runs {runs[0]:.4f}, "
            f"{runs[3]:.4f}), kernel alone {t_device:.4f} ms (profiler), "
            f"wrapper with its preparation {t_wrapper:.4f} ms, plain torch "
            f"{t_plain:.4f} ms (runs {runs[1]:.4f}, {runs[2]:.4f}); bound "
            f"{bounds['bound_ms']:.4f} ms by {bounds['bound_by']} "
            f"({n_bytes} bytes: the covered cells read, {changed} changed "
            f"cells written), the covered bound "
            f"{bounds['covered_bound_ms']:.4f} ms")
    return text, dict(max_abs_err=worst, ms=t_kernel, device_ms=t_device,
                      plain_ms=t_plain, **bounds)


def phase_build():
    from swarm_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build_all(["free_raster", "room_raster", "fp32_probe",
                                  "exact_raster"])
    for name, (lib, secs) in built.items():
        print(f"kernel build [{name}]: {secs:.2f} s ({os.path.relpath(lib)};"
              f" ptxas: {cuda_build.ptxas.get(name, 'built before')})")
    print(f"kernel builds, together: {time.perf_counter() - t0:.2f} s")
    _print_instances()


def _print_instances():
    """Per instance of the window, room and exact-raster kernels: ptxas's
    registers and spilled bytes, and the resident blocks per SM that CUDA's
    occupancy calculator gives (128-thread window and exact-raster blocks,
    512-thread room blocks)."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops import cuda_build
    from swarm_tpu_torch.ops import exact_raster_cuda as er
    from swarm_tpu_torch.ops import room_raster_cuda as rc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec

    reports = {label: (regs, spill)
               for name in ("free_raster", "room_raster", "exact_raster")
               for label, regs, spill in
               cuda_build.ptxas_instances.get(name, [])}
    rows = []
    for t, kind in enumerate(("pack8", "pack16", "grouped")):
        for ring in (True, False):
            for dtype, tag in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16")):
                rows.append((f"free_raster_kernel<{t},{int(ring)},{tag}>",
                             bc.form_name(BeamSpec.scan(), kind == "pack8",
                                          ring, dtype, kind == "grouped"),
                             bc.blocks_per_sm(kind, ring, dtype)))
    for grouped in (False, True):
        for ring in (True, False):
            rows.append((f"room_raster_kernel<{int(grouped)},{int(ring)}>",
                         "room " + rc.form_name(BeamSpec.scan(), ring,
                                                grouped),
                         rc.blocks_per_sm(grouped, ring)))
    rows.append(("exact_raster_kernel", "exact scan, wrapped",
                 er.blocks_per_sm()))
    for label, form, blocks in rows:
        regs, spill = reports.get(label, ("built before", "-"))
        print(f"kernel instance {label} ({form}): {regs} registers, "
              f"{spill} bytes spilled, {blocks} blocks per SM")


def _raster_inputs(cfg, params, rooms, gen, dev, four_way=False):
    """Main-path raster inputs: preset start poses, random headings, noisy
    readings against each agent's room (the 181-beam sweep, or the 4-way
    ultrasonics)."""
    from swarm_tpu_torch.models.scan import sense_scan
    from swarm_tpu_torch.models.sensors import draw_sensor_noise, sense_4way
    from swarm_tpu_torch.ops.beam_raster import beams_from_scan

    n, r = cfg.n_agents, cfg.engine.scan_rays
    yaw = (torch.rand((n,), generator=gen, device=dev) * 2 - 1) * torch.pi
    pose = torch.stack([params.home_x, params.home_y, yaw], -1)
    walls_agent = rooms[0][rooms[1].long()]
    if four_way:
        dist = sense_4way(draw_sensor_noise(gen, (n, 4), dev), pose,
                          walls_agent, cfg.sensors)
    else:
        dist = sense_scan(draw_sensor_noise(gen, (n, r), dev), pose,
                          walls_agent, r, cfg.sensors)
    # beams_from_4way is the same function
    db, tb = beams_from_scan(dist, cfg.sensors.max_range,
                             cfg.sensors.min_range)
    return pose[:, :2].contiguous(), yaw, db, tb


def _prefilled(size, gen, dev, dtype=torch.float32):
    levels = torch.tensor([-9.9, 9.7, -9.6, 9.95], device=dev)
    return levels[torch.randint(0, 4, (size, size), generator=gen,
                                device=dev)].to(dtype)


def _dirty(size, gen, dev):
    """A grid that leaves no tile clean: values beyond +-clamp, -0.0 cells
    and values within, so that every window cell takes its clip."""
    levels = torch.tensor([-12.5, 11.0, -0.0, 9.7, -3.2, 0.0], device=dev)
    return levels[torch.randint(0, 6, (size, size), generator=gen,
                                device=dev)]


def _with_nan(grid, gen):
    """`grid` with 1% of its cells NaN and 1% -0.0: the clip after each
    agent keeps both, as the reference's jnp.clip does."""
    u = torch.rand(grid.shape, generator=gen, device=grid.device)
    grid = grid.masked_fill(u < 0.01, float("nan"))
    return grid.masked_fill((u >= 0.01) & (u < 0.02), -0.0)


# bench.py's single-chip raster flags beyond the paths with a phase of
# their own (presets.deployable's arguments), each launching one form of
# one kernel once per step (`_form_of`)
WINDOW_ROWS = [
    dict(pack8=False), dict(exact_endpoints=True),
    dict(scan_rays=0, pack8=False), dict(scan_rays=0, exact_endpoints=True),
    dict(grid_dtype="bfloat16", exact_endpoints=True),
    dict(grid_dtype="bfloat16", scan_rays=0),
    dict(grid_dtype="bfloat16", pack8=False),
    dict(grid_dtype="bfloat16", pack8=False, exact_endpoints=True),
    dict(grid_dtype="bfloat16", scan_rays=0, pack8=False),
    dict(grid_dtype="bfloat16", scan_rays=0, pack8=False,
         exact_endpoints=True),
    dict(grid_dtype="bfloat16", scan_rays=0, exact_endpoints=True)]
ROOM_ROWS = [
    dict(room_kernel=True, exact_endpoints=True),
    dict(room_kernel=True, scan_rays=0),
    dict(room_kernel=True, scan_rays=0, exact_endpoints=True)]
SLICE = dict(grid_dtype="bfloat16")
# the grouped tier (bench.py --beam-groups N): GROUPED is the grouped path
# (bench.py --beam-groups 8, grouped-ring); the rows below launch the other
# grouped forms. The 4-way fan is grouped only in fewer than 4 groups: in 2
# groups of 2 beams. C1_ROW is 181 beams in 16 groups (ROADMAP C1), the
# path's form again: held and run, not recorded.
GROUPED = dict(beam_groups=8)
GROUPED_WINDOW_ROWS = [
    dict(beam_groups=8, exact_endpoints=True),
    dict(beam_groups=8, grid_dtype="bfloat16"),
    dict(beam_groups=8, grid_dtype="bfloat16", exact_endpoints=True),
    dict(beam_groups=2, scan_rays=0),
    dict(beam_groups=2, scan_rays=0, exact_endpoints=True),
    dict(beam_groups=2, scan_rays=0, grid_dtype="bfloat16"),
    dict(beam_groups=2, scan_rays=0, grid_dtype="bfloat16",
         exact_endpoints=True)]
C1_ROW = dict(beam_groups=16)
GROUPED_ROOM_ROWS = [
    dict(room_kernel=True, beam_groups=8, exact_endpoints=True),
    dict(room_kernel=True, beam_groups=2, scan_rays=0),
    dict(room_kernel=True, beam_groups=2, scan_rays=0, exact_endpoints=True)]


def _flags(flags) -> str:
    """bench.py's command-line flags for presets.deployable's arguments."""
    words = {"pack8": "--no-pack8", "exact_endpoints": "--exact-endpoints",
             "room_kernel": "--room-kernel"}
    out = [words[k] for k in ("room_kernel", "pack8", "exact_endpoints")
           if k in flags]
    if "scan_rays" in flags:
        out.append(f"--scan-rays {flags['scan_rays']}")
    if "grid_dtype" in flags:
        out.append(f"--grid-dtype {flags['grid_dtype']}")
    if "beam_groups" in flags:
        out.append(f"--beam-groups {flags['beam_groups']}")
    return " ".join(out)


def _form_of(flags):
    """(four_way, pack8, ring, dtype, n_groups, form key) of the raster form
    a bench.py flag row launches: the room kernel's key from
    room_raster_cuda.form_name, the window kernel's from
    beam_raster_cuda.form_name. n_groups is None per beam, as the engine
    picks the tier (groups below the fan's beams: grouped)."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops import room_raster_cuda as rc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec

    four_way = flags.get("scan_rays", 181) == 0
    pack8 = flags.get("pack8", True)
    ring = not flags.get("exact_endpoints", False)
    dtype = (torch.bfloat16 if flags.get("grid_dtype") == "bfloat16"
             else torch.float32)
    spec = BeamSpec.four_way() if four_way else BeamSpec.scan()
    groups = flags.get("beam_groups", 0)
    grouped = 0 < groups < spec.n_beams
    n_groups = groups if grouped else None
    key = (rc.form_name(spec, ring, grouped) if flags.get("room_kernel")
           else bc.form_name(spec, pack8, ring, dtype, grouped))
    return four_way, pack8, ring, dtype, n_groups, key


def _n_differ(a, b) -> int:
    """Cells whose bits differ (a -0.0 against a +0.0 counts; a NaN against
    a NaN, whatever its payload, does not)."""
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return int(((a.view(bits) != b.view(bits)) &
                ~(torch.isnan(a) & torch.isnan(b))).sum())


def _max_abs_diff(a, b) -> float:
    """The largest |a - b| over the cells where neither is NaN."""
    d = (a.float() - b.float()).abs()
    return float(torch.where(torch.isnan(d), torch.zeros_like(d), d).max())


def _room_box_cells(rm, spec) -> int:
    """The cells the room kernel evaluates: per slot (an empty one too) its
    evaluation box within its window."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops import room_raster_cuda as rc

    br_n, bc_n = rm.meta.shape[:2]
    m = rm.meta.reshape(-1, rc.META)
    r_lo, r_hi, c_lo, c_hi = bc.evaluation_box(
        rm.table.reshape(m.shape[0], -1), rm.kind, rm.ring, m[:, 0], m[:, 1],
        m[:, 2], spec, rm.n_bins)
    dev = m.device
    tr = torch.arange(br_n, device=dev).repeat_interleave(
        bc_n * rc.AGENTS_PER_ROOM).to(torch.float32)
    tc = torch.arange(bc_n, device=dev).repeat_interleave(
        rc.AGENTS_PER_ROOM).repeat(br_n).to(torch.float32)
    row0 = tr * rc.TILE_ROWS + m[:, 4]
    rows = torch.minimum(r_hi, row0 + rm.win_rows) - torch.maximum(r_lo, row0)
    cols = torch.minimum(c_hi, tc * rc.TILE_COLS + rc.TILE_COLS) - \
        torch.maximum(c_lo, tc * rc.TILE_COLS)
    return int((rows.clamp_min(0).double() *
                cols.clamp_min(0).double()).sum())


def _hold_equal(name, kernel, plain, cases, size):
    """Run kernel and plain version on each case's copy of the grid; maps
    bit-equal (NaN cells NaN on both sides), counts equal (both sum them
    exactly, in double: the grouped tier's fractional counts too). Returns
    the largest |difference| (0.0)."""
    worst = 0.0
    for case, (grid0, args) in cases.items():
        g_k, g_p = grid0.clone(), grid0.clone()
        _, c_k = kernel(g_k, *args)
        torch.cuda.synchronize()
        _, c_p = plain(g_p, *args)
        torch.cuda.synchronize()
        n_diff = _n_differ(g_k, g_p)
        err = _max_abs_diff(g_k, g_p)
        worst = max(worst, err)
        print(f"{name} kernel vs plain [{case}]: {n_diff} of {size * size} "
              f"cells differ (max |diff| {err}), "
              f"{_n_differ(g_k, grid0)} cells changed, "
              f"{int(torch.isnan(g_k).sum())} NaN cells, counts sum "
              f"{float(c_k.sum())} vs {float(c_p.sum())}")
        if n_diff:
            raise AssertionError(f"{name}: kernel and plain maps differ in "
                                 f"{n_diff} cells [{case}]")
        if not torch.equal(c_k, c_p):
            raise AssertionError(f"{name}: counts differ [{case}]")
        if float(c_k.sum()) <= 0:
            raise AssertionError(f"{name}: nothing painted [{case}]")
    return worst


def _plain_in_chunks(plain):
    """The plain raster over agent chunks of PLAIN_CHUNK, in index order:
    each agent's window is applied after the previous agent's whatever
    the chunking, so this is the same function at a fraction of the
    memory (the slice's [32768, 80, 256] float32 deltas would be 2.7 GB
    per temporary)."""
    def run(g, xy, yaw, db, alive, tr, *rest):
        counts = []
        for i in range(0, xy.shape[0], PLAIN_CHUNK):
            j = slice(i, i + PLAIN_CHUNK)
            counts.append(plain(g, xy[j], yaw[j], db[j], alive[j],
                                None if tr is None else tr[j], *rest)[1])
        return g, torch.cat(counts)
    return run


def _window_form(card, dev, name, cfg, params, rooms, seed, four_way,
                 pack8, ring, n_groups=None):
    """One form of the window kernel at a path's shapes (the grid's dtype
    from `cfg`; `n_groups` below the fan's beams: the grouped tier with the
    engine's tail weight): held bit-equal to its plain version at the
    path's swarm size, in an overlap case (64 agents around one point on
    a grid pre-filled near +-clamp) and in a NaN case (the same agents, 1%
    NaN and 1% -0.0 cells), then timed: the launch on prepared
    operands, the wrapper with its preparation, the plain version (in agent
    chunks above PLAIN_CHUNK agents); the bound from this run's inputs.
    Returns (the form's launch-count key, its record)."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec, reach_cells

    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = (BeamSpec.four_way() if four_way
            else BeamSpec.scan(cfg.engine.scan_rays))
    reach = reach_cells(cfg)
    size = cfg.grid.size
    dtype = cfg.grid.lo_dtype
    n = cfg.n_agents
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    xy, yaw, db, tb = _raster_inputs(cfg, params, rooms, gen, dev, four_way)
    tr = tb if ring else None
    grouped = bc.table_kind(spec, pack8, n_groups) == "grouped"
    tier = (dict(n_groups=n_groups, tail_weight=cfg.engine.beam_tail_weight)
            if grouped else {})

    def kernel(g, *a):
        return bc.free_raster(g, *a, pack8=pack8, **tier)

    def plain_one(g, *a):
        return bc.free_raster_plain(g, *a, pack8=pack8, **tier)

    plain = _plain_in_chunks(plain_one) if n > PLAIN_CHUNK else plain_one
    # overlap case: 64 agents within +-4 cells of one point
    k = min(64, n)
    xy_o = xy[:1] + 0.2 + (torch.rand((k, 2), generator=gen, device=dev)
                           - 0.5) * 0.4
    cases = {
        "main": (torch.zeros((size, size), device=dev, dtype=dtype),
                 (xy, yaw, db, alive, tr, spec, cfg.grid, reach)),
        "overlap": (_prefilled(size, gen, dev, dtype),
                    (xy_o, yaw[:k], db[:k], alive[:k],
                     None if tr is None else tr[:k], spec, cfg.grid,
                     reach)),
    }
    cases["nan"] = (_with_nan(_prefilled(size, gen, dev), gen).to(dtype),
                    cases["overlap"][1])
    worst = _hold_equal(name, kernel, plain, cases, size)
    del cases

    g_t = torch.zeros((size, size), device=dev, dtype=dtype)
    w = bc._windows(g_t, xy, yaw, db, alive, spec, cfg.grid, tr, reach,
                    pack8, **tier)
    ln = bc._prepare(g_t, w, spec)
    dense = bc._dense_fan(spec, reach)

    def launch():
        bc._launch(g_t, ln, spec, cfg.grid, dense)

    changed = _changed_cells(launch, g_t)
    t_kernel, t_plain, runs = _ab_ms(
        launch,
        lambda: plain(g_t, xy, yaw, db, alive, tr, spec, cfg.grid, reach),
        20, 3 if n <= PLAIN_CHUNK else 1)
    t_wrapper = _median_ms(lambda: kernel(
        g_t, xy, yaw, db, alive, tr, spec, cfg.grid, reach), 20)
    t_device = device_ms(launch, 20, "free_raster_kernel")

    # bounds: over the union of the windows; the operands read once, the
    # counts written once; the covered bound evaluates every cell of the
    # fan-bbox strips
    evaluated = int(((w.t_ch - w.t_cl).clamp_min(0) * w.rows * 128).sum())
    bounds, n_bytes = _bounds(
        g_t.element_size(), _covered_cells(w, size, dev), changed,
        _nbytes(ln.origins, ln.meta, ln.table) + 4 * n, OPS_PER_CELL,
        evaluated)
    text, rec = _timed(worst, t_kernel, t_plain, runs, t_wrapper, t_device,
                       bounds, n_bytes, changed)
    form = bc.form_name(spec, pack8, ring, dtype, grouped)
    groups = f" in {w.n_bins} groups" if grouped else ""
    print(f"{name} raster at {n} agents x {spec.n_beams} beams{groups} "
          f"({form}, [{w.rows}, {w.cols}] windows) on {size}^2 [{card}]: "
          f"{text}; the kernel evaluates {_box_cells(w, spec)} cells (its "
          f"boxes; the covered bound counts {evaluated})")
    return form, rec


def phase_window_kernel(card, dev):
    """The deployable form (pack8 + ring, the 181-beam scan)."""
    from swarm_tpu_torch import presets

    cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev)
    return dict([_window_form(card, dev, "window", cfg, params, rooms, SEED,
                              four_way=False, pack8=True, ring=True)])


def phase_form_kernels(card, dev):
    """The exploration path's forms (pack16 without the ring on the scan
    and on the wrapped 4-way fan, in the coverage world) and the
    ultrasonic-only path's (pack8 + ring on the wrapped fan)."""
    from swarm_tpu_torch import presets

    cfg, _, params, rooms = presets.coverage(N_AGENTS, device=dev)
    out = dict([_window_form(card, dev, "window pack16 scan", cfg, params,
                             rooms, SEED + 3, four_way=False, pack8=False,
                             ring=False),
                _window_form(card, dev, "window pack16 4-way", cfg, params,
                             rooms, SEED + 4, four_way=True, pack8=False,
                             ring=False)])
    cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                               scan_rays=0)
    out.update([_window_form(card, dev, "window pack8 4-way", cfg, params,
                             rooms, SEED + 5, four_way=True, pack8=True,
                             ring=True)])
    # every other instance (table x ring x fan x storage), each in the
    # world of the bench.py flags that launch it; the slice's own
    # (pack8-ring-bf16) here at 1024 agents too
    for i, flags in enumerate(WINDOW_ROWS + [SLICE]):
        cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                                   **flags)
        four_way, pack8, ring, _, _, key = _form_of(flags)
        out.update([_window_form(card, dev, f"window {key}", cfg, params,
                                 rooms, SEED + 7 + i, four_way, pack8,
                                 ring)])
    return out


def phase_room_kernel(card, dev, flags=None, seed=SEED + 1):
    """One form of the room kernel (the ring on the scan, or the form a
    ROOM_ROWS or GROUPED_ROOM_ROWS row launches) at 1024 agents: held
    bit-equal to its plain version on the main case, an overlap case and
    a NaN case, then timed as the window forms are."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.ops import room_raster_cuda as rc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec, reach_cells

    flags = flags or dict(room_kernel=True)
    four_way, _, ring, _, n_groups, key = _form_of(flags)
    cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                               **flags)
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = BeamSpec.four_way() if four_way else BeamSpec.scan(
        cfg.engine.scan_rays)
    reach = reach_cells(cfg)
    size = cfg.grid.size
    per_row = cfg.engine.room_tile_per_row
    alive = torch.ones((N_AGENTS,), dtype=torch.bool, device=dev)
    xy, yaw, db, tb = _raster_inputs(cfg, params, rooms, gen, dev, four_way)
    tb = tb if ring else None
    alive[-3] = False                       # one inactive agent

    # overlap case: the second agent of every room within +-3 cells of the
    # first, on a grid pre-filled near +-clamp
    xy_o = xy.clone()
    xy_o[1::2] = xy[0::2] + (torch.rand((N_AGENTS // 2, 2), generator=gen,
                                        device=dev) - 0.5) * 0.3
    tail = cfg.engine.beam_tail_weight
    kw = dict(spec=spec, cfg=cfg.grid, n_groups=n_groups or spec.n_beams,
              per_row=per_row, trusted=tb, reach=reach)
    if n_groups:
        kw["tail_weight"] = tail

    def kernel(g, *a):
        return rc.room_raster(g, *a, **kw)

    def plain(g, *a):
        return rc.room_raster_plain(g, *a, **kw)

    cases = {
        "main": (torch.zeros((size, size), device=dev),
                 (xy, yaw, db, alive)),
        "overlap": (_prefilled(size, gen, dev), (xy_o, yaw, db, alive)),
        "nan": (_with_nan(_prefilled(size, gen, dev), gen),
                (xy_o, yaw, db, alive)),
    }
    worst = _hold_equal(f"room {key}", kernel, plain, cases, size)

    g_t = torch.zeros((size, size), device=dev)
    rm = rc._rooms(g_t, xy, yaw, db, alive, spec, cfg.grid, per_row, tb,
                   reach, kw["n_groups"], tail)
    dense = rc._dense_fan(spec, reach)

    def launch():
        rc._launch(g_t, rm, spec, cfg.grid, dense)

    changed = _changed_cells(launch, g_t)
    t_kernel, t_plain, runs = _ab_ms(
        launch, lambda: plain(g_t, xy, yaw, db, alive), 20, 3)
    t_wrapper = _median_ms(lambda: kernel(g_t, xy, yaw, db, alive), 20)
    t_device = device_ms(launch, 20, "room_raster_kernel")

    # bounds: over, in every tile, the union of its two slots' window rows
    # (an empty slot's too: the reference clips it); the operands read
    # once, the counts written once; the covered bound evaluates every
    # slot's window
    r_loc = rm.meta[..., 4]
    lo, hi = r_loc.amin(-1), r_loc.amax(-1)
    rows = torch.minimum(hi - lo, torch.full_like(lo, rm.win_rows)) + \
        rm.win_rows
    n_tiles = rm.meta.shape[0] * rm.meta.shape[1]
    evaluated = n_tiles * rc.AGENTS_PER_ROOM * rm.win_rows * 256
    bounds, n_bytes = _bounds(
        4, int(rows.sum()) * 256, changed,
        _nbytes(rm.meta, rm.table) + 4 * n_tiles, OPS_PER_CELL, evaluated)
    text, rec = _timed(worst, t_kernel, t_plain, runs, t_wrapper, t_device,
                       bounds, n_bytes, changed)
    groups = f" in {rm.n_bins} groups" if n_groups else ""
    print(f"room raster at {N_AGENTS} agents ({n_tiles} tiles, {per_row} "
          f"rooms per row) x {spec.n_beams} beams{groups} ({key}) on "
          f"{size}^2 [{card}]: {text}; the kernel evaluates "
          f"{_room_box_cells(rm, spec)} cells (its boxes; the covered "
          f"bound counts {evaluated})")
    return rec


def phase_path(card, dev, room_kernel: bool, beam_groups: int = 0):
    """One main path at full width: reset the launch counters, one warm-up
    step and TIMED_STEPS timed steps, read the counters. beam_groups > 0:
    the grouped path (bench.py --beam-groups N), grouped-ring on its
    kernel. Returns (the launches of its form, (cfg, rooms, state, the last
    step's metrics), a summary: the step, steps/s, applied cells/s, peak
    memory)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init

    name = ("room" if room_kernel else "window") + (
        f" --beam-groups {beam_groups}" if beam_groups else "")
    cfg, walls, params, rooms = presets.deployable(
        N_AGENTS, device=dev, room_kernel=room_kernel,
        beam_groups=beam_groups)
    every = cfg.engine.merge_every
    state = sim_init(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = make_sim_step(cfg, walls, params, gen, walls_grouped=rooms[0],
                         room_of_agent=rooms[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()                          # the main path starts here
    state, m0 = step(state)                  # warm-up (online is 0 at t=0)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TIMED_STEPS + 1)]
    t0 = time.perf_counter()
    ms = []
    events[0].record()
    for k in range(TIMED_STEPS):
        state, m = step(state)
        events[k + 1].record()
        ms.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_free, by_form, n_room = _read_counts()
    launches = {"free_raster": n_free, "room_raster": n_room}

    steps_run = TIMED_STEPS + 1
    own, other = (("room_raster", "free_raster") if room_kernel
                  else ("free_raster", "room_raster"))
    writes = torch.stack([m.writes for m in ms]).cpu()
    online = torch.stack([m.online for m in ms]).cpu()
    merges = torch.stack([m0.merges] + [m.merges for m in ms]).cpu()
    forms = _room_by_form() if room_kernel else by_form
    want = ("grouped-ring" if beam_groups else
            "pack16-ring" if room_kernel else "pack8-ring")
    if launches[own] != steps_run or launches[other] != 0 or \
            forms != {want: steps_run}:
        raise AssertionError(f"{name} path: launches {launches} in "
                             f"{steps_run} steps")
    if not bool((writes > 0).all()) or int(m0.writes) <= 0:
        raise AssertionError(f"{name} path: a step wrote no cells")
    if not bool((online == N_AGENTS).all()):
        raise AssertionError(f"{name} path: online {online.tolist()[:8]}")
    if not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError(f"{name} path: non-finite poses")
    merge_steps = [k for k in range(steps_run) if k % every == every - 1]
    if int(merges.sum()) <= 0:
        raise AssertionError(f"{name} path: no merge in {steps_run} steps")

    # device-timeline step times (medians: the first merge step also pays
    # the matcher's one-time library set-up)
    step_ms = [events[k].elapsed_time(events[k + 1])
               for k in range(TIMED_STEPS)]
    on = [step_ms[k - 1] for k in merge_steps if k >= 1]
    off = sorted(t for k, t in enumerate(step_ms, 1) if k not in merge_steps)
    applied = int(writes.to(torch.int64).sum())
    peak = torch.cuda.max_memory_allocated()
    print(f"{name} path: {steps_run} steps, launches {launches}, online "
          f"{N_AGENTS}/{N_AGENTS} on every timed step, min writes "
          f"{int(writes.min())}, poses finite, merges "
          f"{[int(merges[k]) for k in merge_steps]} at steps {merge_steps}")
    print(f"{name} path at {N_AGENTS} agents [{card}]: "
          f"{TIMED_STEPS / wall:.2f} steps/s, {applied / wall:.6e} applied "
          f"cells/s ({applied} cells in {wall:.4f} s), peak memory {peak} "
          f"bytes; step median {off[len(off) // 2]:.4f} ms without a merge,"
          f" {sorted(on)[len(on) // 2]:.4f} ms with one ({len(on)} merge "
          f"steps, the first {on[0]:.4f} ms)")
    summary = dict(step=step, steps_s=TIMED_STEPS / wall,
                   cells_s=applied / wall, applied=applied, peak=peak)
    return launches[own], (cfg, rooms, state, ms[-1]), summary


def phase_path_split(card, name, state, summary):
    """SPLIT_STEPS more steps of a 1024-agent path split on the device
    timeline (`_step_split`); adds the raster's share of the device step
    (medians over the steps with neither a merge nor a zone snapshot) to
    the path's summary."""
    # the step goes: it holds its path's world, which later peaks would
    # count
    state, split = _step_split(summary.pop("step"), state, SPLIT_STEPS)
    summary["raster_share"] = split["raster"][0] / split["step"][0]
    print(f"{name} path step split [{card}], device-timeline medians over "
          f"{SPLIT_STEPS} more steps (ms): " + ", ".join(
              f"{p} {t:.4f} (n={k})" for p, (t, k, _) in split.items()) +
          f"; raster share of the device step "
          f"{summary['raster_share']:.4f}")
    return summary


def _compare_paths(card, paths):
    """The grouped paths beside the per-beam ones, from this run."""
    for kernel in ("window", "room"):
        rows = [(tier, paths[(kernel, tier)]) for tier in ("per-beam",
                                                             "grouped")]
        print(f"{kernel} path at {N_AGENTS} agents, per beam vs "
              f"--beam-groups 8 [{card}]: " + "; ".join(
                  f"{tier}: {s['steps_s']:.2f} steps/s, "
                  f"{s['cells_s']:.6e} applied cells/s ({s['applied']} "
                  f"cells), raster share {s['raster_share']:.4f}, peak "
                  f"memory {s['peak']} bytes" for tier, s in rows))


def phase_merge(card, dev, cfg, rooms, state, m):
    """One merge event at 1024 agents, on the room path's final state: the
    engine's call (scan_merge_recover, one 128-agent chunk) and the
    matcher's two translation-scoring routes on that chunk."""
    from swarm_tpu_torch.models.scan import sense_scan
    from swarm_tpu_torch.models.sensors import draw_sensor_noise
    from swarm_tpu_torch.slam import livemerge, scanmatch

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n, r = cfg.n_agents, cfg.engine.scan_rays
    scan = sense_scan(draw_sensor_noise(gen, (n, r), dev), state.pose_true,
                      rooms[0][rooms[1].long()], r, cfg.sensors)
    srv = state.srv
    match_map = torch.where(torch.abs(srv.anchor) >= 0.5, srv.anchor,
                            srv.logodds)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    rx, ry, ryaw = m.srv_x, m.srv_y, m.srv_yaw

    def event():
        return livemerge.scan_merge_recover(
            match_map, rx, ry, ryaw, scan, alive, cfg, event=3, n_global=n,
            fail_count=srv.merge_fail)

    event()
    t_event = _median_ms(event, 7)
    c = min(cfg.slam.merge_chunk, n)
    results = {}

    def match(scores):
        def run():
            port_scores = scanmatch._scores
            scanmatch._scores = scores
            try:
                results[scores] = livemerge.scan_merge(
                    match_map, rx[:c], ry[:c], ryaw[:c], scan[:c], alive[:c],
                    cfg)
            finally:
                scanmatch._scores = port_scores
        return run

    conv, im2col = scanmatch._scores, scanmatch._scores_im2col
    t_conv, t_im2col, runs = _ab_ms(match(conv), match(im2col), 7, 7)
    a, b = results[conv], results[im2col]
    same_ok = int((a.ok == b.ok).sum())
    d_max = float(torch.maximum((a.ddx - b.ddx).abs(),
                                (a.ddy - b.ddy).abs()).max())
    print(f"merge event at {n} agents [{card}]: scan_merge_recover on a "
          f"{c}-agent chunk {t_event:.4f} ms ({int(event()[0].ok.sum())} "
          f"verified); matcher on the chunk with translation scoring by "
          f"grouped conv2d (the port) {t_conv:.4f} ms (runs {runs[0]:.4f}, "
          f"{runs[3]:.4f}) vs by im2col bmm {t_im2col:.4f} ms (runs "
          f"{runs[1]:.4f}, {runs[2]:.4f}); the two agree on ok for "
          f"{same_ok}/{c} agents, max |d correction| {d_max:.3e} m")
    if same_ok < c - 2:
        raise AssertionError("conv and im2col scoring disagree")


def phase_reference(dev, name: str, steps: int = REF_STEPS,
                    equal_merges: bool = False, world=None,
                    expect_merges: bool = True, **flags):
    """The same `steps` steps of presets.deployable(REF_AGENTS, **flags)
    (or of `world(device)`, a preset's return) on the card and on the CPU,
    from the same state and noise; with `equal_merges` the merge counts
    must be equal on both sides, and with `expect_merges` a merge event
    must run.
    The tri-state map is the int8 grid in the parity and profiling
    modes."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import (agent_merge_box, draw_step_noise,
                                            sim_init, sim_step)
    from swarm_tpu_torch.ops.raster import tri_state_view

    if world is None:
        def world(d):
            return presets.deployable(REF_AGENTS, device=d, **flags)
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(SEED)
    worlds = {d: world(d) for d in (cpu, dev)}
    n = worlds[cpu][0].n_agents
    n_rays = worlds[cpu][0].engine.scan_rays
    states = {d: sim_init(w[0], w[2]) for d, w in worlds.items()}
    boxes = {d: agent_merge_box(w[0], w[3][0], w[3][1], d)
             for d, w in worlds.items()}
    writes = {cpu: [], dev: []}
    merges = {cpu: [], dev: []}
    last = {}
    for k in range(steps):
        noise = draw_step_noise(gen, n, n_rays, cpu)
        ms = {}
        for d, (cfg, walls, params, rooms) in worlds.items():
            nz = type(noise)(*(None if f is None else
                               type(f)(*(x.to(d) for x in f))
                               for f in noise))
            states[d], ms[d] = sim_step(
                states[d], nz, cfg, walls, params, walls_grouped=rooms[0],
                room_of_agent=rooms[1], step_no=k, merge_win_box=boxes[d])
            writes[d].append(int(ms[d].writes))
            merges[d].append(int(ms[d].merges))
        if merges[cpu][-1] or merges[dev][-1]:
            ok_c, ok_d = ms[cpu].merge_ok, ms[dev].merge_ok.cpu()
            for a in torch.nonzero(ok_c != ok_d).flatten().tolist():
                print(f"reference [{name}] step {k}: agent {a} merge "
                      f"{bool(ok_d[a])} on the card vs {bool(ok_c[a])} on "
                      f"the CPU (fitness {float(ms[dev].merge_fit[a])} vs "
                      f"{float(ms[cpu].merge_fit[a])})")
        last = ms
    cfg = worlds[cpu][0]
    if int(last[cpu].online) != int(last[dev].online):
        raise AssertionError(f"reference [{name}]: online differs")
    w_c, w_d = sum(writes[cpu]), sum(writes[dev])
    if abs(w_c - w_d) > 0.01 * w_c:
        raise AssertionError(f"reference [{name}]: writes {w_d} on the card "
                             f"vs {w_c} on the CPU")
    int8 = cfg.engine.parity_mode or cfg.engine.raster_mode == "off"

    def tri(d):
        return (states[d].srv.grid if int8 else tri_state_view(
            states[d].srv.logodds, cfg.grid)).cpu()

    tri_c, tri_d = tri(cpu), tri(dev)
    explored = (tri_c != cfg.grid.unknown) | (tri_d != cfg.grid.unknown)
    # the profiling mode maps nothing: nothing explored is agreement
    agree = float(((tri_c == tri_d) & explored).sum()) / int(
        explored.sum()) if int(explored.sum()) else 1.0
    ev = [k for k in range(steps) if merges[cpu][k] or merges[dev][k]]
    print(f"reference [{name}] at {n} agents, {steps} steps: writes "
          f"{w_d} (card) vs {w_c} (CPU), tri-state agreement {agree:.6f} "
          f"over {int(explored.sum())} explored cells, merges at steps {ev}:"
          f" {[merges[dev][k] for k in ev]} (card) vs "
          f"{[merges[cpu][k] for k in ev]} (CPU)")
    if agree < 0.99:
        raise AssertionError(f"reference [{name}]: card and CPU maps "
                             f"disagree")
    if expect_merges and not ev:
        raise AssertionError(f"reference [{name}]: no merge event ran")
    if equal_merges and merges[cpu] != merges[dev]:
        raise AssertionError(f"reference [{name}]: merge counts differ")


def _coverage(logodds, reach) -> float:
    """Fraction of the reachable cells the map calls FREE (the coverage
    tool's count, tools/bench_coverage.py:93-95)."""
    from swarm_tpu_torch.ops.raster import FREE_THRESH

    covered = int(((logodds <= FREE_THRESH) & reach).sum())
    return covered / max(int(reach.sum()), 1)


def _reset_counts():
    from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
    from swarm_tpu_torch.ops.exact_raster_cuda import beam_raster
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster

    for wrapper in (free_raster, room_raster, beam_raster):
        wrapper.launches = 0
        wrapper.launches_by_form.clear()


def _read_counts():
    from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster

    return (free_raster.launches, dict(free_raster.launches_by_form),
            room_raster.launches)


def _room_by_form():
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster

    return dict(room_raster.launches_by_form)


def phase_explore(card, dev):
    """The exploration path at full width: presets.coverage(N_AGENTS,
    frontiers=True) with targets, step 0 untimed, then TIMED_STEPS timed
    steps; both fans through the window kernel every step, frontier events
    every 8 steps (step 0 included)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init

    cfg, walls, params, rooms = presets.coverage(N_AGENTS, device=dev)
    dt = cfg.nav.drive_tick_s + cfg.nav.settle_tick_s
    every = max(1, round(cfg.coord.target_interval_s / dt))
    state = sim_init(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = make_sim_step(cfg, walls, params, gen, enable_targets=True,
                         walls_grouped=rooms[0], room_of_agent=rooms[1])
    reach = torch.as_tensor(reachable_mask(walls.cpu().numpy(), cfg.grid),
                            device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()                          # the main path starts here
    state, m0 = step(state)                  # step 0: a frontier event
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TIMED_STEPS + 1)]
    t0 = time.perf_counter()
    ms, has = [m0], [state.nav.has_target.sum()]
    events[0].record()
    for k in range(TIMED_STEPS):
        state, m = step(state)
        events[k + 1].record()
        ms.append(m)
        has.append(state.nav.has_target.sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_free, by_form, n_room = _read_counts()

    steps_run = TIMED_STEPS + 1
    writes = torch.stack([m.writes for m in ms]).cpu()
    online = torch.stack([m.online for m in ms]).cpu()
    n_fr = torch.stack([m.n_frontiers for m in ms]).cpu()
    has = torch.stack(has).cpu()
    ev = [k for k in range(steps_run) if k % every == 0]
    want = {"pack16": steps_run, "pack16-wrapped": steps_run}
    if n_free != 2 * steps_run or by_form != want or n_room != 0:
        raise AssertionError(f"exploration path: launches {n_free} "
                             f"{by_form}, room {n_room}, in {steps_run} "
                             f"steps")
    if not bool((writes > 0).all()):
        raise AssertionError("exploration path: a step wrote no cells")
    if len(ev) != 26 or not all(int(n_fr[k]) > 0 for k in ev if k >= 8):
        raise AssertionError(f"exploration path: frontier counts "
                             f"{[int(n_fr[k]) for k in ev]} at steps {ev}")
    if int(has.max()) <= 0:
        raise AssertionError("exploration path: no agent got a target")
    if not bool((online[1:] == N_AGENTS).all()):
        raise AssertionError(f"exploration path: online "
                             f"{online.tolist()[:8]}")
    if not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError("exploration path: non-finite poses")

    step_ms = [events[k].elapsed_time(events[k + 1])
               for k in range(TIMED_STEPS)]
    on = sorted(t for k, t in enumerate(step_ms, 1) if k in ev)
    off = sorted(t for k, t in enumerate(step_ms, 1) if k not in ev)
    applied = int(writes[1:].to(torch.int64).sum())
    peak = torch.cuda.max_memory_allocated()
    cover = _coverage(state.srv.logodds, reach)
    print(f"exploration path: {steps_run} steps, launches {n_free} "
          f"{by_form}, room {n_room}, online {N_AGENTS}/{N_AGENTS}, min "
          f"writes {int(writes.min())}, poses finite; {len(ev)} frontier "
          f"events, frontiers {[int(n_fr[k]) for k in ev]}, agents with a "
          f"target {[int(has[k]) for k in ev]}")
    print(f"exploration path at {N_AGENTS} agents [{card}]: "
          f"{TIMED_STEPS / wall:.2f} steps/s, {applied / wall:.6e} applied "
          f"cells/s ({applied} cells in {wall:.4f} s), peak memory {peak} "
          f"bytes; step median {off[len(off) // 2]:.4f} ms without a "
          f"frontier event, {on[len(on) // 2]:.4f} ms with one ({len(on)} "
          f"timed events); coverage {cover:.6f} of {int(reach.sum())} "
          f"reachable cells at step {steps_run - 1}")
    phase_endpoint_scatter(card, dev, cfg, rooms, state)
    return by_form


def phase_endpoint_scatter(card, dev, cfg, rooms, state):
    """The exact endpoint scatter of each fan at full width (torch ops, no
    kernel of its own), on the exploration path's final state."""
    from swarm_tpu_torch.models.scan import sense_scan
    from swarm_tpu_torch.models.sensors import draw_sensor_noise, sense_4way
    from swarm_tpu_torch.ops.beam_raster import (BeamSpec, beams_from_scan,
                                                 endpoint_rays)
    from swarm_tpu_torch.ops.raster import endpoint_scatter

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    n, r = cfg.n_agents, cfg.engine.scan_rays
    walls_agent = rooms[0][rooms[1].long()]
    pose = state.pose_true
    xy = pose[:, :2].contiguous()
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    for name, spec, dist in (
            ("4-way", BeamSpec.four_way(),
             sense_4way(draw_sensor_noise(gen, (n, 4), dev), pose,
                        walls_agent, cfg.sensors)),
            ("scan", BeamSpec.scan(r),
             sense_scan(draw_sensor_noise(gen, (n, r), dev), pose,
                        walls_agent, r, cfg.sensors))):
        db, tb = beams_from_scan(dist, cfg.sensors.max_range,
                                 cfg.sensors.min_range)
        rays = endpoint_rays(xy, pose[:, 2], db, tb, alive, spec)
        grid = state.srv.logodds.clone()
        _, w = endpoint_scatter(grid, rays, cfg.grid)
        t_ms = _median_ms(lambda: endpoint_scatter(grid, rays, cfg.grid),
                          20)
        t_rays = _median_ms(lambda: endpoint_rays(xy, pose[:, 2], db, tb,
                                                  alive, spec), 20)
        print(f"endpoint scatter, {name} fan at {n} agents [{card}]: "
              f"{t_ms:.4f} ms for {int(w)} endpoints ({t_rays:.4f} ms to "
              f"build the rays)")


def phase_ultrasonic(card, dev):
    """bench.py --scan-rays 0 at full width: the wrapped 4-way fan through
    the pack8 + ring form, once per step, for ULTRASONIC_STEPS steps."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init

    cfg, walls, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                                   scan_rays=0)
    state = sim_init(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = make_sim_step(cfg, walls, params, gen, walls_grouped=rooms[0],
                         room_of_agent=rooms[1])
    torch.cuda.synchronize()
    _reset_counts()                          # the main path starts here
    t0 = time.perf_counter()
    ms = []
    for _ in range(ULTRASONIC_STEPS):
        state, m = step(state)
        ms.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_free, by_form, n_room = _read_counts()
    writes = torch.stack([m.writes for m in ms]).cpu()
    if by_form != {"pack8-ring-wrapped": ULTRASONIC_STEPS} or n_room:
        raise AssertionError(f"ultrasonic path: launches {by_form}, room "
                             f"{n_room}, in {ULTRASONIC_STEPS} steps")
    if not bool((writes > 0).all()):
        raise AssertionError("ultrasonic path: a step wrote no cells")
    if not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError("ultrasonic path: non-finite poses")
    applied = int(writes.to(torch.int64).sum())
    print(f"ultrasonic path at {N_AGENTS} agents [{card}]: "
          f"{ULTRASONIC_STEPS} steps, launches {by_form}, min writes "
          f"{int(writes.min())}, online {int(ms[-1].online)}; "
          f"{ULTRASONIC_STEPS / wall:.2f} steps/s, {applied / wall:.6e} "
          f"applied cells/s (the first step included)")
    return by_form


def phase_entry_points(card, dev):
    """Each entry point the exploration path opens, through sim_rollout at
    N_AGENTS agents for ENTRY_STEPS steps (frontier events at steps 0, 8,
    16): every step writes, each window form launched once per step as the
    configuration prescribes and the room kernel never, frontiers found on
    the events from step 8 where they are on, targets where asked for."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import sim_init, sim_rollout

    n, k = N_AGENTS, ENTRY_STEPS
    for name, make, targets, forms in (
            ("coverage, frontier targets",
             lambda: presets.coverage(n, True, dev), True,
             {"pack16-wrapped": k, "pack16": k}),
            ("coverage, wall-following",
             lambda: presets.coverage(n, False, dev), False,
             {"pack16-wrapped": k, "pack16": k}),
            ("bench --frontiers",
             lambda: presets.deployable(n, device=dev, frontiers=True), True,
             {"pack8-ring": k}),
            ("bench --scan-rays 0",
             lambda: presets.deployable(n, device=dev, scan_rays=0), False,
             {"pack8-ring-wrapped": k})):
        cfg, walls, params, rooms = make()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state = sim_init(cfg, params)
        torch.cuda.synchronize()
        _reset_counts()                      # this path starts here
        t0 = time.perf_counter()
        state, m = sim_rollout(state, k, cfg, walls, params, gen,
                               enable_targets=targets,
                               walls_grouped=rooms[0],
                               room_of_agent=rooms[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _, by_form, n_room = _read_counts()
        writes, n_fr = m.writes.cpu(), m.n_frontiers.cpu()
        has = int(state.nav.has_target.sum())
        print(f"entry point [{name}] at {n} agents [{card}]: {k} steps "
              f"through sim_rollout in {wall:.4f} s, launches {by_form}, "
              f"room {n_room}, min writes {int(writes.min())}, frontiers "
              f"{[int(n_fr[j]) for j in range(0, k, 8)]} at steps "
              f"{list(range(0, k, 8))}, {has} agents with a target, "
              f"{int(m.merges.sum())} merges")
        if by_form != forms or n_room:
            raise AssertionError(f"entry point [{name}]: launches "
                                 f"{by_form}, room {n_room}")
        if not bool((writes > 0).all()):
            raise AssertionError(f"entry point [{name}]: a step wrote no "
                                 f"cells")
        if cfg.engine.compute_frontiers != bool(
                (n_fr[8::8] > 0).all()) or (has > 0) != targets:
            raise AssertionError(f"entry point [{name}]: frontiers "
                                 f"{n_fr.tolist()}, targets {has}")
        if not bool(torch.isfinite(state.pose_true).all()):
            raise AssertionError(f"entry point [{name}]: non-finite poses")


def phase_reference_explore(dev):
    """The exploration path at REF_AGENTS agents, the same EXPLORE_REF_STEPS
    steps on the card and on the CPU from the same state and noise,
    targets on: writes within 1%, tri-state maps on >= 99% of explored
    cells, equal frontier counts."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import (agent_target_rooms,
                                            draw_step_noise, sim_init,
                                            sim_step)
    from swarm_tpu_torch.ops.raster import tri_state_view

    n = REF_AGENTS
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(SEED)
    worlds = {d: presets.coverage(n, device=d) for d in (cpu, dev)}
    states = {d: sim_init(w[0], w[2]) for d, w in worlds.items()}
    rooms_t = {d: agent_target_rooms(w[0], w[3][0], w[3][1], d)
               for d, w in worlds.items()}
    writes = {cpu: [], dev: []}
    n_fr = {cpu: [], dev: []}
    for k in range(EXPLORE_REF_STEPS):
        noise = draw_step_noise(gen, n, 181, cpu)
        for d, (cfg, walls, params, rooms) in worlds.items():
            nz = type(noise)(*(type(f)(*(x.to(d) for x in f))
                               for f in noise))
            states[d], m = sim_step(
                states[d], nz, cfg, walls, params, enable_targets=True,
                walls_grouped=rooms[0], room_of_agent=rooms[1], step_no=k,
                target_rooms=rooms_t[d])
            writes[d].append(int(m.writes))
            n_fr[d].append(int(m.n_frontiers))
    cfg = worlds[cpu][0]
    w_c, w_d = sum(writes[cpu]), sum(writes[dev])
    tri_c = tri_state_view(states[cpu].srv.logodds, cfg.grid)
    tri_d = tri_state_view(states[dev].srv.logodds, cfg.grid).cpu()
    explored = (tri_c != cfg.grid.unknown) | (tri_d != cfg.grid.unknown)
    agree = float(((tri_c == tri_d) & explored).sum()) / max(
        int(explored.sum()), 1)
    ev = list(range(0, EXPLORE_REF_STEPS, 8))
    has = [int(states[d].nav.has_target.sum()) for d in (dev, cpu)]
    print(f"reference [exploration] at {n} agents, {EXPLORE_REF_STEPS} "
          f"steps: writes {w_d} (card) vs {w_c} (CPU), tri-state agreement "
          f"{agree:.6f} over {int(explored.sum())} explored cells, frontiers"
          f" at steps {ev}: {[n_fr[dev][k] for k in ev]} (card) vs "
          f"{[n_fr[cpu][k] for k in ev]} (CPU), agents with a target "
          f"{has[0]} vs {has[1]}")
    if abs(w_c - w_d) > 0.01 * w_c:
        raise AssertionError("reference [exploration]: writes differ")
    if agree < 0.99:
        raise AssertionError("reference [exploration]: maps disagree")
    if n_fr[cpu] != n_fr[dev]:
        raise AssertionError("reference [exploration]: frontier counts "
                             "differ")


def phase_slice_kernel(card, dev):
    """The slice's kernel form (pack8 + ring on a bf16 grid) at the slice's
    shapes: presets.deployable(SLICE_AGENTS, grid_dtype="bfloat16"), its
    23,296^2 bf16 grid, held bit-equal to the plain version (run in agent
    chunks) and timed."""
    from swarm_tpu_torch import presets

    cfg, _, params, rooms = presets.deployable(SLICE_AGENTS, device=dev,
                                               **SLICE)
    out = dict([_window_form(card, dev, "window pack8-ring-bf16 (slice)",
                             cfg, params, rooms, SEED + 30, four_way=False,
                             pack8=True, ring=True)])
    torch.cuda.empty_cache()
    return out


def phase_slice(card, dev):
    """The slice: bench.py --agents 32768 --grid-dtype bfloat16, i.e.
    presets.deployable(SLICE_AGENTS, grid_dtype="bfloat16") -> sim_init ->
    one warm-up step (step 0) -> the counters set to 0 -> SLICE_STEPS
    timed steps (1..65; merges at 15, 31, 47 and 63) -> the counters read:
    pack8-ring-bf16 launched once per step and nothing else, every step
    writes, 4 merge events, all agents online, poses finite. Then
    SPLIT_STEPS more steps with the step split (`_step_split`)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init

    n = SLICE_AGENTS
    t_set = time.perf_counter()
    cfg, walls, params, rooms = presets.deployable(n, device=dev, **SLICE)
    every = cfg.engine.merge_every
    state = sim_init(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = make_sim_step(cfg, walls, params, gen, walls_grouped=rooms[0],
                         room_of_agent=rooms[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state)                   # warm-up: step 0
    torch.cuda.synchronize()
    t_set = time.perf_counter() - t_set

    _reset_counts()                          # the main path starts here
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(SLICE_STEPS + 1)]
    ms = []
    t0 = time.perf_counter()
    events[0].record()
    for k in range(SLICE_STEPS):
        state, m = step(state)
        events[k + 1].record()
        ms.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_free, by_form, n_room = _read_counts()

    writes = torch.stack([m.writes for m in ms]).cpu()
    online = torch.stack([m.online for m in ms]).cpu()
    merges = torch.stack([m.merges for m in ms]).cpu()
    merge_steps = [k for k in range(1, SLICE_STEPS + 1)
                   if k % every == every - 1]
    on = [int(merges[k - 1]) for k in merge_steps]
    if by_form != {"pack8-ring-bf16": SLICE_STEPS} or n_room or \
            n_free != SLICE_STEPS:
        raise AssertionError(f"slice: launches {by_form}, room {n_room}, "
                             f"in {SLICE_STEPS} steps")
    if not bool((writes > 0).all()):
        raise AssertionError("slice: a step wrote no cells")
    if len(merge_steps) != 4 or not all(x > 0 for x in on) or \
            int(merges.sum()) != sum(on):
        raise AssertionError(f"slice: merges {merges.tolist()}")
    if not bool((online == n).all()):
        raise AssertionError(f"slice: online {online.tolist()[:8]}")
    if not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError("slice: non-finite poses")
    applied = int(writes.to(torch.int64).sum())
    peak = torch.cuda.max_memory_allocated()
    step_ms = [events[k].elapsed_time(events[k + 1])
               for k in range(SLICE_STEPS)]
    off = [t for k, t in enumerate(step_ms, 1) if k not in merge_steps]
    print(f"slice: bench.py --agents {n} --grid-dtype bfloat16 on "
          f"{cfg.grid.size}^2 ({n // 2} rooms), {SLICE_STEPS} steps after a "
          f"warm-up (set-up and warm-up "
          f"{t_set:.2f} s): launches {by_form}, room {n_room}, min writes "
          f"{int(writes.min())}, merges {on} at steps {merge_steps}, online "
          f"{n}/{n} on every step, poses finite")
    print(f"slice at {n} agents [{card}]: {SLICE_STEPS / wall:.4f} steps/s, "
          f"{applied / wall:.6e} applied cells/s ({applied} cells, int64 "
          f"sum, in {wall:.4f} s), peak memory {peak} bytes; device step "
          f"median {_median(off):.4f} ms without a merge, "
          f"{_median([step_ms[k - 1] for k in merge_steps]):.4f} ms with "
          f"one")
    state, split = _step_split(step, state, SPLIT_STEPS)
    print(f"slice step split [{card}], device-timeline medians over steps "
          f"{SLICE_STEPS + 1}-{SLICE_STEPS + SPLIT_STEPS} (ms, over the n "
          f"steps that ran each part, with the most device memory "
          f"allocated while it ran; step and rest over the steps with "
          f"neither a merge nor a zone snapshot): " + ", ".join(
              f"{p} {t:.4f} (n={k}" + ("" if peak is None else
                                       f", peak {peak} bytes") + ")"
              for p, (t, k, peak) in split.items()))
    del state, step, ms
    torch.cuda.empty_cache()
    return SLICE_STEPS


def _flag_row(card, dev, flags):
    """One bench.py flag row through sim_rollout at N_AGENTS agents for
    FLAG_STEPS steps: exactly the row's form launched once per step, the
    other kernel never, every step writes, poses finite. Returns ((kernel,
    form key), launches)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import (rollout_writes, sim_init,
                                            sim_rollout)

    room = bool(flags.get("room_kernel"))
    key = _form_of(flags)[-1]
    cfg, walls, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                                   **flags)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = sim_init(cfg, params)
    torch.cuda.synchronize()
    _reset_counts()                          # this path starts here
    t0 = time.perf_counter()
    state, m = sim_rollout(state, FLAG_STEPS, cfg, walls, params, gen,
                           walls_grouped=rooms[0], room_of_agent=rooms[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_free, by_form, n_room = _read_counts()
    forms, other = ((_room_by_form(), n_free) if room
                    else (by_form, n_room))
    writes = m.writes.cpu()
    print(f"flags [{_flags(flags)}] at {N_AGENTS} agents [{card}]: "
          f"{FLAG_STEPS} steps through sim_rollout in {wall:.4f} s, "
          f"{'room' if room else 'window'} launches {forms}, other "
          f"kernel {other}, min writes {int(writes.min())}, applied "
          f"{rollout_writes(m)}, merges {int(m.merges.sum())}, online "
          f"{int(m.online[-1])}")
    if forms != {key: FLAG_STEPS} or other:
        raise AssertionError(f"flags [{_flags(flags)}]: launches "
                             f"{forms}, other kernel {other}")
    if not bool((writes > 0).all()):
        raise AssertionError(f"flags [{_flags(flags)}]: a step wrote no "
                             f"cells")
    if not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError(f"flags [{_flags(flags)}]: non-finite "
                             f"poses")
    return ("room" if room else "window", key), forms[key]


def phase_flag_paths(card, dev):
    """Every remaining row of bench.py's single-chip raster flags (WINDOW_ROWS,
    ROOM_ROWS) through sim_rollout (`_flag_row`). Then bench.py
    --room-kernel --grid-dtype bfloat16 must raise ValueError, at sim_init
    and in the room wrapper on a card grid."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import sim_init
    from swarm_tpu_torch.ops import room_raster_cuda as rc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec

    out = dict(_flag_row(card, dev, flags)
               for flags in WINDOW_ROWS + ROOM_ROWS)

    cfg, walls, params, rooms = presets.deployable(
        N_AGENTS, device=dev, room_kernel=True, grid_dtype="bfloat16")
    refused = []
    for what, call in (
            ("sim_init", lambda: sim_init(cfg, params)),
            ("room_raster on the card", lambda: rc.room_raster(
                torch.zeros((cfg.grid.size,) * 2, dtype=torch.bfloat16,
                            device=dev), params.home_x[:, None].repeat(1, 2),
                params.yaw0, torch.ones((N_AGENTS, 181), device=dev),
                torch.ones((N_AGENTS,), dtype=torch.bool, device=dev),
                BeamSpec.scan(), cfg.grid, n_groups=181,
                per_row=cfg.engine.room_tile_per_row))):
        try:
            call()
        except ValueError as e:
            refused.append(f"{what}: ValueError({e})")
        else:
            raise AssertionError(f"--room-kernel --grid-dtype bfloat16: "
                                 f"{what} did not raise")
    print("flags [--room-kernel --grid-dtype bfloat16] refused: " +
          "; ".join(refused))
    return out


def phase_bf16_vs_f32(card, dev):
    """The 1024-agent window path on each grid dtype, same seed,
    BF16_CMP_STEPS steps: tri-state agreement over the explored cells
    >= 0.98 (the JAX package's own bar, tests/test_beam_raster.py)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import (rollout_writes, sim_init,
                                            sim_rollout)
    from swarm_tpu_torch.ops.raster import tri_state_view

    tri, writes = {}, {}
    for dt in ("float32", "bfloat16"):
        cfg, walls, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                                       grid_dtype=dt)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state, m = sim_rollout(sim_init(cfg, params), BF16_CMP_STEPS, cfg,
                               walls, params, gen, walls_grouped=rooms[0],
                               room_of_agent=rooms[1])
        tri[dt] = tri_state_view(state.srv.logodds, cfg.grid)
        writes[dt] = rollout_writes(m)
    unknown = cfg.grid.unknown
    a, b = tri["float32"], tri["bfloat16"]
    explored = (a != unknown) | (b != unknown)
    agree = float(((a == b) & explored).sum()) / max(int(explored.sum()), 1)
    print(f"bf16 vs f32 grid, window path at {N_AGENTS} agents, "
          f"{BF16_CMP_STEPS} steps [{card}]: tri-state agreement "
          f"{agree:.6f} over {int(explored.sum())} explored cells; writes "
          f"{writes['bfloat16']} (bf16) vs {writes['float32']} (f32)")
    if agree < 0.98:
        raise AssertionError("bf16 and f32 grids disagree")


def phase_grouped_kernels(card, dev):
    """Each grouped form of both kernels at 1024 agents, in the world of the
    bench.py flags that launch it (`_window_form`, `phase_room_kernel`):
    the window kernel's 8 instances (GROUPED and the rows of
    GROUPED_WINDOW_ROWS; C1_ROW is the path's instance again, held and
    folded into its record) and the room kernel's 4 forms. Returns
    ({window form: record}, {room form: record})."""
    from swarm_tpu_torch import presets

    window = {}
    for i, flags in enumerate([GROUPED] + GROUPED_WINDOW_ROWS + [C1_ROW]):
        cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                                   **flags)
        four_way, pack8, ring, _, n_groups, key = _form_of(flags)
        form, rec = _window_form(card, dev, f"window {key} "
                                 f"[{_flags(flags)}]", cfg, params, rooms,
                                 SEED + 40 + i, four_way, pack8, ring,
                                 n_groups)
        if form in window:
            window[form]["max_abs_err"] = max(window[form]["max_abs_err"],
                                              rec["max_abs_err"])
        else:
            window[form] = rec
    room = {}
    for i, flags in enumerate([dict(room_kernel=True, **GROUPED)] +
                              GROUPED_ROOM_ROWS):
        room[_form_of(flags)[-1]] = phase_room_kernel(card, dev, flags,
                                                      SEED + 50 + i)
    return window, room


def _exact_world(dev, four_way: bool):
    """The world and fan of the exact raster's cases: the deployable
    preset's 181-beam sweep, or its --scan-rays 0 world's 4-way fan."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.ops.beam_raster import BeamSpec

    cfg, _, params, rooms = presets.deployable(
        N_AGENTS, device=dev, scan_rays=0 if four_way else 181)
    spec = (BeamSpec.four_way() if four_way
            else BeamSpec.scan(cfg.engine.scan_rays))
    return cfg, params, rooms, spec


def _exact_box_cells(w, spec) -> int:
    """The cells the exact raster evaluates on a clean grid: per agent its
    evaluation box (`exact_raster_cuda.evaluation_box`) within its
    window."""
    from swarm_tpu_torch.ops import exact_raster_cuda as er

    r_lo, r_hi, c_lo, c_hi = er.evaluation_box(w, spec)
    row0, col0 = w.row0.to(torch.float32), w.col0.to(torch.float32)
    rows = torch.minimum(r_hi, row0 + w.rows) - torch.maximum(r_lo, row0)
    cols = torch.minimum(c_hi, col0 + w.cols) - torch.maximum(c_lo, col0)
    return int((rows.clamp_min(0).double() *
                cols.clamp_min(0).double()).sum())


def phase_exact_kernel(card, dev):
    """The r1 exact raster (csrc/exact_raster.cu, for beam_raster_pallas's
    _kernel) on the scan and on the wrapped 4-way fan at 1024 agents: the
    map held BIT-EQUAL to beam_raster_plain (torch.sin on the card) on the
    main case (one agent inactive), an overlap case (64 agents around one
    point on a grid pre-filled near +-clamp), a dirty-tile case (the main
    case's agents on a grid of values beyond +-clamp and -0.0 cells: no
    tile clean, every window cell clipped) and a NaN case (the overlap
    case's agents, 1% NaN and 1% -0.0 cells); the kernel's sinf against
    torch.sin on the main case's residual bearings; then timed as the
    window forms are, with its evaluated cells (its boxes). Returns {fan:
    record}."""
    from swarm_tpu_torch.ops import exact_raster_cuda as er

    out = {}
    for i, four_way in enumerate((False, True)):
        cfg, params, rooms, spec = _exact_world(dev, four_way)
        fan = er.form_name(spec)
        gen = torch.Generator(device=dev).manual_seed(SEED + 60 + i)
        size, n = cfg.grid.size, cfg.n_agents
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
        alive[-3] = False
        xy, yaw, db, tb = _raster_inputs(cfg, params, rooms, gen, dev,
                                         four_way)
        k = min(64, n)
        xy_o = xy[:1] + 0.2 + (torch.rand((k, 2), generator=gen, device=dev)
                               - 0.5) * 0.4
        main = (xy, yaw, db, tb, alive)
        overlap = (xy_o, yaw[:k], db[:k], tb[:k], alive[:k])
        cases = {"main": (torch.zeros((size, size), device=dev), main),
                 "overlap": (_prefilled(size, gen, dev), overlap),
                 "dirty": (_dirty(size, gen, dev), main),
                 "nan": (_with_nan(_prefilled(size, gen, dev), gen),
                         overlap)}
        worst = 0.0
        for case, (grid0, args) in cases.items():
            g_k, g_p = grid0.clone(), grid0.clone()
            er.beam_raster(g_k, *args, spec, cfg.grid)
            torch.cuda.synchronize()
            er.beam_raster_plain(g_p, *args, spec, cfg.grid)
            torch.cuda.synchronize()
            n_diff = _n_differ(g_k, g_p)
            err = _max_abs_diff(g_k, g_p)
            worst = max(worst, err)
            changed = _n_differ(g_k, grid0)
            n_nan = int(torch.isnan(g_k).sum())
            print(f"exact raster [{fan}] kernel vs plain [{case}]: {n_diff} "
                  f"of {size * size} cells differ (max |diff| {err}), "
                  f"{changed} cells changed, {n_nan} NaN cells")
            if n_diff or n_nan != int(torch.isnan(grid0).sum()):
                raise AssertionError(f"exact raster [{fan}]: kernel and "
                                     f"plain maps differ in {n_diff} cells, "
                                     f"{n_nan} NaN [{case}]")
            if changed <= 0:
                raise AssertionError(f"exact raster [{fan}]: nothing "
                                     f"painted [{case}]")
        del cases

        g_t = torch.zeros((size, size), device=dev)
        w = er._windows(g_t, xy, yaw, db, tb, alive, cfg.grid)
        resid = er._bins(w, spec)[3].reshape(-1).contiguous()
        s_k, s_t = er.device_sin(resid), torch.sin(resid)
        n_sin = int((s_k != s_t).sum())
        print(f"exact raster [{fan}]: the kernel's sinf vs torch.sin on the "
              f"main case's {resid.numel()} residual bearings: {n_sin} "
              f"differ (max |diff| {float((s_k - s_t).abs().max())})")
        del resid, s_k, s_t
        ln = er._prepare(g_t, w)

        def launch():
            er._launch(g_t, ln, spec, cfg.grid)

        changed = _changed_cells(launch, g_t)
        t_kernel, t_plain, runs = _ab_ms(
            launch, lambda: er.beam_raster_plain(g_t, xy, yaw, db, tb, alive,
                                                 spec, cfg.grid), 20, 3)
        t_wrapper = _median_ms(lambda: er.beam_raster(
            g_t, xy, yaw, db, tb, alive, spec, cfg.grid), 20)
        t_device = device_ms(launch, 20, "exact_raster_kernel")
        # bounds: over the union of the windows; the operands read once;
        # the covered bound evaluates every window cell (no strips)
        evaluated = n * w.rows * w.cols
        bounds, n_bytes = _bounds(
            4, _covered_cells(w, size, dev), changed,
            _nbytes(ln.origins, ln.meta, ln.table), OPS_PER_CELL_EXACT,
            evaluated)
        text, out[fan] = _timed(worst, t_kernel, t_plain, runs, t_wrapper,
                                t_device, bounds, n_bytes, changed)
        print(f"exact raster [{fan}] at {n} agents x {spec.n_beams} beams "
              f"([{w.rows}, {w.cols}] windows) on {size}^2 [{card}]: {text}"
              f"; the kernel evaluates {_exact_box_cells(w, spec)} cells "
              f"(its boxes; the covered bound counts {evaluated})")
    return out


def phase_exact_entry(card, dev):
    """The exact raster's entry point (exact_raster_cuda.beam_raster, the
    counterpart of beam_raster_pallas; no engine path calls it) over
    EXACT_FRAMES frames per fan at 1024 agents, each frame sensed anew from
    the preset's start poses with fresh headings, one grid per fan, the
    counters set to 0 just before: one launch per frame and fan, and each
    map after its frames bit-equal to the plain version's over the same
    frames. Returns {fan: launches}."""
    from swarm_tpu_torch.ops import exact_raster_cuda as er

    fans = {}
    for i, four_way in enumerate((False, True)):
        cfg, params, rooms, spec = _exact_world(dev, four_way)
        gen = torch.Generator(device=dev).manual_seed(SEED + 70 + i)
        alive = torch.ones((cfg.n_agents,), dtype=torch.bool, device=dev)
        frames = [_raster_inputs(cfg, params, rooms, gen, dev, four_way)
                  for _ in range(EXACT_FRAMES)]
        fans[er.form_name(spec)] = (cfg, spec, alive, frames)
    grids = {fan: torch.zeros((c.grid.size,) * 2, device=dev)
             for fan, (c, *_) in fans.items()}
    torch.cuda.synchronize()
    _reset_counts()                          # the entry point starts here
    t0 = time.perf_counter()
    for k in range(EXACT_FRAMES):
        for fan, (cfg, spec, alive, frames) in fans.items():
            xy, yaw, db, tb = frames[k]
            er.beam_raster(grids[fan], xy, yaw, db, tb, alive, spec,
                           cfg.grid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_fan = dict(er.beam_raster.launches_by_form)
    n_free, _, n_room = _read_counts()
    if by_fan != {fan: EXACT_FRAMES for fan in fans} or n_free or n_room:
        raise AssertionError(f"exact raster entry: launches {by_fan}, "
                             f"window {n_free}, room {n_room}")
    for fan, (cfg, spec, alive, frames) in fans.items():
        g_p = torch.zeros_like(grids[fan])
        for xy, yaw, db, tb in frames:
            er.beam_raster_plain(g_p, xy, yaw, db, tb, alive, spec, cfg.grid)
        g = grids[fan]
        n_diff = int((g != g_p).sum())
        print(f"exact raster entry [{fan}] at {cfg.n_agents} agents "
              f"[{card}]: {EXACT_FRAMES} frames, launches {by_fan[fan]}, "
              f"{int((g < 0).sum())} free and {int((g > 0).sum())} occupied "
              f"cells; {n_diff} cells differ from the plain version over the "
              f"same frames; both fans' frames in {wall:.4f} s")
        if n_diff or not bool(torch.isfinite(g).all()) or \
                int((g != 0).sum()) == 0:
            raise AssertionError(f"exact raster entry [{fan}]: map wrong")
    return by_fan


def phase_grouped_flag_paths(card, dev):
    """Every grouped bench.py flag row (GROUPED_WINDOW_ROWS,
    GROUPED_ROOM_ROWS, then C1_ROW) through sim_rollout (`_flag_row`).
    Returns {(kernel, form key): launches} of the rows' own forms."""
    out = dict(_flag_row(card, dev, flags)
               for flags in GROUPED_WINDOW_ROWS + GROUPED_ROOM_ROWS)
    _flag_row(card, dev, C1_ROW)
    return out


# --------------------------------------------------------------------------
# the sharded engine (swarm_tpu_torch/parallel/) on one card

# the band and tile forms of the window kernel the sharded body reaches:
# (beams, groups, ring), as bench.py's flags reach them (BAND_ROWS)
BAND_FORMS = {"pack16-ring": (181, 181, True), "pack16": (181, 181, False),
              "pack16-ring-wrapped": (4, 4, True),
              "pack16-wrapped": (4, 4, False),
              "grouped-ring": (181, 8, True), "grouped": (181, 8, False),
              "grouped-ring-wrapped": (4, 2, True),
              "grouped-wrapped": (4, 2, False)}
# presets.deployable's arguments that make the sharded body launch each
# form (the body passes no pack8: pack16 per beam)
BAND_ROWS = {"pack16-ring": {}, "pack16": dict(exact_endpoints=True),
             "pack16-ring-wrapped": dict(scan_rays=0),
             "pack16-wrapped": dict(scan_rays=0, exact_endpoints=True),
             "grouped-ring": dict(beam_groups=8),
             "grouped": dict(beam_groups=8, exact_endpoints=True),
             "grouped-ring-wrapped": dict(beam_groups=2, scan_rays=0),
             "grouped-wrapped": dict(beam_groups=2, scan_rays=0,
                                     exact_endpoints=True)}
SHARDED_STEPS = 65           # four merge events (steps 15, 31, 47, 63)
SHARDED_FLAG_STEPS = 17
SHARDED_TIMEOUT_S = 600      # a collective waits at most this long


def _band_windows(dev):
    """The band and tile windows the sharded body gives its kernel, and
    their worlds. Returns ({kind: [(label, band, band_cols, agent slice,
    world name)]}, {world name: world}). First of each kind the main
    path's own window (one rank, presets.deployable(N_AGENTS): at 1024
    agents a 4096^2 grid, all agents): the band (0, size), and the tile
    window of a 1x1 rank grid, the whole grid plus its halo ring
    (negative offsets, the guard on every edge). Then each rank's window
    of a 4-rank "rows" layout (the 1024-row bands, 256 agents each) and of
    a 2x2 "tiles" layout on presets.tile_blocks(2, 2, size) (rooms in
    device-major order; [2112, 2304] windows, 256 agents each)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.parallel.mesh import RankLayout
    from swarm_tpu_torch.parallel.sharded import _tile_halo

    worlds = {"deployable": presets.deployable(N_AGENTS, device=dev)}
    size = worlds["deployable"][0].grid.size
    worlds["tile_blocks"] = presets.tile_blocks(2, 2, size, device=dev)

    def halo(world, r, c):
        return _tile_halo(worlds[world][0], RankLayout(
            world=r * c, rank=0, rows=r, cols=c, device=dev))

    _, _, h_r, h_c = halo("deployable", 1, 1)
    every = slice(0, N_AGENTS)
    n_loc = N_AGENTS // 4
    rows = [("1 rank", (0, size), None, every, "deployable")] + [
        (f"rank {r} of 4", (r * (size // 4), size // 4), None,
         slice(r * n_loc, (r + 1) * n_loc), "deployable") for r in range(4)]
    tiles = [("1 rank", (-h_r, size + 2 * h_r), (-h_c, size + 2 * h_c),
              every, "deployable")]
    wr, wc, h_r, h_c = halo("tile_blocks", 2, 2)
    t_loc = worlds["tile_blocks"][0].n_agents // 4
    tiles += [(f"rank {2 * tr + tc} of 2x2", (tr * wr - h_r, wr + 2 * h_r),
               (tc * wc - h_c, wc + 2 * h_c),
               slice((2 * tr + tc) * t_loc, (2 * tr + tc + 1) * t_loc),
               "tile_blocks") for tr in range(2) for tc in range(2)]
    return {"band": rows, "tile": tiles}, worlds


def phase_band_kernels(card, dev):
    """Each band and tile form (BAND_FORMS) of the window kernel against
    its plain version at the sharded body's shapes (`_band_windows`): the
    main path's one-rank windows (all 1024 agents on the band (0, 4096)
    and on the [4160, 4352] tile window of a 1x1 rank grid), each rank's
    window of a 4-rank "rows" and a 2x2 "tiles" layout (256 agents), noisy
    181-beam sweeps or 4-way readings, plus an overlap case (64 agents
    around one point of rank 1's window, pre-filled near +-clamp). Maps
    BIT-EQUAL, counts equal. Timed at the main path's one-rank windows:
    the launch on prepared operands, the wrapper, the plain version; the
    bound from this run's inputs. Returns {form key: record}."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec, reach_cells

    windows, worlds = _band_windows(dev)
    out = {}
    for kind in ("band", "tile"):
        for i, (form, (n_beams, n_groups, ring)) in enumerate(
                BAND_FORMS.items()):
            gen = torch.Generator(device=dev).manual_seed(SEED + 40 + i)
            four_way = n_beams == 4
            spec = BeamSpec.four_way() if four_way else BeamSpec.scan()
            inputs = {}
            for wn in sorted({w[-1] for w in windows[kind]}):
                cfg, _, params, rooms = worlds[wn]
                xy, yaw, db, tb = _raster_inputs(cfg, params, rooms, gen,
                                                 dev, four_way)
                inputs[wn] = (cfg, xy, yaw, db, tb if ring else None)
            tier = dict(pack8=False, n_groups=n_groups,
                        tail_weight=worlds["deployable"][0]
                        .engine.beam_tail_weight)

            def call(fn, g, wn, j, band, band_cols, xy=None):
                cfg, xy_w, yaw, db, tr = inputs[wn]
                xy = xy_w if xy is None else xy
                alive = torch.ones((yaw[j].shape[0],), dtype=torch.bool,
                                   device=dev)
                return fn(g, xy[j], yaw[j], db[j], alive,
                          None if tr is None else tr[j], spec, cfg.grid,
                          reach=reach_cells(cfg), band=band,
                          band_cols=band_cols, **tier)

            worst = 0.0
            for r, (label, band, band_cols, j, wn) in enumerate(
                    windows[kind]):
                cfg, xy = inputs[wn][:2]
                size = cfg.grid.size
                shape = (band[1], band_cols[1] if band_cols else size)
                cases = [(label, torch.zeros(shape, device=dev), j, None)]
                if r == 2:
                    # overlap: 64 of the rank's agents moved around the
                    # window's centre, in a window pre-filled near +-clamp
                    n_o = min(64, j.stop - j.start)
                    k = j.start + torch.arange(n_o, device=dev)
                    mid = [min(max(lo + n / 2.0, 0.0), size - 1.0)
                           for lo, n in (band_cols or (0, size), band)]
                    xy_o = xy.clone()
                    xy_o[k] = torch.tensor(mid, device=dev) * \
                        cfg.grid.resolution + 0.2 + (torch.rand(
                            (n_o, 2), generator=gen, device=dev) - 0.5) * 0.4
                    pre = _prefilled(max(shape), gen, dev)[:shape[0],
                                                           :shape[1]]
                    cases.append((f"{label}, overlap", pre.contiguous(), k,
                                  xy_o))
                for case, g0, jj, xs in cases:
                    g_k, g_p = g0.clone(), g0.clone()
                    _, c_k = call(bc.free_raster, g_k, wn, jj, band,
                                  band_cols, xs)
                    torch.cuda.synchronize()
                    _, c_p = call(bc.free_raster_plain, g_p, wn, jj, band,
                                  band_cols, xs)
                    torch.cuda.synchronize()
                    n_diff = _n_differ(g_k, g_p)
                    worst = max(worst, float((g_k - g_p).abs().max()))
                    n_ag = c_k.numel()
                    print(f"{form}-{kind} kernel vs plain [{case}, window "
                          f"{band}, {band_cols}, {n_ag} agents]: "
                          f"{n_diff} of {g0.numel()} cells differ, "
                          f"{int((g_k != g0).sum())} cells changed, counts "
                          f"sum {float(c_k.sum())} vs {float(c_p.sum())}")
                    if n_diff or not torch.equal(c_k, c_p):
                        raise AssertionError(f"{form}-{kind}: kernel and "
                                             f"plain differ [{case}]")
                    if float(c_k.sum()) <= 0:
                        raise AssertionError(f"{form}-{kind}: nothing "
                                             f"painted [{case}]")

            # timed at the main path's window (one rank, every agent)
            _, band, band_cols, j, wn = windows[kind][0]
            cfg, xy, yaw, db, tr = inputs[wn]
            shape = (band[1], band_cols[1] if band_cols else cfg.grid.size)
            g_t = torch.zeros(shape, device=dev)
            alive = torch.ones((j.stop - j.start,), dtype=torch.bool,
                               device=dev)
            reach = reach_cells(cfg)
            w = bc._windows(g_t, xy[j], yaw[j], db[j], alive, spec,
                            cfg.grid, None if tr is None else tr[j], reach,
                            band=band, band_cols=band_cols, **tier)
            ln = bc._prepare(g_t, w, spec)
            dense = bc._dense_fan(spec, reach)

            def launch():
                bc._launch(g_t, ln, spec, cfg.grid, dense)

            changed = _changed_cells(launch, g_t)
            t_kernel, t_plain, runs = _ab_ms(
                launch, lambda: call(bc.free_raster_plain, g_t, wn, j, band,
                                     band_cols), 20, 3)
            t_wrapper = _median_ms(
                lambda: call(bc.free_raster, g_t, wn, j, band, band_cols),
                20)
            t_device = device_ms(launch, 20, "free_raster_kernel")
            evaluated = int(((w.t_ch - w.t_cl).clamp_min(0) * w.rows *
                             128).sum())
            bounds, n_bytes = _bounds(
                4, _covered_cells(w, shape[0], dev, shape[1]), changed,
                _nbytes(ln.origins, ln.meta, ln.table) + 4 * w.row0.numel(),
                OPS_PER_CELL, evaluated)
            key = bc.form_name(spec, False, ring, grouped=w.kind ==
                               "grouped", window=kind)
            text, out[key] = _timed(worst, t_kernel, t_plain, runs,
                                    t_wrapper, t_device, bounds, n_bytes,
                                    changed)
            print(f"{key} raster at {w.row0.numel()} agents x "
                  f"{spec.n_beams} beams ([{w.rows}, {w.cols}] windows on "
                  f"a {list(shape)} {kind} window) [{card}]: {text}; the "
                  f"kernel evaluates {_box_cells(w, spec)} cells (its "
                  f"boxes; the covered bound counts {evaluated})")
    return out


def _sharded_run(dev, grid_sharding: str, flags=None, eng=None,
                 n_agents: int | None = None):
    """(cfg, step, this rank's state, layout) of the sharded engine on one
    rank at `n_agents` agents (N_AGENTS when None; presets.deployable's
    world with `flags`, then the EngineConfig fields `eng` replaced)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import sim_init
    from swarm_tpu_torch.parallel import mesh, sharded

    cfg, walls, params, rooms = presets.deployable(
        N_AGENTS if n_agents is None else n_agents, device=dev,
        **(flags or {}))
    if eng:
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, **eng))
    lay = mesh.make_layout((1, 1), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = sharded.make_sharded_sim_step(
        cfg, walls, params, lay, gen, grid_sharding=grid_sharding,
        walls_grouped=rooms[0], room_of_agent=rooms[1])
    return cfg, step, sharded.shard_state(sim_init(cfg, params), lay,
                                          grid_sharding), lay


def _captured_step(step, state):
    """One more sharded step with the window wrapper's calls recorded:
    (state, [(args, kwargs)]), each input cloned as it was passed."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc

    calls, real = [], bc.free_raster

    def record(*a, **kw):
        calls.append(([x.clone() if isinstance(x, torch.Tensor) else x
                       for x in a], dict(kw)))
        # the wrapper counts on its module's own name: put it back while
        # it runs
        bc.free_raster = real
        try:
            return real(*a, **kw)
        finally:
            bc.free_raster = record

    bc.free_raster = record
    try:
        state, _ = step(state)
    finally:
        bc.free_raster = real
    torch.cuda.synchronize()
    return state, calls


def _window_witness(name, calls, size):
    """The fans of one captured sharded step (`_captured_step`) raster
    again, in their band or tile window and on the whole [size, size] grid
    from the same inputs, by the kernel and by its plain version: the
    kernel BIT-EQUAL to the plain version in both, counts equal. Returns
    the cells in which the window's core and the whole grid differ (the
    same in the kernel and the plain version, or it raises): the float
    shift of ROADMAP C22 where the window's offsets are not 0."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc

    band, band_cols = calls[0][1]["band"], calls[0][1]["band_cols"]
    r0, c0 = -band[0], -(band_cols or (0, size))[0]
    res = {}
    for side, fn in (("kernel", bc.free_raster),
                     ("plain", bc.free_raster_plain)):
        win = torch.zeros_like(calls[0][0][0])
        whole = torch.zeros((size, size), device=win.device)
        c_win, c_whole = [], []
        for a, kw in calls:
            win, c = fn(win, *a[1:], **kw)
            c_win.append(c)
            whole, c = fn(whole, *a[1:], **dict(kw, band=None,
                                                band_cols=None))
            c_whole.append(c)
        torch.cuda.synchronize()
        res[side] = (win, whole, torch.stack(c_win), torch.stack(c_whole))
    (wk, ak, cwk, cak), (wp, ap, cwp, cap) = res["kernel"], res["plain"]
    n_win, n_whole = int((wk != wp).sum()), int((ak != ap).sum())
    core_k = wk[r0:r0 + size, c0:c0 + size]
    core_p = wp[r0:r0 + size, c0:c0 + size]
    shift_k, shift_p = core_k != ak, core_p != ap
    n_shift = int(shift_k.sum())
    print(f"{name}: one captured step's {len(calls)} fan(s) in the window "
          f"{band}, {band_cols}: kernel vs plain {n_win} of {wk.numel()} "
          f"cells differ (whole grid: {n_whole} of {ak.numel()}), counts "
          f"equal {torch.equal(cwk, cwp) and torch.equal(cak, cap)}; "
          f"window core vs whole grid: {n_shift} cells differ in the "
          f"kernel, {int(shift_p.sum())} in the plain version (same cells "
          f"{torch.equal(shift_k, shift_p)}), painted counts "
          f"{float(cwk.sum())} vs {float(cak.sum())}")
    if n_win or n_whole or not torch.equal(cwk, cwp) or \
            not torch.equal(cak, cap) or not torch.equal(shift_k, shift_p):
        raise AssertionError(f"{name}: the kernel and its plain version "
                             "differ at the sharded step's window")
    return n_shift


def phase_sharded_path(card, dev, grid_sharding: str):
    """The sharded engine at world size 1 on NCCL, at N_AGENTS agents on
    presets.deployable's world and config (f32 grid, ring on, merge every
    16; the body rasters pack16): the counters set to 0, one warm-up step
    and SHARDED_STEPS timed steps, the counters read: exactly one launch
    per step of the decomposition's form (`pack16-ring`, `-band` on "rows",
    `-tile` on "tiles") and no other, every step writes, merges > 0, all
    agents online, no band escape, poses finite; steps/s, peak memory.
    Then SPLIT_STEPS more steps split on the device timeline into
    sensing, raster, merge, zones, collectives and the rest, and on "rows"
    and "tiles" one more step whose raster inputs `_window_witness` runs
    again at the path's own window (kernel BIT-EQUAL to plain; the band
    (0, size) equal to the whole grid). Returns (launches, the global
    state after the timed steps, summary)."""
    from swarm_tpu_torch.engine.sim import total_writes_value
    from swarm_tpu_torch.parallel import sharded

    cfg, step, state, lay = _sharded_run(dev, grid_sharding)
    every = cfg.engine.merge_every
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                          # the path starts here
    state, m0 = step(state)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(SHARDED_STEPS + 1)]
    ms = []
    t0 = time.perf_counter()
    events[0].record()
    for k in range(SHARDED_STEPS):
        state, m = step(state)
        events[k + 1].record()
        ms.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_free, by_form, n_room = _read_counts()
    steps_run = SHARDED_STEPS + 1
    want = "pack16-ring" + {"replicated": "", "rows": "-band",
                            "tiles": "-tile"}[grid_sharding]
    name = f"sharded {grid_sharding}"
    writes = torch.stack([m0.writes] + [m.writes for m in ms]).cpu()
    online = torch.stack([m.online for m in ms]).cpu()
    merges = torch.stack([m0.merges] + [m.merges for m in ms]).cpu()
    escapes = torch.stack([m0.band_escapes] +
                          [m.band_escapes for m in ms]).cpu()
    if by_form != {want: steps_run} or n_free != steps_run or n_room:
        raise AssertionError(f"{name}: launches {by_form}, room {n_room} "
                             f"in {steps_run} steps")
    if not bool((writes > 0).all()):
        raise AssertionError(f"{name}: a step wrote no cells")
    if int(merges.sum()) <= 0 or not bool((online == N_AGENTS).all()):
        raise AssertionError(f"{name}: merges {merges.tolist()}, online "
                             f"{online.tolist()[:8]}")
    if int(escapes.sum()) or not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError(f"{name}: band escapes {escapes.tolist()} or "
                             f"non-finite poses")
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(events[k].elapsed_time(events[k + 1])
                     for k in range(SHARDED_STEPS))
    merge_steps = [k for k in range(steps_run) if k % every == every - 1]
    applied = int(writes.to(torch.int64).sum())
    print(f"{name} at {N_AGENTS} agents on one rank (NCCL) [{card}]: "
          f"{steps_run} steps, launches {by_form}, online {N_AGENTS} on "
          f"every timed step, min writes {int(writes.min())}, merges "
          f"{[int(merges[k]) for k in merge_steps]} at steps {merge_steps},"
          f" band escapes 0, poses finite; {SHARDED_STEPS / wall:.2f} "
          f"steps/s, {applied} applied cells, device step median "
          f"{step_ms[len(step_ms) // 2]:.4f} ms, peak memory {peak} bytes")
    full = sharded.gather_state(state, lay, grid_sharding)
    full = full._replace(srv=full.srv._replace(
        logodds=full.srv.logodds.clone()))
    state, split = _step_split(step, state, SPLIT_STEPS, _sharded_parts())
    print(f"{name} step split [{card}], device-timeline medians over "
          f"{SPLIT_STEPS} more steps (ms): " + ", ".join(
              f"{p} {t:.4f} (n={k})" for p, (t, k, _) in split.items()))
    summary = dict(steps_s=SHARDED_STEPS / wall, peak=peak,
                   writes=total_writes_value(full.srv.total_writes))
    if grid_sharding != "replicated":
        # the kernel at this path's own window, on one step's inputs
        state, calls = _captured_step(step, state)
        summary["shift_cells"] = _window_witness(name, calls,
                                                 cfg.grid.size)
        if grid_sharding == "rows" and summary["shift_cells"]:
            raise AssertionError("the band (0, size) differs from the "
                                 "whole grid")
        del calls
    return steps_run, full, summary


def phase_sharded(card, dev):
    """The sharded engine on one card: a one-rank NCCL group, the three
    decompositions (`phase_sharded_path`), "rows" held BIT-EQUAL to
    "replicated" (maps, writes, poses) and "tiles" compared with it
    (bit-equal, or the differing cells counted: poses equal, tri-state
    decisions differing in at most 1e-4 of the explored cells, applied
    cells within 1e-5; the float shift of ROADMAP C22); then every
    other band and tile form through the sharded body's flag rows
    (BAND_ROWS), SHARDED_FLAG_STEPS steps each, exactly its form launched
    once per step. Returns {form key: launches}."""
    from datetime import timedelta

    import torch.distributed as dist

    from swarm_tpu_torch.config import GridConfig
    from swarm_tpu_torch.ops.raster import tri_state_view
    from swarm_tpu_torch.parallel import mesh

    port = mesh.free_port()
    mesh.init(f"tcp://127.0.0.1:{port}", 1, 0,
              timedelta(seconds=SHARDED_TIMEOUT_S), device=dev)
    print(f"process group: {dist.get_backend()}, world size "
          f"{dist.get_world_size()}")
    if dist.get_backend() != "nccl":
        raise AssertionError("the card's process group is not NCCL")
    try:
        launches, full, summary = {}, {}, {}
        for gs in ("replicated", "rows", "tiles"):
            n, full[gs], summary[gs] = phase_sharded_path(card, dev, gs)
            if gs != "replicated":
                launches[f"pack16-ring-{'band' if gs == 'rows' else 'tile'}"
                         ] = n
            torch.cuda.empty_cache()
        ref = full["replicated"]
        for gs in ("rows", "tiles"):
            got = full[gs]
            n_diff = int((got.srv.logodds != ref.srv.logodds).sum())
            same_poses = torch.equal(got.pose_true, ref.pose_true)
            same_writes = torch.equal(got.srv.total_writes,
                                      ref.srv.total_writes)
            print(f"sharded {gs} vs replicated after "
                  f"{SHARDED_STEPS + 1} steps: {n_diff} of "
                  f"{ref.srv.logodds.numel()} cells differ, writes equal "
                  f"{same_writes}, poses equal {same_poses}")
            if gs == "rows" and (n_diff or not same_poses or
                                 not same_writes):
                raise AssertionError("sharded rows is not bit-equal to "
                                     "replicated")
            if gs == "tiles" and n_diff:
                # the float shift (ROADMAP C22), which the captured step
                # shows in the plain version as in the kernel: a few cells
                # on carve and ring edges, far below these bars
                cfg_g = GridConfig(size=ref.srv.logodds.shape[0])
                t_g = tri_state_view(got.srv.logodds, cfg_g)
                t_r = tri_state_view(ref.srv.logodds, cfg_g)
                explored = (t_g != cfg_g.unknown) | (t_r != cfg_g.unknown)
                n_dec = int((t_g != t_r).sum())
                n_exp = max(int(explored.sum()), 1)
                w_g, w_r = summary["tiles"]["writes"], \
                    summary["replicated"]["writes"]
                print(f"sharded tiles vs replicated: {n_dec} tri-state "
                      f"decisions differ of {n_exp} explored cells "
                      f"({n_dec / n_exp:.3e}), applied cells {w_g} vs "
                      f"{w_r} ({abs(w_g - w_r) / w_r:.3e}); the captured "
                      f"step's shift: {summary['tiles']['shift_cells']} "
                      f"cells")
                if n_dec > 1e-4 * n_exp or abs(w_g - w_r) > 1e-5 * w_r or \
                        not same_poses:
                    raise AssertionError("sharded tiles diverges from "
                                         "replicated")
        del full, ref
        for form, flags in BAND_ROWS.items():
            for gs, kind in (("rows", "band"), ("tiles", "tile")):
                key = f"{form}-{kind}"
                if key in launches:
                    continue
                launches[key] = _sharded_flag_row(card, dev, gs, key, flags)
    finally:
        dist.destroy_process_group()
    return launches


def _sharded_flag_row(card, dev, grid_sharding, key, flags):
    """SHARDED_FLAG_STEPS sharded steps on one rank with bench.py flags
    `flags`: exactly the form `key` launched once per step, every step
    writes, no band escape, poses finite. Returns its launches."""
    _, step, state, _ = _sharded_run(dev, grid_sharding, flags)
    torch.cuda.synchronize()
    _reset_counts()                          # this path starts here
    ms = []
    for _ in range(SHARDED_FLAG_STEPS):
        state, m = step(state)
        ms.append(m)
    torch.cuda.synchronize()
    n_free, by_form, n_room = _read_counts()
    writes = torch.stack([m.writes for m in ms]).cpu()
    esc = int(torch.stack([m.band_escapes for m in ms]).sum())
    print(f"sharded {grid_sharding} flags [{_flags(flags)}] at {N_AGENTS} "
          f"agents [{card}]: launches {by_form}, room {n_room}, min writes "
          f"{int(writes.min())}, band escapes {esc}")
    if by_form != {key: SHARDED_FLAG_STEPS} or n_room or esc or \
            not bool((writes > 0).all()) or \
            not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError(f"sharded {grid_sharding} [{_flags(flags)}]: "
                             f"launches {by_form}")
    return by_form[key]


def phase_dryrun(card, expect=()):
    """parallel/dryrun.py at world size 1 on the card, as its own process
    (`python -m swarm_tpu_torch.parallel.dryrun`): two steps of each tier
    in each decomposition, rows bit-equal to replicated; each text of
    `expect` must be in its output."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "swarm_tpu_torch.parallel.dryrun",
         "--timeout", "300"], cwd=here, capture_output=True, text=True,
        timeout=600)
    print(out.stdout.strip())
    if out.returncode != 0 or "dryrun ok (1 ranks)" not in out.stdout or \
            any(e not in out.stdout for e in expect):
        raise AssertionError(f"parallel/dryrun.py failed:\n"
                             f"{out.stderr[-3000:]}")
    print(f"parallel/dryrun.py on the card [{card}]: "
          f"{time.perf_counter() - t0:.2f} s")

# every raster mode of the fused engine: the untiled world's rows
# (bench.py --raster line, --no-pallas), the profiling mode, the parity
# path, the swarm preset and the yaw-rate bias; no raster kernel runs on
# these paths (the XLA tier, the line and the parity rasters are torch)

UNTILED_STEPS = 65           # four merge events (steps 15, 31, 47, 63)
OFF_STEPS = 17
DUAL_BOT_STEPS = 200         # run_session --preset dual_bot --steps 200
PARITY_STEPS = 33
SWARM_AGENTS = 64            # __graft_entry__.entry()'s swarm
SWARM_STEPS = 201
BIAS_STEPS = 33              # two merge events (steps 15, 31)
UNTILED_ROWS = {
    "--raster line": dict(raster_mode="line"),
    "--no-pallas": dict(raster_mode="beam"),
    "--no-pallas --grid-dtype bfloat16": dict(raster_mode="beam",
                                              grid_dtype="bfloat16")}


def _kernel_launches() -> dict:
    from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
    from swarm_tpu_torch.ops.exact_raster_cuda import beam_raster
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster

    return {"free_raster": free_raster.launches,
            "room_raster": room_raster.launches,
            "exact_raster": beam_raster.launches}


def _run_steps(step, state, n_steps: int):
    """n_steps of `step` with a CUDA event after each. Returns (state, the
    metrics per step, wall seconds, device step times in ms)."""
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(n_steps + 1)]
    ms = []
    t0 = time.perf_counter()
    events[0].record()
    for k in range(n_steps):
        state, m = step(state)
        events[k + 1].record()
        ms.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, ms, wall, [events[k].elapsed_time(events[k + 1])
                             for k in range(n_steps)]


def _stacked(ms, field):
    return torch.stack([getattr(m, field) for m in ms]).cpu()


def _check_path(name, n, ms, state, writes=True, kernels=False):
    """A path's run: no raster kernel launched (unless `kernels`), every
    step writing (none with writes=False), all n agents online, poses
    finite. Returns (writes, merges) per step on the host."""
    w, online = _stacked(ms, "writes"), _stacked(ms, "online")
    launches = _kernel_launches()
    if not kernels and any(launches.values()):
        raise AssertionError(f"{name}: raster kernels launched {launches}")
    if writes and not bool((w > 0).all()):
        raise AssertionError(f"{name}: a step wrote no cells")
    if not writes and bool(w.any()):
        raise AssertionError(f"{name}: writes {w.tolist()}")
    if not bool((online == n).all()):
        raise AssertionError(f"{name}: online {online.tolist()[:8]}")
    if not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError(f"{name}: non-finite poses")
    return w, _stacked(ms, "merges")


def _world_step(cfg, walls, params, rooms, dev):
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init

    gen = torch.Generator(device=dev).manual_seed(SEED)
    return sim_init(cfg, params), make_sim_step(
        cfg, walls, params, gen, walls_grouped=rooms[0],
        room_of_agent=rooms[1])


def _split_text(split) -> str:
    return ", ".join(f"{p} {t:.4f} (n={k}" + (
        "" if peak is None else f", peak {peak} bytes") + ")"
        for p, (t, k, peak) in split.items())


def phase_untiled(card, dev):
    """bench.py's untiled rows at N_AGENTS agents (presets.untiled: the
    3840^2 world, 512 rooms): --raster line, --no-pallas and --no-pallas
    --grid-dtype bfloat16. Each: a warm-up step (step 0), every counter
    set to 0, UNTILED_STEPS steps (merges at 15, 31, 47, 63), the counters
    read: no raster kernel launched, every step writes, merges at every
    event, all agents online, poses finite; steps/s, applied cells/s (the
    XLA tier's count is free plus occupied cells, ROADMAP C18), peak memory,
    the ordered add's deepest layer; then SPLIT_STEPS more steps split on
    the device timeline. Returns per row its device step median without a
    merge (ms)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.ops.raster import ordered_add

    out = {}
    for row, kw in UNTILED_ROWS.items():
        name = f"untiled {row}"
        cfg, walls, params, rooms = presets.untiled(N_AGENTS, device=dev,
                                                    **kw)
        every = cfg.engine.merge_every
        state, step = _world_step(cfg, walls, params, rooms, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_set = time.perf_counter()
        state, _ = step(state)               # warm-up: step 0
        torch.cuda.synchronize()
        t_set = time.perf_counter() - t_set
        _reset_counts()                      # this path starts here
        ordered_add.deepest = 0
        state, ms, wall, step_ms = _run_steps(step, state, UNTILED_STEPS)
        writes, merges = _check_path(name, N_AGENTS, ms, state)
        merge_steps = [k for k in range(1, UNTILED_STEPS + 1)
                       if k % every == every - 1]
        on = [int(merges[k - 1]) for k in merge_steps]
        if not all(x > 0 for x in on):
            raise AssertionError(f"{name}: merges {merges.tolist()}")
        applied = int(writes.to(torch.int64).sum())
        peak = torch.cuda.max_memory_allocated()
        off = [t for k, t in enumerate(step_ms, 1) if k not in merge_steps]
        print(f"{name}: {UNTILED_STEPS} steps at {N_AGENTS} agents on "
              f"{cfg.grid.size}^2 after a warm-up ({t_set:.2f} s): raster "
              f"kernels {_kernel_launches()}, min writes "
              f"{int(writes.min())}, merges {on} at steps {merge_steps}, "
              f"online {N_AGENTS}/{N_AGENTS}, poses finite; the ordered "
              f"add's deepest layer {ordered_add.deepest}")
        print(f"{name} [{card}]: {UNTILED_STEPS / wall:.4f} steps/s, "
              f"{applied / wall:.6e} applied cells/s ({applied} cells in "
              f"{wall:.4f} s), peak memory {peak} bytes; device step "
              f"median {_median(off):.4f} ms without a merge, "
              f"{_median([step_ms[k - 1] for k in merge_steps]):.4f} ms "
              f"with one")
        state, split = _step_split(step, state, SPLIT_STEPS)
        print(f"{name} step split [{card}], device-timeline medians over "
              f"{SPLIT_STEPS} more steps (ms): {_split_text(split)}; raster "
              f"share of the device step "
              f"{split['raster'][0] / split['step'][0]:.4f}")
        out[row] = _median(off)
        del state, step, ms
        torch.cuda.empty_cache()
    return out


def phase_profiling(card, dev, untiled_ms):
    """The profiling mode (raster_mode="off") on the untiled world at
    N_AGENTS agents, OFF_STEPS steps after a warm-up: writes 0 on every
    step, the int8 grid and the log-odds bit-unchanged, no raster kernel;
    steps/s, and each untiled row's raster share as one less the ratio of
    the device step medians without a merge."""
    from swarm_tpu_torch import presets

    cfg, walls, params, rooms = presets.untiled(N_AGENTS, raster_mode="off",
                                                device=dev)
    state, step = _world_step(cfg, walls, params, rooms, dev)
    state, _ = step(state)                   # warm-up: step 0
    grid0 = state.srv.grid.clone()
    lo0 = state.srv.logodds.clone()
    torch.cuda.synchronize()
    _reset_counts()                          # this path starts here
    state, ms, wall, step_ms = _run_steps(step, state, OFF_STEPS)
    _check_path("profiling mode", N_AGENTS, ms, state, writes=False)
    if not (torch.equal(state.srv.grid, grid0) and torch.equal(
            state.srv.logodds.view(torch.int32), lo0.view(torch.int32))):
        raise AssertionError("profiling mode: the maps changed")
    every = cfg.engine.merge_every
    off = _median([t for k, t in enumerate(step_ms, 1)
                   if k % every != every - 1])
    print(f"profiling mode at {N_AGENTS} agents [{card}]: {OFF_STEPS} steps, "
          f"writes 0, grid and log-odds bit-unchanged, "
          f"{OFF_STEPS / wall:.4f} steps/s, device step median {off:.4f} ms "
          f"without a merge; the raster's share of each untiled row's step "
          + ", ".join(f"{row} {1 - off / t:.4f} (step {t:.4f} ms)"
                      for row, t in untiled_ms.items()))
    del state, step, ms, grid0, lo0
    torch.cuda.empty_cache()


def phase_parity(card, dev):
    """The reference-parity path: presets.dual_bot() for DUAL_BOT_STEPS
    steps (the verify recipe's bar: more than 500 FREE and 20 OCCUPIED
    cells, both agents online; closures printed), then the untiled world
    at N_AGENTS agents in parity mode without a sweep
    (`_cfg_and_world(1024, parity=True)`) for PARITY_STEPS steps and a
    SPLIT_STEPS split (the sequential closure's device time). No raster
    kernel; the log-odds stay zero."""
    from swarm_tpu_torch import presets

    cfg, walls, params, rooms = presets.dual_bot(device=dev)
    state, step = _world_step(cfg, walls, params, rooms, dev)
    torch.cuda.synchronize()
    _reset_counts()                          # this path starts here
    state, ms, wall, _ = _run_steps(step, state, DUAL_BOT_STEPS)
    _check_path("dual_bot", 2, ms[1:], state)
    g = cfg.grid
    free = int((state.srv.grid == g.free).sum())
    occ = int((state.srv.grid == g.occupied).sum())
    closures = int(_stacked(ms, "closures").sum())
    writes = int(_stacked(ms, "writes").to(torch.int64).sum())
    print(f"dual_bot [{card}]: {DUAL_BOT_STEPS} steps, {wall:.4f} s "
          f"({DUAL_BOT_STEPS / wall:.2f} steps/s), FREE {free}, OCCUPIED "
          f"{occ} cells, {writes} cell writes, {closures} closures, online "
          f"2/2, raster kernels {_kernel_launches()}")
    if free <= 500 or occ <= 20 or bool(state.srv.logodds.any()):
        raise AssertionError(f"dual_bot: FREE {free}, OCCUPIED {occ}")

    cfg, walls, params, rooms = presets.untiled(
        N_AGENTS, raster_mode="line", scan_rays=0, device=dev)
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                 parity_mode=True))
    state, step = _world_step(cfg, walls, params, rooms, dev)
    state, _ = step(state)                   # warm-up: step 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                          # this path starts here
    state, ms, wall, step_ms = _run_steps(step, state, PARITY_STEPS)
    writes, _ = _check_path("untiled parity", N_AGENTS, ms, state)
    closures = int(_stacked(ms, "closures").sum())
    print(f"untiled parity mode at {N_AGENTS} agents [{card}]: "
          f"{PARITY_STEPS} steps, {PARITY_STEPS / wall:.4f} steps/s, min "
          f"writes {int(writes.min())}, {closures} closures, device step "
          f"median {_median(step_ms):.4f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated()} bytes, raster kernels "
          f"{_kernel_launches()}")
    if bool(state.srv.logodds.any()):
        raise AssertionError("untiled parity: the log-odds changed")
    state, split = _step_split(step, state, SPLIT_STEPS)
    print(f"untiled parity mode step split [{card}] (ms): "
          f"{_split_text(split)}; the sequential closure "
          f"{split['closure'][0]:.4f} ms a step")
    del state, step, ms
    torch.cuda.empty_cache()


def phase_swarm(card, dev):
    """`run_session --preset swarm` at SWARM_AGENTS agents
    (`__graft_entry__.entry()`'s world; presets.swarm): SWARM_STEPS steps
    of the line raster of the 4-way ultrasonics, no raster kernel, every
    step writes, all agents online, poses finite."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.ops.raster import ordered_add

    cfg, walls, params, rooms = presets.swarm(SWARM_AGENTS, device=dev)
    state, step = _world_step(cfg, walls, params, rooms, dev)
    torch.cuda.synchronize()
    _reset_counts()                          # this path starts here
    ordered_add.deepest = 0
    state, ms, wall, step_ms = _run_steps(step, state, SWARM_STEPS)
    writes, _ = _check_path("swarm", SWARM_AGENTS, ms[1:], state)
    print(f"swarm preset at {SWARM_AGENTS} agents [{card}]: {SWARM_STEPS} "
          f"steps, {SWARM_STEPS / wall:.4f} steps/s, device step median "
          f"{_median(step_ms):.4f} ms, {int(writes.sum())} cell writes, "
          f"the ordered add's deepest layer {ordered_add.deepest}, raster "
          f"kernels {_kernel_launches()}")


def phase_bias(card, dev):
    """The yaw-rate bias (merge_bias_alpha=0.1) on presets.deployable at
    N_AGENTS agents for BIAS_STEPS steps (merges at 15 and 31): the window
    kernel once per step, every step writes, merges at both events, the
    estimate finite everywhere and nonzero for some agent after them."""
    from swarm_tpu_torch import presets

    cfg, walls, params, rooms = presets.deployable(N_AGENTS, device=dev)
    cfg = cfg.replace(slam=dataclasses.replace(cfg.slam,
                                               merge_bias_alpha=0.1))
    state, step = _world_step(cfg, walls, params, rooms, dev)
    torch.cuda.synchronize()
    _reset_counts()                          # this path starts here
    state, ms, wall, _ = _run_steps(step, state, BIAS_STEPS)
    _, by_form, n_room = _read_counts()
    _check_path("bias", N_AGENTS, ms[1:], state, kernels=True)
    merges = _stacked(ms, "merges")
    rate = state.srv.merge_yaw_rate
    n_rate = int((rate != 0).sum())
    print(f"yaw-rate bias at {N_AGENTS} agents [{card}]: {BIAS_STEPS} steps, "
          f"{BIAS_STEPS / wall:.4f} steps/s, launches {by_form}, room "
          f"{n_room}, merges {int(merges[15])} and {int(merges[31])}, "
          f"{n_rate} agents with a rate, max |rate| "
          f"{float(rate.abs().max()):.6e} rad/m, max |mark| "
          f"{float(state.srv.merge_dist_mark.abs().max()):.4f} m")
    if by_form != {"pack8-ring": BIAS_STEPS} or n_room or \
            not (int(merges[15]) > 0 and int(merges[31]) > 0):
        raise AssertionError(f"bias: launches {by_form}, merges "
                             f"{merges.tolist()}")
    if not bool(torch.isfinite(rate).all()) or n_rate == 0:
        raise AssertionError("bias: the estimate is not finite or is zero")
    del state, step, ms
    torch.cuda.empty_cache()


def _bit_differ(a, b) -> int:
    """Cells whose bits differ (a -0.0 against a +0.0 counts), a NaN
    against a NaN counting as equal whatever their payloads (the card's
    arithmetic returns its canonical NaN)."""
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    differ = a.view(view) != b.view(view)
    if a.is_floating_point():
        differ = (differ & ~(torch.isnan(a) & torch.isnan(b))) | (
            torch.isnan(a) != torch.isnan(b))
    return int(differ.sum())


def phase_card_vs_cpu(card, dev):
    """One call each, on the card and on the CPU, on the same inputs at the
    untiled world's 1024-agent shapes (homes, random headings, noisy 4-way
    and sweep readings against each agent's room): `parity_raster` and the
    line raster (`logodds_raster`) on the step's ordered rays, and
    `ordered_add` on the XLA tier's own patch deltas (on a grid with -0.0
    and NaN cells), each BIT-EQUAL (a NaN equal to a NaN); the XLA tier (`beam_raster_reference`,
    both fans, float32 and bfloat16) decision-equal (cells differing by
    more than 1e-6 at most 0.01% of the painted cells, writes within the
    same bar); the line raster and the XLA tier run twice on the card,
    bit-identical."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch._device import recip32
    from swarm_tpu_torch.engine import sim
    from swarm_tpu_torch.models.scan import sense_scan
    from swarm_tpu_torch.models.sensors import draw_sensor_noise, sense_4way
    from swarm_tpu_torch.ops import beam_raster as br
    from swarm_tpu_torch.ops import raster

    cpu = torch.device("cpu")
    cfg, walls, params, rooms = presets.untiled(N_AGENTS, raster_mode="beam",
                                                device=dev)
    sens, size = cfg.sensors, cfg.grid.size
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    n, r = cfg.n_agents, cfg.engine.scan_rays
    yaw = (torch.rand((n,), generator=gen, device=dev) * 2 - 1) * torch.pi
    pose = torch.stack([params.home_x, params.home_y, yaw], -1)
    wa = rooms[0][rooms[1].long()]
    dist4 = sense_4way(draw_sensor_noise(gen, (n, 4), dev), pose, wa, sens)
    scan = sense_scan(draw_sensor_noise(gen, (n, r), dev), pose, wa, r, sens)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    rx, ry = pose[:, 0], pose[:, 1]
    hv = (dist4 > sens.min_range) & (dist4 <= sens.max_range)
    rng = torch.where(hv, dist4, torch.full_like(dist4, sens.max_range))
    ang = yaw[:, None] + torch.tensor(sens.angles, device=dev)[None, :]
    rays = sim._line_rays(rx, ry, yaw, rx[:, None] + rng * torch.cos(ang),
                          ry[:, None] + rng * torch.sin(ang), hv, alive,
                          scan, cfg)
    rays_c = type(rays)(*(x.cpu() for x in rays))

    grid0 = torch.tensor([cfg.grid.unknown, cfg.grid.free,
                          cfg.grid.occupied], dtype=torch.int8,
                         device=dev)[torch.randint(0, 3, (size, size),
                                                   generator=gen,
                                                   device=dev)]
    g_d, w_d = raster.parity_raster(grid0.clone(), rays, cfg.grid)
    g_c, w_c = raster.parity_raster(grid0.cpu(), rays_c, cfg.grid)
    n_par = _bit_differ(g_d.cpu(), g_c)
    print(f"card vs CPU [{card}]: parity_raster on {rays.ox.numel()} rays: "
          f"{n_par} of {size * size} cells differ, writes {int(w_d)} vs "
          f"{int(w_c)}")

    lo0 = (torch.rand((size, size), generator=gen, device=dev) * 2 - 1) \
        * 9.9
    outs = []
    for _ in range(2):
        raster.ordered_add.deepest = 0
        outs.append(raster.logodds_raster(lo0.clone(), rays, cfg.grid))
    depth = raster.ordered_add.deepest
    l_c, lw_c = raster.logodds_raster(lo0.cpu(), rays_c, cfg.grid)
    n_line = _bit_differ(outs[0][0].cpu(), l_c)
    n_line2 = _bit_differ(outs[0][0], outs[1][0])
    print(f"card vs CPU [{card}]: logodds_raster (the line raster): "
          f"{n_line} of {size * size} cells differ, writes "
          f"{int(outs[0][1])} vs {int(lw_c)}; run twice on the card "
          f"{n_line2} cells differ; the ordered add's deepest layer "
          f"{depth}")

    # the ordered add on the XLA tier's own deltas (the first patch chunk)
    inv = recip32(cfg.grid.resolution)
    ax = (rx - cfg.grid.origin_x) * inv
    ay = (ry - cfg.grid.origin_y) * inv
    db, tb = br.beams_from_scan(scan, sens.max_range, sens.min_range)
    pr, pc = br.patch_dims(size, br.reach_cells(cfg))
    row0, col0 = br.patch_origin(ax, ay, size, pr, pc, br.reach_cells(cfg))
    m = min(n, br.PATCH_CHUNK_CELLS // (pr * pc))
    delta, _, _ = br._patch_delta(ax[:m], ay[:m], yaw[:m], db[:m] * inv,
                                  tb[:m], row0[:m], col0[:m],
                                  br.BeamSpec.scan(r), cfg.grid.logodds_hit,
                                  cfg.grid.logodds_miss, pr, pc)
    cells = ((row0[:m].long()[:, None, None]
              + torch.arange(pr, device=dev)[:, None]) * size
             + col0[:m].long()[:, None, None]
             + torch.arange(pc, device=dev))
    special = torch.randint(0, size * size, (20000,), generator=gen,
                            device=dev)
    n_oa = {}
    for dtype in (torch.float32, torch.bfloat16):
        g0 = lo0.to(dtype)
        g0.view(-1)[special[:10000]] = -0.0
        g0.view(-1)[special[10000:]] = float("nan")
        a_d, a_c = g0.clone(), g0.cpu()
        raster.ordered_add(a_d.view(-1), cells, delta)
        raster.ordered_add(a_c.view(-1), cells.cpu(), delta.cpu())
        n_oa[str(dtype)[6:]] = _bit_differ(a_d.cpu(), a_c)
    print(f"card vs CPU [{card}]: ordered_add of {cells.numel()} patch "
          f"deltas ({m} agents of the sweep's XLA tier): cells differing "
          f"{n_oa}")

    n_tier, worst = {}, 0.0
    for dtype in ("float32", "bfloat16"):
        gcfg = dataclasses.replace(cfg.grid, logodds_dtype=dtype)
        lo = lo0.to(gcfg.lo_dtype)
        for spec, d, t in ((br.BeamSpec.four_way(),) + br.beams_from_4way(
                dist4, sens.max_range, sens.min_range),
                (br.BeamSpec.scan(r), db, tb)):
            args = (torch.stack([rx, ry], -1), yaw, d, t, spec, gcfg)
            runs = [br.beam_raster_reference(lo.clone(), *args,
                                             reach=br.reach_cells(cfg))
                    for _ in range(2)]
            ref, wr = br.beam_raster_reference(
                lo.cpu(), *(a.cpu() if isinstance(a, torch.Tensor) else a
                            for a in args), reach=br.reach_cells(cfg))
            got = runs[0][0].cpu().to(torch.float32)
            want = ref.to(torch.float32)
            changed = int((want != lo.cpu().to(torch.float32)).sum())
            diff = int(((got - want).abs() > 1e-6).sum())
            key = f"{'wrapped' if spec.wrap else 'scan'} {dtype}"
            n_tier[key] = (diff, changed, int(runs[0][1]), int(wr),
                           _bit_differ(runs[0][0], runs[1][0]))
            worst = max(worst, float((got - want).abs().max()))
            if diff > 1e-4 * changed or abs(int(runs[0][1]) - int(wr)) > \
                    1e-4 * int(wr) or n_tier[key][4]:
                raise AssertionError(f"XLA tier card vs CPU {key}: "
                                     f"{n_tier[key]}")
    print(f"card vs CPU [{card}]: the XLA tier, per fan and grid dtype "
          f"(cells differing by > 1e-6, changed cells, writes card, writes "
          f"CPU, cells differing between two card runs): {n_tier}; max "
          f"|diff| {worst:.4e}")
    if n_par or int(w_d) != int(w_c) or n_line or n_line2 or \
            int(outs[0][1]) != int(lw_c) or any(n_oa.values()):
        raise AssertionError("card vs CPU: a bit-equal raster differs")


def phase_reference_modes(dev):
    """Card against CPU at REF_AGENTS agents (phase_reference's bar) on each
    new path: the line raster and the XLA tier on the untiled world, the
    parity mode there (no sweep) and on dual_bot, the profiling mode, and
    the yaw-rate bias on the deployable path."""
    from swarm_tpu_torch import presets

    def untiled(**kw):
        return lambda d: presets.untiled(REF_AGENTS, device=d, **kw)

    def parity(d):
        cfg, *rest = presets.untiled(REF_AGENTS, raster_mode="line",
                                     scan_rays=0, device=d)
        return (cfg.replace(engine=dataclasses.replace(
            cfg.engine, parity_mode=True)), *rest)

    def bias(d):
        cfg, *rest = presets.deployable(REF_AGENTS, device=d)
        return (cfg.replace(slam=dataclasses.replace(
            cfg.slam, merge_bias_alpha=0.1)), *rest)

    phase_reference(dev, "untiled --raster line", world=untiled(
        raster_mode="line"))
    phase_reference(dev, "untiled --no-pallas", world=untiled(
        raster_mode="beam"))
    phase_reference(dev, "untiled --no-pallas bf16", 17, world=untiled(
        raster_mode="beam", grid_dtype="bfloat16"))
    phase_reference(dev, "untiled parity", 17, world=parity,
                    expect_merges=False)
    phase_reference(dev, "dual_bot", REF_STEPS, expect_merges=False,
                    world=lambda d: presets.dual_bot(device=d))
    phase_reference(dev, "profiling mode", 17, expect_merges=False,
                    world=untiled(raster_mode="off"))
    phase_reference(dev, "bias", world=bias)


ACCURACY_AGENTS = 64         # tools/bench_accuracy.py --agents
ACCURACY_STEPS = 500         # the tool's 2000, cut to fit the time limit
ACCURACY_CHUNK = 250
ACCURACY_REF_AGENTS = 4
ACCURACY_REF_STEPS = 24
# the card-vs-CPU check's closure settings, in every variant and tier: the
# pair matcher runs between a room's two agents from step 0, and a gate of
# 0.3 lets some of those far-apart views through as measured edges within
# 24 steps
ACCURACY_REF_SLAM = dict(closure_cross_radius_m=6.5, closure_pair_cooldown=16,
                         merge_fitness_min=0.3)
# positions (m) and yaws (rad, as angles): the solvers' bar
# (tests/test_tridiag.py)
ACCURACY_POSE_ATOL = 1e-3
ACCURACY_MEAS_ATOL = 1e-4


def _finite_tiers(results):
    for tier, res in results.items():
        for k, v in res.items():
            for x in (v if isinstance(v, list) else [v]):
                if not math.isfinite(float(x)):
                    raise AssertionError(f"accuracy {tier}: {k} = {v}")


def _pose_diff(sol_d, sol_c, tiers):
    """The largest |card - CPU| over the tiers' refined poses: (position,
    m; yaw, rad, as an angle: the solvers wrap yaw into [-pi, pi), so a
    yaw at the seam may land on either end)."""
    pos, yaw = 0.0, 0.0
    for tier in tiers:
        if sol_d[tier].keys() != sol_c[tier].keys():
            raise AssertionError(f"accuracy card vs CPU {tier}: agents "
                                 f"{sorted(sol_d[tier])} vs "
                                 f"{sorted(sol_c[tier])}")
        for a, r in sol_c[tier].items():
            d = sol_d[tier][a]["poses"].astype(np.float64) - r["poses"]
            pos = max(pos, float(np.abs(d[:, :2]).max()))
            yaw = max(yaw, float(np.abs(
                np.remainder(d[:, 2] + np.pi, 2 * np.pi) - np.pi).max()))
    return pos, yaw


def phase_accuracy(card, dev):
    """Offline SLAM at the accuracy tool's width (phase 22 of the module
    docstring). Returns (the window kernel's launches per form on the
    path, its records at the path's shapes per form)."""
    from swarm_tpu_torch import accuracy, presets
    from swarm_tpu_torch.slam.joint import joint_refine_session
    from swarm_tpu_torch.slam.refine import refine_session

    cfg, _, params, rooms = presets.accuracy(ACCURACY_AGENTS, "raw",
                                             device=dev)
    k_forms = dict([
        _window_form(card, dev, "accuracy window pack16 scan", cfg, params,
                     rooms, SEED + 40, four_way=False, pack8=False,
                     ring=False),
        _window_form(card, dev, "accuracy window pack16 4-way", cfg, params,
                     rooms, SEED + 41, four_way=True, pack8=False,
                     ring=False)])

    print(f"accuracy: {ACCURACY_AGENTS} agents, {ACCURACY_STEPS} steps "
          f"(chunks of {ACCURACY_CHUNK}) on {card}")
    variant_worlds = accuracy.worlds(ACCURACY_AGENTS, dev)
    _reset_counts()
    results, logs, sec_v = accuracy.run_variants(
        variant_worlds, ACCURACY_STEPS, ACCURACY_CHUNK,
        log=lambda m: print("  " + m, flush=True))
    n_free, by_form, n_room = _read_counts()
    print(f"accuracy variants: window kernel launches {by_form}, room "
          f"kernel {n_room}")
    want = {"pack16": 4 * ACCURACY_STEPS, "pack16-wrapped":
            4 * ACCURACY_STEPS}
    if by_form != want or n_room:
        raise AssertionError(f"accuracy: launches {by_form} (room {n_room})"
                             f", want {want}")
    base = variant_worlds["raw"]
    solved = {}
    tiers, sec_t = accuracy.offline_tiers(
        logs, base, dev, log=lambda m: print("  " + m, flush=True),
        solved=solved)
    results.update(tiers)
    _finite_tiers(results)
    for name in ("raw", "merge_anchored"):
        cl = logs[name][1].srv.closure
        c = min(int(cl.cl_count), cl.cl_node.shape[0])
        measured = int((cl.cl_fit[:c] >= 0).sum())
        print(f"accuracy {name}: {c} closure edges, {measured} measured")
        if measured == 0:
            raise AssertionError(f"accuracy {name}: no measured closure edge")
    cross = max(results[t]["inter_edges"] for t in
                ("joint", "anchored_joint", "calibrated_joint",
                 "reloc_joint"))
    if cross == 0:
        raise AssertionError("accuracy: no verified cross edge")
    for tier, res in results.items():
        print(f"accuracy tier {tier}: ATE mean {res['ate_mean_m']} late "
              f"{res['ate_late_m']} | IoU {res.get('wall_iou')} p90 "
              f"{res.get('wall_p90')} | closures {res.get('closures')} "
              f"merges {res.get('merges')} | measured "
              f"{res.get('measured_edges')} cross {res.get('inter_edges')}")
    print("accuracy steps/s: " + ", ".join(
        f"{k} {ACCURACY_STEPS / v:.2f}" for k, v in sec_v.items()))
    print("accuracy offline seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sec_t.items()))
    print(json.dumps({"accuracy": {
        "agents": ACCURACY_AGENTS, "steps": ACCURACY_STEPS, "card": card,
        "variants": results,
        "steps_per_s": {k: ACCURACY_STEPS / v for k, v in sec_v.items()},
        "offline_s": sec_t}}))

    # the raw session's graphs again on the CPU, from the same logs
    lg, state = logs["raw"]
    session = accuracy.session_from_log(lg, "sx", "sy", "yq")
    closures = accuracy.closure_log(state)
    t0 = time.perf_counter()
    cpu = {"refined": refine_session(session, closures=closures,
                                     cfg=base[0], device="cpu"),
           "joint": joint_refine_session(session, closures=closures,
                                         cfg=base[0], device="cpu")}
    t_cpu = time.perf_counter() - t0
    n_edges = (results["refined"]["closures_used"],
               results["joint"]["inter_edges"])
    if min(n_edges) == 0:
        raise AssertionError(f"accuracy: (closure, cross) edges reaching "
                             f"the solvers {n_edges}")
    pos, yaw = _pose_diff(solved, cpu, ("refined", "joint"))
    print(f"accuracy solvers card vs CPU ({ACCURACY_AGENTS} agents, "
          f"{ACCURACY_STEPS} steps, {n_edges[0]} closure edges, "
          f"{n_edges[1]} cross edges): refined / joint poses within "
          f"{pos:.3g} m, yaw {yaw:.3g} rad (CPU {t_cpu:.2f} s)")
    if not max(pos, yaw) <= ACCURACY_POSE_ATOL:
        raise AssertionError(f"accuracy solvers card vs CPU: poses differ "
                             f"by {pos} m, {yaw} rad")
    _accuracy_split(dev, state)
    del logs, base, variant_worlds, solved, cpu
    phase_accuracy_card_vs_cpu(dev)
    return by_form, k_forms


ACCURACY_SPLIT_STEPS = 64


def _accuracy_split(dev, state):
    """ACCURACY_SPLIT_STEPS more steps of the raw variant from its final
    state, on the device timeline: the step, the closure (its landmark
    match, the gates' host read and the matchers) and the matcher alone
    (`closurematch.match_scan_pairs_batch`), summed over the window."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine import sim
    from swarm_tpu_torch.slam import closurematch

    cfg, walls, params, rooms = presets.accuracy(ACCURACY_AGENTS, "raw",
                                                 device=dev)
    step = sim.make_sim_step(
        cfg, walls, params, torch.Generator(device=dev).manual_seed(SEED),
        walls_grouped=rooms[0], room_of_agent=rooms[1])
    events = {"closure": [], "matcher": []}

    def timed(part, fn):
        def run(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            events[part].append((e0, e1))
            return out
        return run

    originals = ((sim, "closure_add_poses_batch"),
                 (closurematch, "match_scan_pairs_batch"))
    saved = [getattr(m, nm) for m, nm in originals]
    steps = []
    try:
        for (m, nm), part in zip(originals, events):
            setattr(m, nm, timed(part, getattr(m, nm)))
        for _ in range(ACCURACY_SPLIT_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, _ = step(state)
            e1.record()
            steps.append((e0, e1))
        torch.cuda.synchronize()
    finally:
        for (m, nm), fn in zip(originals, saved):
            setattr(m, nm, fn)

    def total(pairs):
        return sum(a.elapsed_time(b) for a, b in pairs)
    t_step, t_cl, t_m = total(steps), total(events["closure"]), \
        total(events["matcher"])
    print(f"accuracy raw split over {ACCURACY_SPLIT_STEPS} steps: step "
          f"{t_step / ACCURACY_SPLIT_STEPS:.4f} ms, closure "
          f"{t_cl / ACCURACY_SPLIT_STEPS:.4f} ms a step (share "
          f"{t_cl / t_step:.3f}), matcher {len(events['matcher'])} calls, "
          f"{t_m / max(len(events['matcher']), 1):.4f} ms a call (share "
          f"{t_m / t_step:.3f})")


def phase_accuracy_card_vs_cpu(dev):
    """The accuracy path at 4 agents over 24 steps on the card and on the
    CPU on the same noise, every variant and tier with ACCURACY_REF_SLAM:
    raw's and merge_anchored's closure rings (nodes and agents exact,
    measurements and fitness within 1e-4), a cross edge and a merge fix
    reaching the solvers, the refined, joint and anchored poses within
    1e-3 (m, rad)."""
    from swarm_tpu_torch import accuracy

    cpu = torch.device("cpu")
    out = {}
    for where in (dev, cpu):
        variant_worlds = {
            v: (w[0].replace(slam=dataclasses.replace(
                w[0].slam, **ACCURACY_REF_SLAM)), *w[1:])
            for v, w in accuracy.worlds(ACCURACY_REF_AGENTS, where).items()}
        _, logs, _ = accuracy.run_variants(
            variant_worlds, ACCURACY_REF_STEPS, ACCURACY_REF_STEPS,
            log=lambda m: 0)
        solved = {}
        tiers, _ = accuracy.offline_tiers(logs, variant_worlds["raw"], where,
                                          log=lambda m: 0, solved=solved)
        out[where.type] = (
            {v: (accuracy.closure_log(logs[v][1]),
                 logs[v][1].srv.closure.last_pair_node.cpu())
             for v in ("raw", "merge_anchored")}, solved, tiers)
    (rings_d, sol_d, _), (rings_c, sol_c, tiers_c) = out[dev.type], out["cpu"]
    d_meas, d_fit, n_meas = np.zeros((1, 3)), np.zeros(1), 0
    for v, ((cl_d, lp_d), (cl_c, lp_c)) in (
            (v, (rings_d[v], rings_c[v])) for v in rings_c):
        for k, what in ((0, "lm node"), (1, "node"), (2, "agent")):
            if not (cl_d[k].shape == cl_c[k].shape and
                    (cl_d[k] == cl_c[k]).all()):
                raise AssertionError(f"accuracy card vs CPU {v}: closure "
                                     f"{what} {cl_d[k]} vs {cl_c[k]}")
        if not torch.equal(lp_d, lp_c):
            raise AssertionError(f"accuracy card vs CPU {v}: pair cooldown"
                                 f" {lp_d} vs {lp_c}")
        d_meas = np.concatenate([d_meas, np.abs(cl_d[3] - cl_c[3])])
        d_fit = np.concatenate([d_fit, np.abs(cl_d[4] - cl_c[4])])
        n_meas += int((cl_c[4] >= 0).sum())
    if not ((d_meas <= ACCURACY_MEAS_ATOL).all() and
            (d_fit <= ACCURACY_MEAS_ATOL).all() and n_meas > 0):
        raise AssertionError(f"accuracy card vs CPU: {n_meas} measured "
                             f"edges, measurements differ {d_meas.max()} "
                             f"fit {d_fit.max()}")
    n_cross = tiers_c["joint"]["inter_edges"]
    n_fix = tiers_c["anchored_gn"]["merge_obs"]
    if n_cross == 0 or n_fix == 0:
        raise AssertionError(f"accuracy card vs CPU: {n_cross} cross edges"
                             f" and {n_fix} merge fixes reach the solvers")
    tiers = ("refined", "joint", "anchored_gn", "anchored_joint")
    pos, yaw = _pose_diff(sol_d, sol_c, tiers)
    if not max(pos, yaw) <= ACCURACY_POSE_ATOL:
        raise AssertionError(f"accuracy card vs CPU: refined poses differ "
                             f"by {pos} m, {yaw} rad")
    cl_c, lp_c = rings_c["raw"]
    print(f"accuracy card vs CPU ({ACCURACY_REF_AGENTS} agents, "
          f"{ACCURACY_REF_STEPS} steps): raw {len(cl_c[0])} and "
          f"merge_anchored {len(rings_c['merge_anchored'][0][0])} closure "
          f"edges equal ({n_meas} measured; measurement diff "
          f"{d_meas.max():.3g}, fit {d_fit.max():.3g}), raw pair attempts "
          f"{int((lp_c >= 0).sum())}; {n_cross} cross edges, {n_fix} merge "
          f"fixes; {' / '.join(tiers)} poses within {pos:.3g} m, yaw "
          f"{yaw:.3g} rad")


# ---------------------------------------------------------------------------
# The mapping server (engine/replay.py), the packet formats and native codec,
# the synthetic session, and the rank-sharded pose-graph solvers
# (parallel/solve.py). No raster kernel lies on these paths.
# ---------------------------------------------------------------------------

REPLAY_SEED = 42             # generate_dual_session's default seed
SWARM_STREAM_AGENTS = 64     # tools/bench_serve.py --agents default
SWARM_STREAM_PACKETS = 20480  # five turns of bench_serve's 4096-packet ring
WINDOW_SWEEP = (64, 256, 512, 1024, 4096)  # closure windows timed
SERVE_AGENTS = 1024
SERVE_FRAME = 2048           # tools/bench_serve.py --max-packets default
SERVE_FRAMES = 64
SERVE_STRIDE = 64            # drain-buffer row, bytes
SOLVE_GRAPHS = 1024          # BASELINE.json configs[4]: 1024 agents
SOLVE_NODES = 64
SOLVE_LOOP = 16              # graphs also solved one after another
SOLVE_ITERS = 10
CHAIN_NODES = 4096           # the scale of tests/test_tridiag.py:85-92
CHAIN_ITERS = 5
# the solvers' card-vs-CPU bar (positions m, yaws rad as angles; phase
# 22's bar, ROADMAP C31) and the batched-vs-loop bar on the card
SOLVE_CPU_ATOL = 1e-3
SOLVE_LOOP_ATOL = 1e-4


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _wall(fn, dev):
    """(fn(), its wall seconds with the device synchronised on both
    sides)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _no_kernel(name):
    """None of the three raster kernels launched since `_reset_counts`."""
    n = _kernel_launches()
    if any(n.values()):
        raise AssertionError(f"{name}: raster kernels launched {n}")
    return n


def _traced(rx, ry, hits, hit_valid, cfg):
    """The traced cells of the replay rays (4 per packet, in order), on
    the CPU: (flat, free, occ) [4T, 32]."""
    from swarm_tpu_torch.ops.raster import RayBatch, _traced_cells

    c = [v.detach().cpu() for v in (rx, ry, hits, hit_valid)]
    rays = RayBatch(ox=c[0].repeat_interleave(4),
                    oy=c[1].repeat_interleave(4),
                    hx=c[2][..., 0].reshape(-1), hy=c[2][..., 1].reshape(-1),
                    hit_valid=c[3].reshape(-1),
                    active=torch.ones(c[3].numel(), dtype=torch.bool))
    return _traced_cells(rays, cfg.grid, 32)


def _ray_cells_apart(out_a, out_b, cfg):
    """Cells that rays traced differently by two runs touch (ROADMAP C26:
    an ulp of cos or sin moves an endpoint across a cell edge): ([S*S]
    bool, the rays traced apart [4T] bool)."""
    a = _traced(out_a.rx, out_a.ry, out_a.hits, out_a.hit_valid, cfg)
    b = _traced(out_b.rx, out_b.ry, out_b.hits, out_b.hit_valid, cfg)
    apart = ((a[0] != b[0]) | (a[1] != b[1]) | (a[2] != b[2])).any(dim=1)
    mask = torch.zeros(cfg.grid.size ** 2, dtype=torch.bool)
    for flat, free, occ in (a, b):
        on = (free | occ) & apart[:, None]
        mask[flat[on].long()] = True
    return mask, apart


def _grids_agree(name, g_a, g_b, mask, apart):
    """Two runs' grids bit-equal, or differing only in cells that rays
    traced differently touch; the counts printed."""
    diff = (g_a.detach().cpu() != g_b.detach().cpu()).reshape(-1)
    print(f"{name}: {int(diff.sum())} of {diff.numel()} cells differ, "
          f"{int(apart.sum())} of {apart.numel()} rays traced apart")
    if bool((diff & ~mask).any()):
        raise AssertionError(f"{name}: {int((diff & ~mask).sum())} cells "
                             "differ off every ray traced apart")


def _same_closures(name, st_a, st_b):
    n = int(st_a.closure.cl_count)
    if n != int(st_b.closure.cl_count):
        raise AssertionError(f"{name}: {n} closures vs "
                             f"{int(st_b.closure.cl_count)}")
    for f in ("cl_node", "cl_lm_node", "cl_agent", "cl_dx", "cl_dy"):
        a = getattr(st_a.closure, f)[:n].cpu()
        if not torch.equal(a, getattr(st_b.closure, f)[:n].cpu()):
            raise AssertionError(f"{name}: closure log {f} differs")
    return n


def _oracle_grid(out, cfg):
    """The port's native oracle: `update_ray` on the replay's corrected
    rays, one after another in packet order."""
    from swarm_tpu_torch import native

    g = cfg.grid
    grid = np.full((g.size, g.size), g.unknown, np.int8)
    rx, ry = out.rx.cpu().numpy(), out.ry.cpu().numpy()
    hits, hv = out.hits.cpu().numpy(), out.hit_valid.cpu().numpy()
    for i in range(rx.shape[0]):
        for k in range(4):
            native.update_ray(grid, g.resolution, g.origin_x, g.origin_y,
                              rx[i], ry[i], hits[i, k, 0], hits[i, k, 1],
                              bool(hv[i, k]))
    return grid


def _session_landmarks():
    """The landmark column of generate_dual_session(REPLAY_SEED) on the
    CPU: the sensor model's sightings over the scripted session (ids 2 and
    5 on 137 of its 698 packets). The swarm streams and the serving frames
    that carry landmarks draw theirs from it, ids and share alike."""
    from swarm_tpu_torch.sim.scenario import generate_dual_session

    return np.asarray(generate_dual_session(
        REPLAY_SEED, device=torch.device("cpu")).landmark, np.int32)


def _swarm_stream(n_agents, n_packets, dev, lm_pool, seed):
    """tools/bench_serve.py's packet ring (`_packet_ring`: agent k % N
    walking a noisy circle, four ranges in [0.1, 1.1) m), `n_packets`
    long, stamped 0.05 / N s apart; each packet's landmark drawn from
    `lm_pool` (the ring itself sends none: a pool of one 0)."""
    from swarm_tpu_torch.engine.replay import PacketStream

    rng = np.random.default_rng(seed)
    k = np.arange(n_packets)
    a = k % n_agents
    t = k * 0.05
    lm = rng.choice(lm_pool, n_packets)

    def col(v, dt):
        return torch.as_tensor(np.asarray(v, dt), device=dev)
    return PacketStream(
        t=col(1.0 + k * (0.05 / n_agents), np.float32), agent=col(a, np.int32),
        x=col(2.0 + np.cos(t + a) * 1.5, np.float32),
        y=col(1.5 + np.sin(t + a) * 1.0, np.float32),
        yaw=col((t + a) % 6.28 - 3.14, np.float32), encoder=col(k, np.int32),
        v2v=col(np.zeros(n_packets), np.int32),
        dist=col(rng.uniform(0.1, 1.1, (n_packets, 4)), np.float32),
        landmark=col(lm, np.int32),
        valid=torch.ones(n_packets, dtype=torch.bool, device=dev))


def _replay_timed(stream, cfg, dev, reps=3, warm=True):
    """replay_session, a warm-up run (with `warm`) then the median of
    `reps` timed runs: (state, outputs, ReplayStats, seconds)."""
    from swarm_tpu_torch.engine.replay import replay_session

    if warm:
        replay_session(stream, cfg, stats=True)
    runs = [_wall(lambda: replay_session(stream, cfg, stats=True), dev)
            for _ in range(reps)]
    (st, out, stats), _ = runs[0]
    return st, out, stats, _median([s for _, s in runs])


def _window_sweep(name, card, stream, cfg, dev, st, out):
    """replay_session with each closure window of WINDOW_SWEEP in place of
    replay.WINDOW, one timed run each: packets/s and windows. Every run's
    closures, closed flags and grid equal `st` and `out` (where a window
    ends changes no result)."""
    from swarm_tpu_torch.engine import replay

    n = stream.t.shape[0]
    keep = replay.WINDOW
    rates = []
    try:
        for w in WINDOW_SWEEP:
            replay.WINDOW = w
            (st_w, out_w, stats_w), sec_w = _wall(
                lambda: replay.replay_session(stream, cfg, stats=True), dev)
            _same_closures(f"{name} window {w}", st_w, st)
            if not (torch.equal(out_w.closed, out.closed) and
                    torch.equal(st_w.grid, st.grid)):
                raise AssertionError(f"{name}: window {w} changed the "
                                     "replay")
            rates.append(f"{w}: {n / sec_w:.1f} ({stats_w.windows} windows)")
    finally:
        replay.WINDOW = keep
    print(f"{name} replay window sizes [{card}] (packets/s; replay.WINDOW "
          f"{keep}): " + ", ".join(rates))


def phase_replay(card, dev):
    """The mapping server's replay (phase 23 of the module docstring):
    run_session's scripted sequence without the render, then the swarm
    streams. Returns {stream: (packets, seconds, ReplayStats)}."""
    import tempfile

    from swarm_tpu_torch.config import SwarmConfig
    from swarm_tpu_torch.engine.replay import replay_session
    from swarm_tpu_torch.proto.csvio import (load_session,
                                             packet_stream_from_telemetry,
                                             write_session)
    from swarm_tpu_torch.sim.scenario import generate_dual_session
    from swarm_tpu_torch.slam.refine import refine_session, reraster_session

    cpu = torch.device("cpu")
    cfg = SwarmConfig(n_agents=2)
    _reset_counts()                          # this path starts here
    (sess, gen_s) = _wall(lambda: generate_dual_session(REPLAY_SEED,
                                                        device=dev), dev)
    sess_c = generate_dual_session(REPLAY_SEED, device=cpu)
    for f in ("t", "agent", "x", "y", "yaw_q", "encoder", "true_pose"):
        if not np.array_equal(getattr(sess, f), getattr(sess_c, f)):
            raise AssertionError(f"dual session: {f} card != CPU")
    d4 = float(np.abs(sess.dist4 - sess_c.dist4).max())
    flips = {f: int((getattr(sess, f) != getattr(sess_c, f)).sum())
             for f in ("landmark", "v2v")}
    if d4 > 1e-5:
        raise AssertionError(f"dual session: dist4 card vs CPU {d4} m")
    with tempfile.TemporaryDirectory() as tmp:
        write_session(tmp, sess.t, sess.agent, sess.x, sess.y, sess.yaw_q,
                      sess.encoder, sess.v2v, sess.dist4, sess.landmark)
        session = load_session(tmp)
    stream = packet_stream_from_telemetry(session, device=dev)
    st, out, stats, sec = _replay_timed(stream, cfg, dev)
    st_c, out_c = replay_session(packet_stream_from_telemetry(
        session, device=cpu), cfg)
    n_pk = int(stream.t.shape[0])
    mask, apart = _ray_cells_apart(out, out_c, cfg)
    _grids_agree(f"dual replay card vs CPU [{card}]", st.grid, st_c.grid,
                 mask, apart)
    n_cl = _same_closures("dual replay card vs CPU", st, st_c)
    same_rays = ~apart.reshape(-1, 4).any(dim=1)
    if not torch.equal(out.closed.cpu(), out_c.closed) or \
            not torch.equal(out.rx.cpu(), out_c.rx) or \
            not torch.equal(out.ry.cpu(), out_c.ry) or \
            not torch.equal(out.writes.cpu()[same_rays],
                            out_c.writes[same_rays]):
        raise AssertionError("dual replay: closures, corrected poses or "
                             "writes differ card vs CPU")
    oracle = _oracle_grid(out, cfg)
    n_or = int((st.grid.cpu().numpy() != oracle).sum())
    g = cfg.grid
    free = int((st.grid == g.free).sum())
    occ = int((st.grid == g.occupied).sum())
    print(f"dual session [{card}]: generated in {gen_s:.4f} s (dist4 card "
          f"vs CPU {d4:.3g} m, flips {flips}), {n_pk} packets replayed in "
          f"{sec:.6f} s ({n_pk / sec:.1f} packets/s), {stats.windows} "
          f"closure windows (host reads), {n_cl} closures, FREE {free}, "
          f"OCCUPIED {occ}; native oracle: {n_or} cells differ")
    if n_or or n_cl == 0 or free <= 2000 or occ <= 100:
        raise AssertionError("dual replay: oracle or map")

    # refine, then re-raster from the refined poses
    (refined, ref_s) = _wall(lambda: refine_session(session, cfg=cfg,
                                                    device=dev), dev)
    refined_c = refine_session(session, cfg=cfg, device=cpu)
    pos, yaw = _pose_diff({"r": refined}, {"r": refined_c}, ["r"])
    (grid_r, stream_r), rr_s = _wall(lambda: reraster_session(
        session, refined, cfg, device=dev), dev)
    grid_rc, stream_rc = reraster_session(session, refined, cfg, device=cpu)
    st_r, out_r = replay_session(stream_r, cfg)
    st_rc, out_rc = replay_session(stream_rc, cfg)
    if not (np.array_equal(st_r.grid.cpu().numpy(), grid_r) and
            np.array_equal(st_rc.grid.numpy(), grid_rc)):
        raise AssertionError("reraster_session is not its replay")
    mask, apart = _ray_cells_apart(out_r, out_rc, cfg)
    _grids_agree(f"reraster card vs CPU [{card}]", st_r.grid, st_rc.grid,
                 mask, apart)
    print(f"refine_session [{card}]: {ref_s:.4f} s, poses card vs CPU "
          f"{pos:.3g} m / {yaw:.3g} rad; reraster_session {rr_s:.4f} s, "
          f"OCCUPIED {int((grid_r == g.occupied).sum())}")
    if pos > ACCURACY_POSE_ATOL or yaw > ACCURACY_POSE_ATOL or \
            not np.isfinite(grid_r).all():
        raise AssertionError("refine: card vs CPU")

    # the swarm streams: bench_serve's ring as it is (no landmark), and
    # with the dual session's landmarks (closures on most windows)
    done = {"dual": (n_pk, sec, stats)}
    cfg = SwarmConfig(n_agents=SWARM_STREAM_AGENTS)
    pools = (("swarm", np.zeros(1, np.int32)),
             ("swarm+landmarks", _session_landmarks()))
    for name, pool in pools:
        s = _swarm_stream(SWARM_STREAM_AGENTS, SWARM_STREAM_PACKETS, dev,
                          pool, SEED + 60)
        # the stream without landmarks warms the one with them up
        st, out, stats, sec = _replay_timed(s, cfg, dev, reps=1,
                                            warm=name == "swarm")
        if not bool(torch.isfinite(out.rx).all()) or \
                int(st.pkt_counts.sum()) != SWARM_STREAM_PACKETS:
            raise AssertionError(f"{name} replay")
        st_c, out_c = replay_session(_swarm_stream(
            SWARM_STREAM_AGENTS, SWARM_STREAM_PACKETS, cpu, pool,
            SEED + 60), cfg)
        mask, apart = _ray_cells_apart(out, out_c, cfg)
        _grids_agree(f"{name} replay card vs CPU [{card}]", st.grid,
                     st_c.grid, mask, apart)
        _same_closures(f"{name} replay card vs CPU", st, st_c)
        if not torch.equal(out.closed.cpu(), out_c.closed):
            raise AssertionError(f"{name} replay: closures fire on other "
                                 "packets card vs CPU")
        _window_sweep(name, card, s, cfg, dev, st, out)
        print(f"{name} replay [{card}]: {SWARM_STREAM_AGENTS} agents, "
              f"{SWARM_STREAM_PACKETS} packets in {sec:.6f} s "
              f"({SWARM_STREAM_PACKETS / sec:.1f} packets/s), "
              f"{stats.windows} closure windows (host reads), "
              f"{stats.closures} closures, "
              f"{int(st.total_writes[0]) * (1 << 30) + int(st.total_writes[1])}"
              f" cell writes")
        done[name] = (SWARM_STREAM_PACKETS, sec, stats)
    print(f"replay raster kernels {_no_kernel('replay')}")
    return done


def _serve_wire(n_agents, frame, n_frames, seed):
    """bench_serve's ring over `n_agents` (packet k from agent k % N on
    its noisy circle), packed by the port's `pack_quasar_v2_batch` into
    drain-style buffers [frame, SERVE_STRIDE] (one datagram a row), each
    packet's landmark drawn from the dual session's (`_session_landmarks`).
    The v2 wire's agent field is one byte, so it carries (a % 255) + 1;
    the agent index a rides beside it. [n_frames] (buffer, lengths, agent
    indices)."""
    from swarm_tpu_torch.proto.packets import PACKET_SIZE_V2, \
        pack_quasar_v2_batch

    rng = np.random.default_rng(seed)
    pool = _session_landmarks()
    out = []
    for f in range(n_frames):
        k = f * frame + np.arange(frame)
        a = k % n_agents
        t = k * 0.05
        wire = pack_quasar_v2_batch(
            (a % 255) + 1,
            2.0 + np.cos(t + a) * 1.5, 1.5 + np.sin(t + a) * 1.0,
            (t + a) % 6.28 - 3.14, k, np.zeros(frame),
            rng.uniform(0.1, 1.1, (frame, 4)), rng.choice(pool, frame))
        buf = np.zeros((frame, SERVE_STRIDE), np.uint8)
        buf[:, :PACKET_SIZE_V2] = np.frombuffer(wire, np.uint8).reshape(
            frame, PACKET_SIZE_V2)
        out.append((buf, np.full(frame, PACKET_SIZE_V2, np.int32), a))
    return out


def _frame_stream(cols, agents, f, dev):
    """One parsed frame as a PacketStream on `dev`, stamped by the
    server's clock (a frame every 33 ms) as the live server stamps
    arrivals. The agents are the indices that ride beside the wire (its
    agent byte holds at most 255 ids)."""
    from swarm_tpu_torch.engine.replay import PacketStream

    b = agents.shape[0]
    t = 1.0 + f * 0.033 + np.arange(b) * (0.033 / b)

    def col(v, dt):
        return torch.as_tensor(np.asarray(v, dt), device=dev)
    return PacketStream(
        t=col(t, np.float32), agent=col(agents, np.int32),
        x=col(cols["x"], np.float32), y=col(cols["y"], np.float32),
        yaw=col(cols["yaw"], np.float32), encoder=col(cols["encoder"],
                                                      np.int32),
        v2v=col(cols["v2v"], np.int32), dist=col(cols["dist4"], np.float32),
        landmark=col(cols["landmark"], np.int32),
        valid=torch.ones(b, dtype=torch.bool, device=dev))


def phase_serve(card, dev):
    """Serving (phase 24 of the module docstring): `ingest_frame` at
    SERVE_AGENTS agents, SERVE_FRAMES frames of SERVE_FRAME packets packed
    by the port's `pack_quasar_v2_batch` and parsed by its native
    `parse_telemetry_buffer`. Returns (frames, packets, seconds)."""
    from swarm_tpu_torch import native
    from swarm_tpu_torch.config import SwarmConfig
    from swarm_tpu_torch.engine.replay import ingest_frame, server_init

    cfg = SwarmConfig(n_agents=SERVE_AGENTS)
    wire = _serve_wire(SERVE_AGENTS, SERVE_FRAME, SERVE_FRAMES, SEED + 70)
    t0 = time.perf_counter()
    parsed = [native.parse_telemetry_buffer(buf, lens, SERVE_FRAME)
              for buf, lens, _ in wire]
    codec_s = time.perf_counter() - t0
    if any(p["n_good"] != SERVE_FRAME or (p["kind"] != 2).any() or
           (p["agent"] != w[2] % 255 + 1).any()
           for p, w in zip(parsed, wire)):
        raise AssertionError("serve: the native codec rejected packets")
    frames = {d: [_frame_stream(p, w[2], f, d)
                  for f, (p, w) in enumerate(zip(parsed, wire))]
              for d in (dev, torch.device("cpu"))}

    def serve(d):
        st = server_init(cfg, t0=1.0, device=d)
        off = torch.zeros(SERVE_AGENTS, device=d)
        outs = []
        for fr in frames[d]:
            st, out = ingest_frame(st, fr, cfg, off)
            outs.append(out)
        return st, outs

    serve(dev)                               # warm-up
    _reset_counts()                          # this path starts here
    (st, outs), sec = _wall(lambda: serve(dev), dev)
    n_kernels = _no_kernel("serve")

    def end_to_end():
        st2 = server_init(cfg, t0=1.0, device=dev)
        off = torch.zeros(SERVE_AGENTS, device=dev)
        for f, (buf, lens, agents) in enumerate(wire):
            cols = native.parse_telemetry_buffer(buf, lens, SERVE_FRAME)
            st2, _ = ingest_frame(st2, _frame_stream(cols, agents, f, dev),
                                  cfg, off)
        return st2
    st_e, sec_e = _wall(end_to_end, dev)
    st_c, outs_c = serve(torch.device("cpu"))

    def frames_cat(src):
        return types.SimpleNamespace(**{
            f: torch.cat([getattr(o, f) for o in src]).cpu()
            for f in ("rx", "ry", "hits", "hit_valid")})
    mask, apart = _ray_cells_apart(frames_cat(outs), frames_cat(outs_c), cfg)
    _grids_agree(f"serve card vs CPU [{card}]", st.grid, st_c.grid, mask,
                 apart)
    if not torch.equal(st_e.grid, st.grid):
        raise AssertionError("serve: the codec loop's grid differs")
    n_cl = _same_closures("serve card vs CPU", st, st_c)
    online = outs[-1].online[0]
    n_pk = SERVE_FRAMES * SERVE_FRAME
    print(f"serve [{card}]: {SERVE_AGENTS} agents, {SERVE_FRAMES} frames "
          f"of {SERVE_FRAME} packets: ingest_frame {sec:.6f} s "
          f"({SERVE_FRAMES / sec:.2f} frames/s, {n_pk / sec:.1f} "
          f"packets/s); native codec {codec_s:.6f} s "
          f"({n_pk / codec_s:.1f} packets/s on the host); codec + copy + "
          f"ingest {sec_e:.6f} s ({n_pk / sec_e:.1f} packets/s); {n_cl} "
          f"closures; online {int(online.sum())}/{SERVE_AGENTS}; raster "
          f"kernels {n_kernels}")
    if not bool(online.all()) or int(st.pkt_counts.min()) != \
            n_pk // SERVE_AGENTS or n_cl == 0:
        raise AssertionError("serve: agents offline, packets lost or no "
                             "closure")
    return SERVE_FRAMES, n_pk, sec


def _loop_graphs(n, m, dev, seed):
    """n noisy square loops of m nodes, each with one closure from its
    last node to its first (tests/test_slam_upgrades.py's
    noisy_loop_trajectory, as tests/test_sharded_solve.py batches them):
    one batch of PoseGraph on `dev`."""
    from swarm_tpu_torch.slam.posegraph import PoseGraph, graph_from_trajectory

    rng = np.random.default_rng(seed)
    side = m // 4
    th = np.repeat(np.arange(4) * (np.pi / 2), side)
    th = np.remainder(th + np.pi, 2 * np.pi) - np.pi
    step = 0.2 * np.stack([np.cos(th), np.sin(th)], -1)
    true_xy = np.concatenate([np.zeros((1, 2)), np.cumsum(step, 0)[:-1]])
    graphs = []
    for _ in range(n):
        dth = np.diff(th) + rng.normal(0, 0.03, m - 1)
        th_n = np.concatenate([th[:1], th[0] + np.cumsum(dth)])
        th_n = np.remainder(th_n + np.pi, 2 * np.pi) - np.pi
        dist = np.hypot(*np.diff(true_xy, axis=0).T)
        xy = np.concatenate([true_xy[:1], true_xy[0] + np.cumsum(
            dist[:, None] * np.stack([np.cos(th_n[1:]), np.sin(th_n[1:])],
                                     -1) + rng.normal(0, 0.006, (m - 1, 2)),
            0)])
        poses = torch.from_numpy(np.concatenate([xy, th_n[:, None]], -1)
                                 .astype(np.float32))
        graphs.append(graph_from_trajectory(
            poses, m, torch.tensor([m - 1]), torch.tensor([0]),
            torch.zeros((1, 3)), 1, closure_weight=(50.0,) * 3))
    return PoseGraph(*(torch.stack(f).to(dev) for f in zip(*graphs)))


def _chain_graph(m, dev, seed):
    """tests/test_tridiag.py's noisy circular loop of m nodes with 6 of 8
    closures (`_noisy_loop_graph(rng, 4096, closure_cap=8,
    n_closures=6)`), on `dev`."""
    from swarm_tpu_torch.slam.posegraph import graph_from_trajectory

    rng = np.random.default_rng(seed)
    s = np.linspace(0, 4 * np.pi, m)
    truth = np.stack([np.cos(s), np.sin(s), s + np.pi / 2], -1)
    noisy = (truth + 0.05 * rng.normal(size=truth.shape)).astype(np.float32)
    noisy[0] = truth[0]
    ci = np.zeros(8, np.int32)
    cj = np.zeros(8, np.int32)
    ci[:6] = rng.integers(m // 2, m - 1, 6)
    cj[:6] = rng.integers(1, m // 4, 6)
    return graph_from_trajectory(
        torch.from_numpy(noisy).to(dev), m, torch.from_numpy(ci).to(dev),
        torch.from_numpy(cj).to(dev), torch.zeros((8, 3), device=dev), 6)


def _graph_pose_diff(a, b):
    """Largest |a - b| over batched poses: (positions, yaws as angles)."""
    d = a.detach().cpu().double() - b.detach().cpu().double()
    yaw = torch.remainder(d[..., 2] + math.pi, 2 * math.pi) - math.pi
    return float(d[..., :2].abs().max()), float(yaw.abs().max())


def phase_solve(card, dev):
    """The pose-graph solvers (phase 25 of the module docstring). Returns
    {solver: seconds}."""
    from datetime import timedelta

    import torch.distributed as dist

    from swarm_tpu_torch.parallel import mesh
    from swarm_tpu_torch.parallel.solve import (make_sharded_solver,
                                                make_trajectory_sharded_gn,
                                                shard_graphs)
    from swarm_tpu_torch.slam.posegraph import (PoseGraph, gauss_newton,
                                                optimize_graphs_batch)
    from swarm_tpu_torch.slam.tridiag import structured_gn, structured_gn_batch

    mesh.init(f"tcp://127.0.0.1:{mesh.free_port()}", 1, 0,
              timedelta(seconds=SHARDED_TIMEOUT_S), device=dev)
    if dev.type == "cuda" and dist.get_backend() != "nccl":
        raise AssertionError("the card's process group is not NCCL")
    times = {}
    try:
        lay = mesh.make_layout(device=dev)
        graphs = _loop_graphs(SOLVE_GRAPHS, SOLVE_NODES, torch.device("cpu"),
                              SEED + 80)
        mine = shard_graphs(graphs, lay)
        head = PoseGraph(*(f[:SOLVE_LOOP] for f in mine))
        _reset_counts()                      # this path starts here
        for name, kw, one, batch_cpu in (
                ("dense", {}, gauss_newton, optimize_graphs_batch),
                ("structured", {"structured": True,
                                "n_chain": SOLVE_NODES - 1},
                 lambda g, iterations: structured_gn(
                     g, SOLVE_NODES - 1, iterations),
                 lambda g, iterations: structured_gn_batch(
                     g, SOLVE_NODES - 1, iterations))):
            solver = make_sharded_solver(lay, iterations=SOLVE_ITERS, **kw)
            solver(head)                     # warm-up
            (out, costs, total), sec = _wall(lambda: solver(mine), dev)
            (out16, _, _), sec16 = _wall(lambda: solver(head), dev)
            loop, sec_loop = _wall(lambda: [one(PoseGraph(
                *(f[i] for f in head)), iterations=SOLVE_ITERS)[0].poses
                for i in range(SOLVE_LOOP)], dev)
            loop_d = _graph_pose_diff(out.poses[:SOLVE_LOOP],
                                      torch.stack(loop))
            b16_d = _graph_pose_diff(out16.poses, out.poses[:SOLVE_LOOP])
            ref, cost_c = batch_cpu(graphs, iterations=SOLVE_ITERS)
            cpu_d = _graph_pose_diff(out.poses, ref.poses)
            fin = costs[:, -1].cpu()
            ok = bool(torch.isfinite(out.poses).all()) and \
                bool((fin < costs[:, 0].cpu()).all())
            print(f"solve {name} [{card}]: {SOLVE_GRAPHS} graphs of "
                  f"{SOLVE_NODES} nodes, {SOLVE_ITERS} iterations on one "
                  f"{dist.get_backend()} rank: batched {sec:.6f} s; the "
                  f"first {SOLVE_LOOP} batched {sec16:.6f} s against one "
                  f"after another {sec_loop:.6f} s; batch vs loop "
                  f"{loop_d[0]:.3g} m / {loop_d[1]:.3g} rad, card vs CPU "
                  f"{cpu_d[0]:.3g} m / {cpu_d[1]:.3g} rad, summed final "
                  f"cost {float(total):.6g} (CPU "
                  f"{float(cost_c[:, -1].sum()):.6g})")
            if not ok or max(loop_d) > SOLVE_LOOP_ATOL or \
                    max(b16_d) > SOLVE_LOOP_ATOL or \
                    max(cpu_d) > SOLVE_CPU_ATOL or \
                    abs(float(total) - float(fin.sum())) > \
                    1e-5 * abs(float(fin.sum())):
                raise AssertionError(f"solve {name}")
            times[name] = (sec, sec16, sec_loop)

        chain = _chain_graph(CHAIN_NODES, dev, SEED + 81)
        traj = make_trajectory_sharded_gn(lay, n_chain=CHAIN_NODES - 1,
                                          iterations=CHAIN_ITERS)
        traj(chain)                          # warm-up
        (g_t, c_t), sec_t = _wall(lambda: traj(chain), dev)
        (g_s, c_s), sec_s = _wall(lambda: structured_gn(
            chain, CHAIN_NODES - 1, CHAIN_ITERS), dev)
        d = _graph_pose_diff(g_t.poses, g_s.poses)
        print(f"trajectory solve [{card}]: {CHAIN_NODES}-node chain, "
              f"{CHAIN_ITERS} iterations on one rank {sec_t:.6f} s, "
              f"structured_gn {sec_s:.6f} s; poses apart {d[0]:.3g} m / "
              f"{d[1]:.3g} rad; cost {float(c_t[0]):.6g} -> "
              f"{float(c_t[-1]):.6g}")
        if max(d) > SOLVE_CPU_ATOL or \
                not float(c_t[-1]) < 0.2 * float(c_t[0]) or \
                not bool(torch.isfinite(g_t.poses).all()):
            raise AssertionError("trajectory solve")
        times["trajectory"] = (sec_t, sec_s)
        print(f"solve raster kernels {_no_kernel('solve')}")
    finally:
        dist.destroy_process_group()
    return times


LIVE_SECONDS = 4.0           # each bench_serve run on loopback
LIVE_AGENTS = (64, 255)      # bench_serve's default; the wire's most
LIVE_FRAME = 20              # the reference's datagrams per frame (:816)
SESSION_STEPS = 200          # run_session --steps (the verify recipe's)
SESSION_SWARM_AGENTS = 64
SESSION_SWARM_STEPS = 100
CHECKPOINT_STEPS = 100       # run, checkpoint, resume: 2 x 100 = 200


def _recording_server():
    """A LiveServer that keeps every applied frame (stamp, agents,
    columns) and its outputs, so that the same frames can be applied again
    elsewhere."""
    from swarm_tpu_torch.server.live import LiveServer

    class Recording(LiveServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.frames, self.outs = [], []

        def ingest_columns(self, agents0, cols, now=None):
            now = self.now() if now is None else now
            self.frames.append((now, np.array(agents0), dict(cols)))
            super().ingest_columns(agents0, cols, now)

        def _apply(self, batch):
            st, out = super()._apply(batch)
            self.outs.append(out)
            return st, out
    return Recording


def _outs_cat(outs):
    return types.SimpleNamespace(**{
        f: torch.cat([getattr(o, f).reshape((-1,) + getattr(o, f).shape[1:])
                      for o in outs]).cpu()
        for f in ("rx", "ry", "hits", "hit_valid")})


def _replayed_on_cpu(srv):
    """`srv`'s recorded frames applied again by a CPU server of the same
    configuration; returns it (closed)."""
    cpu = _recording_server()(srv.cfg, port=0, device="cpu",
                              ingest_mode=srv.ingest_mode,
                              native_codec=srv.native_codec,
                              separation=float(srv.offsets[1].item())
                              if srv.n > 1 else 0.0)
    for now, agents, cols in srv.frames:
        cpu.ingest_columns(agents, cols, now)
    cpu.close()
    return cpu


def _hold_server(name, srv, cpu):
    """The card server against its frames re-applied on the CPU: the same
    packets, closures equal, the grid bit-equal or differing only in cells
    of rays traced apart (as in phase 23)."""
    if cpu.pkt_total != srv.pkt_total:
        raise AssertionError(f"{name}: {srv.pkt_total} packets vs "
                             f"{cpu.pkt_total} on the CPU")
    mask, apart = _ray_cells_apart(_outs_cat(srv.outs), _outs_cat(cpu.outs),
                                   srv.cfg)
    _grids_agree(name, srv.state.grid, cpu.state.grid, mask, apart)
    return _same_closures(name, srv.state, cpu.state)


def phase_live(card, dev):
    """The live server's real loop on loopback (phase 26): bench_serve's
    ring through UDP, the recvmmsg drain, the native codec and the
    throughput ingest on the card, at each of LIVE_AGENTS agents for
    LIVE_SECONDS; every applied frame re-applied on the CPU. Returns
    {agents: bench_serve's record}."""
    import contextlib
    import io

    from swarm_tpu_torch import bench_serve

    out = {}
    for n in LIVE_AGENTS:
        _reset_counts()                      # this path starts here
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rec, srv = bench_serve.serve(n, LIVE_SECONDS, device=dev,
                                         server_cls=_recording_server())
        n_kernels = _no_kernel(f"live {n}")
        d = rec["detail"]
        beats = log.getvalue().count("[HEARTBEAT]")
        print(f"live server [{card}]: {n} agents, throughput ingest, "
              f"native codec, {d['duration_s']} s: {rec['value']} "
              f"packets/s, {len(srv.frames)} frames, {d['packets_applied']}"
              f" of {d['packets_sent']} packets applied (applied/offered "
              f"{d['applied_over_offered']}), {beats} heartbeat lines, "
              f"raster kernels {n_kernels}")
        print(json.dumps(rec))
        cpu = _replayed_on_cpu(srv)
        n_cl = _hold_server(f"live {n} card vs CPU [{card}]", srv, cpu)
        online = int(srv.state.pkt_counts.gt(0).sum())
        print(f"live {n}: {n_cl} closures on both sides, {online}/{n} "
              "agents heard")
        if len(srv.frames) < 2 or online != n or not d["packets_sent"]:
            raise AssertionError(f"live {n}: {len(srv.frames)} frames, "
                                 f"{online} agents heard")
        out[n] = rec
    return out


def phase_live_parity(card, dev):
    """The parity ingest (phase 27): the dual session's datagrams over
    loopback, LIVE_FRAME to a frame, drained with the native codec and
    applied packet by packet (`ingest_packet`) on the card, each frame
    stamped with its last packet's time; then the same frames on the
    CPU."""
    import socket

    from swarm_tpu_torch.config import SwarmConfig
    from swarm_tpu_torch.proto.packets import pack_quasar_v2_batch
    from swarm_tpu_torch.sim.scenario import generate_dual_session

    r = generate_dual_session(REPLAY_SEED, device="cpu")
    wire = pack_quasar_v2_batch(r.agent, r.x, r.y, r.yaw_q, r.encoder,
                                r.v2v, r.dist4, r.landmark)
    size = len(wire) // len(r.t)
    srv = _recording_server()(SwarmConfig(n_agents=2), port=0, device=dev,
                              ingest_mode="parity")
    clock = types.SimpleNamespace(value=0.0)
    srv.now = lambda: clock.value
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    _reset_counts()                          # this path starts here
    apply_s = 0.0
    try:
        for i in range(0, len(r.t), LIVE_FRAME):
            k = min(LIVE_FRAME, len(r.t) - i)
            for j in range(i, i + k):
                tx.sendto(wire[j * size:(j + 1) * size],
                          ("127.0.0.1", srv.port))
            agents, cols, got = [], [], 0
            deadline = time.time() + 5.0
            while got < k:
                a, c = srv.drain_columns()
                if len(a):
                    agents.append(a)
                    cols.append(c)
                    got += len(a)
                elif time.time() > deadline:
                    raise AssertionError(f"parity ingest: {got} of {k} "
                                         "datagrams arrived")
            clock.value = float(r.t[i + k - 1])
            _, sec = _wall(lambda: srv.ingest_columns(
                np.concatenate(agents),
                {f: np.concatenate([c[f] for c in cols]) for f in cols[0]}),
                dev)
            apply_s += sec
    finally:
        tx.close()
    n_kernels = _no_kernel("live parity")
    srv.close()
    cpu = _replayed_on_cpu(srv)
    n_cl = _hold_server(f"live parity card vs CPU [{card}]", srv, cpu)
    print(f"live parity ingest [{card}]: {srv.pkt_total} packets in "
          f"{len(srv.frames)} frames, {apply_s:.6f} s of frame application "
          f"({srv.pkt_total / apply_s:.1f} packets/s), {n_cl} closures, "
          f"raster kernels {n_kernels}")
    if srv.pkt_total != len(r.t) or n_cl == 0:
        raise AssertionError("live parity: packets lost or no closure")


def _read_png(path):
    """[H, W, 3] uint8 of an 8-bit RGB PNG with filter 0 on every row (what
    render.raster2d.encode_png writes)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise AssertionError(f"{path}: chunk {tag} CRC")
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
            if body[8:10] != b"\x08\x02":
                raise AssertionError(f"{path}: not 8-bit RGB")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def phase_run_session(card, dev):
    """run_session in its three presets into a temporary directory (phase
    28): dual_bot and swarm on the card, dual_bot_scripted on the card and
    on the CPU (the session files equal, the metrics equal but for the
    timing); each map.png read back with the module's own PNG reader.
    Returns the dual_bot run's final state."""
    import tempfile

    from swarm_tpu_torch.cli.run_session import main as run_session

    tmp = tempfile.mkdtemp(prefix="chip_smoke_session_")
    runs = {}
    for name, argv in (
            ("dual_bot", ["--preset", "dual_bot", "--steps",
                          str(SESSION_STEPS)]),
            ("swarm", ["--preset", "swarm", "--agents",
                       str(SESSION_SWARM_AGENTS), "--steps",
                       str(SESSION_SWARM_STEPS)]),
            ("dual_bot_scripted", ["--preset", "dual_bot_scripted"]),
            ("dual_bot_scripted cpu", ["--preset", "dual_bot_scripted",
                                       "--device", "cpu"])):
        out = os.path.join(tmp, name.replace(" ", "_"))
        if "cpu" not in name:
            argv = argv + ["--device", str(dev)]
        _reset_counts()                      # this path starts here
        (final, metrics), sec = _wall(lambda: run_session(
            argv + ["--out", out]), dev)
        n_kernels = _no_kernel(f"run_session {name}")
        img = _read_png(os.path.join(out, "map.png"))
        runs[name] = (out, final, metrics)
        print(f"run_session {name} [{card}]: {sec:.3f} s, map.png "
              f"{img.shape[1]}x{img.shape[0]}, files "
              f"{sorted(os.listdir(out))}, raster kernels {n_kernels}")
        if img.shape[0] != img.shape[1] or not img.any():
            raise AssertionError(f"run_session {name}: map.png {img.shape}")
    d, s = runs["dual_bot"][2], runs["swarm"][2]
    if d["packets"] != 2 * SESSION_STEPS or d["online_at_end"] != 2 or \
            s["packets"] != SESSION_SWARM_AGENTS * SESSION_SWARM_STEPS or \
            d["total_cell_writes"] <= 0 or s["total_cell_writes"] <= 0:
        raise AssertionError(f"run_session: metrics {d} {s}")
    (oc, _, mc), (oh, _, mh) = runs["dual_bot_scripted"], \
        runs["dual_bot_scripted cpu"]
    for fn in ("telemetry.csv", "pointcloud.csv", "slam_closures.csv",
               "pointcloud_merged.csv"):
        with open(os.path.join(oc, fn), "rb") as a, \
                open(os.path.join(oh, fn), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"run_session scripted: {fn} card != "
                                     "CPU")
    same = {k: (mc[k], mh[k]) for k in mc if k != "replay_elapsed_s"}
    if any(a != b for a, b in same.values()) or mc["closures"] == 0:
        raise AssertionError(f"run_session scripted: metrics {same}")
    print(f"run_session scripted card vs CPU: the session files equal, "
          f"metrics {mc}")
    return runs["dual_bot"][1], tmp


def phase_checkpoint(card, dev, full, tmp):
    """Checkpoint / resume on the card (phase 29): run_session dual_bot for
    CHECKPOINT_STEPS steps with --checkpoint, then --resume for as many
    more: every leaf of the final state bit-equal to phase 28's
    uninterrupted SESSION_STEPS-step run (same seed)."""
    from swarm_tpu_torch.cli.run_session import main as run_session
    from swarm_tpu_torch.engine.checkpoint import _paths

    ck = os.path.join(tmp, "dual_bot.npz")
    common = ["--preset", "dual_bot", "--device", str(dev), "--steps",
              str(CHECKPOINT_STEPS)]
    _reset_counts()                          # this path starts here
    run_session(common + ["--out", os.path.join(tmp, "half"),
                          "--checkpoint", ck])
    done, _ = run_session(common + ["--out", os.path.join(tmp, "resumed"),
                                    "--resume", ck])
    n_kernels = _no_kernel("checkpoint")
    bad = [k for (k, a), (_, b) in zip(_paths(done), _paths(full))
           if not torch.equal(a, b)]
    print(f"checkpoint [{card}]: {CHECKPOINT_STEPS} + {CHECKPOINT_STEPS} "
          f"steps resumed vs {SESSION_STEPS} straight: "
          f"{len(_paths(full)) - len(bad)} of {len(_paths(full))} leaves "
          f"bit-equal, checkpoint {os.path.getsize(ck)} bytes, raster "
          f"kernels {n_kernels}")
    if bad or int(done.step) != SESSION_STEPS:
        raise AssertionError(f"checkpoint: leaves differ {bad}")


# the sharded engine's XLA tiers (no raster kernel on these paths): the
# fast free-space tier (use_pallas=False) and the line scatter (every
# raster mode but the beam mode) in every decomposition, bench_sharded,
# and the card against the CPU

XLA_STEPS = 33               # timed, after one warm-up: merges at 15 and 31
LINE_STEPS = 16              # timed, after one warm-up: a merge at step 15
XLA_DECISIONS_BAR = 0.01     # XLA vs kernel tier: differing explored cells
XLA_WRITES_RATIO = (0.9, 1.1)  # kernel / XLA writes (__graft_entry__.py:317)
BENCH_SHARDED_AGENTS = 1024
BENCH_SHARDED_STEPS = 20
TIERS_XLA = dict(use_pallas=False)
TIERS_LINE = dict(raster_mode="line")


def _tier_path(card, dev, name, grid_sharding, eng, flags, n_timed,
               kernels=False, split=True):
    """One sharded path on the one-rank group at N_AGENTS agents: the
    counters set to 0, one warm-up step and `n_timed` timed steps, the
    counters read: no raster kernel launched (unless `kernels`), every
    timed step writes with all agents online, a merge on every merge step
    and on no other, no band escape, poses finite; steps/s and peak
    memory; then (with `split`) SPLIT_STEPS more steps split on the device
    timeline. Returns (the global state after the timed steps, summary)."""
    from swarm_tpu_torch.engine.sim import total_writes_value
    from swarm_tpu_torch.ops.raster import ordered_add
    from swarm_tpu_torch.parallel import sharded

    cfg, step, state, lay = _sharded_run(dev, grid_sharding, flags, eng)
    every = cfg.engine.merge_every
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ordered_add.deepest = 0
    _reset_counts()                          # the path starts here
    state, m0 = step(state)
    torch.cuda.synchronize()
    state, ms, wall, step_ms = _run_steps(step, state, n_timed)
    launches = _kernel_launches()
    _check_path(name, N_AGENTS, ms, state, kernels=kernels)
    allm = [m0] + ms
    writes = _stacked(allm, "writes")
    merges = _stacked(allm, "merges")
    escapes = int(_stacked(allm, "band_escapes").sum())
    want = [k % every == every - 1 for k in range(n_timed + 1)]
    if not bool((writes > 0).all()) or escapes or \
            [bool(x > 0) for x in merges] != want:
        raise AssertionError(f"{name}: writes {writes.tolist()[:4]}, "
                             f"merges {merges.tolist()}, band escapes "
                             f"{escapes}")
    peak = torch.cuda.max_memory_allocated()
    merge_steps = [k for k in range(n_timed + 1) if want[k]]
    print(f"{name} at {N_AGENTS} agents on one rank (NCCL) [{card}]: "
          f"{n_timed + 1} steps, raster launches {launches}, online "
          f"{N_AGENTS} on every timed step, min writes {int(writes.min())}, "
          f"merges {[int(merges[k]) for k in merge_steps]} at steps "
          f"{merge_steps}, band escapes 0, poses finite; "
          f"{n_timed / wall:.2f} steps/s, "
          f"{int(writes.to(torch.int64).sum())} applied cells, device step "
          f"median {_median(step_ms):.4f} ms, peak memory {peak} bytes, "
          f"ordered add's deepest layer {ordered_add.deepest}")
    full = sharded.gather_state(state, lay, grid_sharding)
    full = full._replace(srv=full.srv._replace(
        logodds=full.srv.logodds.clone()))
    summary = dict(steps_s=n_timed / wall, peak=peak,
                   writes=total_writes_value(full.srv.total_writes))
    if split:
        state, summary["split"] = _step_split(step, state, SPLIT_STEPS,
                                              _sharded_parts())
        print(f"{name} step split [{card}], device-timeline medians over "
              f"{SPLIT_STEPS} more steps (ms): "
              f"{_split_text(summary['split'])}")
    del state, step
    torch.cuda.empty_cache()
    return full, summary


def _bit_equal_decomps(name, full):
    """"rows" and "tiles" BIT-EQUAL to "replicated": maps, writes, poses."""
    ref = full["replicated"]
    for gs in ("rows", "tiles"):
        got = full[gs]
        n_diff = int((got.srv.logodds != ref.srv.logodds).sum())
        same_w = torch.equal(got.srv.total_writes, ref.srv.total_writes)
        same_p = torch.equal(got.pose_true, ref.pose_true)
        print(f"{name} {gs} vs replicated: {n_diff} of "
              f"{ref.srv.logodds.numel()} cells differ, writes equal "
              f"{same_w}, poses equal {same_p}")
        if n_diff or not same_w or not same_p:
            raise AssertionError(f"{name}: {gs} is not bit-equal to "
                                 "replicated")


def phase_sharded_xla(card, dev):
    """Phase 30: the XLA fast tier (presets.deployable(1024) with
    use_pallas=False: free_raster_reference per fan on a fresh window, the
    exact endpoint delta) on the one-rank NCCL group in "replicated",
    "rows" and "tiles" (`_tier_path`, XLA_STEPS timed steps, no raster
    kernel), "rows" and "tiles" BIT-EQUAL to "replicated"; then the
    window kernel without the ring (exact_endpoints=True, the reference's
    pairing) on the same world, seed and steps: writes ratio within
    XLA_WRITES_RATIO and tri-state decisions differing in at most
    XLA_DECISIONS_BAR of the explored cells."""
    from swarm_tpu_torch.config import GridConfig
    from swarm_tpu_torch.ops.raster import tri_state_view

    full, summary = {}, {}
    for gs in ("replicated", "rows", "tiles"):
        full[gs], summary[gs] = _tier_path(
            card, dev, f"sharded XLA tier {gs}", gs, TIERS_XLA, None,
            XLA_STEPS)
    _bit_equal_decomps("sharded XLA tier", full)
    kern, k_sum = _tier_path(card, dev, "sharded kernel tier without the "
                             "ring, replicated", "replicated", None,
                             dict(exact_endpoints=True), XLA_STEPS,
                             kernels=True)
    xla = full["replicated"]
    cfg_g = GridConfig(size=xla.srv.logodds.shape[0])
    t_x = tri_state_view(xla.srv.logodds, cfg_g)
    t_k = tri_state_view(kern.srv.logodds, cfg_g)
    explored = (t_x != cfg_g.unknown) | (t_k != cfg_g.unknown)
    n_dec, n_exp = int((t_x != t_k).sum()), max(int(explored.sum()), 1)
    ratio = k_sum["writes"] / max(summary["replicated"]["writes"], 1)
    apart = int((torch.abs(kern.srv.logodds - xla.srv.logodds) > 1e-3).sum())
    rx, rk = summary["replicated"]["split"]["raster"][0], \
        k_sum["split"]["raster"][0]
    print(f"sharded XLA tier vs kernel tier (replicated, {XLA_STEPS + 1} "
          f"steps) [{card}]: writes {summary['replicated']['writes']} vs "
          f"{k_sum['writes']} (kernel / XLA {ratio:.6f}), {n_dec} tri-state "
          f"decisions differ of {n_exp} explored cells "
          f"({n_dec / n_exp:.3e}), {apart} cells apart by > 1e-3; raster "
          f"{rx:.4f} ms vs {rk:.4f} ms a step, steps/s "
          f"{summary['replicated']['steps_s']:.2f} vs {k_sum['steps_s']:.2f}")
    if not XLA_WRITES_RATIO[0] < ratio < XLA_WRITES_RATIO[1] or \
            n_dec > XLA_DECISIONS_BAR * n_exp:
        raise AssertionError("the sharded XLA tier and the kernel tier "
                             "disagree")


def phase_sharded_line(card, dev):
    """Phase 31: the line scatter (presets.deployable(1024) with
    raster_mode="line": the 4-way rays, then the sweep's, through
    logodds_delta's ordered scatter) on the one-rank NCCL group in the
    three decompositions (`_tier_path`, LINE_STEPS timed steps, no raster
    kernel), "rows" and "tiles" BIT-EQUAL to "replicated", and
    "replicated" run a second time BIT-IDENTICAL to the first."""
    full = {}
    for gs in ("replicated", "rows", "tiles"):
        full[gs], _ = _tier_path(card, dev, f"sharded line scatter {gs}", gs,
                                 TIERS_LINE, None, LINE_STEPS,
                                 split=gs == "replicated")
    _bit_equal_decomps("sharded line scatter", full)
    again, _ = _tier_path(card, dev, "sharded line scatter replicated "
                          "(again)", "replicated", TIERS_LINE, None,
                          LINE_STEPS, split=False)
    ref = full["replicated"]
    same = torch.equal(again.srv.logodds, ref.srv.logodds) and \
        torch.equal(again.pose_true, ref.pose_true) and \
        torch.equal(again.srv.total_writes, ref.srv.total_writes)
    print(f"sharded line scatter replicated run twice: bit-identical {same}")
    if not same:
        raise AssertionError("the sharded line scatter changed between "
                             "runs")


def phase_bench_sharded(card):
    """bench_sharded (`python -m swarm_tpu_torch.bench_sharded --agents
    BENCH_SHARDED_AGENTS --steps BENCH_SHARDED_STEPS`, world 1 on this
    card) as its own process: it must exit 0."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "swarm_tpu_torch.bench_sharded", "--agents",
         str(BENCH_SHARDED_AGENTS), "--steps", str(BENCH_SHARDED_STEPS)],
        cwd=here, capture_output=True, text=True, timeout=600)
    print(out.stdout.strip())
    if out.returncode != 0 or "OK: identical writes" not in out.stdout:
        raise AssertionError(f"bench_sharded failed:\n{out.stderr[-3000:]}")
    print(f"bench_sharded on the card [{card}]: "
          f"{time.perf_counter() - t0:.2f} s in all")


def phase_sharded_reference(card, dev):
    """Phase 32: the card against the CPU at REF_AGENTS agents over
    REF_STEPS steps (two merge events) from the same state and noise (drawn
    on the CPU): the XLA tier on "replicated" and "tiles" and the line
    scatter on "replicated", on a one-rank NCCL group and on a one-rank
    gloo group, held to phase 11's bar (online equal, writes within 1%,
    tri-state maps equal on >= 99% of the explored cells, a merge event
    ran)."""
    from datetime import timedelta

    import torch.distributed as dist

    from swarm_tpu_torch.config import GridConfig
    from swarm_tpu_torch.engine.sim import draw_step_noise
    from swarm_tpu_torch.ops.raster import tri_state_view
    from swarm_tpu_torch.parallel import mesh, sharded

    cases = {"XLA tier replicated": ("replicated", TIERS_XLA),
             "XLA tier tiles": ("tiles", TIERS_XLA),
             "line scatter replicated": ("replicated", TIERS_LINE)}
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(SEED)
    noises = [draw_step_noise(gen, REF_AGENTS, 181, cpu)
              for _ in range(REF_STEPS)]
    out = {}
    for d in (dev, cpu):
        mesh.init(f"tcp://127.0.0.1:{mesh.free_port()}", 1, 0,
                  timedelta(seconds=SHARDED_TIMEOUT_S), device=d)
        try:
            for name, (gs, eng) in cases.items():
                cfg, step, st, lay = _sharded_run(d, gs, None, eng,
                                                  n_agents=REF_AGENTS)
                writes, merges = [], []
                for nz in noises:
                    st, m = step(st, type(nz)(*(
                        None if f is None else type(f)(*(x.to(d) for x in f))
                        for f in nz)))
                    writes.append(int(m.writes))
                    merges.append(int(m.merges))
                full = sharded.gather_state(st, lay, gs)
                out[name, d.type] = (
                    tri_state_view(full.srv.logodds, cfg.grid).cpu(),
                    writes, merges, int(m.online))
        finally:
            dist.destroy_process_group()
    unknown = GridConfig().unknown
    for name in cases:
        (t_d, w_d, m_d, on_d), (t_c, w_c, m_c, on_c) = \
            out[name, dev.type], out[name, "cpu"]
        explored = (t_c != unknown) | (t_d != unknown)
        agree = float(((t_c == t_d) & explored).sum()) / max(
            int(explored.sum()), 1)
        ev = [k for k in range(REF_STEPS) if m_c[k] or m_d[k]]
        print(f"sharded reference [{name}] at {REF_AGENTS} agents, "
              f"{REF_STEPS} steps, NCCL vs gloo [{card}]: writes "
              f"{sum(w_d)} (card) vs {sum(w_c)} (CPU), tri-state agreement "
              f"{agree:.6f} over {int(explored.sum())} explored cells, "
              f"merges at steps {ev}: {[m_d[k] for k in ev]} (card) vs "
              f"{[m_c[k] for k in ev]} (CPU)")
        if on_d != on_c or abs(sum(w_d) - sum(w_c)) > 0.01 * sum(w_c) or \
                agree < 0.99 or not ev:
            raise AssertionError(f"sharded reference [{name}]: card and "
                                 "CPU disagree")


def phase_sharded_tiers(card, dev):
    """Phases 30-32: the XLA fast tier and the line scatter at N_AGENTS
    agents on a one-rank NCCL group, bench_sharded as its own process,
    then the card against the CPU at REF_AGENTS agents and the dry run's
    new sections at world size 1 on the card."""
    from datetime import timedelta

    import torch.distributed as dist

    from swarm_tpu_torch.parallel import mesh

    mesh.init(f"tcp://127.0.0.1:{mesh.free_port()}", 1, 0,
              timedelta(seconds=SHARDED_TIMEOUT_S), device=dev)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError("the card's process group is not NCCL")
        phase_sharded_xla(card, dev)
        phase_sharded_line(card, dev)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    phase_bench_sharded(card)
    phase_sharded_reference(card, dev)
    phase_dryrun(card, expect=("rows [xla] vs replicated",
                               "tiles [line] vs replicated",
                               "XLA tier vs kernel without the ring"))


FIRMWARE_AGENTS = N_AGENTS   # presets.deployable(1024)'s robots and rooms
FIRMWARE_TICKS = 100
FIRMWARE_DT = 0.05           # s a tick
FIRMWARE_PACKET_AGENTS = 64  # closure packets: these agents' estimates at
FIRMWARE_PACKET_TICKS = tuple(range(0, 40, 5))  # these ticks, 512 packets
FIRMWARE_ATOL = 1e-5         # card vs CPU floats (atol = rtol)
FW_THRESHOLDS = (0.4, 0.8)   # detect_landmark_fw's 40 cm / 80 cm


def _firmware_draws(params, rooms, seed):
    """Everything the firmware phase consumes, made on the host with numpy
    so that the card and the CPU see the same inputs: the robots' true
    poses per tick (from a random place and heading in each robot's room,
    the commanded motion kept 15 cm off its walls), the
    commands and their ages, gyro readings, encoder counts, the commanded
    yaw and three pings' sensor noise [T, 3, N, 4]."""
    from swarm_tpu_torch.geom.world import agent_room_boxes

    rng = np.random.default_rng(seed)
    n, steps = params.home_x.shape[0], FIRMWARE_TICKS
    box = agent_room_boxes(rooms[0].cpu().numpy(), rooms[1].cpu().numpy())
    lo, hi = box[:, :2] + 0.15, box[:, 2:] - 0.15        # 15 cm off a wall
    lin = rng.uniform(-0.2, 1.0, (steps, n)).astype(np.float32)
    ang = rng.uniform(-2.0, 2.0, (steps, n)).astype(np.float32)
    age = rng.uniform(0.0, 0.8, (steps, n)).astype(np.float32)
    age[:, ::16] = 0.5                     # the dead-man's own bound
    pose = np.zeros((steps, n, 3), np.float32)
    p = np.concatenate([rng.uniform(lo, hi),
                        rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    yaw_cmd = np.zeros((steps, n), np.float32)
    for k in range(steps):
        p[:, 2] = np.remainder(p[:, 2] + ang[k] * FIRMWARE_DT + np.pi,
                               2 * np.pi) - np.pi
        step = lin[k] * FIRMWARE_DT
        p[:, :2] = np.clip(p[:, :2] + step[:, None] * np.stack(
            [np.cos(p[:, 2]), np.sin(p[:, 2])], -1), lo, hi)
        pose[k] = p
        yaw_cmd[k] = p[:, 2]
    return dict(
        pose=pose, lin=lin, ang=ang, age=age, yaw_cmd=yaw_cmd,
        omega=(ang + rng.normal(0, 0.01, (steps, n))).astype(np.float32),
        counts=rng.integers(-5, 30, (steps, n)).astype(np.int32),
        gauss=rng.standard_normal((steps, 3, n, 4)).astype(np.float32),
        spur_u=rng.random((steps, 3, n, 4), np.float32),
        spur_p=rng.random((steps, 3, n, 4), np.float32))


def _firmware_run(dev, params, rooms, draws):
    """The per-robot firmware loop on `dev` over FIRMWARE_TICKS ticks:
    three-ping sensing against each robot's room, room-culled casting held
    BIT-EQUAL to sense_true's cast, the firmware landmark classifier, the
    command receiver, dead reckoning along the commanded yaw and the EKF's
    predict and update, batched over the robots. Returns (per-tick records
    and final states on the CPU, seconds)."""
    from swarm_tpu_torch.config import SensorConfig
    from swarm_tpu_torch.geom.world import cast_rays_grouped
    from swarm_tpu_torch.models import (detect_landmark_fw, ekf_init,
                                        ekf_predict, ekf_update,
                                        firmware_odometry_step,
                                        sense_4way_median3, sense_true)
    from swarm_tpu_torch.models.scan import cmd_vel_drive
    from swarm_tpu_torch.models.sensors import SensorNoise

    def d(key, k):
        return torch.from_numpy(draws[key][k]).to(dev)

    wg, roa = rooms[0].to(dev), rooms[1].to(dev)
    walls_agent = wg[roa.long()]                          # [N, 4, 4]
    angles = torch.tensor(SensorConfig().angles, device=dev)
    n = roa.shape[0]
    pose0 = torch.from_numpy(draws["pose"][0]).to(dev)
    zeros = torch.zeros((n,), device=dev)
    st = ekf_init(torch.stack([pose0[:, 0], pose0[:, 1], pose0[:, 2], zeros,
                               zeros, zeros], -1))
    x_est, y_est = pose0[:, 0].clone(), pose0[:, 1].clone()
    rec = {k: [] for k in ("readings", "codes", "pwm", "m")}
    culled_apart = 0
    _sync(dev)
    t0 = time.perf_counter()
    for k in range(FIRMWARE_TICKS):
        pose = d("pose", k)
        noise = SensorNoise(d("gauss", k), d("spur_u", k), d("spur_p", k))
        readings = sense_4way_median3(noise, pose, walls_agent)
        culled = cast_rays_grouped(
            pose[:, None, :2].expand(n, 4, 2), pose[:, 2:3] + angles, wg,
            roa[:, None].expand(n, 4))
        culled_apart += int((culled != sense_true(pose, walls_agent)).sum())
        codes = detect_landmark_fw(readings[:, 0], readings[:, 1],
                                   readings[:, 3])
        pwm = torch.stack(cmd_vel_drive(d("lin", k), d("ang", k),
                                        d("age", k)), -1)
        x_est, y_est, m = firmware_odometry_step(x_est, y_est,
                                                 d("yaw_cmd", k),
                                                 d("counts", k))
        tk = (k + 1) * FIRMWARE_DT
        st = ekf_predict(st, d("omega", k), tk)
        st = ekf_update(st, m / FIRMWARE_DT, d("omega", k))
        for key, v in (("readings", readings), ("codes", codes),
                       ("pwm", pwm), ("m", m)):
            rec[key].append(v)
    _sync(dev)
    sec = time.perf_counter() - t0
    out = {key: torch.stack(v).cpu() for key, v in rec.items()}
    out.update(x_est=x_est.cpu(), y_est=y_est.cpu(), ekf_x=st.x.cpu(),
               ekf_P=st.P.cpu(), culled_apart=culled_apart)
    return out, sec


def _fw_packets(rec, draws):
    """Closure packets: FIRMWARE_PACKET_AGENTS robots' positions (the true
    poses plus their dead-reckoning error at that tick) and landmark codes
    at each of FIRMWARE_PACKET_TICKS, one batch of distinct agents per
    tick, every ninth packet invalid."""
    a = FIRMWARE_PACKET_AGENTS
    out = []
    for j, k in enumerate(FIRMWARE_PACKET_TICKS):
        pose = torch.from_numpy(draws["pose"][k][:a])
        err = 0.01 * torch.sin(torch.arange(a, dtype=torch.float32) + k)
        valid = (torch.arange(a) + j) % 9 != 0
        out.append((pose[:, 0] + err, pose[:, 1] - err,
                    torch.arange(a, dtype=torch.int32),
                    rec["codes"][k][:a].clone(), valid))
    return out


def _fw_closures(dev, packets):
    """The packets through `closure_add_pose` one by one and through
    `closure_add_poses_seq` batch by batch on `dev`: every state field,
    closed, cdx and cdy BIT-EQUAL between the two. Returns (state, closed,
    cdx, cdy) of the one-by-one run on the CPU, and its seconds."""
    from swarm_tpu_torch.slam import (closure_add_pose, closure_add_poses_seq,
                                      closure_init)

    st1 = st2 = closure_init(FIRMWARE_PACKET_AGENTS, device=dev)
    got, ref = [], []
    _sync(dev)
    t0 = time.perf_counter()
    for xs, ys, ag, lm, valid in packets:
        xs, ys, ag, lm, valid = (v.to(dev) for v in (xs, ys, ag, lm, valid))
        for i in range(xs.shape[0]):
            st1, c, dx, dy = closure_add_pose(st1, xs[i], ys[i], ag[i], lm[i],
                                              valid=valid[i])
            got.append(torch.stack([c.float(), dx, dy]))
        st2, c, dx, dy = closure_add_poses_seq(st2, xs, ys, ag, lm,
                                               valid=valid)
        ref.append(torch.stack([c.float(), dx, dy], -1))
    _sync(dev)
    sec = time.perf_counter() - t0
    got, ref = torch.stack(got), torch.cat(ref)
    apart = [f for f in st1._fields
             if not torch.equal(getattr(st1, f), getattr(st2, f))]
    if apart or not torch.equal(got, ref):
        raise AssertionError(f"closure_add_pose vs closure_add_poses_seq on "
                             f"{dev}: fields {apart}, decisions equal "
                             f"{torch.equal(got, ref)}")
    return type(st1)(*(f.cpu() for f in st1)), got.cpu(), sec


def _near(values, thresholds, tol):
    """Entries within `tol` of any threshold."""
    near = torch.zeros(values.shape, dtype=torch.bool)
    for c in thresholds:
        near |= (values - c).abs() <= tol
    return near


def phase_firmware(card, dev):
    """Phase 33: the firmware-faithful per-robot API at FIRMWARE_AGENTS
    robots on presets.deployable's tiled rooms for FIRMWARE_TICKS ticks,
    then FIRMWARE_PACKET_AGENTS x len(FIRMWARE_PACKET_TICKS) closure
    packets one by one, on the card and again on the CPU from the same
    draws: PWM, closure decisions and ints equal, landmark codes equal
    (but where a reading lies within FIRMWARE_ATOL of a threshold: none
    expected), floats within FIRMWARE_ATOL (the EKF's yaw as an angle,
    ROADMAP C31), the sentinel exact, the culled cast bit-equal to the
    full one on each device; no raster kernel launched."""
    from swarm_tpu_torch.config import SensorConfig
    from swarm_tpu_torch.presets import deployable

    cpu = torch.device("cpu")
    _, _, params, rooms = deployable(FIRMWARE_AGENTS, device=cpu)
    draws = _firmware_draws(params, rooms, SEED + 90)
    _reset_counts()
    runs, secs = {}, {}
    for d in (dev, cpu):
        runs[d.type], secs[d.type] = _firmware_run(d, params, rooms, draws)
    packets = _fw_packets(runs["cpu"], draws)
    closures, secs_cl = {}, {}
    for d in (dev, cpu):
        st, dec, secs_cl[d.type] = _fw_closures(d, packets)
        closures[d.type] = (st, dec)
    rd, rc = runs[dev.type], runs["cpu"]
    atol = FIRMWARE_ATOL
    sentinel = SensorConfig().timeout_sentinel
    near = _near(rc["readings"][..., [0, 1, 3]], FW_THRESHOLDS, atol) | \
        _near(rd["readings"][..., [0, 1, 3]], FW_THRESHOLDS, atol)
    near_code = near.any(-1)
    code_flips = int(((rd["codes"] != rc["codes"]) & ~near_code).sum())
    near_flips = int(((rd["codes"] != rc["codes"]) & near_code).sum())
    read_d = float((rd["readings"] - rc["readings"]).abs().max())
    sent_c, sent_d = rc["readings"] == sentinel, rd["readings"] == sentinel
    sent_apart = int(((sent_c != sent_d) & ~_near(rc["readings"],
                                                   (sentinel,), atol)).sum())
    yaw = torch.remainder(rd["ekf_x"][:, 2] - rc["ekf_x"][:, 2] + math.pi,
                          2 * math.pi) - math.pi

    def off(a, b):
        """Largest |a - b| beyond the atol = rtol bar (<= 0 passes)."""
        return float(((a - b).abs() - atol - atol * b.abs()).max())

    float_off = max(off(rd["m"], rc["m"]), off(rd["x_est"], rc["x_est"]),
                    off(rd["y_est"], rc["y_est"]),
                    off(rd["ekf_x"][:, [0, 1, 3, 4, 5]],
                        rc["ekf_x"][:, [0, 1, 3, 4, 5]]),
                    off(rd["ekf_P"], rc["ekf_P"]), float(yaw.abs().max())
                    - atol, off(rd["readings"], rc["readings"]))
    (st_d, dec_d), (st_c, dec_c) = closures[dev.type], closures["cpu"]
    ints_apart = [f for f in st_c._fields
                  if not getattr(st_c, f).dtype.is_floating_point and
                  not torch.equal(getattr(st_d, f), getattr(st_c, f))]
    fl_apart = max(float((getattr(st_d, f) - getattr(st_c, f)).abs().max())
                   for f in st_c._fields
                   if getattr(st_c, f).dtype.is_floating_point)
    n_closed = int(dec_c[:, 0].sum())
    n_pk = dec_c.shape[0]
    codes = torch.bincount(rc["codes"].reshape(-1).long(), minlength=6)
    print(f"firmware [{card}]: {FIRMWARE_AGENTS} robots x {FIRMWARE_TICKS} "
          f"ticks on the card {secs[dev.type]:.6f} s "
          f"({1e3 * secs[dev.type] / FIRMWARE_TICKS:.4f} ms a tick), the "
          f"CPU {secs['cpu']:.6f} s; {n_pk} closure packets one by one on "
          f"the card {secs_cl[dev.type]:.6f} s "
          f"({1e3 * secs_cl[dev.type] / n_pk:.4f} ms a packet), the CPU "
          f"{secs_cl['cpu']:.6f} s; landmark codes {codes.tolist()}, "
          f"{int(sent_c.sum())} sentinel readings, {n_closed} closures")
    print(f"firmware card vs CPU [{card}]: codes apart {code_flips} (+ "
          f"{near_flips} within {atol} of a threshold), PWM "
          f"{'equal' if torch.equal(rd['pwm'], rc['pwm']) else 'APART'}, "
          f"readings {read_d:.3g} apart, sentinel apart {sent_apart}, "
          f"floats beyond the bar by {float_off:.3g} (<= 0 passes), EKF "
          f"yaw {float(yaw.abs().max()):.3g} rad; culled vs full cast "
          f"{rd['culled_apart']} (card) / {rc['culled_apart']} (CPU) "
          f"readings apart; closures: ints apart {ints_apart}, decisions "
          f"{'equal' if torch.equal(dec_d[:, 0], dec_c[:, 0]) else 'APART'}"
          f", floats {fl_apart:.3g} apart; raster kernels "
          f"{_no_kernel('firmware')}")
    if code_flips or near_flips > 4 or \
            not torch.equal(rd["pwm"], rc["pwm"]) or sent_apart or \
            float_off > 0 or rd["culled_apart"] or rc["culled_apart"] or \
            ints_apart or not torch.equal(dec_d[:, 0], dec_c[:, 0]) or \
            fl_apart > atol or not n_closed or not int(sent_c.sum()) or \
            int((codes[1:] > 0).sum()) < 2:
        raise AssertionError("firmware phase")
    return secs[dev.type] + secs_cl[dev.type]


PILE_NODES = 256             # the pile-up graph: a noisy loop whose
PILE_CLOSURES = 32           # closures mostly start at one node
PILE_NODE = 37
PILE_UNARY = 16


def _pileup_graph(dev, seed):
    """A noisy loop of PILE_NODES nodes with PILE_CLOSURES closures, 28 of
    them from node PILE_NODE (two between the same pair), and PILE_UNARY
    unary factors, 6 on PILE_NODE: (graph, unary) on `dev`."""
    from swarm_tpu_torch.slam.posegraph import graph_from_trajectory

    rng = np.random.default_rng(seed)
    m, c = PILE_NODES, PILE_CLOSURES
    s = np.linspace(0, 4 * np.pi, m)
    truth = np.stack([np.cos(s), np.sin(s), s + np.pi / 2], -1)
    noisy = (truth + 0.05 * rng.normal(size=truth.shape)).astype(np.float32)
    noisy[0] = truth[0]
    ci = np.full(c, PILE_NODE, np.int32)
    ci[-4:] = rng.integers(m // 2, m - 1, 4)
    cj = rng.integers(m // 2, m - 1, c).astype(np.int32)
    cj[1] = cj[0]
    cmeas = (0.02 * rng.normal(size=(c, 3))).astype(np.float32)
    g = graph_from_trajectory(torch.from_numpy(noisy), m,
                              torch.from_numpy(ci), torch.from_numpy(cj),
                              torch.from_numpy(cmeas), c)
    nodes = rng.integers(0, m, PILE_UNARY)
    nodes[:6] = PILE_NODE
    unary = (torch.from_numpy(nodes.astype(np.int32)),
             torch.from_numpy(noisy[nodes] + 0.01 * rng.normal(
                 size=(PILE_UNARY, 3)).astype(np.float32)),
             torch.full((PILE_UNARY, 3), 4.0))
    return (type(g)(*(f.to(dev) for f in g)),
            tuple(u.to(dev) for u in unary))


def _order_inputs(g, unary):
    """The addends of every assembly site on the pile-up graph [1, ...],
    computed once (on the CPU): the graph, the unary nodes, each edge's
    gradient terms, its four Hessian blocks, the unary terms, the closures'
    Jacobians and weights (the closure factor's inputs)."""
    from swarm_tpu_torch.slam.posegraph import (_blk, _residuals_and_jac,
                                                _unary_residuals)

    wmask = torch.where(g.e_valid[..., None], g.weight,
                        torch.zeros_like(g.weight))
    r, Ji, Jj = _residuals_and_jac(g)
    wr = wmask * r
    Hij = _blk(Ji, Jj, wmask)
    n_chain = g.poses.shape[1] - 1
    return dict(
        g=g, nodes=unary[0],
        bi=torch.einsum("...eab,...ea->...eb", Ji, wr),
        bj=torch.einsum("...eab,...ea->...eb", Jj, wr),
        blocks=(_blk(Ji, Ji, wmask), _blk(Jj, Jj, wmask), Hij,
                Hij.transpose(-1, -2)),
        uwr=_unary_residuals(g.poses, unary)[0],
        cl=(Ji[:, n_chain:], Jj[:, n_chain:], g.ei[:, n_chain:].long(),
            g.ej[:, n_chain:].long(),
            g.e_valid[:, n_chain:, None] & (wmask[:, n_chain:] > 0)))


def _order_on(x, d):
    """`_order_inputs` moved to device d."""
    if isinstance(x, dict):
        return {k: _order_on(v, d) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(_order_on(v, d) for v in x)) \
            if hasattr(x, "_fields") else tuple(_order_on(v, d) for v in x)
    return x.to(d)


def _former_sites(x):
    """The scatter-add assembly the solvers used before their plans
    (ROADMAP C43), on the addends' device: {site: sum}."""
    from swarm_tpu_torch.slam.tridiag import _closure_factor

    g = x["g"]

    def rows(idx, src):
        return torch.zeros_like(g.poses).scatter_add_(
            -2, idx.long()[..., None].expand(src.shape), src)

    b = rows(g.ei, x["bi"]).scatter_add_(
        -2, g.ej.long()[..., None].expand(x["bj"].shape), x["bj"])
    nb, m = g.poses.shape[:2]
    H = torch.zeros((nb, 3 * m, 3 * m), device=b.device)
    k = torch.arange(3, device=b.device)
    for a_, c_, blocks in zip((g.ei, g.ej, g.ei, g.ej),
                              (g.ei, g.ej, g.ej, g.ei), x["blocks"]):
        rr = (3 * a_.long()[..., None, None] + k[:, None]).expand_as(blocks)
        cc = (3 * c_.long()[..., None, None] + k[None, :]).expand_as(blocks)
        bb = torch.arange(nb, device=b.device)[:, None, None, None]
        H.index_put_((bb.expand_as(blocks).reshape(-1), rr.reshape(-1),
                      cc.reshape(-1)), blocks.reshape(-1), accumulate=True)
    Jic, Jjc, ci, cj, live = x["cl"]
    n_chain = m - 1
    return {
        "gradient (posegraph._gradient, scatter_add_)": b,
        "dense Hessian (posegraph._add_blocks, index_put_ accumulate)": H,
        "unary terms (posegraph.unary_terms, scatter_add_)": rows(
            x["nodes"], x["uwr"]),
        "closure factor (tridiag._closure_factor, index_put_ accumulate)":
            _closure_factor(Jic, Jjc, ci, cj, live, m),
        "sharded trajectory solver's closure gradient (index_add)":
            b[0].index_add(0, ci[0], x["bi"][0, n_chain:]).index_add(
                0, cj[0], x["bj"][0, n_chain:]),
    }


def _plan_sites(x):
    """The same sums through the solvers' AddPlans: {site: sum}."""
    from swarm_tpu_torch.slam.posegraph import (_plan_rows, _sum_blocks,
                                                add_plans, plan_add,
                                                solve_plans)

    g = x["g"]
    plans = solve_plans(g, (x["nodes"],), hessian=True)
    m = g.poses.shape[1]
    b = _plan_rows(g.poses, plans["b"], torch.cat(
        [x["bi"].reshape(-1, 3), x["bj"].reshape(-1, 3)]))
    ci, cj = x["cl"][2][0], x["cl"][3][0]
    cl = add_plans((torch.cat([ci, cj]), 2 * ci.numel()))[0]
    return {
        "gradient": b,
        "dense Hessian": _sum_blocks(g.poses, plans["H"], x["blocks"]),
        "unary terms": _plan_rows(g.poses, plans["unary"], x["uwr"]),
        "sharded trajectory solver's closure gradient": plan_add(
            b[0].clone(), cl, torch.cat([x["bi"][0, m - 1:],
                                         x["bj"][0, m - 1:]])),
    }


def phase_solve_order(card, dev):
    """Phase 34: the solvers summed in a fixed order (ROADMAP C43). First
    each assembly site on the pile-up graph from the same addends (the
    CPU's, `_order_inputs`): the former scatter-add form run twice on the
    card (the
    bits apart between the runs and against the CPU: the finding for each
    site) and the plans' form, which must be BIT-EQUAL to the CPU's and
    between the runs. Then the batched dense and structured solves of
    phase 25's graphs and of the pile-up graph (dense and structured, with
    unary factors) twice on the card: BIT-IDENTICAL runs, and within
    SOLVE_CPU_ATOL of the CPU (yaws as angles) with final costs within
    rtol 1e-3."""
    from swarm_tpu_torch.slam.posegraph import (batched, gauss_newton,
                                                optimize_graphs_batch)
    from swarm_tpu_torch.slam.tridiag import structured_gn, structured_gn_batch

    cpu = torch.device("cpu")
    _reset_counts()
    g1, un1 = _pileup_graph(cpu, SEED + 82)
    inputs = _order_inputs(batched(g1), tuple(u[None] for u in un1))
    for name, fn, hard in (("former", _former_sites, False),
                           ("plan", _plan_sites, True)):
        ref = fn(inputs)
        run1, run2 = fn(_order_on(inputs, dev)), fn(_order_on(inputs, dev))
        for site in ref:
            runs = _bit_differ(run1[site].cpu(), run2[site].cpu())
            vs_cpu = _bit_differ(run1[site].cpu(), ref[site])
            print(f"solve order [{card}] {name} {site}: runs apart in "
                  f"{runs}, card vs CPU in {vs_cpu} of {ref[site].numel()} "
                  f"entries")
            if hard and (runs or vs_cpu):
                raise AssertionError(f"solve order: {name} {site}")

    loops = _loop_graphs(SOLVE_GRAPHS, SOLVE_NODES, cpu, SEED + 80)
    cases = (
        ("dense batch", loops, None, lambda gg, _: optimize_graphs_batch(
            gg, iterations=SOLVE_ITERS)),
        ("structured batch", loops, None, lambda gg, _: structured_gn_batch(
            gg, SOLVE_NODES - 1, iterations=SOLVE_ITERS)),
        ("dense pile-up + unary", g1, un1, lambda gg, uu: gauss_newton(
            gg, iterations=SOLVE_ITERS, unary=uu)),
        ("structured pile-up + unary", g1, un1, lambda gg, uu: structured_gn(
            gg, PILE_NODES - 1, iterations=SOLVE_ITERS, unary=uu)),
    )
    times = {}
    for name, gc, uc, solve in cases:
        gd = type(gc)(*(f.to(dev) for f in gc))
        ud = None if uc is None else tuple(u.to(dev) for u in uc)
        (o1, c1), sec = _wall(lambda: solve(gd, ud), dev)
        o2, c2 = solve(gd, ud)
        oc, cc = solve(gc, uc)
        runs = _bit_differ(o1.poses.cpu(), o2.poses.cpu()) + \
            _bit_differ(c1.cpu(), c2.cpu())
        pos, yaw = _graph_pose_diff(o1.poses, oc.poses)
        cost = float(((c1[..., -1].cpu() - cc[..., -1]).abs()
                      / cc[..., -1].abs().clamp_min(1e-6)).max())
        print(f"solve order [{card}] {name}: {sec:.6f} s on the card, two "
              f"runs apart in {runs} bits, card vs CPU {pos:.3g} m / "
              f"{yaw:.3g} rad, final cost rtol {cost:.3g}")
        if runs or max(pos, yaw) > SOLVE_CPU_ATOL or cost > 1e-3 or \
                not bool(torch.isfinite(o1.poses).all()):
            raise AssertionError(f"solve order: {name}")
        times[name] = sec
    print(f"solve order raster kernels {_no_kernel('solve order')}")
    return times


BENCH_RUNS = (("bench", []),                 # bench.py's defaults
              ("bench --room-kernel", ["--room-kernel", "--steps", "50",
                                       "--chunks", "1"]))
COVERAGE_TOOL_ARGS = ["--agents", str(COVERAGE_AGENTS), "--steps", "300",
                      "--chunk", "100"]
MERGE_INNER = 16
# card vs CPU solves of the merge bench's 1024-node graph, m and rad (yaws
# as angles, ROADMAP C31): dense at phase 25's bar; the structured solve
# of this graph is set by float32 to ~1e-3 (a 1e-6 change of the inputs
# moves it 8.7e-4 on the CPU, ROADMAP C44)
MERGE_CPU_ATOL = {"dense": SOLVE_CPU_ATOL, "structured": 5e-3}
PROFILE_ARGS = ["--agents", str(N_AGENTS), "--inner", "16", "--reps", "1"]
QUALITY_STEPS = 300
ROOFLINE_SHARE_MAX = 1.05


def _tool(name, fn, argv):
    """One tool's `main(argv)` on the card, timed; returns its result."""
    t0 = time.perf_counter()
    print(f"{name}: python -m swarm_tpu_torch.{fn.__module__.split('.')[-1]}"
          f" {' '.join(argv)}", flush=True)
    out = fn(argv)
    print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_bench(card, dev):
    """bench.py on the port (swarm_tpu_torch.bench) at its defaults and
    with --room-kernel, each with the counters set to 0 just before and
    read just after: its raster kernel launched once a step (warm chunk,
    timed chunks and the reconciliation's steps), the other never; the
    fresh ratio above the floor, merges, a finite merge probe. Returns
    {form: launches} per kernel ("window", "room")."""
    from swarm_tpu_torch import bench

    out = {}
    for name, argv in BENCH_RUNS:
        args = bench.parse_args(argv)
        steps = args.steps * (args.chunks + 1) + bench.RATIO_STEPS
        _reset_counts()
        res = _tool(name, bench.main, argv)
        n_free, by_form, n_room = _read_counts()
        d = res["detail"]
        room = args.room_kernel
        own = _room_by_form() if room else by_form
        want = {"pack16-ring" if room else "pack8-ring": steps}
        if own != want or (n_free if room else n_room):
            raise AssertionError(f"{name}: launches {own} (window {n_free}"
                                 f", room {n_room}), want {want}")
        if not d["delta_ratio_fresh"] > bench.RATIO_FLOOR or \
                d["merges_total"] <= 0 or \
                not math.isfinite(d["merge_event_ms"]) or \
                d["platform"] != "gpu" or res["value"] <= 0:
            raise AssertionError(f"{name}: {res}")
        print(f"{name} at {d['agents']} agents [{card}]: {res['value']:.6e} "
              f"cells/s, {d['steps_per_s']} steps/s, ratio curve "
              f"{d['delta_ratio_curve']}, merges {d['merges_total']}, merge "
              f"event {d['merge_event_ms']} ms ({d['merge_event_chunk']} "
              f"agents), full batch {d['merge_latency_full_batch_ms']} ms; "
              f"launches {want}")
        out["room" if room else "window"] = sum(want.values())
    return out


def phase_bench_coverage(card, dev):
    """tools/bench_coverage.py on the port at 64 agents (its world, both
    fans through the window kernel's pack16 forms at the accuracy path's
    shapes), 300 steps of each variant: both coverages > 0, launches one
    per fan a step. Returns the window kernel's launches per form."""
    from swarm_tpu_torch import bench_coverage

    _reset_counts()
    res = _tool("bench_coverage", bench_coverage.main, COVERAGE_TOOL_ARGS)
    n_free, by_form, n_room = _read_counts()
    steps = 2 * int(COVERAGE_TOOL_ARGS[3])
    if by_form != {"pack16": steps, "pack16-wrapped": steps} or n_room:
        raise AssertionError(f"bench_coverage: launches {by_form} (room "
                             f"{n_room})")
    finals = res["detail"]["finals_per_seed"]
    if min(min(v) for v in finals.values()) <= 0:
        raise AssertionError(f"bench_coverage: nothing covered {finals}")
    print(f"bench_coverage [{card}]: finals {finals}, steps to 50% "
          f"{ {k: res['detail'][k]['steps_to_50pct'] for k in finals} }, "
          f"launches {by_form}")
    return by_form


def phase_bench_merge(card, dev):
    """tools/bench_merge.py on the port (--inner 16): three finite times;
    then the 1024-node graph solved dense and structured on the card and
    on the CPU: poses within MERGE_CPU_ATOL (yaws as angles), final costs
    within rtol 1e-3."""
    from swarm_tpu_torch import bench_merge

    _reset_counts()
    res = _tool("bench_merge", bench_merge.main,
                ["--inner", str(MERGE_INNER)])
    times = [res[k] for k in ("scanmatch_ms", "posegraph_gn_1024n_10it_ms",
                              "posegraph_structured_gn_1024n_10it_ms")]
    if not all(math.isfinite(t) and t > 0 for t in times):
        raise AssertionError(f"bench_merge: {res}")
    g_d = bench_merge.inputs(bench_merge.NODES, dev)[2]
    g_c = bench_merge.inputs(bench_merge.NODES, "cpu")[2]
    for name, solve in (("dense", bench_merge.solve_dense),
                        ("structured", bench_merge.solve_structured)):
        (out_d, cost_d), (out_c, cost_c) = solve(g_d), solve(g_c)
        pos, yaw = _graph_pose_diff(out_d.poses, out_c.poses)
        cost_d, cost_c = float(cost_d[-1]), float(cost_c[-1])
        print(f"bench_merge {name} GN card vs CPU ({bench_merge.NODES} "
              f"nodes): poses within {pos:.3g} m, yaw {yaw:.3g} rad; final "
              f"cost {cost_d:.6g} vs {cost_c:.6g}")
        if not max(pos, yaw) <= MERGE_CPU_ATOL[name] or \
                not abs(cost_d - cost_c) <= 1e-3 * abs(cost_c):
            raise AssertionError(f"bench_merge {name}: card vs CPU {pos} m,"
                                 f" {yaw} rad, costs {cost_d}, {cost_c}")
    print(f"bench_merge [{card}]: {res}; raster kernels "
          f"{_no_kernel('bench_merge')}")


def phase_profile_step(card, dev):
    """tools/profile_step.py on the port at 1024 agents (--inner 16
    --reps 1): every row timed on the device and on the host, the step
    split's parts within the step (its rest >= 0), and the launches of its
    counted steps: the window kernel once a step, torch ops dispatched and
    device operations recorded."""
    from swarm_tpu_torch import profile_step

    res = _tool("profile_step", profile_step.main, PROFILE_ARGS)
    bad = {k: v for k, v in res["rows"].items()
           if not (v["device_ms"] > 0 and v["host_ms"] > 0)}
    split, n = res["split"], res["launches"]
    if len(res["rows"]) != 18 or bad or split["rest"][0] < 0 or \
            n["raster"] != n["steps"] or n["ops"] <= 0 or not n["device"]:
        raise AssertionError(f"profile_step: rows {bad}, split {split}, "
                             f"launches {n}")


def phase_roofline(card, dev):
    """tools/roofline.py on the port: the probe equal to its torch chain,
    the window kernel's share of its bound in (0, ROOFLINE_SHARE_MAX]."""
    from swarm_tpu_torch import roofline

    res = _tool("roofline", roofline.main, ["--agents", str(N_AGENTS)])
    share = res["kernel_bound_frac"]
    if res["probe_max_abs_err"] != 0.0 or \
            not 0.0 < share <= ROOFLINE_SHARE_MAX:
        raise AssertionError(f"roofline: {res}")


def phase_quality(card, dev):
    """tools/quality_onchip.py (--steps 300 --turbo) and
    tools/proto_phase_quality.py on the port: each tier's IoU and wall p90
    finite."""
    from swarm_tpu_torch import proto_phase_quality, quality_onchip

    q = _tool("quality_onchip", quality_onchip.main,
              ["--steps", str(QUALITY_STEPS), "--turbo"])
    p = _tool("proto_phase_quality", proto_phase_quality.main, [])
    tiers = {**{f"quality {k}": v for k, v in q["tiers"].items()},
             **{f"proto {k}": v for k, v in p["tiers"].items()}}
    bad = [k for k, v in tiers.items()
           if not (0 < v["iou"] <= 1 and math.isfinite(v["p90"]))]
    if len(tiers) != 5 or bad:
        raise AssertionError(f"quality: {tiers}")
    print(f"quality [{card}]: " + ", ".join(
        f"{k} IoU {v['iou']:.4f} p90 {v['p90']:.1f}"
        for k, v in tiers.items()))


def phase_tools(card, dev):
    """bench.py and the tools (phases 35-41 of the module docstring). Returns (the
    bench runs' launches per kernel, bench_coverage's per form)."""
    n_bench = phase_bench(card, dev)
    n_cov = phase_bench_coverage(card, dev)
    phase_bench_merge(card, dev)
    phase_profile_step(card, dev)
    phase_roofline(card, dev)
    phase_quality(card, dev)
    return n_bench, n_cov


DONATION_STEPS = 17          # one merge event (step 15)
DONATION_REPS = 5            # timed copies of the slice's grid


def _leaves(tree, path=""):
    """(path, tensor) of every tensor leaf of a NamedTuple tree."""
    if isinstance(tree, tuple):
        for name, x in zip(getattr(tree, "_fields", range(len(tree))), tree):
            yield from _leaves(x, f"{path}.{name}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _clone_tree(tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_clone_tree(x) for x in tree))
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _bits_apart(a, b) -> list:
    """The leaves of two NamedTuple trees whose bytes differ (a -0.0 is not
    a +0.0, a NaN equals only its own bits)."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["<structure>"]
    return [p for (p, x), (_, y) in zip(la, lb)
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.reshape(-1).contiguous().view(torch.uint8),
                y.reshape(-1).contiguous().view(torch.uint8))]


def _hold_bits(what, a, b):
    apart = _bits_apart(a, b)
    if apart:
        raise AssertionError(f"donation: {what}: {apart[:6]} differ")


def _peak_of(fn):
    """(fn's result, the bytes its call allocated at its peak beyond what
    was allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _donation_steps(name, step_d, step_u, st_d, st_u, draw):
    """DONATION_STEPS steps of a donate=True and a donate=False step
    closure on the same noise: (a) the states and StepMetrics bit-
    identical after every step, (b) each state handed to the donate=False
    step unchanged in every byte. Returns (the largest extra peak of a
    step of each kind, the merges)."""
    peak_d = peak_u = 0
    merges = 0
    for k in range(DONATION_STEPS):
        noise = draw()
        before = _clone_tree(st_u)
        (nxt_u, m_u), p_u = _peak_of(lambda: step_u(st_u, noise))
        _hold_bits(f"{name} step {k}: the state passed to donate=False",
                   st_u, before)
        del before
        (st_d, m_d), p_d = _peak_of(lambda: step_d(st_d, noise))
        _hold_bits(f"{name} step {k}: donate=False against True", nxt_u,
                   st_d)
        _hold_bits(f"{name} step {k}: metrics", m_u, m_d)
        if int(m_d.writes) <= 0:
            raise AssertionError(f"donation: {name} step {k} wrote nothing")
        merges += int(m_d.merges)
        peak_d, peak_u = max(peak_d, p_d), max(peak_u, p_u)
        st_u = nxt_u
    if merges <= 0:
        raise AssertionError(f"donation: {name}: no merge")
    return peak_d, peak_u, merges


def _donation_fused(card, dev, room_kernel: bool):
    """(a)-(c) of phase 42 on one fused path at N_AGENTS agents."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import (draw_step_noise, make_sim_step,
                                            run_steps, sim_init, sim_rollout)

    name = "room" if room_kernel else "window"
    cfg, walls, params, rooms = presets.deployable(
        N_AGENTS, device=dev, room_kernel=room_kernel)
    kw = dict(walls_grouped=rooms[0], room_of_agent=rooms[1])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step_d, step_u = (make_sim_step(cfg, walls, params, gen, donate=d, **kw)
                      for d in (True, False))
    st0 = sim_init(cfg, params)
    peak_d, peak_u, merges = _donation_steps(
        name, step_d, step_u, _clone_tree(st0), _clone_tree(st0),
        lambda: draw_step_noise(gen, N_AGENTS, cfg.engine.scan_rays, dev))

    kept = _clone_tree(st0)
    runs, peaks = [], []
    for _ in range(2):
        g = torch.Generator(device=dev).manual_seed(SEED + 7)
        out, peak = _peak_of(lambda: sim_rollout(
            st0, DONATION_STEPS, cfg, walls, params, g, **kw))
        runs.append(out)
        peaks.append(peak)
    _hold_bits(f"{name}: the state passed to sim_rollout", st0, kept)
    _hold_bits(f"{name}: the second sim_rollout", runs[0], runs[1])
    del runs
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    step = make_sim_step(cfg, walls, params, g, donate=True, **kw)
    _, peak_run = _peak_of(lambda: run_steps(step, kept, DONATION_STEPS))
    grid = st0.srv.logodds.numel() * st0.srv.logodds.element_size()
    print(f"donation {name} path at {N_AGENTS} agents [{card}]: "
          f"{DONATION_STEPS} steps donate=False BIT-IDENTICAL to "
          f"donate=True (states, metrics; merges {merges}), every state "
          f"passed to donate=False unchanged; two sim_rollouts from one "
          f"state BIT-IDENTICAL, the state unchanged; extra peak: a "
          f"donate=False step {peak_u} bytes against {peak_d} "
          f"({peak_u - peak_d} more), sim_rollout {peaks[0]} against "
          f"{peak_run} for the donated steps ({peaks[0] - peak_run} more); "
          f"the grid is {grid} bytes")


def _donation_sharded(card, dev):
    """(d) of phase 42: the sharded step on a one-rank NCCL group."""
    from datetime import timedelta

    import torch.distributed as dist

    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import draw_step_noise, sim_init
    from swarm_tpu_torch.parallel import mesh, sharded

    mesh.init(f"tcp://127.0.0.1:{mesh.free_port()}", 1, 0,
              timedelta(seconds=SHARDED_TIMEOUT_S), device=dev)
    if dist.get_backend() != "nccl":
        raise AssertionError("the card's process group is not NCCL")
    try:
        for gs in ("replicated", "tiles"):
            cfg, walls, params, rooms = presets.deployable(N_AGENTS,
                                                           device=dev)
            lay = mesh.make_layout((1, 1), device=dev)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            step_d, step_u = (sharded.make_sharded_sim_step(
                cfg, walls, params, lay, gen, donate=d, grid_sharding=gs,
                walls_grouped=rooms[0], room_of_agent=rooms[1])
                for d in (True, False))
            st0 = sim_init(cfg, params)
            kept = _clone_tree(st0)
            peak_d, peak_u, merges = _donation_steps(
                f"sharded {gs}", step_d, step_u,
                sharded.shard_state(st0, lay, gs),
                sharded.shard_state(st0, lay, gs),
                lambda: draw_step_noise(gen, N_AGENTS,
                                        cfg.engine.scan_rays, dev))
            _hold_bits(f"sharded {gs}: the state handed to shard_state",
                       st0, kept)
            print(f"donation sharded {gs} on one NCCL rank at {N_AGENTS} "
                  f"agents [{card}]: {DONATION_STEPS} steps donate=False "
                  f"BIT-IDENTICAL to donate=True (merges {merges}), every "
                  f"state passed in unchanged, the unsharded state too; "
                  f"extra peak of a step {peak_u} / {peak_d} bytes "
                  f"(donate=False / True)")
            del st0, kept
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def _donation_slice(card, dev):
    """sim_rollout's one copy at the slice's size: its peak beyond one
    donated step's, and the copy's time (CUDA events, median of
    DONATION_REPS)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine import sim

    cfg, walls, params, rooms = presets.deployable(SLICE_AGENTS, device=dev,
                                                   **SLICE)
    kw = dict(walls_grouped=rooms[0], room_of_agent=rooms[1])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = sim.make_sim_step(cfg, walls, params, gen, donate=True, **kw)
    state, _ = step(sim.sim_init(cfg, params))            # warm-up
    _, peak_r = _peak_of(lambda: sim.sim_rollout(state, 1, cfg, walls,
                                                 params, gen, **kw))
    _, peak_d = _peak_of(lambda: sim.run_steps(step, state, 1))
    times = []
    for _ in range(DONATION_REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        sim._copy_written(state, cfg)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    grid = state.srv.logodds.numel() * state.srv.logodds.element_size()
    copy_ms = sorted(times)[len(times) // 2]
    print(f"donation at the slice ({SLICE_AGENTS} agents, "
          f"{cfg.grid.size}^2 {cfg.grid.logodds_dtype}) [{card}]: one "
          f"sim_rollout step peaks {peak_r} bytes beyond its input, one "
          f"donated step {peak_d} ({peak_r - peak_d} more; the grid is "
          f"{grid} bytes); sim_rollout's copy of the grid {copy_ms:.4f} ms "
          f"(median of {DONATION_REPS}: {[round(t, 4) for t in times]}), "
          f"{2 * grid / copy_ms / 1e6:.1f} GB/s read + written")


def phase_donation(card, dev):
    """Phase 42: the engines keep the caller's state as the reference's
    do. Returns {(kernel, form): launches} of its runs."""
    from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    _reset_counts()                          # this phase starts here
    _donation_fused(card, dev, room_kernel=False)
    _donation_fused(card, dev, room_kernel=True)
    torch.cuda.empty_cache()
    _donation_sharded(card, dev)
    _donation_slice(card, dev)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = {**{("window", f): n
                   for f, n in free_raster.launches_by_form.items()},
                **{("room", f): n
                   for f, n in room_raster.launches_by_form.items()}}
    fused = 2 * DONATION_STEPS + 3 * DONATION_STEPS
    want = {("window", "pack8-ring"): fused, ("room", "pack16-ring"): fused,
            ("window", "pack16-ring"): 2 * DONATION_STEPS,
            ("window", "pack16-ring-tile"): 2 * DONATION_STEPS,
            ("window", "pack8-ring-bf16"): 3}
    if launches != want:
        raise AssertionError(f"donation: launches {launches}, want {want}")
    print(f"donation phase [{card}]: launches {launches}, "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


FAULT_STEPS = 18             # dead past the 5 s timeout, a merge at 15
FAULT_OTHERS = 63            # agents killed besides agent 0 (at 1024)
FAULT_REF_AGENTS = 8         # the card-vs-CPU run
FAULT_FRAMES = 20            # ingest_frame frames, FAULT_FRAME_DT apart
FAULT_FRAME_DT = 0.4         # s between frames: the timeout spans 13
FAULT_ABSENT = 0.1           # share of the agents missing from a frame


def _kill_schedule(n, dev):
    """The kill schedule of phase 43 (tests/test_torch_faults.py's at 8
    agents): agent 0 dead from 0.6 to 5.8 s (steps 2-14 at 0.4 s a step)
    and agents 3, 19, 35, ... (every 16th from 3, up to FAULT_OTHERS) from
    0.6 to 6.6 s (steps 2-16). The last packet of both is older than the 5
    s timeout at step 14; the merge step 15 finds agent 0 back and the
    others dead; all are back by step 17. Returns (FaultSchedule, the
    killed agents)."""
    from swarm_tpu_torch.engine.sim import FaultSchedule

    others = [a for a in range(3, n, 16)][:FAULT_OTHERS]
    agents = [0] + others
    t0 = [0.6] * len(agents)
    t1 = [5.8] + [6.6] * len(others)
    return FaultSchedule(
        agent=torch.tensor(agents, dtype=torch.int32, device=dev),
        t_start=torch.tensor(t0, dtype=torch.float32, device=dev),
        t_end=torch.tensor(t1, dtype=torch.float32, device=dev)), agents


def _check_failover(name, ms, n, killed):
    """The schedule's effect on stacked StepMetrics: the agents that died
    are the killed ones; the online count (from step 1: at step 0 no
    agent has spoken) falls by all of them once the timeout has passed and
    is whole at the last step; a dead agent's reported poses stay put and
    it paints nothing. Returns the online counts."""
    alive = ms.alive.cpu()
    online = ms.online.cpu()
    dead = torch.nonzero(~alive.all(dim=0)).flatten().tolist()
    if dead != sorted(killed):
        raise AssertionError(f"faults {name}: dead agents {dead[:8]}... "
                             f"({len(dead)}), killed {len(killed)}")
    if int(online[1:].min()) != n - len(killed) or \
            int(online[-1]) != n or not bool(alive[-1].all()):
        raise AssertionError(f"faults {name}: online {online.tolist()}")
    hv = ms.hit_valid.cpu()
    for a in killed:
        span = torch.nonzero(~alive[:, a]).flatten()
        for f in ("srv_x", "srv_y", "srv_yaw", "est_x", "est_y"):
            v = getattr(ms, f)[:, a].cpu()[span]
            if not bool((v == v[0]).all()):
                raise AssertionError(f"faults {name}: dead agent {a} "
                                     f"moved ({f})")
        if bool(hv[span, a].any()):
            raise AssertionError(f"faults {name}: dead agent {a} painted")
    return online.tolist()


def _faults_fused(card, dev, name, world, targets=False):
    """FAULT_STEPS steps of a fused path at N_AGENTS agents under the kill
    schedule, launches counted from 0. Returns {form: launches}."""
    from swarm_tpu_torch.engine.sim import make_sim_step, run_steps, sim_init

    cfg, walls, params, rooms = world
    faults, killed = _kill_schedule(N_AGENTS, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    step = make_sim_step(cfg, walls, params, gen, faults, targets,
                         walls_grouped=rooms[0], room_of_agent=rooms[1])
    state = sim_init(cfg, params)
    _sync(dev)
    _reset_counts()                          # this path starts here
    (state, ms), sec = _wall(lambda: run_steps(step, state, FAULT_STEPS),
                             dev)
    by_form = {**_read_counts()[1], **{f"room {k}": v
                                       for k, v in _room_by_form().items()}}
    online = _check_failover(name, ms, N_AGENTS, killed)
    merges = ms.merges.cpu().tolist()
    n_fr = ms.n_frontiers.cpu().tolist()
    if targets:
        if n_fr[8] <= 0 or n_fr[16] <= 0:
            raise AssertionError(f"faults {name}: frontiers {n_fr}")
    elif merges[15] <= 0:
        raise AssertionError(f"faults {name}: no merge at step 15")
    if not bool((ms.writes > 0).all()) or \
            not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError(f"faults {name}: a step wrote nothing or a "
                             "pose is not finite")
    print(f"faults {name} at {N_AGENTS} agents [{card}]: {FAULT_STEPS} "
          f"steps in {sec:.4f} s ({FAULT_STEPS / sec:.2f} steps/s), "
          f"{len(killed)} agents killed; online {online}; merges at step "
          f"15 {merges[15]}, frontiers at steps 8 / 16 {n_fr[8]} / "
          f"{n_fr[16]}; dead agents stayed put and painted nothing; "
          f"launches {by_form}; applied cells "
          f"{int(ms.writes.to(torch.int64).sum())}")
    return by_form


def _faults_card_vs_cpu(card, dev, room_kernel):
    """The kill schedule at FAULT_REF_AGENTS agents on the card and on the
    CPU from one state and the same noise: every step's writes, closures,
    merges and online count equal, the maps' tri-state cells equal."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import (draw_step_noise, sim_init,
                                            sim_step)
    from swarm_tpu_torch.ops.raster import tri_state_view

    name = "room" if room_kernel else "window"
    cpu = torch.device("cpu")
    n = FAULT_REF_AGENTS
    worlds = {d: presets.deployable(n, device=d, room_kernel=room_kernel)
              for d in (cpu, dev)}
    faults = {d: _kill_schedule(n, d)[0] for d in (cpu, dev)}
    killed = _kill_schedule(n, cpu)[1]
    states = {d: sim_init(w[0], w[2]) for d, w in worlds.items()}
    gen = torch.Generator(device=cpu).manual_seed(SEED + 44)
    ms = {cpu: [], dev: []}
    for k in range(FAULT_STEPS):
        noise = draw_step_noise(gen, n, worlds[cpu][0].engine.scan_rays, cpu)
        for d, (cfg, walls, params, rooms) in worlds.items():
            nz = type(noise)(*(None if f is None else
                               type(f)(*(x.to(d) for x in f))
                               for f in noise))
            states[d], m = sim_step(states[d], nz, cfg, walls, params,
                                    faults[d], walls_grouped=rooms[0],
                                    room_of_agent=rooms[1])
            ms[d].append(m)
    stacked = {d: type(v[0])(*(torch.stack(f).cpu() for f in zip(*v)))
               for d, v in ms.items()}
    for f in ("writes", "closures", "merges", "online", "alive"):
        a, b = getattr(stacked[dev], f), getattr(stacked[cpu], f)
        if not torch.equal(a, b):
            raise AssertionError(f"faults card vs CPU [{name}]: {f} "
                                 f"{a.tolist()} vs {b.tolist()}")
    _check_failover(f"{name} at {n} agents", stacked[dev], n, killed)
    cfg = worlds[cpu][0]
    tri = {d: tri_state_view(s.srv.logodds, cfg.grid).cpu()
           for d, s in states.items()}
    n_diff = int((tri[dev] != tri[cpu]).sum())
    if n_diff:
        raise AssertionError(f"faults card vs CPU [{name}]: {n_diff} "
                             "tri-state cells differ")
    w = stacked[dev].writes.to(torch.int64)
    print(f"faults card vs CPU [{name}] at {n} agents, {FAULT_STEPS} steps "
          f"under the kill schedule [{card}]: writes {int(w.sum())} on both"
          f" (every step equal), closures "
          f"{int(stacked[dev].closures.sum())} on both, merges "
          f"{stacked[dev].merges.tolist()}, online "
          f"{stacked[dev].online.tolist()}; 0 tri-state cells differ")


def _faults_sharded(card, dev):
    """The sharded step on a one-rank NCCL group, "replicated" and
    "tiles", FAULT_STEPS steps under the kill schedule: the failover's
    checks, and "tiles" equal to "replicated" step for step (writes,
    merges, online) with the maps' tri-state cells equal. Returns
    {form: launches}."""
    from datetime import timedelta

    import torch.distributed as dist

    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import (StepMetrics, draw_step_noise,
                                            sim_init)
    from swarm_tpu_torch.ops.raster import tri_state_view
    from swarm_tpu_torch.parallel import mesh, sharded

    mesh.init(f"tcp://127.0.0.1:{mesh.free_port()}", 1, 0,
              timedelta(seconds=SHARDED_TIMEOUT_S), device=dev)
    if dev.type == "cuda" and dist.get_backend() != "nccl":
        raise AssertionError("the card's process group is not NCCL")
    runs, launches = {}, {}
    try:
        cfg, walls, params, rooms = presets.deployable(N_AGENTS, device=dev)
        faults, killed = _kill_schedule(N_AGENTS, dev)
        lay = mesh.make_layout((1, 1), device=dev)
        for gs in ("replicated", "tiles"):
            gen = torch.Generator(device=dev).manual_seed(SEED + 45)
            step = sharded.make_sharded_sim_step(
                cfg, walls, params, lay, gen, faults, grid_sharding=gs,
                walls_grouped=rooms[0], room_of_agent=rooms[1])
            st = sharded.shard_state(sim_init(cfg, params), lay, gs)
            _sync(dev)
            _reset_counts()
            ms = []
            t0 = time.perf_counter()
            for _ in range(FAULT_STEPS):
                st, m = step(st, draw_step_noise(gen, N_AGENTS,
                                                 cfg.engine.scan_rays, dev))
                ms.append(m)
            _sync(dev)
            sec = time.perf_counter() - t0
            launches.update(_read_counts()[1])
            ms = StepMetrics(*(torch.stack(f) for f in zip(*ms)))
            online = _check_failover(f"sharded {gs}", ms, N_AGENTS, killed)
            if int(ms.merges[15]) <= 0:
                raise AssertionError(f"faults sharded {gs}: no merge")
            runs[gs] = (ms, tri_state_view(st.srv.logodds, cfg.grid).cpu())
            print(f"faults sharded {gs} on one rank at {N_AGENTS} agents "
                  f"[{card}]: {FAULT_STEPS} steps in {sec:.4f} s, online "
                  f"{online}, merges at step 15 {int(ms.merges[15])}")
            del st
    finally:
        dist.destroy_process_group()
    (ma, ta), (mb, tb) = runs["replicated"], runs["tiles"]
    for f in ("merges", "online", "closures"):
        if not torch.equal(getattr(ma, f), getattr(mb, f)):
            raise AssertionError(f"faults sharded: tiles' {f} differ from "
                                 "replicated's")
    wa, wb = int(ma.writes.to(torch.int64).sum()), \
        int(mb.writes.to(torch.int64).sum())
    n_diff = int((ta != tb).sum())
    explored = int(((ta != cfg.grid.unknown) | (tb != cfg.grid.unknown))
                   .sum())
    print(f"faults sharded tiles vs replicated [{card}]: writes {wb} vs "
          f"{wa}, {n_diff} of {explored} explored tri-state cells differ")
    # ROADMAP C22: "tiles" shifts the float cells by the tile window's
    # offsets, so its bars are the decision bars, not bits
    if abs(wa - wb) > 1e-5 * wa or n_diff > 1e-4 * explored:
        raise AssertionError("faults sharded: tiles and replicated apart")
    return launches


def _partial_frame(rng, present, f):
    """One serving frame of the agents `present`, shuffled, one packet
    each, stamped FAULT_FRAME_DT s after the last: columns on the host."""
    order = rng.permutation(present).astype(np.int32)
    b = order.shape[0]
    t = np.float32(1.0 + f * FAULT_FRAME_DT) + \
        np.arange(b, dtype=np.float32) * np.float32(1e-4)
    ph = order * 0.37 + f * 0.3
    return dict(t=t, agent=order, x=(2.0 + 1.5 * np.cos(ph)).astype(
        np.float32), y=(1.5 + np.sin(ph)).astype(np.float32),
        yaw=((ph % 6.28) - 3.14).astype(np.float32),
        encoder=np.zeros(b, np.int32), v2v=np.zeros(b, np.int32),
        dist=rng.uniform(0.1, 1.1, (b, 4)).astype(np.float32),
        landmark=np.where(rng.random(b) < 0.3, rng.integers(1, 4, b),
                          0).astype(np.int32))


def _faults_ingest(card, dev):
    """`ingest_frame` at N_AGENTS agents on FAULT_FRAMES frames, each
    missing FAULT_ABSENT of the agents at random, and a block of agents
    (the kill schedule's) missing from frames 1-15 (6 s): the card and the
    CPU give the same grids (bar cells that rays traced apart by an ulp
    touch, ROADMAP C26), closure logs, per-row closure flags and
    corrections (the reference's row-0 write, C34), packet counts and
    online counts; the block falls offline after the timeout and comes
    back. Returns the online counts."""
    from swarm_tpu_torch.config import SwarmConfig
    from swarm_tpu_torch.engine.replay import (PacketStream, ingest_frame,
                                               server_init)

    cfg = SwarmConfig(n_agents=N_AGENTS)
    rng = np.random.default_rng(SEED + 46)
    block = set(_kill_schedule(N_AGENTS, torch.device("cpu"))[1])
    frames, n_absent = [], []
    for f in range(FAULT_FRAMES):
        miss = rng.random(N_AGENTS) < FAULT_ABSENT
        if 1 <= f <= 15:
            miss[list(block)] = True
        present = np.nonzero(~miss)[0]
        n_absent.append(int(miss.sum()))
        frames.append(_partial_frame(rng, present, f))

    def serve(d):
        st = server_init(cfg, t0=1.0, device=d)
        off = torch.zeros(N_AGENTS, device=d)
        outs = []
        for fr in frames:
            b = fr["t"].shape[0]
            batch = PacketStream(**{k: torch.as_tensor(v, device=d)
                                    for k, v in fr.items()},
                                 valid=torch.ones(b, dtype=torch.bool,
                                                  device=d))
            st, out = ingest_frame(st, batch, cfg, off)
            outs.append(out)
        return st, outs

    _reset_counts()
    (st, outs), sec = _wall(lambda: serve(dev), dev)
    n_kernels = _no_kernel("faults ingest")
    st_c, outs_c = serve(torch.device("cpu"))

    def cat(src):
        return types.SimpleNamespace(**{
            f: torch.cat([getattr(o, f) for o in src]).cpu()
            for f in ("rx", "ry", "hits", "hit_valid")})
    mask, apart = _ray_cells_apart(cat(outs), cat(outs_c), cfg)
    _grids_agree(f"faults ingest card vs CPU [{card}]", st.grid, st_c.grid,
                 mask, apart)
    n_cl = _same_closures("faults ingest card vs CPU", st, st_c)
    for k, (a, b) in enumerate(zip(outs, outs_c)):
        for f in ("closed", "online"):
            if not torch.equal(getattr(a, f).cpu(), getattr(b, f)):
                raise AssertionError(f"faults ingest frame {k}: {f} "
                                     "differs card vs CPU")
        if not torch.allclose(a.corr.cpu(), b.corr, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"faults ingest frame {k}: corr differs")
    if not torch.equal(st.pkt_counts.cpu(), st_c.pkt_counts):
        raise AssertionError("faults ingest: packet counts differ")
    online = [int(o.online[0].sum()) for o in outs]
    row0 = sum(int(o.closed[0]) for o in outs)
    if min(online[1:]) > N_AGENTS - len(block) or online[-1] != N_AGENTS:
        raise AssertionError(f"faults ingest: online {online}")
    print(f"faults ingest_frame at {N_AGENTS} agents [{card}]: "
          f"{FAULT_FRAMES} frames {FAULT_FRAME_DT} s apart, {n_absent} "
          f"agents absent a frame ({len(block)} of them from frames 1-15), "
          f"{sec:.4f} s on the card; online {online}; {n_cl} closures "
          f"({row0} flagged on row 0); raster kernels {n_kernels}")
    return online


def _faults_rooms_off_grid(card, dev):
    """ROADMAP C11 on the card: 13 rooms at 3 a row on a 512^2 grid (4 x 2
    tiles; 5 rooms off the grid, dropped on the host) through the room
    kernel, bit-equal to its plain version on the card and on the CPU's
    plain version's tiles."""
    from swarm_tpu_torch.config import GridConfig
    from swarm_tpu_torch.geom.world import make_tiled_rooms
    from swarm_tpu_torch.ops import room_raster_cuda as rc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec

    per_row, n_rooms, n_beams = 3, 13, 181
    rng = np.random.default_rng(SEED + 47)
    _, origins = make_tiled_rooms(n_rooms, per_row=per_row)
    n = 2 * n_rooms
    xy = origins[np.arange(n) // 2] + rng.uniform([0.4, 0.4], [5.6, 3.6],
                                                  (n, 2))
    cfg = GridConfig(size=512, origin_x=0.0, origin_y=0.0)
    args = [torch.tensor(a, dtype=dt) for a, dt in (
        (xy, torch.float32), (rng.uniform(-np.pi, np.pi, n), torch.float32),
        (rng.uniform(0.1, 1.2, (n, n_beams)), torch.float32),
        (np.ones(n, bool), torch.bool),
        (rng.random((n, n_beams)) < 0.7, torch.bool))]
    kw = dict(spec=BeamSpec.scan(n_beams), cfg=cfg, n_groups=n_beams,
              per_row=per_row, reach=26)

    def run(fn, d):
        a = [x.to(d) for x in args]
        return fn(torch.zeros((512, 512), device=d), *a[:4], trusted=a[4],
                  **kw)
    got, counts = run(rc.room_raster, dev)
    plain, counts_p = run(rc.room_raster_plain, dev)
    cpu, counts_c = run(rc.room_raster_plain, torch.device("cpu"))
    n_diff = _n_differ(got, plain)
    if n_diff or not torch.equal(counts, counts_p) or \
            int((counts.cpu() > 0).sum()) != 8:
        raise AssertionError(f"faults rooms off the grid: {n_diff} cells "
                             f"apart, tiles painted {counts.tolist()}")
    print(f"faults rooms off the tile grid (C11) [{card}]: {n_rooms} rooms"
          f" at {per_row} a row on 4 x 2 tiles, 5 dropped; the kernel "
          f"bit-equal to its plain version ({int((got != 0).sum())} cells "
          f"painted, 8 tiles), {_n_differ(got.cpu(), cpu)} cells apart "
          f"from the CPU's plain version")


def phase_faults(card, dev):
    """Phase 43: the fault-injection path and frames that lack agents.
    Returns {(kernel, form): launches} of the 1024-agent fused runs."""
    from swarm_tpu_torch import presets

    t0 = time.perf_counter()
    launches = {}
    for name, kw, want in (
            ("window", {}, {"pack8-ring": FAULT_STEPS}),
            ("room", dict(room_kernel=True),
             {"room pack16-ring": FAULT_STEPS})):
        got = _faults_fused(card, dev, name,
                            presets.deployable(N_AGENTS, device=dev, **kw))
        if got != want:
            raise AssertionError(f"faults {name}: launches {got}, want "
                                 f"{want}")
        launches.update(got)
    got = _faults_fused(card, dev, "exploration",
                        presets.coverage(N_AGENTS, device=dev),
                        targets=True)
    want = {"pack16": FAULT_STEPS, "pack16-wrapped": FAULT_STEPS}
    if got != want:
        raise AssertionError(f"faults exploration: launches {got}, want "
                             f"{want}")
    launches.update(got)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    got = _faults_sharded(card, dev)
    want = {"pack16-ring": FAULT_STEPS, "pack16-ring-tile": FAULT_STEPS}
    if got != want:
        raise AssertionError(f"faults sharded: launches {got}, want {want}")
    launches.update(got)
    for room_kernel in (False, True):
        _faults_card_vs_cpu(card, dev, room_kernel)
    _faults_ingest(card, dev)
    _faults_rooms_off_grid(card, dev)
    out = {(("room", k[5:]) if k.startswith("room ") else ("window", k)): v
           for k, v in launches.items()}
    print(f"faults phase [{card}]: launches {out}, "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def _group_kernels(card, dev, r):
    """Phases 2-3: every per-beam form against its plain version, the
    slice."""
    r["k_window"] = phase_window_kernel(card, dev)
    r["k_forms"] = phase_form_kernels(card, dev)
    r["k_room"] = {"pack16-ring": phase_room_kernel(card, dev)}
    for i, flags in enumerate(ROOM_ROWS):
        r["k_room"][_form_of(flags)[-1]] = phase_room_kernel(
            card, dev, flags, SEED + 20 + i)
    r.lap("2")
    r["k_slice"] = phase_slice_kernel(card, dev)
    r["n_slice"] = phase_slice(card, dev)
    r.lap("2-3: the slice")


def _group_paths(card, dev, r):
    """Phases 4-12: the fused paths, flag rows, references, the grouped
    tier and the exact raster."""
    paths = {}
    r["n_window"], (_, _, state, _), summary = phase_path(
        card, dev, room_kernel=False)
    paths[("window", "per-beam")] = phase_path_split(card, "window", state,
                                                     summary)
    del state, summary           # the room path's peak is its own (C19)
    r["n_room"], (cfg, rooms, state, m), summary = phase_path(
        card, dev, room_kernel=True)
    phase_merge(card, dev, cfg, rooms, state, m)
    paths[("room", "per-beam")] = phase_path_split(card, "room", state,
                                                   summary)
    del cfg, rooms, state, m, summary
    r.lap("4-5")
    r["n_explore"] = phase_explore(card, dev)
    r["n_ultrasonic"] = phase_ultrasonic(card, dev)
    phase_entry_points(card, dev)
    r["n_flags"] = phase_flag_paths(card, dev)
    r.lap("6-9")
    phase_bf16_vs_f32(card, dev)
    phase_reference(dev, "window")
    phase_reference(dev, "room", room_kernel=True)
    phase_reference(dev, "window bf16", 17, equal_merges=True,
                    grid_dtype="bfloat16")
    phase_reference_explore(dev)
    r.lap("10-11")

    # the grouped tier (bench.py --beam-groups N) and the exact raster
    r["k_grouped"], r["k_grouped_room"] = phase_grouped_kernels(card, dev)
    r["k_exact"] = phase_exact_kernel(card, dev)
    r["n_exact"] = phase_exact_entry(card, dev)
    r["n_grouped"] = {}
    for kernel_name, room_kernel in (("window", False), ("room", True)):
        r["n_grouped"][kernel_name], (_, _, state, _), summary = phase_path(
            card, dev, room_kernel=room_kernel, beam_groups=8)
        paths[(kernel_name, "grouped")] = phase_path_split(
            card, f"{kernel_name} --beam-groups 8", state, summary)
        del state, summary
    _compare_paths(card, paths)
    r["n_gflags"] = phase_grouped_flag_paths(card, dev)
    phase_reference(dev, "window --beam-groups 8", beam_groups=8)
    phase_reference(dev, "room --beam-groups 8", room_kernel=True,
                    beam_groups=8)
    r.lap("12")


def _group_sharded(card, dev, r):
    """Phases 13-15 and 30-32: the sharded engine."""
    # the band and tile forms, the three decompositions on a one-rank NCCL
    # group, the dry run
    r["k_band"] = phase_band_kernels(card, dev)
    r["n_band"] = phase_sharded(card, dev)
    phase_dryrun(card)
    r.lap("13-15")
    # the sharded engine's XLA tiers (no raster kernel on these paths)
    phase_sharded_tiers(card, dev)
    r.lap("30-32")


def _group_modes(card, dev, r):
    """Phases 16-21: every raster mode of the fused engine (no raster
    kernel on these)."""
    untiled_ms = phase_untiled(card, dev)
    phase_profiling(card, dev, untiled_ms)
    phase_parity(card, dev)
    phase_swarm(card, dev)
    phase_bias(card, dev)
    phase_card_vs_cpu(card, dev)
    phase_reference_modes(dev)
    r.lap("16-21")


def _group_accuracy(card, dev, r):
    """Phase 22: offline SLAM, the accuracy tool's path (both fans through
    the window kernel's pack16 forms)."""
    r["n_accuracy"], r["k_accuracy"] = phase_accuracy(card, dev)
    r.lap("22")


def _group_server(card, dev, r):
    """Phases 23-29 and 33-34: the mapping server, the packet formats, the
    solvers, the live server, the session CLI, checkpoints, the firmware
    API (no raster kernel on these paths)."""
    phase_replay(card, dev)
    phase_serve(card, dev)
    phase_solve(card, dev)
    r.lap("23-25")
    phase_live(card, dev)
    phase_live_parity(card, dev)
    full, tmp = phase_run_session(card, dev)
    phase_checkpoint(card, dev, full, tmp)
    r.lap("26-29")
    phase_firmware(card, dev)
    phase_solve_order(card, dev)
    r.lap("33-34")


def _group_tools(card, dev, r):
    """Phases 35-41: bench.py and the tools on the port."""
    r["n_bench"], r["n_cov"] = phase_tools(card, dev)
    r.lap("35-41: bench.py and the tools")


def _group_donation(card, dev, r):
    """Phase 42: donation at the engines' boundary."""
    r["n_donation"] = phase_donation(card, dev)
    r.lap("42: donation")


def _group_faults(card, dev, r):
    """Phase 43: the fault-injection path and frames that lack agents."""
    r["n_faults"] = phase_faults(card, dev)
    r.lap("43: faults")


# the groups of phases `--group` runs one at a time, in the order of a full
# run (the module docstring's phase numbers)
GROUPS = {"kernels": _group_kernels, "paths": _group_paths,
          "sharded": _group_sharded, "modes": _group_modes,
          "accuracy": _group_accuracy, "server": _group_server,
          "tools": _group_tools, "donation": _group_donation,
          "faults": _group_faults}


class _Results(dict):
    """The phases' results by name, and the clock of their groups."""

    def __init__(self):
        super().__init__()
        self.clock = time.perf_counter()

    def lap(self, what):
        now = time.perf_counter()
        print(f"phase time [{what}]: {now - self.clock:.1f} s", flush=True)
        self.clock = now


# a record's numbers when the group that measures its kernel did not run
NOT_RUN = dict(max_abs_err=None, ms=None, plain_ms=None, bound_ms=None,
               bound_by=None)


def _records(r, full: bool) -> list:
    """The per-kernel records of the JSON line from the results `r` of the
    groups that ran: a record's numbers from the phase that held its kernel
    against the plain version (null where that group did not run), its
    launches summed over the paths that ran it. With `full` (every group
    ran) every record must be there."""
    def kernel(name, form, res, *counts):
        counts = [c for c in counts if c is not None]
        if res is None and not counts:
            return []
        src, line = {"room_raster": ("room_raster.cu", 672),
                     "exact_raster": ("exact_raster.cu", 235)}.get(
                         name, ("free_raster.cu", 305))
        return [{"name": f"{name}[{form}]", "route": "cuda",
                 "source": f"swarm_tpu_torch/csrc/{src}",
                 "replaces": f"swarm_tpu/ops/beam_raster_pallas.py:{line}",
                 "launches": sum(counts), **(res or NOT_RUN),
                 "library_ms": None}]

    def get(name, *keys):
        x = r.get(name)
        for k in keys:
            if x is None:
                return None
            x = x.get(k)
        return x

    def don(kind, form):
        return get("n_donation", (kind, form))

    def flt(kind, form):
        return get("n_faults", (kind, form))

    slice_res = None
    if "k_slice" in r:
        slice_res = dict(r["k_slice"]["pack8-ring-bf16"], max_abs_err=max(
            r["k_slice"]["pack8-ring-bf16"]["max_abs_err"],
            r["k_forms"]["pack8-ring-bf16"]["max_abs_err"]))
    window_rows = [_form_of(f)[-1] for f in WINDOW_ROWS]
    room_rows = [_form_of(f)[-1] for f in ROOM_ROWS]
    grouped_window = [_form_of(f)[-1] for f in GROUPED_WINDOW_ROWS]
    grouped_room = [_form_of(f)[-1] for f in GROUPED_ROOM_ROWS]
    band_keys = [f"{form}-{kind}" for kind in ("band", "tile")
                 for form in BAND_FORMS]

    out = kernel("free_raster", "pack8-ring", get("k_window", "pack8-ring"),
                 r.get("n_window"), get("n_bench", "window"),
                 don("window", "pack8-ring"), flt("window", "pack8-ring"))
    for key in ("pack16", "pack16-wrapped"):
        out += kernel("free_raster", key, get("k_forms", key),
                      get("n_explore", key), flt("window", key))
    # the same two forms at the accuracy tool's and bench_coverage's
    # shapes (64 agents on 1024^2), records of their own
    for key in ("pack16", "pack16-wrapped"):
        out += kernel("free_raster", f"{key}-64-agents",
                      get("k_accuracy", key), get("n_accuracy", key),
                      get("n_cov", key))
    out += kernel("free_raster", "pack8-ring-wrapped",
                  get("k_forms", "pack8-ring-wrapped"),
                  get("n_ultrasonic", "pack8-ring-wrapped"))
    out += kernel("free_raster", "pack8-ring-bf16", slice_res,
                  r.get("n_slice"), don("window", "pack8-ring-bf16"))
    for key in window_rows:
        out += kernel("free_raster", key, get("k_forms", key),
                      get("n_flags", ("window", key)), don("window", key),
                      flt("window", key))
    out += kernel("room_raster", "pack16-ring", get("k_room", "pack16-ring"),
                  r.get("n_room"), get("n_bench", "room"),
                  don("room", "pack16-ring"), flt("room", "pack16-ring"))
    for key in room_rows:
        out += kernel("room_raster", key, get("k_room", key),
                      get("n_flags", ("room", key)))
    out += kernel("free_raster", "grouped-ring",
                  get("k_grouped", "grouped-ring"),
                  get("n_grouped", "window"))
    for key in grouped_window:
        out += kernel("free_raster", key, get("k_grouped", key),
                      get("n_gflags", ("window", key)))
    out += kernel("room_raster", "grouped-ring",
                  get("k_grouped_room", "grouped-ring"),
                  get("n_grouped", "room"))
    for key in grouped_room:
        out += kernel("room_raster", key, get("k_grouped_room", key),
                      get("n_gflags", ("room", key)))
    for fan in ("scan", "wrapped"):
        out += kernel("exact_raster", fan, get("k_exact", fan),
                      get("n_exact", fan))
    for key in band_keys:
        out += kernel("free_raster", key, get("k_band", key),
                      get("n_band", key), don("window", key),
                      flt("window", key))
    names = {k["name"] for k in out}
    if len(names) != len(out) or full and (
            len(out) != 16 + 4 + 8 + 4 + 2 + 2 * len(BAND_FORMS) + 2 or
            any(k["ms"] is None or k["launches"] <= 0 for k in out)):
        raise AssertionError(f"kernel records: {sorted(names)}")
    return out


def run(card, dev, groups=tuple(GROUPS)) -> list:
    """The groups of phases after the build, in order; returns the
    per-kernel records of the JSON line. Prints each group's seconds."""
    r = _Results()
    for g in groups:
        GROUPS[g](card, dev, r)
    return _records(r, full=tuple(groups) == tuple(GROUPS))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--group", choices=list(GROUPS),
                    help="run this group of phases only (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False"
                         " -- this script runs only on a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import swarm_tpu_torch  # noqa: F401  (fails outside the checkout)

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = _card()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    kernels = run(card, dev, tuple(GROUPS) if args.group is None
                  else (args.group,))
    print(f"chip_smoke {args.group or 'all groups'}: "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
