"""Session playback (swarm_tpu/cli/playback.py) — the reference's PyGame
replay viewer
(simulation_tools/playback_dual_session.py) as a headless frame renderer:
load a session directory, advance a simulated clock, and emit PNG frames
(or one animated GIF) of the accumulating point clouds + paths, same
time-ordered drain semantics (:203-219).

  python -m swarm_tpu_torch.cli.playback --session DIR --out DIR/frames \
      --frame-dt 5.0 [--gif DIR/playback.gif]
"""

from __future__ import annotations

import argparse
import os


def playback(session_dir: str, out_dir: str, frame_dt: float = 5.0,
             scale: int = 4, gif: str = None, max_points: int = 3000,
             device=None):
    """Render a session's frames on `device` (the card when None) into
    `out_dir`; returns the frame paths."""
    import numpy as np
    import torch

    from swarm_tpu_torch._device import default_device
    from swarm_tpu_torch.config import GridConfig
    from swarm_tpu_torch.proto.csvio import load_session
    from swarm_tpu_torch.render import render_map, save_png

    dev = default_device(device)
    sess = load_session(session_dir)
    cfg = GridConfig()
    os.makedirs(out_dir, exist_ok=True)

    pts = sess["points"]
    t_tele = sess["t"]
    t_end = float(t_tele[-1])
    frames = []
    empty = torch.full((cfg.size, cfg.size), -1, dtype=torch.int8,
                       device=dev)

    k = 0
    t_cursor = float(t_tele[0])
    while t_cursor <= t_end + frame_dt:
        tele_mask = t_tele <= t_cursor
        paths = np.stack([sess["x"][tele_mask], sess["y"][tele_mask]], -1)
        pa = sess["agent"][tele_mask] - 1
        kwargs = {}
        if pts is not None:
            pmask = pts["t"] <= t_cursor
            idx = np.nonzero(pmask)[0][-max_points:]   # ref draws last 3000
            kwargs = dict(
                points_xy=np.stack([pts["x"][idx], pts["y"][idx]], -1),
                points_agent=pts["agent"][idx] - 1)
        # latest pose per agent
        poses = []
        for a in np.unique(pa):
            i = np.nonzero(pa == a)[0][-1]
            poses.append([paths[i, 0], paths[i, 1],
                          np.radians(sess["yaw_deg"][tele_mask][i])])
        img = render_map(empty, cfg, scale=scale, paths_xy=paths,
                         paths_agent=pa,
                         poses=np.asarray(poses, np.float32)
                         if poses else None, **kwargs)
        frame_path = os.path.join(out_dir, f"frame_{k:04d}.png")
        save_png(img, frame_path)
        frames.append(frame_path)
        k += 1
        t_cursor += frame_dt

    if gif:
        from PIL import Image

        imgs = [Image.open(f) for f in frames]
        imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                     duration=200, loop=0)
    return frames


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--session", default=None)
    ap.add_argument("--polar-scan", default=None, metavar="SCAN_CSV",
                    help="frame-by-frame POLAR replay of a per-agent scan "
                         "log (the reference's playback_viewer.py:54-68, "
                         "10 fps) instead of a session replay")
    ap.add_argument("--every", type=int, default=1,
                    help="--polar-scan: render every k-th scan row")
    ap.add_argument("--limit", type=int, default=None,
                    help="--polar-scan: max frames")
    ap.add_argument("--out", default=None,
                    help="frame output dir (headless mode)")
    ap.add_argument("--frame-dt", type=float, default=5.0,
                    help="simulated seconds per frame")
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--gif", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the render (default: the card)")
    ap.add_argument("--view", type=int, nargs="?", const=8800, default=None,
                    metavar="PORT",
                    help="interactive browser playback: pause / speed "
                         "0.1-20x / reset / zoom / pan (the reference's "
                         "PyGame replay controls, "
                         "playback_dual_session.py:163-219)")
    ap.add_argument("--speed", type=float, default=1.0)
    ap.add_argument("--duration", type=float, default=None,
                    help="--view: stop serving after this many wall "
                         "seconds (default: until Ctrl-C)")
    args = ap.parse_args(argv)
    if args.polar_scan is not None:
        if not args.out:
            ap.error("--out is required with --polar-scan")
        from swarm_tpu_torch.render.polar import playback_scan_frames
        from swarm_tpu_torch.server.bridge import load_scan_log

        frames = playback_scan_frames(
            load_scan_log(args.polar_scan), args.out, every=args.every,
            limit=args.limit, gif=args.gif)
        print(f"[PLAYBACK] wrote {len(frames)} polar frames to {args.out}"
              + (f" + {args.gif}" if args.gif else ""))
        return
    if args.session is None:
        ap.error("--session is required without --polar-scan")
    if args.view is not None:
        import time

        from swarm_tpu_torch.server.view import PlaybackSource

        src = PlaybackSource(args.session, speed=args.speed)
        view = src.serve(args.view)
        print(f"[PLAYBACK] interactive viewer at "
              f"http://localhost:{view.port}/ (Ctrl-C to stop)")
        try:
            t0 = time.time()
            while args.duration is None or time.time() - t0 < args.duration:
                time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        view.stop()
        return
    if not args.out:
        ap.error("--out is required without --view")
    frames = playback(args.session, args.out, args.frame_dt, args.scale,
                      args.gif, device=args.device)
    print(f"[PLAYBACK] wrote {len(frames)} frames to {args.out}"
          + (f" + {args.gif}" if args.gif else ""))


if __name__ == "__main__":
    main()
