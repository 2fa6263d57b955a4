"""Rendering (swarm_tpu_torch/render/raster2d.py, server/view.py,
cli/playback.py) against the JAX package's, on the CPU.

`render_map` and `render_points` are byte-equal to the JAX functions on
the same inputs (numpy made from a seed: a tri-state grid, points, paths,
poses, zones, frontiers; three scales; points that share a pixel, where
the last one wins); `render_view` and the HTTP view's `/hud.json` equal
JAX's; the standard-library PNG writer decodes (with PIL) to the very
pixels it was given; the playback CLI's frames and the live server's map
decode to JAX's pixels.
"""

import io
import json
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from swarm_tpu.config import GridConfig as JGrid
from swarm_tpu.render import raster2d as jr
from swarm_tpu.server import view as jview
from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.render import raster2d as pr
from swarm_tpu_torch.server import view as pview


def _inputs(seed, s=200):
    rng = np.random.default_rng(seed)
    grid = rng.choice(np.array([-1, 0, 100], np.int8), size=(s, s))
    n = 64
    pts = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    pts[1] = pts[0]                     # two points on one pixel
    lo = rng.uniform(-5, 3, (3, 2))
    zones = np.concatenate([lo, lo + rng.uniform(0.2, 2, (3, 2))], 1)
    return grid, dict(
        points_xy=pts, points_agent=rng.integers(0, 9, n),
        points_valid=rng.random(n) < 0.8,
        paths_xy=rng.uniform(-6, 6, (n, 2)).astype(np.float32),
        paths_agent=rng.integers(0, 9, n),
        poses=np.concatenate([rng.uniform(-5, 5, (3, 2)),
                              rng.uniform(-4, 4, (3, 1))], 1)
        .astype(np.float32),
        zones=zones[:, [0, 1, 2, 3]].astype(np.float32),
        zones_active=np.array([True, False, True]),
        frontiers=rng.uniform(-5, 5, (8, 2)).astype(np.float32),
        n_frontiers=5)


def _decode(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scale", [1, 2, 3])
def test_render_map_equals_jax(seed, scale):
    grid, kw = _inputs(seed)
    want = np.asarray(jr.render_map(
        jnp.asarray(grid), JGrid(), scale=scale,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = pr.render_map(torch.as_tensor(grid), GridConfig(), scale=scale,
                        **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # numpy inputs and tensor inputs draw the same image
    got_t = pr.render_map(torch.as_tensor(grid), GridConfig(), scale=scale,
                          **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert torch.equal(got_t, got)


def test_render_map_grid_only_and_points():
    cfg = GridConfig()
    grid = np.full((cfg.size, cfg.size), -1, np.int8)
    grid[90:110, 90:110] = 0
    grid[100, 120] = 100
    img = pr.render_map(torch.as_tensor(grid), cfg, scale=1).numpy()
    np.testing.assert_array_equal(
        img, np.asarray(jr.render_map(jnp.asarray(grid), JGrid(), scale=1)))
    assert tuple(img[99, 120]) == (120, 200, 255)
    _, kw = _inputs(3)
    want = np.asarray(jr.render_points(jnp.asarray(kw["points_xy"]),
                                       jnp.asarray(kw["points_agent"]),
                                       JGrid()))
    got = pr.render_points(kw["points_xy"], kw["points_agent"], cfg,
                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert pr.render_ascii(torch.as_tensor(grid), slice(85, 125),
                           slice(85, 115)) == \
        jr.render_ascii(grid, slice(85, 125), slice(85, 115))


def test_png_writer_decodes_to_the_pixels(tmp_path):
    rng = np.random.default_rng(5)
    for h, w in ((1, 1), (17, 33), (64, 200)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        p = pr.save_png(torch.as_tensor(img), str(tmp_path / f"{h}.png"))
        with open(p, "rb") as f:
            np.testing.assert_array_equal(_decode(f.read()), img)
    with pytest.raises(ValueError):
        pr.encode_png(np.zeros((4, 4), np.uint8))


def _snap(n=2, s=64):
    grid = np.full((s, s), -1, np.int8)
    grid[10:50, 10:50] = 0
    grid[10, 10:50] = 100
    return {
        "grid": grid, "resolution": 0.05, "origin": (0.0, 0.0),
        "poses": np.array([[1.0, 1.0, 0.3], [2.0, 1.5, -1.0]][:n]),
        "online": np.array([True, False][:n]),
        "pkt_counts": np.array([17, 5][:n]),
        "zones": np.array([[0.5, 0.5, 1.5, 1.2], [0, 0, 0, 0]][:n]),
        "zone_active": np.array([True, False][:n]),
        "frontiers": np.array([[1.2, 1.2]]), "n_frontiers": 1,
        "closures": 3, "pkt_total": 22, "t": 12.5,
        "points": (np.array([[1.1, 1.0], [1.3, 1.4]], np.float32),
                   np.array([0, 1])),
        "points_sensor": np.array([1, 2], np.int8),
        "paths": (np.array([[0.9, 0.9]], np.float32), np.array([0])),
    }


@pytest.mark.parametrize("window", [(1.5, 1.5, 100, 320, 240),
                                    (900.0, -900.0, 1e9, 64, 64),
                                    (0.0, 0.0, 1.0, 64, 48)])
def test_render_view_equals_jax(window):
    cx, cy, zoom, w, h = window
    np.testing.assert_array_equal(
        pview.render_view(_snap(), cx, cy, zoom, w, h),
        jview.render_view(_snap(), cx, cy, zoom, w, h))


def test_http_view_equals_jax():
    views = [pview.MapView(_snap, port=0).start(),
             jview.MapView(_snap, port=0).start()]
    try:
        got = []
        for v in views:
            base = f"http://127.0.0.1:{v.port}"
            hud = json.load(urllib.request.urlopen(base + "/hud.json"))
            png = urllib.request.urlopen(
                base + "/map.png?cx=1.5&cy=1.5&zoom=150&w=400&h=300").read()
            got.append((hud, _decode(png)))
        assert got[0][0] == got[1][0]
        np.testing.assert_array_equal(got[0][1], got[1][1])
        assert b"swarm_tpu_torch live view" in urllib.request.urlopen(
            f"http://127.0.0.1:{views[0].port}/").read()
    finally:
        for v in views:
            v.stop()


def _session_with_points(tmp_path):
    import math

    from swarm_tpu_torch.proto.csvio import write_session
    from swarm_tpu_torch.sim.scenario import generate_dual_session

    res = generate_dual_session(seed=42, device="cpu")
    angles = np.asarray([0.0, math.pi / 2, math.pi, -math.pi / 2])
    valid = (res.dist4 > 0.05) & (res.dist4 <= 1.2)
    ang = res.yaw_q[:, None] + angles[None, :]
    hx = res.x[:, None] + res.dist4 * np.cos(ang)
    hy = res.y[:, None] + res.dist4 * np.sin(ang)
    return write_session(str(tmp_path / "s"), res.t, res.agent, res.x,
                         res.y, res.yaw_q, res.encoder, res.v2v, res.dist4,
                         res.landmark, hits_xy=np.stack([hx, hy], -1),
                         hit_valid=valid)


def test_playback_frames_equal_jax(tmp_path):
    from swarm_tpu.cli.playback import playback as j_playback
    from swarm_tpu_torch.cli.playback import playback

    sess = _session_with_points(tmp_path)
    fj = j_playback(sess, str(tmp_path / "fj"), frame_dt=60.0, scale=2)
    fp = playback(sess, str(tmp_path / "fp"), frame_dt=60.0, scale=2,
                  device="cpu")
    assert len(fp) == len(fj) >= 3
    for a, b in zip(fp, fj):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            np.testing.assert_array_equal(_decode(fa.read()),
                                          _decode(fb.read()))
    # the interactive source's snapshot is the JAX one's
    src_p = pview.PlaybackSource(sess)
    src_j = jview.PlaybackSource(sess)
    for src in (src_p, src_j):
        src.cursor = src.t0 + 30.0
        src.paused = True
    sp, sj = src_p.snapshot(), src_j.snapshot()
    assert sp.keys() == sj.keys()
    np.testing.assert_array_equal(sp["poses"], sj["poses"])
    np.testing.assert_array_equal(sp["points"][0], sj["points"][0])
    np.testing.assert_array_equal(
        pview.render_view(sp, 1.0, 0.0, 80, 200, 160),
        jview.render_view(sj, 1.0, 0.0, 80, 200, 160))


def test_live_server_render_equals_jax(tmp_path):
    from swarm_tpu.config import SwarmConfig as JConfig
    from swarm_tpu.server.live import LiveServer as JServer
    from swarm_tpu_torch.config import SwarmConfig
    from swarm_tpu_torch.proto.packets import QuasarPacketV2
    from swarm_tpu_torch.server.live import LiveServer

    pkts = [(i % 2, QuasarPacketV2(i % 2 + 1, (i // 2) * 0.05,
                                   0.3 * (i % 2), 0.0, i, 0, 1.0, 0.5, 4.0,
                                   0.5, 0)) for i in range(60)]
    out = []
    for srv in (LiveServer(SwarmConfig(n_agents=2), port=0, device="cpu"),
                JServer(JConfig(n_agents=2), port=0)):
        srv.now = lambda: 1.0
        srv.ingest(pkts)
        p = srv.render(str(tmp_path / f"{len(out)}.png"))
        with open(p, "rb") as f:
            out.append(_decode(f.read()))
        srv.close()
    np.testing.assert_array_equal(out[0], out[1])
    assert os.path.getsize(tmp_path / "0.png") > 0
