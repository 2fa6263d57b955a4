"""Interactive live operator view (swarm_tpu/server/view.py) — the
reference's PyGame dashboard
(server_nodes/dual_bot_mapper.py:380-668: zoom 20-500 px/m, drag-pan,
per-agent colors, HUD with ONLINE/OFFLINE + packet counts at 30 FPS)
re-built as a zero-dependency HTTP view so it works over SSH/headless
where PyGame can't.

A background `ThreadingHTTPServer` serves:
  /          — an HTML canvas page: wheel = zoom (clamped to the
               reference's 20-500 px/m), drag = pan, ~10 FPS frame
               refresh, HUD overlay, optional playback controls
  /map.png   — the current map rendered for the requested
               (cx, cy, zoom, w, h) window: nearest-neighbour crop of the
               tri-state grid + robot markers/heading ticks, zone
               outlines, frontier diamonds
  /hud.json  — per-bot ONLINE/pkt-count/pose, closure + frontier counts
               (the HUD block, dual_bot_mapper.py:639-665)
  /ctl       — optional playback commands (pause/speed 0.1-20x/reset —
               playback_dual_session.py:163-219) forwarded to the source

The view reads state through a `snapshot()` callable returning plain
numpy, so any engine (live server, playback, sim) can expose itself; the
render is pure numpy on the HTTP thread — the ingest path never blocks.
PNGs are encoded by render.raster2d.encode_png (standard library only).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from swarm_tpu_torch.render.raster2d import encode_png

ZOOM_MIN, ZOOM_MAX = 20.0, 500.0      # ref: dual_bot_mapper.py:404-431

# palette mirrors render.raster2d.RenderTheme
_BG = np.array([15, 18, 24], np.uint8)
_FREE = np.array([34, 40, 49], np.uint8)
_OCC = np.array([120, 200, 255], np.uint8)
_AGENT = np.array([[255, 120, 90], [90, 200, 255], [170, 255, 120],
                   [255, 210, 80], [220, 130, 255], [130, 255, 220]],
                  np.uint8)
_ZONE = np.array([255, 80, 80], np.uint8)
_FRONTIER = np.array([255, 255, 0], np.uint8)
_OFFLINE = np.array([128, 128, 128], np.uint8)


def render_view(snap: Dict, cx: float, cy: float, zoom: float,
                w: int = 1000, h: int = 800) -> np.ndarray:
    """One [h, w, 3] frame of the world window centred at (cx, cy) world
    metres at `zoom` px/m. Pure numpy nearest-neighbour sampling."""
    zoom = float(np.clip(zoom, ZOOM_MIN, ZOOM_MAX))
    grid = snap["grid"]
    res = snap["resolution"]
    ox, oy = snap["origin"]
    s_rows, s_cols = grid.shape

    # pixel -> world -> cell index maps (row 0 = TOP = max y)
    wx = cx + (np.arange(w, dtype=np.float64) - w / 2) / zoom
    wy = cy + (h / 2 - np.arange(h, dtype=np.float64)) / zoom
    ix = np.floor((wx - ox) / res).astype(np.int64)
    iy = np.floor((wy - oy) / res).astype(np.int64)
    ok_x = (ix >= 0) & (ix < s_cols)
    ok_y = (iy >= 0) & (iy < s_rows)
    ixc = np.clip(ix, 0, s_cols - 1)
    iyc = np.clip(iy, 0, s_rows - 1)
    cells = grid[iyc[:, None], ixc[None, :]]
    img = np.broadcast_to(_BG, (h, w, 3)).copy()
    inb = ok_y[:, None] & ok_x[None, :]
    img[inb & (cells == 0)] = _FREE
    img[inb & (cells == 100)] = _OCC

    def to_px(x, y):
        px = np.round((np.asarray(x, np.float64) - cx) * zoom + w / 2)
        py = np.round((cy - np.asarray(y, np.float64)) * zoom + h / 2)
        return px.astype(np.int64), py.astype(np.int64)

    def stamp(px, py, color, size=2):
        for dy in range(-size, size + 1):
            for dx in range(-size, size + 1):
                qx, qy = px + dx, py + dy
                m = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
                img[qy[m], qx[m]] = color

    # zone outlines (translucent AABBs in the ref, :527-543 — outlines here)
    zones = snap.get("zones")
    if zones is not None:
        for a, z in enumerate(zones):
            if not snap["zone_active"][a]:
                continue
            x0, y0 = to_px(z[0], z[1])
            x1, y1 = to_px(z[2], z[3])
            xa, xb = sorted((int(x0), int(x1)))
            ya, yb = sorted((int(y0), int(y1)))
            xa2, xb2 = max(xa, 0), min(xb, w - 1)
            ya2, yb2 = max(ya, 0), min(yb, h - 1)
            if xa2 > xb2 or ya2 > yb2:
                continue
            if 0 <= ya < h:
                img[ya, xa2:xb2 + 1] = _ZONE
            if 0 <= yb < h:
                img[yb, xa2:xb2 + 1] = _ZONE
            if 0 <= xa < w:
                img[ya2:yb2 + 1, xa] = _ZONE
            if 0 <= xb < w:
                img[ya2:yb2 + 1, xb] = _ZONE

    # frontier diamonds (:545-557)
    fr = snap.get("frontiers")
    if fr is not None and snap.get("n_frontiers", 0) > 0:
        k = int(snap["n_frontiers"])
        fx, fy = to_px(fr[:k, 0], fr[:k, 1])
        stamp(fx, fy, _FRONTIER, size=2)

    # point clouds + paths (playback_dual_session.py:247-306 and the live
    # dashboard's per-sensor clouds, dual_bot_mapper.py:560-572: last-2000
    # points per sensor, per-agent colors shaded per sensor, wall-side
    # sensors drawn as larger rects; paths dimmed)
    sensor_shade = np.array([1.0, 0.75, 0.55, 0.65])   # F / L / B / R
    for key, dim, size in (("paths", 0.45, 0), ("points", 1.0, 0)):
        data = snap.get(key)
        if data is None or len(data[0]) == 0:
            continue
        xy, agent = data[0], data[1]
        px, py = to_px(xy[:, 0], xy[:, 1])
        m = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        shade = np.full(int(m.sum()), dim)
        sens = None
        if key == "points" and snap.get("points_sensor") is not None:
            sens = np.asarray(snap["points_sensor"])[m]
            shade = shade * sensor_shade[np.clip(sens, 0, 3)]
        colors = (_AGENT[np.asarray(agent)[m] % len(_AGENT)]
                  .astype(np.float64) * shade[:, None]).astype(np.uint8)
        img[py[m], px[m]] = colors
        if sens is not None:
            # wall-side sensors (left/right) as 2x2 rects — the reference
            # draws them 8x8 so wall evidence reads as surface (:563-572)
            side = (sens == 1) | (sens == 3)
            if side.any():
                qx, qy = px[m][side], py[m][side]
                cc = colors[side]
                for dy in (0, 1):
                    for dx in (0, 1):
                        ax_, ay_ = qx + dx, qy + dy
                        mm = (ax_ >= 0) & (ax_ < w) & (ay_ >= 0) & (ay_ < h)
                        img[ay_[mm], ax_[mm]] = cc[mm]

    # robots: colored square + heading tick, gray when offline (:571-597)
    poses = snap.get("poses")
    if poses is not None:
        online = snap.get("online",
                          np.ones(len(poses), bool))
        # color by the TRUE agent id (sessions may have non-contiguous
        # ids), matching the cloud/path colors above
        aids = np.asarray(snap.get("agent_ids", np.arange(len(poses))))
        for a, p in enumerate(poses):
            color = (_AGENT[int(aids[a]) % len(_AGENT)] if online[a]
                     else _OFFLINE)
            px, py = to_px(p[0], p[1])
            stamp(np.array([px]), np.array([py]), color, size=3)
            ts = np.linspace(0, 14, 8)
            hx = (px + ts * np.cos(p[2])).astype(np.int64)
            hy = (py - ts * np.sin(p[2])).astype(np.int64)
            stamp(hx, hy, color, size=0)
    return img


_PAGE = """<!doctype html><html><head><title>swarm_tpu_torch live view</title>
<style>
 body{margin:0;background:#0f1218;color:#dde;font:13px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:8px 12px;
      border-radius:6px;white-space:pre;pointer-events:none}
 #ctl{position:fixed;bottom:8px;left:8px;background:#000a;padding:6px;
      border-radius:6px}
 #ctl button{font:12px monospace;margin-right:4px}
 img{display:block;cursor:grab;user-select:none;-webkit-user-drag:none}
</style></head><body>
<img id=m width=1000 height=800>
<div id=hud>loading…</div>
<div id=ctl style="display:none">
 <button onclick="ctl('pause')">&#9208; pause</button>
 <button onclick="ctl('speed&value=0.5')">0.5x</button>
 <button onclick="ctl('speed&value=1')">1x</button>
 <button onclick="ctl('speed&value=4')">4x</button>
 <button onclick="ctl('speed&value=20')">20x</button>
 <button onclick="ctl('reset')">reset</button>
</div>
<script>
let cx=%CX%, cy=%CY%, zoom=100, drag=null;
const img=document.getElementById('m');
function fit(){img.width=innerWidth;img.height=innerHeight;}
fit(); onresize=fit;
function refresh(){
  img.src=`/map.png?cx=${cx}&cy=${cy}&zoom=${zoom}&w=${img.width}&h=${img.height}&_=${Date.now()}`;
}
img.onload=()=>setTimeout(refresh,100);
img.onerror=()=>setTimeout(refresh,500);
refresh();
img.onmousedown=e=>{drag=[e.clientX,e.clientY];e.preventDefault()};
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return;
  cx-=(e.clientX-drag[0])/zoom; cy+=(e.clientY-drag[1])/zoom;
  drag=[e.clientX,e.clientY];};
onwheel=e=>{zoom=Math.max(20,Math.min(500,zoom*(e.deltaY<0?1.2:1/1.2)));};
async function hud(){
  try{const r=await fetch('/hud.json');const d=await r.json();
   let s=`t=${d.t.toFixed(1)}s  pkts=${d.pkt_total}  closures=${d.closures}  frontiers=${d.frontiers}\\n`;
   for(const b of d.bots)
    s+=`BOT ${b.id}: ${b.online?'ONLINE ':'OFFLINE'} pkts=${b.pkts} (${b.x.toFixed(2)}, ${b.y.toFixed(2)}) yaw=${b.yaw.toFixed(2)}\\n`;
   if(d.playback) s+=`playback ${d.playback.paused?'PAUSED':''} speed=${d.playback.speed}x  ${(100*d.playback.progress).toFixed(0)}%`;
   document.getElementById('hud').textContent=s;
   document.getElementById('ctl').style.display=d.playback?'block':'none';
  }catch(e){}
  setTimeout(hud,500);
}
hud();
function ctl(c){fetch('/ctl?cmd='+c);}
</script></body></html>"""


class MapView:
    """Background HTTP view server. `snapshot` returns a dict of numpy:
    grid [S,S] int8, resolution, origin (ox, oy), poses [N,3], online [N],
    pkt_counts [N], zones [N,4], zone_active [N], frontiers [K,2],
    n_frontiers, closures, pkt_total, t; optionally playback
    {paused, speed, progress}. `ctl` (optional) receives playback
    commands: ("pause"), ("speed", float), ("reset")."""

    def __init__(self, snapshot: Callable[[], Dict], port: int = 8800,
                 ctl: Optional[Callable] = None,
                 bind: str = "127.0.0.1"):
        # bind defaults to loopback: the view exposes the live map and
        # playback /ctl without auth, so external exposure must be a
        # deliberate --bind 0.0.0.0
        self.snapshot = snapshot
        self.ctl = ctl
        self.port = port
        self.bind = bind
        view = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    u = urlparse(self.path)
                    q = {k: v[0] for k, v in parse_qs(u.query).items()}
                    if u.path == "/":
                        snap = view.snapshot()
                        poses = snap.get("poses")
                        cx = cy = 0.0
                        if poses is not None and len(poses):
                            cx = float(np.mean(poses[:, 0]))
                            cy = float(np.mean(poses[:, 1]))
                        page = (_PAGE.replace("%CX%", f"{cx:.2f}")
                                     .replace("%CY%", f"{cy:.2f}"))
                        self._send(200, "text/html", page.encode())
                    elif u.path == "/map.png":
                        snap = view.snapshot()
                        img = render_view(
                            snap,
                            cx=float(q.get("cx", 0.0)),
                            cy=float(q.get("cy", 0.0)),
                            zoom=float(q.get("zoom", 100.0)),
                            w=min(int(q.get("w", 1000)), 4096),
                            h=min(int(q.get("h", 800)), 4096))
                        self._send(200, "image/png", encode_png(img))
                    elif u.path == "/hud.json":
                        snap = view.snapshot()
                        poses = snap.get("poses")
                        n = 0 if poses is None else len(poses)
                        online = snap.get("online", np.ones(n, bool))
                        pkts = snap.get("pkt_counts", np.zeros(n, int))
                        aids = np.asarray(snap.get("agent_ids",
                                                   np.arange(n)))
                        hud = {
                            "t": float(snap.get("t", 0.0)),
                            "pkt_total": int(snap.get("pkt_total", 0)),
                            "closures": int(snap.get("closures", 0)),
                            "frontiers": int(snap.get("n_frontiers", 0)),
                            "bots": [{
                                "id": int(aids[a]) + 1,
                                "online": bool(online[a]),
                                "pkts": int(pkts[a]),
                                "x": float(poses[a, 0]),
                                "y": float(poses[a, 1]),
                                "yaw": float(poses[a, 2]),
                            } for a in range(n)],
                        }
                        if "playback" in snap:
                            hud["playback"] = snap["playback"]
                        self._send(200, "application/json",
                                   json.dumps(hud).encode())
                    elif u.path == "/ctl" and view.ctl is not None:
                        cmd = q.get("cmd", "")
                        val = q.get("value")
                        view.ctl(cmd, float(val) if val else None)
                        self._send(200, "text/plain", b"ok")
                    else:
                        self._send(404, "text/plain", b"not found")
                except BrokenPipeError:
                    pass
                except Exception as e:      # view must never kill the server
                    try:
                        self._send(500, "text/plain", str(e).encode())
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((bind, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    def start(self) -> "MapView":
        self._thread.start()
        print(f"[VIEW] live map at http://localhost:{self.port}/")
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


class PlaybackSource:
    """Interactive session playback behind MapView — the reference's replay
    viewer controls (playback_dual_session.py:163-219: adjustable speed
    0.1-20x, pause, reset) over the same time-ordered drain semantics.

    The simulated clock advances by wall-dt * speed on every snapshot
    (the viewer polls ~10/s); /ctl drives pause/speed/reset."""

    def __init__(self, session_dir: str, speed: float = 1.0,
                 max_points: int = 3000):
        import time as _time

        from swarm_tpu_torch.proto.csvio import load_session

        self._time = _time
        self.sess = load_session(session_dir)
        self.t0 = float(self.sess["t"][0])
        self.t_end = float(self.sess["t"][-1])
        self.cursor = self.t0
        self.speed = speed
        self.paused = False
        self.max_points = max_points
        self._last_wall = _time.time()
        self._lock = threading.Lock()

    def ctl(self, cmd: str, value: Optional[float] = None):
        with self._lock:
            if cmd == "pause":
                self.paused = not self.paused
            elif cmd == "speed" and value is not None:
                # ref clamps speed to 0.1-20x (:209-213)
                self.speed = float(np.clip(value, 0.1, 20.0))
            elif cmd == "reset":
                self.cursor = self.t0

    def snapshot(self) -> Dict:
        with self._lock:
            now = self._time.time()
            if not self.paused:
                self.cursor = min(self.cursor +
                                  (now - self._last_wall) * self.speed,
                                  self.t_end)
            self._last_wall = now
            cur = self.cursor
        s = self.sess
        tele = s["t"] <= cur
        paths = np.stack([s["x"][tele], s["y"][tele]], -1)
        pa = (s["agent"][tele] - 1).astype(np.int64)
        uids = np.unique(pa)
        poses = []
        for a in uids:
            i = np.nonzero(pa == a)[0][-1]
            poses.append([paths[i, 0], paths[i, 1],
                          np.radians(s["yaw_deg"][tele][i])])
        snap = {
            "grid": np.full((1, 1), -1, np.int8),
            "resolution": 0.05,
            "origin": (0.0, 0.0),
            "poses": np.asarray(poses, np.float64).reshape(-1, 3),
            # HUD rows follow the unique-id order used for poses —
            # indexing bincount by raw id misaligned counts for sessions
            # with non-contiguous agent ids
            "agent_ids": uids,
            "pkt_counts": (np.bincount(pa)[uids]
                           if len(pa) else np.zeros(0, int)),
            "paths": (paths, pa),
            "t": cur - self.t0,
            "playback": {"paused": self.paused, "speed": self.speed,
                         "progress": (cur - self.t0) /
                         max(self.t_end - self.t0, 1e-9)},
        }
        pts = s["points"]
        if pts is not None:
            pm = pts["t"] <= cur
            idx = np.nonzero(pm)[0][-self.max_points:]  # ref: last 3000
            snap["points"] = (
                np.stack([pts["x"][idx], pts["y"][idx]], -1),
                (pts["agent"][idx] - 1).astype(np.int64))
        return snap

    def serve(self, port: int = 8800, bind: str = "127.0.0.1") -> MapView:
        return MapView(self.snapshot, port=port, ctl=self.ctl,
                       bind=bind).start()
