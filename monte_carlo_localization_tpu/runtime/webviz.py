"""Interactive live viewer — the RViz-session analogue, ROS-free.

The reference's interactive surface is RViz: a live map + particle cloud
+ inferred pose display, a "2D Pose Estimate" tool publishing to
``/initialpose`` and a "Publish Point" tool to ``/clicked_point``
(reference rviz/particle_filter.rviz:170-194, wired by
src/particle_filter.cpp:355-379). Headless deployments have no RViz;
this module serves the same interactions over plain HTTP from the Python
standard library (no new dependencies):

* ``GET /``           — a self-contained HTML page: the live frame
  (auto-refreshing), pose/quality readout, and the two RViz tools —
  press-drag on the map to set a pose estimate (press = position, drag
  direction = heading, exactly RViz's 2D Pose Estimate gesture), and a
  button for global re-localization (the Publish Point analogue).
* ``GET /frame.png``  — the latest rendered frame (viz.render_frame,
  rate-limited server-side so rendering never starves the filter).
* ``GET /state.json`` — inferred pose, iteration count, log quality.
* ``POST /initialpose`` — JSON ``{"u0","v0","u1","v1"}`` image-pixel
  press/release coords (converted server-side) or ``{"x","y","theta"}``
  world coords; re-seeds the filter like the reference's clicked_pose
  (reference :355-374).
* ``POST /global``    — global re-initialization (reference :376-379).

Runs on a daemon thread next to the live loop: ``cli live
--serve PORT`` or ``WebViz(node, gm).start()``. State access goes through
the same MCLNode methods the ROS bridge uses, so the viewer composes
with LiveRunner/sinks untouched.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>tpu-mcl live</title><style>
body{font-family:sans-serif;background:#181818;color:#ddd;margin:16px}
#frame{border:1px solid #444;cursor:crosshair;image-rendering:pixelated}
#bar{margin:8px 0}button{margin-right:8px}
#pose{font-family:monospace}
</style></head><body>
<h3>tpu-mcl live viewer</h3>
<div id="bar">
  <button onclick="reinit()">Global re-localization</button>
  <span>drag on the map to set a pose estimate (drag direction = heading)</span>
</div>
<div id="pose">...</div>
<img id="frame" src="/frame.png">
<script>
const img = document.getElementById('frame');
let press = null;
img.addEventListener('mousedown', e => {
  const r = img.getBoundingClientRect();
  press = [e.clientX - r.left, e.clientY - r.top];
  e.preventDefault();
});
img.addEventListener('mouseup', e => {
  if (!press) return;
  const r = img.getBoundingClientRect();
  const sx = img.naturalWidth / r.width, sy = img.naturalHeight / r.height;
  fetch('/initialpose', {method:'POST', body: JSON.stringify({
    u0: press[0]*sx, v0: press[1]*sy,
    u1: (e.clientX-r.left)*sx, v1: (e.clientY-r.top)*sy})});
  press = null;
});
function reinit(){ fetch('/global', {method:'POST'}); }
setInterval(() => { img.src = '/frame.png?' + Date.now(); }, 250);
setInterval(async () => {
  const s = await (await fetch('/state.json')).json();
  document.getElementById('pose').textContent =
    `pose x=${s.pose[0].toFixed(3)} y=${s.pose[1].toFixed(3)} ` +
    `th=${s.pose[2].toFixed(3)}  iters=${s.iters}  logq=${s.log_quality.toFixed(2)}`;
}, 500);
</script></body></html>
"""


class WebViz:
    """Serve the live viewer for an :class:`~..runtime.node.MCLNode`."""

    def __init__(self, node, grid_map, host: str = "127.0.0.1",
                 port: int = 0, min_frame_interval_s: float = 0.1):
        from monte_carlo_localization_tpu.runtime.viz import _auto_scale

        self.node = node
        self.gm = grid_map
        self.scale = _auto_scale(grid_map.height, grid_map.width)
        self._frame_lock = threading.Lock()
        self._frame_png: bytes = b""
        self._frame_at = 0.0
        self._min_interval = min_frame_interval_s
        self._trajectory: list[np.ndarray] = []
        # last-known values served when the donated-buffer race hits _state()
        self._last_log_q = 0.0
        self._last_pose = np.zeros(3, np.float64)
        viz = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet server
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif path == "/frame.png":
                    self._send(200, viz._render(), "image/png")
                elif path == "/state.json":
                    self._send(200, json.dumps(viz._state()).encode())
                else:
                    self._send(404, b"{}")

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b"{}"
                try:
                    payload = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    self._send(400, b'{"error":"bad json"}')
                    return
                path = self.path.split("?")[0]
                if path == "/initialpose":
                    try:
                        pose = viz._pose_from_payload(payload)
                    except (KeyError, TypeError, ValueError) as e:
                        self._send(400, json.dumps(
                            {"error": str(e)}).encode())
                        return
                    # deferred: applied at the top of the next live tick on
                    # the loop thread — a direct initialize_pose from this
                    # HTTP thread races the live loop's state commit and can
                    # be silently overwritten by the stepped old belief
                    viz.node.request_initialize_pose(pose)
                    viz._trajectory.clear()
                    self._send(200, json.dumps(
                        {"pose": [float(v) for v in pose]}).encode())
                elif path == "/global":
                    viz.node.request_initialize_global()
                    viz._trajectory.clear()
                    self._send(200, b'{"ok": true}')
                else:
                    self._send(404, b"{}")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    # -- lifecycle --
    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}/"

    def start(self) -> "WebViz":
        self._thread.start()
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "WebViz":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request helpers --
    def _pose_from_payload(self, payload: dict) -> np.ndarray:
        """World pose from either world coords or the press-drag gesture
        in image pixels (press = position, drag direction = heading —
        RViz 2D Pose Estimate semantics)."""
        if "x" in payload:
            return np.array(
                [float(payload["x"]), float(payload["y"]),
                 float(payload.get("theta", 0.0))],
                np.float64,
            )
        u0, v0 = float(payload["u0"]), float(payload["v0"])
        u1, v1 = float(payload["u1"]), float(payload["v1"])
        x, y = self._px_to_world(u0, v0)
        if (u1 - u0) ** 2 + (v1 - v0) ** 2 < 4.0:
            theta = 0.0  # a bare click: position only
        else:
            # image v grows downward; world y grows upward
            theta = float(np.arctan2(-(v1 - v0), u1 - u0))
        return np.array([x, y, theta], np.float64)

    def _px_to_world(self, u: float, v: float) -> tuple[float, float]:
        """Inverse of viz.world_to_px for this viewer's scale."""
        gm = self.gm
        res = gm.resolution
        x = u / self.scale * res + float(gm.origin_x)
        y = (gm.height - v / self.scale) * res + float(gm.origin_y)
        return x, y

    # -- rendering / state --
    def _state(self) -> dict:
        # same donated-buffer race as _render(): the live loop donates the
        # state into the next dispatch, so any array this thread grabbed
        # (particles via current_pose, the log_quality scalar) may already
        # be deleted — serve the last-known values instead of 500ing the
        # /state.json poll
        node = self.node
        state = node.state  # snapshot the reference once
        try:
            pose = np.asarray(node.current_pose())[:3]
        except RuntimeError as e:
            self._check_deleted_buffer(e)
            pose = self._last_pose
        else:
            self._last_pose = pose
        log_q = self._last_log_q
        if state is not None:
            try:
                log_q = float(node.filter.log_quality(state))
            except RuntimeError as e:
                self._check_deleted_buffer(e)
            else:
                self._last_log_q = log_q
        return dict(
            pose=[float(v) for v in pose],
            iters=int(node.iters),
            log_quality=log_q,
        )

    @staticmethod
    def _check_deleted_buffer(e: RuntimeError) -> None:
        """Re-raise a RuntimeError that is NOT the donated-buffer race.

        The live loop donates the state into the next dispatch, so a
        monitoring thread touching ``state.particles`` can legitimately see
        jax's deleted/donated-array error — that one is survivable (serve
        the last-known value). Anything else is a genuine bug and must not
        be masked behind stale monitoring output."""
        msg = str(e).lower()
        if "delete" not in msg and "donat" not in msg:
            raise e

    def _render(self) -> bytes:
        now = time.monotonic()
        with self._frame_lock:
            if self._frame_png and now - self._frame_at < self._min_interval:
                return self._frame_png
            from monte_carlo_localization_tpu.runtime.viz import render_frame

            node = self.node
            particles = weights = None
            state = node.state  # snapshot the reference once
            if state is not None:
                try:
                    particles = np.asarray(state.particles)
                    weights = np.asarray(state.weights())
                except RuntimeError as e:
                    # the live loop DONATES the state buffer into the next
                    # dispatch; between dispatch and reassignment the old
                    # array can already be deleted — serve the previous
                    # frame instead of 500ing the viewer
                    self._check_deleted_buffer(e)
                    if self._frame_png:
                        return self._frame_png
                    particles = weights = None
                if particles is not None and len(particles) > 2000:
                    idx = np.linspace(
                        0, len(particles) - 1, 2000
                    ).astype(int)
                    particles, weights = particles[idx], weights[idx]
            try:
                pose = node.current_pose()
            except RuntimeError as e:
                # current_pose reads state.particles — same donated-buffer
                # race as above
                self._check_deleted_buffer(e)
                pose = None
            if pose is not None:
                self._trajectory.append(np.asarray(pose, np.float64))
                if len(self._trajectory) > 2000:
                    del self._trajectory[:1000]
            img = render_frame(
                self.gm, particles=particles, weights=weights, pose=pose,
                trajectory=(
                    np.stack(self._trajectory)
                    if len(self._trajectory) >= 2
                    else None
                ),
                scale=self.scale,
            )
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            self._frame_png = buf.getvalue()
            self._frame_at = now
            return self._frame_png
