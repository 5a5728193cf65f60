"""Visualization output — the RViz-config equivalent.

The reference ships an RViz configuration that displays the occupancy map,
the particle cloud (PoseArray), the inferred pose, and the TF frame
(reference rviz/particle_filter.rviz:1-227, wired to /pf/viz/* topics by
src/particle_filter.cpp:923-983). Headless deployments have no RViz,
so this module renders the same displays straight to PNG with Pillow:

* occupancy-map underlay with ROS ``map_saver`` shading
  (free=254, occupied=0, unknown=205),
* the particle cloud colored by normalized weight (cold blue -> hot red),
* the inferred pose as an oriented arrow,
* the trajectory so far as a polyline.

``VizSink`` plugs into ``MCLNode``'s sink surface (runtime/sinks.py) and
writes a frame every Nth correction plus a final trajectory overview —
the trace-replay analogue of watching RViz during a rosbag run.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from monte_carlo_localization_tpu.runtime.sinks import Sink

# ROS map_saver grayscale convention.
_FREE, _OCCUPIED, _UNKNOWN = 254, 0, 205


def _auto_scale(h: int, w: int, target: int = 640) -> int:
    """Integer upscale so small maps render legibly; never downscale."""
    return max(1, int(round(target / max(h, w))))


def map_image(gm, scale: int | None = None):
    """Occupancy underlay as an RGB PIL image, row 0 of the grid at the
    image bottom (ROS origin is the lower-left corner)."""
    from PIL import Image

    occ = np.asarray(gm.occupancy)
    h, w = occ.shape
    scale = scale or _auto_scale(h, w)
    gray = np.full((h, w), _UNKNOWN, np.uint8)
    gray[occ == 0] = _FREE
    gray[occ > 50] = _OCCUPIED
    gray = gray[::-1]  # flip: world +y is image up
    img = Image.fromarray(gray, "L").convert("RGB")
    if scale != 1:
        img = img.resize((w * scale, h * scale), Image.NEAREST)
    return img


def world_to_px(gm, xy: np.ndarray, scale: int) -> np.ndarray:
    """World (x, y) -> image (u, v) pixel coordinates (float)."""
    h = int(np.asarray(gm.occupancy).shape[0])
    res = gm.resolution
    xy = np.atleast_2d(np.asarray(xy, np.float64))
    # continuous pixel coords: pixel i covers [i, i+1); grid row r renders
    # at image row h-1-r, so v = (h - gy) * scale puts a point with
    # fractional grid-y gy inside the correct flipped pixel
    u = (xy[:, 0] - float(gm.origin_x)) / res * scale
    v = (h - (xy[:, 1] - float(gm.origin_y)) / res) * scale
    return np.stack([u, v], axis=1)


def _weight_colors(weights: np.ndarray | None, n: int) -> np.ndarray:
    """(n, 3) uint8: normalized weight mapped blue (low) -> red (high)."""
    if weights is None:
        return np.tile(np.array([[60, 100, 230]], np.uint8), (n, 1))
    w = np.asarray(weights, np.float64)
    lo, hi = float(w.min()), float(w.max())
    t = np.zeros_like(w) if hi - lo < 1e-30 else (w - lo) / (hi - lo)
    r = (60 + 195 * t).astype(np.uint8)
    g = (100 * (1 - t) + 60 * t).astype(np.uint8)
    b = (230 * (1 - t) + 60 * t).astype(np.uint8)
    return np.stack([r, g, b], axis=1)


def render_frame(
    gm,
    particles: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    pose: np.ndarray | None = None,
    trajectory: np.ndarray | None = None,
    scale: int | None = None,
):
    """Render one frame (the RViz display set) onto the map underlay.

    particles: (N, 3) [x, y, theta]; weights: (N,) or None;
    pose: (3,) inferred pose; trajectory: (K, 2|3) past poses.
    Returns a PIL RGB image.
    """
    from PIL import ImageDraw

    occ = np.asarray(gm.occupancy)
    scale = scale or _auto_scale(*occ.shape)
    img = map_image(gm, scale)
    draw = ImageDraw.Draw(img)

    if trajectory is not None and len(trajectory) >= 2:
        pts = world_to_px(gm, np.asarray(trajectory)[:, :2], scale)
        draw.line([tuple(p) for p in pts], fill=(40, 170, 80), width=max(1, scale // 2))

    if particles is not None and len(particles):
        p = np.asarray(particles)
        uv = world_to_px(gm, p[:, :2], scale)
        colors = _weight_colors(weights, len(p))
        px = img.load()
        wpx, hpx = img.size
        for (u, v), (r, g, b) in zip(uv, colors):
            ui, vi = int(u), int(v)
            if 0 <= ui < wpx and 0 <= vi < hpx:
                px[ui, vi] = (int(r), int(g), int(b))

    if pose is not None:
        pose = np.asarray(pose, np.float64)
        (u, v), = world_to_px(gm, pose[None, :2], scale)
        length = max(8.0, 3.0 * scale)
        du = length * np.cos(pose[2])
        dv = -length * np.sin(pose[2])  # image v grows downward
        draw.line([(u, v), (u + du, v + dv)], fill=(230, 40, 40),
                  width=max(2, scale // 2))
        rad = max(2.0, 0.8 * scale)
        draw.ellipse([u - rad, v - rad, u + rad, v + rad],
                     fill=(230, 40, 40))
    return img


class VizSink(Sink):
    """Sink that renders PNG frames — the RViz session analogue.

    Subscribes to ``pose`` and ``particles`` (reference /pf/viz/* topics).
    Writes ``frame_NNNNN.png`` every ``every``-th correction and a final
    ``trajectory.png`` overview on close.
    """

    topics = frozenset(("pose", "particles"))

    def __init__(self, gm, out_dir: str | Path, every: int = 10,
                 scale: int | None = None):
        self.gm = gm
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.every = max(1, int(every))
        self.scale = scale
        self._poses: list[np.ndarray] = []
        self._last_cloud: np.ndarray | None = None
        self._n_corrections = 0
        self.frames_written = 0

    def publish(self, topic: str, t: float, payload: dict) -> None:
        if topic == "particles":
            self._last_cloud = np.asarray(payload["cloud"])
            return
        if topic != "pose":
            return
        pose = np.asarray(payload["pose"], np.float64)
        self._poses.append(pose)
        self._n_corrections += 1
        if (self._n_corrections - 1) % self.every == 0:
            img = render_frame(
                self.gm,
                particles=self._last_cloud,
                pose=pose,
                trajectory=np.asarray(self._poses),
                scale=self.scale,
            )
            img.save(self.out_dir / f"frame_{self._n_corrections:05d}.png")
            self.frames_written += 1

    def close(self) -> None:
        if not self._poses:
            return
        img = render_frame(
            self.gm,
            particles=self._last_cloud,
            pose=self._poses[-1],
            trajectory=np.asarray(self._poses),
            scale=self.scale,
        )
        img.save(self.out_dir / "trajectory.png")
