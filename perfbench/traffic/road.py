"""The traffic's inputs, made from the seed: synthetic road frames and the
ego vehicle's measurements.

Road frames are vanishing-point scenes with sky, grass, a road with two
solid lane edges and two box vehicles weaving ahead, as BGR uint8 arrays,
drawn with numpy: the road polygon by half-plane tests on pixel centres, a
line as the pixels within half its thickness of the segment, rectangles as
filled index ranges.  Only the vehicles move with the frame index, so the
background is drawn once a pool and copied.  The seed picks where in the
vehicles' motion a pool starts.

Ego measurements follow a constant 10 m/s drive whose heading swings as
0.05 sin(0.5 t), with Gaussian noise of 0.1 m on position and 0.05 m/s on
velocity.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """Independent generators from one seed of any size or sign."""
    return np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), stream]))


def _fill_convex(frame, pts, color) -> None:
    h, w = frame.shape[:2]
    pts = np.asarray(pts, np.float64)
    y0, y1 = max(0, int(np.floor(pts[:, 1].min()))), min(h, int(np.ceil(pts[:, 1].max())) + 1)
    x0, x1 = max(0, int(np.floor(pts[:, 0].min()))), min(w, int(np.ceil(pts[:, 0].max())) + 1)
    if y0 >= y1 or x0 >= x1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    inside = np.ones(ys.shape, bool)
    for i in range(len(pts)):
        (ax, ay), (bx, by) = pts[i], pts[(i + 1) % len(pts)]
        inside &= (bx - ax) * (ys - ay) - (by - ay) * (xs - ax) >= 0
    frame[y0:y1, x0:x1][inside] = color


def _line(frame, p0, p1, color, thickness: int) -> None:
    h, w = frame.shape[:2]
    r = thickness / 2.0
    (ax, ay), (bx, by) = (float(v) for v in p0), (float(v) for v in p1)
    y0, y1 = max(0, int(np.floor(min(ay, by) - r))), min(h, int(np.ceil(max(ay, by) + r)) + 1)
    x0, x1 = max(0, int(np.floor(min(ax, bx) - r))), min(w, int(np.ceil(max(ax, bx) + r)) + 1)
    if y0 >= y1 or x0 >= x1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1].astype(np.float64)
    dx, dy = bx - ax, by - ay
    n2 = dx * dx + dy * dy
    t = np.clip(((xs - ax) * dx + (ys - ay) * dy) / n2, 0.0, 1.0) if n2 > 0 else np.zeros_like(xs)
    d2 = (xs - ax - t * dx) ** 2 + (ys - ay - t * dy) ** 2
    frame[y0:y1, x0:x1][d2 <= r * r] = color


def _rectangle(frame, p0, p1, color) -> None:
    h, w = frame.shape[:2]
    x0, x1 = sorted((int(p0[0]), int(p1[0])))
    y0, y1 = sorted((int(p0[1]), int(p1[1])))
    frame[max(0, y0) : min(h, y1 + 1), max(0, x0) : min(w, x1 + 1)] = color


class RoadScene:
    """The scene's geometry at a frame size: vanishing point at (0.5 w,
    0.45 h), lane edges from (0.15 w, h) and (0.85 w, h) to it."""

    def __init__(self, width: int, height: int):
        self.width, self.height = width, height
        self.vp = (int(width * 0.5), int(height * 0.45))
        self.left_base = (int(width * 0.15), height)
        self.right_base = (int(width * 0.85), height)

    def background(self) -> np.ndarray:
        w, h = self.width, self.height
        frame = np.zeros((h, w, 3), np.uint8)
        horizon = self.vp[1]
        for y in range(horizon):
            shade = 200 - int(60 * y / max(1, horizon))
            frame[y, :] = (min(255, shade + 55), shade, max(0, shade - 30))
        frame[horizon:, :] = (40, 110, 50)
        road = [(self.left_base[0] - 30, h), (self.vp[0] - 8, horizon), (self.vp[0] + 8, horizon),
                (self.right_base[0] + 30, h)]
        _fill_convex(frame, road, (60, 60, 60))
        for base in (self.left_base, self.right_base):
            _line(frame, base, self.vp, (240, 240, 240), 5)
        return frame

    def vehicles(self, frame: np.ndarray, index: int) -> None:
        """Draw frame ``index``'s two vehicles into ``frame``."""
        t = index * 0.05
        for i, (lane_t, speed) in enumerate(((0.35, 0.9), (0.62, 0.6))):
            depth = 0.35 + 0.25 * (0.5 + 0.5 * np.sin(t * speed + i * 2))
            y = int(self.height - depth * (self.height - self.vp[1]))
            scale = max(0.25, 1.2 * (1 - depth))
            x = int(self.left_base[0] + lane_t * (self.right_base[0] - self.left_base[0]) * (1 - depth)
                    + depth * (self.vp[0] - 40))
            bw, bh = int(80 * scale), int(55 * scale)
            _rectangle(frame, (x, y - bh), (x + bw, y), (30, 30, 160))
            _rectangle(frame, (x + bw // 6, y - bh + 4), (x + 5 * bw // 6, y - bh // 2), (150, 200, 220))


def road_frames(seed: int, count: int, height: int, width: int) -> np.ndarray:
    """(count, height, width, 3) uint8 BGR frames, consecutive from a
    start the seed picks."""
    scene = RoadScene(width, height)
    start = int(rng(seed, 0).integers(0, 100_000))
    background = scene.background()
    out = np.empty((count, height, width, 3), np.uint8)
    for i in range(count):
        out[i] = background
        scene.vehicles(out[i], start + i)
    return out


def ego_measurements(seed: int, count: int, fps: float) -> np.ndarray:
    """(count, 4) float32 [x, y, vx, vy] measurements of the drive."""
    dt = 1.0 / fps
    t = np.arange(count) * dt
    heading = 0.05 * np.sin(t * 0.5)
    vx, vy = 10.0 * np.cos(heading), 10.0 * np.sin(heading)
    x, y = np.cumsum(vx * dt), np.cumsum(vy * dt)
    noise = rng(seed, 1).normal(0.0, 1.0, (count, 4)) * np.array([0.1, 0.1, 0.05, 0.05])
    return (np.stack([x, y, vx, vy], axis=1) + noise).astype(np.float32)
