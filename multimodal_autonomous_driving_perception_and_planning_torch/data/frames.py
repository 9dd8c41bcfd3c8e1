"""Synthetic road-scene frames, drawn with numpy alone.

Port of the JAX package's data/frames.py: vanishing-point road frames with
lane markings, sky and grass, and two box vehicles, as BGR uint8 arrays, so
that the frames path runs with no camera footage.  The geometry and the
ground truth (`SyntheticRoadGenerator.lane_x_at`) are the JAX package's.
The JAX package draws with cv2; this copy rasterises with numpy: the road
polygon by half-plane tests on pixel centres, a line as the pixels within
half its thickness of the segment, rectangles as filled index ranges.  The
frames stand close to the cv2 ones, not equal to them pixel for pixel
(tests/test_torch_frames_pipeline.py bounds the gap).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .synthetic import ego_motion_stream


def _fill_convex(frame: np.ndarray, pts, color) -> None:
    """Fill the convex polygon ``pts`` (counter-clockwise in image
    coordinates, y down) with ``color``: every pixel centre on the inner
    side of every edge."""
    h, w = frame.shape[:2]
    pts = np.asarray(pts, np.float64)
    y0 = max(0, int(np.floor(pts[:, 1].min())))
    y1 = min(h, int(np.ceil(pts[:, 1].max())) + 1)
    x0 = max(0, int(np.floor(pts[:, 0].min())))
    x1 = min(w, int(np.ceil(pts[:, 0].max())) + 1)
    if y0 >= y1 or x0 >= x1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    inside = np.ones(ys.shape, bool)
    for i in range(len(pts)):
        (ax, ay), (bx, by) = pts[i], pts[(i + 1) % len(pts)]
        inside &= (bx - ax) * (ys - ay) - (by - ay) * (xs - ax) >= 0
    frame[y0:y1, x0:x1][inside] = color


def _line(frame: np.ndarray, p0, p1, color, thickness: int) -> None:
    """Draw the segment p0-p1: every pixel centre within ``thickness / 2``
    of it (round caps, as a thick cv2.line)."""
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


def _rectangle(frame: np.ndarray, p0, p1, color) -> None:
    """Fill the rectangle with corners p0 and p1, both included."""
    h, w = frame.shape[:2]
    x0, x1 = sorted((int(p0[0]), int(p1[0])))
    y0, y1 = sorted((int(p0[1]), int(p1[1])))
    frame[max(0, y0) : min(h, y1 + 1), max(0, x0) : min(w, x1 + 1)] = color


class SyntheticRoadGenerator:
    """Vanishing-point synthetic road scenes.

    Ground truth: left lane from (0.15w, h) to vp, right lane from
    (0.85w, h) to vp, vp at (0.5w, 0.45h).  Dashes scroll with frame index.
    """

    def __init__(
        self,
        width: int = 640,
        height: int = 480,
        fps: float = 30.0,
        draw_adjacent_dash: bool = False,
    ):
        self.width = width
        self.height = height
        self.fps = fps
        self.frame_count = 0
        self.draw_adjacent_dash = draw_adjacent_dash
        self.vp = (int(width * 0.5), int(height * 0.45))
        # The ego drives inside its lane: markings at the lane edges.
        self.left_base = (int(width * 0.15), height)
        self.right_base = (int(width * 0.85), height)

    def lane_x_at(self, side: str, y: float) -> float:
        """Ground-truth lane x at image row y (linear to the vanishing pt)."""
        bx, by = self.left_base if side == "left" else self.right_base
        vx, vy = self.vp
        t = (y - by) / (vy - by)
        return bx + t * (vx - bx)

    def generate_road_frame(self) -> np.ndarray:
        w, h = self.width, self.height
        frame = np.zeros((h, w, 3), np.uint8)
        horizon = self.vp[1]
        self._draw_environment(frame, horizon)
        road = [
            (self.left_base[0] - 30, h),
            (self.vp[0] - 8, horizon),
            (self.vp[0] + 8, horizon),
            (self.right_base[0] + 30, h),
        ]
        _fill_convex(frame, road, (60, 60, 60))
        self._draw_lane_markings(frame, self.vp[0], self.vp[1])
        return frame

    def _draw_environment(self, frame: np.ndarray, horizon_y: int) -> None:
        w = self.width
        for y in range(horizon_y):  # sky gradient
            shade = 200 - int(60 * y / max(1, horizon_y))
            frame[y, :] = (min(255, shade + 55), shade, max(0, shade - 30))
        frame[horizon_y:, :] = (40, 110, 50)  # grass

    def _draw_lane_markings(self, frame: np.ndarray, vp_x: int, vp_y: int) -> None:
        h = self.height
        for base in (self.left_base, self.right_base):  # solid ego-lane edges
            _line(frame, base, (vp_x, vp_y), (240, 240, 240), 5)
        # Optional adjacent-lane dashed marking, scrolling with the frame
        # counter, converging to the same vanishing point.
        if self.draw_adjacent_dash:
            base_x = int(self.width * 0.02)
            phase = (self.frame_count * 8) % 40
            for i in range(14):
                t0 = (i * 40 + phase) / 560.0
                t1 = t0 + 20 / 560.0
                if t1 >= 1.0:
                    continue
                p0 = (int(base_x + t0 * (vp_x - base_x)), int(h - t0 * (h - vp_y)))
                p1 = (int(base_x + t1 * (vp_x - base_x)), int(h - t1 * (h - vp_y)))
                _line(frame, p0, p1, (230, 230, 230), 3)

    def generate_vehicle(
        self,
        frame: np.ndarray,
        x: int,
        y: int,
        scale: float = 1.0,
        color: Tuple[int, int, int] = (30, 30, 160),
    ) -> None:
        bw, bh = int(80 * scale), int(55 * scale)
        _rectangle(frame, (x, y - bh), (x + bw, y), color)
        _rectangle(frame, (x + bw // 6, y - bh + 4), (x + 5 * bw // 6, y - bh // 2), (150, 200, 220))

    def generate_frame_with_vehicles(self) -> np.ndarray:
        frame = self.generate_road_frame()
        t = self.frame_count * 0.05
        for i, (lane_t, speed) in enumerate(((0.35, 0.9), (0.62, 0.6))):  # two vehicles weaving ahead
            depth = 0.35 + 0.25 * (0.5 + 0.5 * np.sin(t * speed + i * 2))
            y = int(self.height - depth * (self.height - self.vp[1]))
            scale = max(0.25, 1.2 * (1 - depth))
            x = int(
                self.left_base[0]
                + lane_t * (self.right_base[0] - self.left_base[0]) * (1 - depth)
                + depth * (self.vp[0] - 40)
            )
            self.generate_vehicle(frame, x, y, scale)
        self.frame_count += 1
        return frame

    def generate_video_stream(self, num_frames: int):
        for _ in range(num_frames):
            yield self.generate_frame_with_vehicles()

    def generate_frames(self, num_frames: int) -> np.ndarray:
        """(T, H, W, 3) uint8 stacked frames."""
        return np.stack(list(self.generate_video_stream(num_frames)))

    def generate_ego_motion(self, num_steps: Optional[int] = None):
        # seed=None: the current global RNG state, as the JAX package draws.
        return ego_motion_stream(num_steps or 300, dt=1.0 / self.fps, seed=None)

    def reset(self) -> None:
        self.frame_count = 0
