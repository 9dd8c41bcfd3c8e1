"""Per-module camera-frame draw helpers.

Visual parity with the reference's draw methods: detector.draw_detections
(detector.py:171-222), lane_detector.draw_lanes (lane_detector.py:220-251),
tracker.draw_tracks (multi_object_tracker.py:251-313).

A copy of the JAX package's viz/draw.py on the port's host records; cv2
is imported inside each function, so that the port imports on a machine
without it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..host import CLASS_COLORS, HostDetection, HostTrack, lane_points


_TRACK_COLORS = (
    (255, 0, 0),
    (0, 255, 0),
    (0, 0, 255),
    (255, 255, 0),
    (255, 0, 255),
    (0, 255, 255),
    (128, 0, 255),
    (255, 128, 0),
)


def draw_detections(
    frame: np.ndarray,
    detections: Sequence[HostDetection],
    show_labels: bool = True,
    show_confidence: bool = True,
) -> np.ndarray:
    import cv2

    out = frame.copy()
    for det in detections:
        x1, y1, x2, y2 = (int(v) for v in det.bbox)
        color = CLASS_COLORS.get(det.class_id, (255, 255, 255))
        cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
        if show_labels:
            label = det.class_name
            if show_confidence:
                label += f" {det.confidence:.2f}"
            (lw, lh), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
            cv2.rectangle(out, (x1, y1 - lh - 10), (x1 + lw + 5, y1), color, -1)
            cv2.putText(out, label, (x1 + 2, y1 - 5), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    return out


def draw_lanes(
    frame: np.ndarray,
    left_fit: Optional[np.ndarray],
    right_fit: Optional[np.ndarray],
    fill_lane: bool = True,
) -> np.ndarray:
    import cv2

    h = frame.shape[0]
    left = lane_points(left_fit, h) if left_fit is not None else None
    right = lane_points(right_fit, h) if right_fit is not None else None
    overlay = frame.copy()
    if fill_lane and left is not None and right is not None:
        pts = np.vstack([left, right[::-1]])
        cv2.fillPoly(overlay, [pts], (0, 255, 100))
        frame = cv2.addWeighted(frame, 0.7, overlay, 0.3, 0)
    if left is not None:
        cv2.polylines(frame, [left], False, (255, 0, 0), 3)
    if right is not None:
        cv2.polylines(frame, [right], False, (0, 0, 255), 3)
    return frame


def draw_tracks(
    frame: np.ndarray,
    tracks: Sequence[HostTrack],
    draw_trajectories: bool = True,
    draw_ids: bool = True,
    draw_velocities: bool = False,
) -> np.ndarray:
    import cv2

    out = frame.copy()
    for track in tracks:
        color = _TRACK_COLORS[track.track_id % len(_TRACK_COLORS)]
        x1, y1, x2, y2 = (int(v) for v in track.bbox)
        cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
        if draw_ids:
            cv2.putText(out, f"ID:{track.track_id} {track.class_name}",
                        (x1, y1 - 10), cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 2)
        if draw_trajectories and len(track.trajectory) > 1:
            pts = np.asarray(track.trajectory, np.int32)
            for i in range(1, len(pts)):
                thickness = max(1, int(3 * i / len(pts)))
                cv2.line(out, tuple(pts[i - 1]), tuple(pts[i]), color, thickness)
        if draw_velocities and track.velocity is not None:
            cx, cy = (int(v) for v in track.center)
            vx, vy = track.velocity
            cv2.arrowedLine(out, (cx, cy), (int(cx + vx * 5), int(cy + vy * 5)),
                            (0, 255, 255), 2, tipLength=0.3)
    return out
