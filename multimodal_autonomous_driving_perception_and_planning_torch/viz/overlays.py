"""Camera-view HUD overlays (host raster I/O).

Visual parity with src/visualization/overlays.py:26-210: info panel,
detection summary, lane-offset gauge, tracking stats, side-by-side composer.

A copy of the JAX package's viz/overlays.py on the port's host records; cv2
is imported inside each function, so that the port imports on a machine
without it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..host import HostDetection, HostTrack, HostVehicleState


class OverlayRenderer:
    def __init__(self):
        self.font_scale = 0.5
        self.font_thickness = 1

    def draw_info_panel(
        self,
        frame: np.ndarray,
        vehicle_state: Optional[HostVehicleState] = None,
        fps: float = 0.0,
        frame_num: int = 0,
    ) -> np.ndarray:
        import cv2

        overlay = frame.copy()
        cv2.rectangle(overlay, (10, 10), (250, 150), (0, 0, 0), -1)
        frame = cv2.addWeighted(frame, 0.7, overlay, 0.3, 0)
        lines = [f"Frame: {frame_num}", f"FPS: {fps:.1f}"]
        if vehicle_state is not None:
            lines += [
                f"Speed: {vehicle_state.speed * 3.6:.1f} km/h",
                f"Heading: {np.degrees(vehicle_state.heading):.1f} deg",
                f"Accel: {vehicle_state.acceleration:.2f} m/s2",
                f"Pos: ({vehicle_state.x:.1f}, {vehicle_state.y:.1f})",
            ]
        y = 30
        for line in lines:
            cv2.putText(frame, line, (20, y), cv2.FONT_HERSHEY_SIMPLEX, self.font_scale,
                        (255, 255, 255), self.font_thickness)
            y += 20
        return frame

    def draw_detection_summary(
        self,
        frame: np.ndarray,
        detections: Sequence[HostDetection],
        position: str = "top_right",
    ) -> np.ndarray:
        import cv2

        h, w = frame.shape[:2]
        counts = {}
        for det in detections:
            counts[det.class_name] = counts.get(det.class_name, 0) + 1
        x0, y0 = (w - 150, 10) if position == "top_right" else (10, h - 100)
        overlay = frame.copy()
        cv2.rectangle(overlay, (x0, y0), (x0 + 140, y0 + 20 + len(counts) * 18),
                      (0, 0, 0), -1)
        frame = cv2.addWeighted(frame, 0.7, overlay, 0.3, 0)
        cv2.putText(frame, "Detections:", (x0 + 5, y0 + 15), cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                    (255, 255, 255), 1)
        y = y0 + 35
        for name, count in counts.items():
            cv2.putText(frame, f"  {name}: {count}", (x0 + 5, y), cv2.FONT_HERSHEY_SIMPLEX, 0.35,
                        (200, 200, 200), 1)
            y += 18
        return frame

    def draw_lane_offset_indicator(
        self, frame: np.ndarray, offset: Optional[float]
    ) -> np.ndarray:
        import cv2

        h, w = frame.shape[:2]
        iw, ih = 200, 30
        x0, y0 = (w - iw) // 2, h - 50
        cv2.rectangle(frame, (x0, y0), (x0 + iw, y0 + ih), (50, 50, 50), -1)
        cv2.rectangle(frame, (x0, y0), (x0 + iw, y0 + ih), (100, 100, 100), 1)
        cx = x0 + iw // 2
        cv2.line(frame, (cx, y0), (cx, y0 + ih), (255, 255, 255), 1)
        if offset is not None:
            off = int(np.clip(offset, -100, 100))
            if abs(offset) < 20:
                color = (0, 255, 0)
            elif abs(offset) < 50:
                color = (0, 255, 255)
            else:
                color = (0, 0, 255)
            cv2.circle(frame, (cx + off, y0 + ih // 2), 8, color, -1)
            cv2.putText(frame, f"Offset: {offset:.0f}px", (x0 + 5, y0 - 5),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1)
        return frame

    def draw_tracking_stats(
        self,
        frame: np.ndarray,
        tracks: Sequence[HostTrack],
        position: str = "bottom_left",
    ) -> np.ndarray:
        import cv2

        h, w = frame.shape[:2]
        x0, y0 = (10, h - 80) if position == "bottom_left" else (w - 150, h - 80)
        overlay = frame.copy()
        cv2.rectangle(overlay, (x0, y0), (x0 + 140, y0 + 70), (0, 0, 0), -1)
        frame = cv2.addWeighted(frame, 0.7, overlay, 0.3, 0)
        avg_age = np.mean([t.age for t in tracks]) if tracks else 0
        cv2.putText(frame, "Tracking Stats:", (x0 + 5, y0 + 15), cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                    (255, 255, 255), 1)
        cv2.putText(frame, f"  Active: {len(tracks)}", (x0 + 5, y0 + 35), cv2.FONT_HERSHEY_SIMPLEX,
                    0.35, (200, 200, 200), 1)
        cv2.putText(frame, f"  Avg Age: {avg_age:.0f} frames", (x0 + 5, y0 + 55),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.35, (200, 200, 200), 1)
        return frame

    def create_side_by_side(
        self,
        frame1: np.ndarray,
        frame2: np.ndarray,
        labels: Tuple[str, str] = ("Camera", "BEV"),
    ) -> np.ndarray:
        import cv2

        h1, h2 = frame1.shape[0], frame2.shape[0]
        target = max(h1, h2)
        if h1 != target:
            frame1 = cv2.resize(frame1, (int(frame1.shape[1] * target / h1), target))
        if h2 != target:
            frame2 = cv2.resize(frame2, (int(frame2.shape[1] * target / h2), target))
        combined = np.hstack([frame1, frame2])
        cv2.putText(combined, labels[0], (10, 25), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 2)
        cv2.putText(combined, labels[1], (frame1.shape[1] + 10, 25), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                    (255, 255, 255), 2)
        return combined
