"""Structured per-frame metrics logging (JSONL).

The reference logs via bare prints (SURVEY.md section 5).  This emits one
JSON object per frame — consumable by dashboards or offline analysis —
from the host-extracted frame results.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import IO, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self._fh: Optional[IO] = None
        if path is not None:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(path, "a")
        self.records = []

    def log_frame(self, frame_idx: int, **metrics) -> Dict:
        rec = {"frame": frame_idx, **metrics}
        if self._fh is not None:
            # Streaming to a file: don't ALSO accumulate every record in
            # memory — a multi-hour session would grow without bound.
            self._fh.write(json.dumps(rec) + "\n")
        else:
            self.records.append(rec)
        return rec

    def log_frame_result(self, res) -> Dict:
        """Log the standard metrics from a host FrameResult."""
        return self.log_frame(
            res.frame_idx,
            num_detections=len(res.detections),
            num_tracks=len(res.tracks),
            speed_kmh=res.vehicle_state.speed * 3.6,
            heading_deg=float(res.vehicle_state.heading) * 57.29577951308232,
            plan_cost=res.optimal_trajectory.cost,
            plan_type=res.optimal_trajectory.trajectory_type,
            lane_offset=res.lane_offset,
            risk=str(res.tags.get("overall_risk", "")) if res.tags else "",
        )

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
