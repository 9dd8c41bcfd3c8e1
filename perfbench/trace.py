"""The traced run's profile: a steady stretch of segments under
``torch.profiler``, the card's activity only (host operators are not
recorded, which would slow the host that paces these cells), read back
into what the per-layer metric readers take.

The stretch opens a third of the way into the window, after filler
launches that absorb the records a trace may lose at its start.  Marker
kernels (``torch.cuda._sleep(0)``, named ``spin_kernel``, which the
program never launches) bracket the stretch and, from the harness's hooks
on the program's YOLOv8 module, each tower pass: a device record between
a tower's two markers belongs to the tower, as one stream runs them in
order.  Kernel names, the program's launch counters and its outputs on the
stretch give the kernels' work.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
from collections import defaultdict
from typing import Dict, List

import torch

from . import counts

MARKER = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
FILLERS = 256  # launches that open a trace, for the records a trace may lose
FILLER_TRIES = 3


def mark() -> None:
    """Put a marker kernel on the card's queue."""
    torch.cuda._sleep(0)


class Stretch:
    def __init__(self, drive, segments: int):
        self.drive, self.segments, self.ran = drive, segments, False

    def due(self, elapsed: float, seconds: float) -> bool:
        return not self.ran and elapsed >= seconds / 3

    def run(self, serve) -> None:
        """Serve ``segments`` segments through ``serve`` under the
        profiler, keeping their outputs (and the previous segment's) for
        the kernels' counts.  The profiler can lose a trace's first
        records, so each trace opens with filler launches, finished before
        the stretch; a trace that lost a marker is taken again over the
        next segments, with eight times the fillers."""
        from multimodal_autonomous_driving_perception_and_planning_torch.ops import (
            kalman_kernel, nms_kernel, tagging_kernel, tracker_kernel,
        )

        self.ran = True
        modules = {"tracker": tracker_kernel, "kalman": kalman_kernel, "tagging": tagging_kernel,
                   "nms": nms_kernel}
        scratch = torch.zeros(1, device=self.drive.device)
        self.drive.keep = True
        for attempt in range(FILLER_TRIES):
            self.previous = self.drive.last_outs
            self.outs = []
            before = {k: m.launches for k, m in modules.items()}
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(FILLERS * 8**attempt):
                    scratch.add_(1)
                torch.cuda.synchronize()
                mark()
                for _ in range(self.segments):
                    serve()
                    self.outs.append(self.drive.last_outs)
                mark()
                torch.cuda.synchronize()
            self.launches = {k: m.launches - before[k] for k, m in modules.items()}
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                prof.export_chrome_trace(path)
                with open(path) as fh:
                    self.events = json.load(fh)["traceEvents"]
            finally:
                os.unlink(path)
            markers = sum(1 for e in self.events if e.get("cat") == "kernel" and MARKER in e.get("name", ""))
            if markers == 2 + 2 * self.segments:
                self.drive.keep = False
                return
            print(f"perfbench: trace {attempt + 1} shows {markers} of {2 + 2 * self.segments} markers",
                  file=sys.stderr)
        raise RuntimeError(f"{FILLER_TRIES} traces each lost records")

    def context(self, config: Dict, traffic: Dict, segment_s: List[float]) -> "Context":
        return Context(self, config, traffic, segment_s)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Context:
    """What the metric readers read: the stretch's device records, its
    length and frames, the tower's device time, the launch counts and the
    per-launch work of each hand-written kernel; and the host-clock seconds
    of the window's segments served before the stretch opened."""

    def __init__(self, stretch: Stretch, config: Dict, traffic: Dict, segment_s: List[float]):
        self.config, self.segment_s = config, list(segment_s)
        ev = [e for e in stretch.events if e.get("ph") == "X"]
        on_card = sorted((e for e in ev if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
        markers = [e for e in on_card if MARKER in e["name"]]
        t0, t1 = markers[0]["ts"] + markers[0]["dur"], markers[-1]["ts"]
        self.frames = stretch.segments * traffic["segment_frames"]
        self.window_s = (t1 - t0) * 1e-6
        self.device = [e for e in on_card if MARKER not in e["name"] and t0 <= e["ts"] < t1]
        merged = _union([(e["ts"], min(e["ts"] + e["dur"], t1)) for e in self.device])
        self.busy_s = sum(e - s for s, e in merged) * 1e-6
        self._merged, self._t0, self._t1 = merged, t0, t1

        towers = [(a["ts"], b["ts"]) for a, b in zip(markers[1:-1:2], markers[2:-1:2])]
        self.tower_ranges = len(towers)
        starts = [a for a, _ in towers]

        def in_tower(ts):
            i = bisect.bisect_right(starts, ts) - 1
            return i >= 0 and ts < towers[i][1]

        self.tower_s = sum(e["dur"] for e in self.device if in_tower(e["ts"])) * 1e-6
        self._host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                            if e.get("cat") in HOST_CATS and t0 - 1e6 <= e["ts"] < t1)
        self.launches = stretch.launches
        self.work = _work(stretch, config, traffic)

    def device_seconds(self, part: str) -> float:
        """Device seconds of the kernels whose names contain ``part``."""
        return sum(e["dur"] for e in self.device if e.get("cat") == "kernel" and part in e["name"]) * 1e-6

    def device_records(self) -> int:
        return len(self.device)

    def breakdown(self) -> Dict:
        """The device operations that took most time, and the idle gaps by
        the runtime call the host was in (Python between calls otherwise)."""
        by_name = defaultdict(float)
        for e in self.device:
            by_name[e["name"]] += e["dur"] * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = defaultdict(float)
        prev = self._t0
        host_starts = [h[0] for h in self._host]
        for s, e in self._merged + [[self._t1, self._t1]]:
            if s > prev:
                gaps[self._host_at((prev + s) / 2, host_starts)] += (s - prev) * 1e-6
            prev = max(prev, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}

    def _host_at(self, t: float, starts: List[float]) -> str:
        """The runtime call the host was in at time t."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - 64), -1):
            s, e, name = self._host[j]
            if e >= t:
                return name
        return "host Python, between runtime calls"


def _work(stretch: Stretch, config: Dict, traffic: Dict) -> Dict:
    """Bound seconds and operations of each kernel over the stretch, from
    the program's outputs there and the counts of ``counts``."""
    drive = stretch.drive
    cfg = drive.cfg
    T, D = cfg.tracker.max_tracks, cfg.detector.max_detections
    L = cfg.tracker.trajectory_length
    tg = cfg.tagging
    W, H, HI = tg.scene_smoothing_window, tg.maneuver_history, tg.interaction_history
    K = min(traffic["pre_topk"], sum((config["img_size"] // s) ** 2 for s in (8, 16, 32)))
    work = {k: {"bound_s": 0.0, "ops": 0} for k in ("tracker", "kalman", "tagging", "nms")}
    prev_ids = stretch.previous["track_id"][-1]
    for outs in stretch.outs:
        scores = outs["candidates"]["scores"]
        live = (scores > traffic["score_threshold"]).sum(dim=-1).clamp(max=K)
        ops = counts.nms_ops(live)
        work["nms"]["ops"] += ops
        work["nms"]["bound_s"] += counts.bound_s(counts.nms_bytes(scores.shape[0], K), ops, counts.PEAK_F32_PER_S)
        dets = outs["detections"]
        matches = (outs["match"] >= 0).sum(dim=-1).tolist()
        ids, hits, velc = outs["track_id"], outs["track_hits"], outs["track_vel_count"]
        valid, cls = dets["valid"], dets["class_id"]
        for f, m in enumerate(matches):
            ops = counts.tracker_ops(T, D, m)
            work["tracker"]["ops"] += ops
            work["tracker"]["bound_s"] += counts.bound_s(counts.tracker_bytes(T, D, L), ops, counts.PEAK_F32_PER_S)
            work["kalman"]["ops"] += counts.KALMAN_OPS
            work["kalman"]["bound_s"] += counts.bound_s(counts.kalman_bytes(), counts.KALMAN_OPS, counts.PEAK_F64_PER_S)
            alive = ids[f] > 0
            nbytes = counts.tagging_bytes(
                T, D, W, H, HI, n_valid=int(valid[f].sum()),
                n_signs=int((valid[f] & ((cls[f] == 6) | (cls[f] == 7))).sum()), alive=int(alive.sum()),
                with_velocity=int((velc[f] > 0).sum()), kept=int((prev_ids == ids[f]).sum()),
                confirmed=int((alive & (hits[f] >= cfg.tracker.min_hits)).sum()))
            ops = counts.tagging_ops(T, D, W, H, HI)
            work["tagging"]["ops"] += ops
            work["tagging"]["bound_s"] += counts.bound_s(nbytes, ops, counts.PEAK_F32_PER_S)
            prev_ids = ids[f]
    return work
