"""Host-side tag aggregation, search, statistics, and export.

Rebuild of the reference AutoTagger (src/tagging/auto_tagger.py:74-372): the
tagging stage emits structured per-frame tag tensors (tagging/rules.py, kernel
K3 on the card); this module converts them into the reference's record
shapes (FrameTags with flat string tag lists and confidences) and provides
the same search / statistics / event-segment / export surface.  A copy of
the JAX package's tagging/auto_tagger.py, which the port cannot import; the
tags may be tensors on the card or the CPU, or arrays.
"""

from __future__ import annotations

import dataclasses
import json
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..host import to_numpy
from .rules import CONDITIONS, INTERACTIONS, LATERAL, LONGITUDINAL, RISKS, ROAD_TYPES, TURNING


@dataclasses.dataclass
class FrameTags:
    """Per-frame tag record (auto_tagger.py:18-50)."""

    frame_idx: int
    timestamp: float
    scene: Dict
    maneuver: Dict
    interaction: Dict
    all_tags: List[str]
    tag_confidences: Dict[str, float]

    def to_dict(self) -> Dict:
        return {
            "frame_idx": self.frame_idx,
            "timestamp": self.timestamp,
            "scene": self.scene,
            "maneuver": self.maneuver,
            "interaction": self.interaction,
            "all_tags": self.all_tags,
            "tag_confidences": self.tag_confidences,
        }

    def get_summary_string(self) -> str:
        parts = []
        if self.scene:
            parts.append(f"Scene: {self.scene['road_type']}")
        if self.maneuver:
            parts.append(
                f"Maneuver: {self.maneuver['lateral']}, {self.maneuver['longitudinal']}"
            )
        if self.interaction and self.interaction.get("primary_interaction"):
            parts.append(f"Interaction: {self.interaction['primary_interaction']}")
        return " | ".join(parts) if parts else "No tags"


@dataclasses.dataclass
class TaggingSession:
    """Session metadata (auto_tagger.py:53-71)."""

    session_id: str
    video_path: str
    start_time: datetime
    end_time: Optional[datetime] = None
    total_frames: int = 0
    fps: float = 30.0

    def to_dict(self) -> Dict:
        return {
            "session_id": self.session_id,
            "video_path": self.video_path,
            "start_time": self.start_time.isoformat(),
            "end_time": self.end_time.isoformat() if self.end_time else None,
            "total_frames": self.total_frames,
            "fps": self.fps,
        }


def _frame_tags_from_device(f: int, tags: Dict[str, np.ndarray]) -> FrameTags:
    """Decode one frame's device tag tensors into a FrameTags record.

    Tag-list construction order mirrors the reference aggregation
    (auto_tagger.py:154-187: scene list, maneuver list, interaction list,
    order-preserving dedup).
    """
    g = lambda k: tags[k]  # noqa: E731

    road_type = ROAD_TYPES[int(g("road_type"))]
    conditions: List[Tuple[str, float]] = []
    # _analyze_conditions order (scene_classifier.py:230-259).
    if bool(g("cond_night")):
        conditions.append(("night", 0.8))
    else:
        conditions.append(("day", float(g("cond_day_confidence"))))
    if bool(g("cond_congested")):
        conditions.append(("congested", 0.7))
    elif bool(g("cond_clear")):
        conditions.append(("clear", 0.7))
    if bool(g("cond_fog")):
        conditions.append(("fog", 0.3))

    elements: List[Tuple[str, float]] = []
    if bool(g("has_traffic_light")):
        elements.append(("traffic_light", float(g("traffic_light_confidence"))))
    if bool(g("has_stop_sign")):
        elements.append(("stop_sign", float(g("stop_sign_confidence"))))

    scene_tag_list = [road_type]
    scene_tag_list += [e for e, _ in elements]
    scene_tag_list += [c for c, _ in conditions]
    if bool(g("has_pedestrian_area")):
        scene_tag_list.append("pedestrian_area")

    lateral = LATERAL[int(g("lateral"))]
    longitudinal = LONGITUDINAL[int(g("longitudinal"))]
    turning = TURNING[int(g("turning"))]
    maneuver_tag_list = [lateral, longitudinal, turning]

    present = np.asarray(g("interaction_present"))
    int_conf = np.asarray(g("interaction_confidence"))
    risk = RISKS[int(g("overall_risk"))]
    interaction_tag_list = [INTERACTIONS[i] for i in np.flatnonzero(present)]
    if risk != "low":
        interaction_tag_list.append(f"risk_{risk}")

    all_tags: List[str] = []
    seen = set()
    for tag in scene_tag_list + maneuver_tag_list + interaction_tag_list:
        if tag not in seen:
            seen.add(tag)
            all_tags.append(tag)

    tag_confidences: Dict[str, float] = {}
    tag_confidences[road_type] = float(g("road_type_confidence"))
    for e, c in elements:
        tag_confidences[e] = c
    tag_confidences[lateral] = float(g("lateral_confidence"))
    tag_confidences[longitudinal] = float(g("longitudinal_confidence"))
    tag_confidences[turning] = float(g("turning_confidence"))
    itypes = np.asarray(g("track_interaction_type"))
    iconfs = np.asarray(g("track_interaction_confidence"))
    for k in np.flatnonzero(itypes >= 0):
        tag_confidences[INTERACTIONS[int(itypes[k])]] = float(iconfs[k])

    primary = int(g("primary_interaction"))
    interactions_detail = [
        {
            "type": INTERACTIONS[int(itypes[k])],
            "confidence": float(iconfs[k]),
            "risk_level": RISKS[int(np.asarray(g("track_interaction_risk"))[k])],
            "distance": float(np.asarray(g("track_distance"))[k]),
            "relative_speed": float(np.asarray(g("track_relative_speed"))[k]),
            "time_to_collision": (
                float(np.asarray(g("track_ttc"))[k])
                if bool(np.asarray(g("track_has_ttc"))[k])
                else None
            ),
        }
        for k in np.flatnonzero(itypes >= 0)
    ]

    return FrameTags(
        frame_idx=f,
        timestamp=float(g("timestamp")),
        scene={
            "road_type": road_type,
            "road_type_confidence": float(g("road_type_confidence")),
            "traffic_elements": elements,
            "conditions": conditions,
            "lane_count": int(g("lane_count")),
            "has_pedestrian_area": bool(g("has_pedestrian_area")),
            "timestamp": float(g("timestamp")),
        },
        maneuver={
            "lateral": lateral,
            "lateral_confidence": float(g("lateral_confidence")),
            "longitudinal": longitudinal,
            "longitudinal_confidence": float(g("longitudinal_confidence")),
            "turning": turning,
            "turning_confidence": float(g("turning_confidence")),
            "speed_kmh": float(g("speed_kmh")),
            "acceleration": float(g("acceleration")),
            "yaw_rate_deg": float(g("yaw_rate_deg")),
            "timestamp": float(g("timestamp")),
        },
        interaction={
            "interactions": interactions_detail,
            "primary_interaction": INTERACTIONS[primary] if primary >= 0 else None,
            "overall_risk": risk,
            "agent_count": int(g("agent_count")),
            "pedestrian_count": int(g("pedestrian_count")),
            "cyclist_count": int(g("cyclist_count")),
            "vehicle_count": int(g("vehicle_count")),
            "closest_agent_distance": float(g("closest_agent_distance")),
            "min_ttc": float(g("min_ttc")) if bool(g("has_min_ttc")) else None,
            "timestamp": float(g("timestamp")),
        },
        all_tags=all_tags,
        tag_confidences=tag_confidences,
    )


def get_maneuver_summary(
    speeds: np.ndarray, accelerations: np.ndarray, positions: np.ndarray
) -> Dict:
    """Recent-maneuver summary (maneuver_detector.py:270-299) over stacked
    per-frame ego history: speed stats in km/h and accel stats over the last
    30 frames, plus total distance over the last 30 positions.  Empty dict
    below 5 frames of history, like the reference."""
    speeds = np.asarray(speeds, np.float64)
    if speeds.shape[0] < 5:
        return {}
    recent_s = speeds[-30:]
    recent_a = np.asarray(accelerations, np.float64)[-30:]
    pos = np.asarray(positions, np.float64)[-30:]
    total_dist = float(np.sum(np.linalg.norm(np.diff(pos, axis=0), axis=1))) if len(pos) >= 2 else 0.0
    return {
        "avg_speed_kmh": float(np.mean(recent_s)) * 3.6,
        "max_speed_kmh": float(np.max(recent_s)) * 3.6,
        "min_speed_kmh": float(np.min(recent_s)) * 3.6,
        "avg_acceleration": float(np.mean(recent_a)),
        "max_acceleration": float(np.max(recent_a)),
        "min_acceleration": float(np.min(recent_a)),
        "total_distance": total_dist,
    }


class AutoTagger:
    """Aggregator + in-memory tag search / statistics / export
    (auto_tagger.py:74-372).  Frames are ingested from device tag tensors
    instead of being computed per-frame in Python."""

    def __init__(self, video_path: str = "unknown", fps: float = 30.0):
        self.video_path = video_path
        self.fps = fps
        self.session = TaggingSession(
            session_id=datetime.now().strftime("%Y%m%d_%H%M%S"),
            video_path=video_path,
            start_time=datetime.now(),
            fps=fps,
        )
        self.frame_tags: List[FrameTags] = []
        self.tag_counts: Dict[str, int] = {}
        self.frame_count = 0

    # -- ingestion ---------------------------------------------------------
    def ingest_device_tags(self, tags: Dict[str, Any], num_frames: int) -> None:
        """Consume the stacked `outs["tags"]` dict from a pipeline scan."""
        host_tags = {k: to_numpy(v) for k, v in tags.items()}
        for f in range(num_frames):
            per_frame = {k: v[f] for k, v in host_tags.items()}
            # Timestamps come from the device "timestamp" tag tensor (which
            # already encodes the tagging fps), not from self.fps.
            ft = _frame_tags_from_device(self.frame_count, per_frame)
            self.frame_tags.append(ft)
            for tag in ft.all_tags:
                self.tag_counts[tag] = self.tag_counts.get(tag, 0) + 1
            self.frame_count += 1
        self.session.total_frames = self.frame_count

    # -- statistics / search (reference surface) ---------------------------
    def get_tag_statistics(self) -> Dict:
        if not self.frame_tags:
            return {}
        total = len(self.frame_tags)
        freq = {t: c / total for t, c in self.tag_counts.items()}
        ordered = sorted(freq.items(), key=lambda x: x[1], reverse=True)
        speeds = [ft.maneuver["speed_kmh"] for ft in self.frame_tags]
        risk_counts = {"low": 0, "medium": 0, "high": 0, "critical": 0}
        for ft in self.frame_tags:
            risk_counts[ft.interaction["overall_risk"]] += 1
        return {
            "total_frames": total,
            "unique_tags": len(self.tag_counts),
            "tag_frequency": dict(ordered[:20]),
            "tag_counts": self.tag_counts,
            "speed_stats": {
                "min": min(speeds) if speeds else 0,
                "max": max(speeds) if speeds else 0,
                "avg": float(np.mean(speeds)) if speeds else 0,
            },
            "risk_distribution": risk_counts,
            "session_info": self.session.to_dict(),
        }

    def search_by_tag(self, tag: str) -> List[FrameTags]:
        return [ft for ft in self.frame_tags if tag in ft.all_tags]

    def search_by_tags(self, tags: List[str], match_all: bool = True) -> List[FrameTags]:
        if match_all:
            return [ft for ft in self.frame_tags if all(t in ft.all_tags for t in tags)]
        return [ft for ft in self.frame_tags if any(t in ft.all_tags for t in tags)]

    def get_high_risk_frames(self) -> List[FrameTags]:
        return [
            ft
            for ft in self.frame_tags
            if ft.interaction["overall_risk"] in ("high", "critical")
        ]

    def get_event_segments(self, event_tag: str, min_duration: int = 5) -> List[Tuple[int, int]]:
        segments = []
        start = None
        for i, ft in enumerate(self.frame_tags):
            has = event_tag in ft.all_tags
            if has and start is None:
                start = i
            elif not has and start is not None:
                if i - start >= min_duration:
                    segments.append((start, i - 1))
                start = None
        if start is not None and len(self.frame_tags) - start >= min_duration:
            segments.append((start, len(self.frame_tags) - 1))
        return segments

    def export_tags(self, format: str = "dict") -> Any:
        if format == "dict":
            return {
                "session": self.session.to_dict(),
                "statistics": self.get_tag_statistics(),
                "frames": [ft.to_dict() for ft in self.frame_tags],
            }
        if format == "json":
            return json.dumps(self.export_tags("dict"), indent=2)
        if format == "csv":
            return [
                {
                    "frame_idx": ft.frame_idx,
                    "timestamp": ft.timestamp,
                    "road_type": ft.scene["road_type"],
                    "lateral_maneuver": ft.maneuver["lateral"],
                    "longitudinal_maneuver": ft.maneuver["longitudinal"],
                    "turning_maneuver": ft.maneuver["turning"],
                    "speed_kmh": ft.maneuver["speed_kmh"],
                    "risk_level": ft.interaction["overall_risk"],
                    "agent_count": ft.interaction["agent_count"],
                    "all_tags": "|".join(ft.all_tags),
                }
                for ft in self.frame_tags
            ]
        return None

    def reset(self) -> None:
        self.frame_tags = []
        self.tag_counts = {}
        self.frame_count = 0
        self.session = TaggingSession(
            session_id=datetime.now().strftime("%Y%m%d_%H%M%S"),
            video_path=self.video_path,
            start_time=datetime.now(),
            fps=self.fps,
        )

    def finalize(self) -> None:
        self.session.end_time = datetime.now()
        self.session.total_frames = self.frame_count
