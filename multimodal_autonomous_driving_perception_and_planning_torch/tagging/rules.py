"""Rule-based tagging: the scene classifier, the maneuver detector and the
interaction detector, one step a frame.

The same rules as the JAX package's tagging/rules.py (reference:
src/tagging/{scene_classifier,maneuver_detector,interaction_detector}.py),
and its quirks:
  * the road-type majority vote breaks ties by first appearance in the
    window, and the smoothed road type is written back into the vote ring
    (the reference mutates the history entry it just appended);
  * the lane count takes the lane width at the frame bottom (the
    reference's ``_estimate_lane_count`` raises whenever both lanes exist);
  * the primary interaction sorts risks by their *names*, descending:
    medium > low > high > critical;
  * the lane offset is the reference's hard-coded 0.0 stub.

`make_tagging_step` is the entry point.  For CUDA tensors it launches
kernel K3 (ops.tagging_kernel), for CPU tensors it runs the plain version
below.  Both produce two packed rows a frame, ``tag_f`` (float32) and
``tag_i`` (int32), laid out by `FLOAT_TAGS` and `INT_TAGS`; `unpack_tags`
turns them, with any leading axes, into the JAX package's 43-key dict.

Float arithmetic follows what XLA computes for the JAX package on the CPU
under ``jit``, so that the port meets it bit for bit where a rounding step
matters: a division by a constant is a multiplication by its float32
reciprocal, and where XLA contracts ``a * b + c`` into one fused
multiply-add, `_fma` rounds once.  Kernel K3 repeats each of these steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops import tagging_kernel
from ..ops.tagging_kernel import (
    BOOL_TAGS,
    FLOAT_TAGS,
    INT_TAGS,
    NUM_INTERACTIONS,
    PARAM_NAMES,
    row_width,
)
from ..types import (
    Detections,
    LaneObservation,
    TaggingState,
    VEHICLE_STATE_FIELDS,
    TrackTable,
    map_lanes,
    vehicle_row,
)

# --- enum code tables (host-side names, device-side ints) ------------------

ROAD_TYPES = ("unknown", "intersection", "highway", "urban", "residential", "parking")
CONDITIONS = ("clear", "congested", "night", "day", "rain", "fog")
LATERAL = ("lane_keeping", "lane_change_left", "lane_change_right", "swerving")
LONGITUDINAL = ("cruising", "accelerating", "braking", "hard_braking", "stopped")
TURNING = (
    "straight",
    "turning_left",
    "turning_right",
    "u_turn",
    "curving_left",
    "curving_right",
)
INTERACTIONS = (
    "no_interaction",
    "following_vehicle",
    "being_followed",
    "yielding",
    "vehicle_cut_in",
    "vehicle_cut_out",
    "pedestrian_crossing",
    "pedestrian_waiting",
    "cyclist_nearby",
    "near_miss",
    "merging",
    "passing",
    "being_passed",
)
RISKS = ("low", "medium", "high", "critical")
# Rank of each risk in *descending string order* (the reference's sort
# quirk): "medium" > "low" > "high" > "critical", so a bigger rank sorts
# earlier.  Indexed by (low, medium, high, critical).
_RISK_DESC_STRING_RANK = (2, 3, 1, 0)

# The maneuver history's entry, as positions in the vehicle-state row.
_ENTRY_FIELDS = [
    VEHICLE_STATE_FIELDS.index(n) for n in ("speed", "heading", "acceleration", "yaw_rate", "x", "y")
]

# Detection class ids (detector.py:39-48).
_CAR, _TRUCK, _PED, _CYC, _MOTO, _BUS, _TLIGHT, _SSIGN = range(8)

_I = INTERACTIONS.index

# Scene score table: rows are the seven conditions, columns the road types
# (scene_classifier.py:145-207).
_SCENE_WEIGHTS = np.asarray(
    [
        # unknown, intersection, highway, urban, residential, parking
        [0.0, 0.4, 0.0, 0.0, 0.0, 0.0],  # center edge density
        [0.0, 0.0, 0.5, 0.0, 0.0, 0.0],  # many long lines
        [0.0, 0.3, 0.0, 0.2, 0.0, 0.0],  # traffic elements
        [0.0, 0.0, 0.2, 0.3, 0.0, 0.0],  # dense vehicles
        [0.0, 0.0, 0.0, 0.0, 0.3, 0.0],  # sparse vehicles
        [0.0, 0.0, 0.0, 0.0, 0.3, 0.0],  # green ratio
        [0.0, 0.0, 0.2, 0.1, 0.0, 0.0],  # both lanes
    ],
    np.float32,
)
# The nonzero weights, row-major.
_TOTAL_TERMS = tuple(int(i) for i in np.flatnonzero(_SCENE_WEIGHTS))


def unpack_tags(tag_f: torch.Tensor, tag_i: torch.Tensor, max_tracks: int) -> Dict[str, torch.Tensor]:
    """The tags dict from the packed rows, keeping any leading axes."""
    tags = {}
    for row, layout in ((tag_f, FLOAT_TAGS), (tag_i, INT_TAGS)):
        if row.shape[-1] != row_width(layout, max_tracks):
            raise ValueError(
                f"packed tag row of width {row.shape[-1]}, expected "
                f"{row_width(layout, max_tracks)} for {max_tracks} track slots"
            )
        off = 0
        for name, n in layout:
            width = max_tracks if n == "T" else n
            v = row[..., off] if n == 1 else row[..., off : off + width]
            tags[name] = v.bool() if name in BOOL_TAGS else v
            off += width
    return tags


# --- float32 constants ------------------------------------------------------

_F32 = np.float32


def _recip(c: float) -> float:
    return float(_F32(1) / _F32(c))


@dataclasses.dataclass(frozen=True)
class TaggingRules:
    """The stage's sizes and float32 constants, shared by the plain version
    and kernel K3."""

    window: int  # W, scene vote ring
    history: int  # H, maneuver history ring
    interaction_history: int  # HI, per-slot center ring
    max_tracks: int  # T
    min_hits: int
    params: np.ndarray  # (len(PARAM_NAMES),) float32

    @staticmethod
    def from_config(cfg: PipelineConfig) -> "TaggingRules":
        tg = cfg.tagging
        h, w = float(cfg.frame_height), float(cfg.frame_width)
        values = {
            "frame_height": h,
            "inv_frame_height": _recip(h),
            "half_width": w / 2.0,
            "quarter_width": w / 4.0,
            "three_quarter_width": 3.0 * w / 4.0,
            "inv_fps": _recip(tg.fps),
            "deg_per_rad": 180.0 / math.pi,
            "inv_10": _recip(10.0),
            "inv_20": _recip(20.0),
            "inv_5": _recip(5.0),
            "inv_3": _recip(3.0),
            "inv_90": _recip(90.0),
            "inv_45": _recip(45.0),
            "inv_360": _recip(360.0),
        }
        for name in PARAM_NAMES:
            if name not in values:
                values[name] = getattr(tg, name)
        return TaggingRules(
            window=tg.scene_smoothing_window,
            history=tg.maneuver_history,
            interaction_history=tg.interaction_history,
            max_tracks=cfg.tracker.max_tracks,
            min_hits=cfg.tracker.min_hits,
            params=np.asarray([values[n] for n in PARAM_NAMES], _F32),
        )

    def __getitem__(self, name: str) -> float:
        return float(self.params[PARAM_NAMES.index(name)])


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA's contracted
    multiply-add: the product of two float32 values is exact in float64,
    and the sum is rounded there and then to float32."""
    return (a.double() * b + c).float()


def _div(num, den: torch.Tensor) -> torch.Tensor:
    """A true division.  ``x / tensor`` is ``reciprocal * x`` in PyTorch, and
    a division by a Python number is a reciprocal multiply on CUDA."""
    return torch.div(torch.as_tensor(num, dtype=den.dtype, device=den.device), den)


def _seq_sum(values) -> torch.Tensor:
    """Sum in the given order, one rounding per addition."""
    total = values[0]
    for v in values[1:]:
        total = total + v
    return total


# --- the plain version ------------------------------------------------------


def _scene(rules: TaggingRules, state, dets, lane_obs, feats, speed):
    """Road type, conditions and elements (scene_classifier.py:91-298)."""
    dev = dets.bbox.device
    W = rules.window
    valid, cls = dets.valid, dets.class_id
    any_dets = valid.any()
    hist = ((cls[:, None] == torch.arange(8, device=dev)) & valid[:, None]).sum(0)
    traffic_count = hist[_TLIGHT] + hist[_SSIGN]
    vehicle_count = hist[_CAR] + hist[_TRUCK] + hist[_BUS]
    ped_count = hist[_PED]

    false = torch.zeros((), dtype=torch.bool, device=dev)
    if feats is not None:
        center_density = feats["center_edge_density"]
        many_long = (feats["num_long_lines"] > 5) & (feats["avg_line_length"] > 150.0)
        green = feats["green_ratio"] > 0.15
        brightness = feats["brightness"]
        lap_var = feats["laplacian_var"]
        dense_center = center_density > 0.15
    else:
        many_long = green = dense_center = false
        brightness = torch.tensor(128.0, device=dev)
        lap_var = torch.tensor(1000.0, device=dev)
    both_lanes = (lane_obs.left_found & lane_obs.right_found) if lane_obs is not None else false

    conds = torch.stack(
        [
            dense_center,
            many_long,
            any_dets & (traffic_count > 0),
            any_dets & (vehicle_count > 3),
            any_dets & (vehicle_count <= 1),
            green,
            both_lanes,
        ]
    ).float()
    weights = torch.as_tensor(_SCENE_WEIGHTS, device=dev)
    # XLA's orders: each score sums its column top to bottom; the total sums
    # the whole (7, 6) product in row-major order, where the zero weights
    # add nothing.
    scores = _seq_sum([conds[r] * weights[r] for r in range(7)])
    products = (conds[:, None] * weights).reshape(-1)
    total = _seq_sum([products[i] for i in _TOTAL_TERMS]) + 0.001
    norm = torch.div(scores, total)
    best = torch.argmax(norm).to(torch.int32)  # first max
    conf = norm[best.long()]
    uncertain = conf < 0.3
    road_type = torch.where(uncertain, 3, best).to(torch.int32)  # urban
    road_conf = torch.where(uncertain, 0.3, conf)

    # Majority vote over the last <= W road types, this one included
    # (scene_classifier.py:282-298), oldest first for the tie-break.
    count = state.scene_count
    slots = torch.arange(W, device=dev)
    widx = count % W
    votes = torch.where(slots == widx, road_type, state.scene_votes)
    count1 = count + 1
    n_hist = torch.minimum(count1, torch.tensor(W, dtype=count1.dtype, device=dev))
    window = votes[(count1 - W + slots) % W]  # oldest .. newest
    in_window = slots >= (W - n_hist)
    hit = in_window[None, :] & (window[None, :] == torch.arange(6, device=dev)[:, None])
    counts = hit.sum(1)
    first_pos = torch.where(hit, slots[None, :], W + 1).amin(1)
    max_count = counts.max()
    tie_key = torch.where(counts == max_count, first_pos, W + 2)
    vote_winner = torch.argmin(tie_key).to(torch.int32)
    use_vote = (n_hist >= 2) & (max_count > n_hist // 2)
    smoothed = torch.where(use_vote, vote_winner, road_type).to(torch.int32)
    votes = torch.where(slots == widx, smoothed, votes)

    night = brightness < 60
    day_strong = brightness > 120

    if lane_obs is not None:
        yb = rules["frame_height"]

        def at_bottom(fit):
            return fit[0] * yb * yb + fit[1] * yb + fit[2]

        width_px = (at_bottom(lane_obs.right_fit) - at_bottom(lane_obs.left_fit)).abs()
        lane_count = torch.where(
            both_lanes,
            torch.where(width_px > 200, 3, torch.where(width_px > 100, 2, 1)),
            2,
        ).to(torch.int32)
    else:
        lane_count = torch.tensor(2, dtype=torch.int32, device=dev)

    # Traffic-element confidences: the last matching detection wins
    # (auto_tagger.py:162-163).
    pos = torch.arange(cls.shape[0], device=dev)

    def last_conf(class_id):
        m = valid & (cls == class_id)
        last = torch.where(m, pos, -1).max()
        return m.any(), torch.where(last >= 0, dets.confidence[last.clamp(min=0)], 0.0)

    has_tl, tl_conf = last_conf(_TLIGHT)
    has_ss, ss_conf = last_conf(_SSIGN)

    f = {
        "road_type_confidence": road_conf,
        "traffic_light_confidence": tl_conf,
        "stop_sign_confidence": ss_conf,
        "cond_day_confidence": torch.where(day_strong, 0.8, 0.5),
    }
    i = {
        "road_type": smoothed,
        "road_type_raw": road_type,
        "lane_count": lane_count,
        "has_traffic_light": has_tl & any_dets,
        "has_stop_sign": has_ss & any_dets,
        "has_pedestrian_area": any_dets & (ped_count > 0),
        "cond_night": night,
        "cond_day": ~night,
        "cond_congested": speed < 2.0,
        "cond_clear": speed > 15.0,
        "cond_fog": lap_var < 100.0,
    }
    return votes, f, i


def _maneuver(rules: TaggingRules, state, entry):
    """maneuver_detector.py:105-268 over the state-history ring.  ``entry``
    is (speed, heading, acceleration, yaw rate, x, y)."""
    dev = entry.device
    H = rules.history
    speed, accel, yaw = entry[0], entry[2], entry[3]
    count = state.man_count
    slots = torch.arange(H, device=dev)
    hist = torch.where((slots == count % H)[:, None], entry[None, :], state.man_history)
    count1 = count + 1
    deg = rules["deg_per_rad"]
    yaw_deg = yaw * deg

    # Lateral (:162-195), the last 10 yaw rates oldest first.
    last10 = hist[(count1 - 10 + torch.arange(10, device=dev)) % H, 3]
    have10 = count1 >= 10
    avg_yaw = _seq_sum([last10[k] for k in range(10)]) * rules["inv_10"]
    centered = last10 - avg_yaw
    sq = [centered[k] for k in range(10)]
    var = sq[0] * sq[0]
    for c in sq[1:]:
        var = _fma(c, c, var)
    std_yaw = torch.sqrt(var * rules["inv_10"])
    avg_yaw_deg = avg_yaw * deg

    swerve = have10 & (std_yaw > 0.1)
    lc_left = have10 & ~swerve & (avg_yaw_deg > rules["lane_change_yaw_deg"])
    lc_right = have10 & ~swerve & (avg_yaw_deg < -rules["lane_change_yaw_deg"])
    # The lane offset is the reference's 0.0 stub, so the offset branches
    # (|offset| > lane_change_lateral_m) never fire.
    lateral = torch.where(swerve, 3, torch.where(lc_left, 1, torch.where(lc_right, 2, 0)))
    lat_conf = torch.where(
        swerve,
        torch.clamp(std_yaw * 5.0, max=0.9),
        torch.where(
            lc_left | lc_right, torch.clamp(avg_yaw_deg.abs() * rules["inv_20"], max=0.9), 0.8
        ),
    )

    # Longitudinal (:197-222).
    stopped = speed < rules["stopped_speed"]
    hard_brake = accel < rules["hard_brake"]
    brake = accel < rules["brake"]
    accelerating = accel > rules["accel"]
    longitudinal = torch.where(
        stopped,
        4,
        torch.where(hard_brake, 3, torch.where(brake, 2, torch.where(accelerating, 1, 0))),
    )
    lon_conf = torch.where(
        stopped,
        0.95,
        torch.where(
            hard_brake,
            torch.clamp(accel.abs() * rules["inv_5"], max=0.95),
            torch.where(
                brake,
                torch.clamp(accel.abs() * rules["inv_3"], max=0.9),
                torch.where(accelerating, torch.clamp(accel * rules["inv_3"], max=0.9), 0.8),
            ),
        ),
    )

    # Turning (:224-268): heading change over the last 15 frames.
    have15 = count1 >= 15
    hc = (hist[(count1 - 1) % H, 1] - hist[(count1 - 15) % H, 1]) * deg
    hc = _fma(torch.floor((hc + 180.0) * rules["inv_360"]), -360.0, hc)  # wrap to [-180, 180)
    u_turn = hc.abs() > 120
    t_left = hc > 60
    t_right = hc < -60
    c_left = hc > 15
    c_right = hc < -15
    inst_left = yaw_deg > rules["turn_yaw_rate_deg"]
    inst_right = yaw_deg < -rules["turn_yaw_rate_deg"]
    turning_hist = torch.where(
        u_turn,
        3,
        torch.where(
            t_left, 1, torch.where(t_right, 2, torch.where(c_left, 4, torch.where(c_right, 5, -1)))
        ),
    )
    conf_hist = torch.where(
        u_turn,
        0.8,
        torch.where(
            t_left | t_right,
            torch.clamp(hc.abs() * rules["inv_90"], max=0.9),
            torch.where(c_left | c_right, torch.clamp(hc.abs() * rules["inv_45"], max=0.8), 0.0),
        ),
    )
    turning_inst = torch.where(inst_left, 4, torch.where(inst_right, 5, 0))
    conf_inst = torch.where(inst_left | inst_right, 0.6, 0.8)
    use_hist = have15 & (turning_hist >= 0)
    turning = torch.where(have15, torch.where(use_hist, turning_hist, turning_inst), 0)
    turn_conf = torch.where(have15, torch.where(use_hist, conf_hist, conf_inst), 0.5)

    f = {
        "lateral_confidence": lat_conf,
        "longitudinal_confidence": lon_conf,
        "turning_confidence": turn_conf,
        "speed_kmh": speed * 3.6,
        "acceleration": accel,
        "yaw_rate_deg": yaw_deg,
    }
    i = {"lateral": lateral, "longitudinal": longitudinal, "turning": turning}
    return hist, f, i


def _interaction(rules: TaggingRules, state, table: TrackTable, speed):
    """interaction_detector.py:132-398, vectorised over the track slots."""
    dev = table.bbox.device
    HI, T = rules.interaction_history, rules.max_tracks
    tid, cls, bbox = table.track_id, table.class_id, table.bbox
    confirmed = (tid > 0) & (table.hits >= rules.min_hits)

    # Distance heuristic (:224-247).
    box_h = bbox[:, 3] - bbox[:, 1]
    base_d = _fma(_fma(-bbox[:, 3], rules["inv_frame_height"], 1.0), 50.0, 5.0)
    size_f = _div(100.0, box_h + 10.0)
    dist = torch.where(box_h <= 0, 50.0, torch.clamp((base_d + size_f) * 0.5, 2.0, 100.0))

    # Relative speed (:249-258), 0 without a velocity; TTC (:260-266).
    rel = torch.where(table.vel_count > 0, speed - table.velocity[:, 1], 0.0)
    has_ttc = rel > 0.1
    ttc = torch.where(has_ttc, torch.div(dist, torch.where(has_ttc, rel, 1.0)), math.inf)
    has_ttc = has_ttc & (ttc > 0)

    # Per-slot center ring; a slot claimed by a new id starts afresh.
    lens = torch.where(state.int_track_id == tid, state.int_len, 0)
    cx = (bbox[:, 0] + bbox[:, 2]) * 0.5
    cy = (bbox[:, 1] + bbox[:, 3]) * 0.5
    cols = torch.arange(2 * HI, device=dev)
    write = ((cols // 2)[None, :] == (lens % HI)[:, None]) & confirmed[:, None]
    val = torch.where((cols % 2 == 0)[None, :], cx[:, None], cy[:, None])
    int_centers = torch.where(write, val, state.int_centers)
    hist_len = torch.where(confirmed, lens + 1, lens)

    # Cut-in drift: oldest against newest center, this frame's included
    # (:195-201, :358-364).
    oldest = torch.where(hist_len < HI, 0, hist_len % HI)
    newest = (hist_len - 1) % HI
    start_x = int_centers.gather(1, (2 * oldest).long()[:, None])[:, 0]
    end_x = int_centers.gather(1, (2 * newest).long()[:, None])[:, 0]
    half_w = rules["half_width"]
    cut_drift = (end_x - half_w).abs() < (start_x - half_w).abs()

    # Interaction cascade (:268-375).
    near_miss = dist < rules["near_miss_distance"]
    ped_close = (cls == _PED) & (dist < rules["pedestrian_danger_distance"])
    ped_center = (cx - half_w).abs() < rules["quarter_width"]
    ped_crossing = ped_close & ped_center
    ped_waiting = ped_close & ~ped_center
    cyc_near = (cls == _CYC) & (dist < 15.0)
    is_veh = (cls == _CAR) | (cls == _TRUCK) | (cls == _BUS)
    in_front = (cx > rules["quarter_width"]) & (cx < rules["three_quarter_width"])
    following = (
        is_veh & in_front & (dist > rules["following_distance_min"]) & (dist < rules["following_distance_max"])
    )
    cut_in = is_veh & (hist_len >= 10) & cut_drift & (dist < rules["cut_in_distance"])
    follow_risk = torch.where(
        has_ttc & (ttc < rules["ttc_warning"]), 2, torch.where(dist < 10.0, 1, 0)
    )

    # Priority: near miss > pedestrian > cyclist > following > cut-in.
    itype = torch.full((T,), -1, dtype=torch.int32, device=dev)
    iconf = torch.zeros((T,), dtype=torch.float32, device=dev)
    irisk = torch.zeros((T,), dtype=torch.int32, device=dev)
    for cond, t_val, c_val, r_val in (
        (near_miss, _I("near_miss"), 0.9, 3),
        (ped_crossing, _I("pedestrian_crossing"), 0.8, torch.where(dist < 8.0, 2, 1)),
        (ped_waiting, _I("pedestrian_waiting"), 0.6, 0),
        (cyc_near, _I("cyclist_nearby"), 0.7, torch.where(dist < 8.0, 1, 0)),
        (following, _I("following_vehicle"), 0.75, follow_risk),
        (cut_in, _I("vehicle_cut_in"), 0.7, 1),
    ):
        do = cond & (itype < 0) & confirmed
        itype = torch.where(do, t_val, itype)
        iconf = torch.where(do, c_val, iconf)
        irisk = torch.where(do, r_val, irisk).to(torch.int32)
    has_int = itype >= 0

    conf_hist = ((cls[:, None] == torch.arange(8, device=dev)) & confirmed[:, None]).sum(0)
    n_conf = confirmed.sum()
    inf = torch.tensor(math.inf, device=dev)
    min_dist = torch.where(confirmed, dist, inf).min()
    min_ttc = torch.where(confirmed & has_ttc, ttc, inf).min()

    # Primary interaction: the reference's descending *string* sort on
    # (risk, -confidence), stable in ascending id.
    desc_rank = torch.tensor(_RISK_DESC_STRING_RANK, device=dev)[irisk.long()]
    any_int = has_int.any()
    m1 = torch.where(has_int, desc_rank, -1).max()
    e1 = has_int & (desc_rank == m1)
    m2 = torch.where(e1, iconf, inf).min()
    e2 = e1 & (iconf == m2)
    primary_slot = torch.argmin(torch.where(e2, tid, torch.iinfo(torch.int32).max))
    primary = torch.where(any_int, itype[primary_slot], -1)

    # Overall risk (:377-398).
    max_risk = torch.where(has_int, irisk, 0).max()
    has_min_ttc = torch.isfinite(min_ttc)
    overall = torch.where(any_int, torch.where(has_min_ttc & (min_ttc < rules["ttc_critical"]), 3, max_risk), 0)

    # Presence (confidence > 0.5) and last-wins confidence per type; "last"
    # is the highest id having the type (auto_tagger.py:177-178).
    match = (itype[None, :] == torch.arange(NUM_INTERACTIONS, device=dev)[:, None]) & has_int[None, :]
    present = (match & (iconf > 0.5)[None, :]).any(1)
    last_slot = torch.argmax(torch.where(match, tid[None, :], -1), dim=1)
    type_conf = torch.where(match.any(1), iconf[last_slot], 0.0)

    f = {
        "closest_agent_distance": torch.where(torch.isfinite(min_dist), min_dist, 0.0),
        "min_ttc": torch.where(has_min_ttc, min_ttc, 0.0),
        "interaction_confidence": type_conf,
        "track_interaction_confidence": iconf,
        "track_distance": dist,
        "track_relative_speed": rel,
        "track_ttc": torch.where(has_ttc, ttc, 0.0),
    }
    i = {
        "primary_interaction": primary,
        "overall_risk": overall,
        "agent_count": n_conf,
        "pedestrian_count": conf_hist[_PED],
        "cyclist_count": conf_hist[_CYC],
        "vehicle_count": conf_hist[_CAR] + conf_hist[_TRUCK] + conf_hist[_BUS] + conf_hist[_MOTO],
        "has_min_ttc": has_min_ttc,
        "interaction_present": present,
        "track_interaction_type": itype,
        "track_interaction_risk": irisk,
        "track_has_ttc": has_ttc,
    }
    return int_centers, hist_len, f, i


def _pack(layout, values: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    return torch.cat([values[name].to(dtype).reshape(-1) for name, _ in layout])


def tagging_step_plain(
    rules: TaggingRules,
    state: TaggingState,
    dets: Detections,
    table: TrackTable,
    vrow: torch.Tensor,
    lane_obs: Optional[LaneObservation] = None,
    frame_feats: Optional[Dict] = None,
) -> Tuple[TaggingState, torch.Tensor, torch.Tensor]:
    """One tagging step, the plain version (kernel K3's reference).

    ``vrow`` is the (11,) float32 vehicle-state row in VehicleState field
    order.  Returns the new state and the packed rows ``(tag_f, tag_i)``."""
    entry = vrow.float()[_ENTRY_FIELDS]
    speed = entry[0]
    votes, scene_f, scene_i = _scene(rules, state, dets, lane_obs, frame_feats, speed)
    hist, man_f, man_i = _maneuver(rules, state, entry)
    int_centers, int_len, int_f, int_i = _interaction(rules, state, table, speed)

    counts = torch.stack([state.scene_count, state.man_count, state.frame_count]).to(torch.int32) + 1
    new_state = TaggingState(
        scene_votes=votes.to(torch.int32),
        scene_count=counts[0],
        man_history=hist,
        man_count=counts[1],
        int_centers=int_centers,
        int_len=int_len.to(torch.int32),
        int_track_id=table.track_id,
        frame_count=counts[2],
    )
    timestamp = state.frame_count.float() * rules["inv_fps"]
    tag_f = _pack(FLOAT_TAGS, {**scene_f, **man_f, **int_f, "timestamp": timestamp}, torch.float32)
    tag_i = _pack(INT_TAGS, {**scene_i, **man_i, **int_i}, torch.int32)
    return new_state, tag_f, tag_i


# The scene features in the order of K3's feature row.
FEATURE_KEYS = (
    "center_edge_density", "num_long_lines", "avg_line_length", "green_ratio", "brightness", "laplacian_var",
)


def frames_rows(lane_obs: Optional[LaneObservation], frame_feats: Optional[Dict]):
    """Frames mode's inputs as K3 takes them: the (..., 8) float32 lane row
    (left fit, right fit, the two found flags) and the (..., 6) float32
    feature row (`FEATURE_KEYS`); ``(None, None)`` in detections mode."""
    if lane_obs is None:
        return None, None
    found = torch.stack([lane_obs.left_found, lane_obs.right_found], dim=-1).float()
    lane_row = torch.cat([lane_obs.left_fit.float(), lane_obs.right_fit.float(), found], dim=-1)
    return lane_row, torch.stack([frame_feats[k].float() for k in FEATURE_KEYS], dim=-1)


def frames_from_rows(lane_row: torch.Tensor, feat_row: torch.Tensor):
    """`frames_rows` undone for the plain version: ``(lane_obs,
    frame_feats)`` with what the rules read (the fits and found flags; the
    observation's other fields are zeros).  The plain version's tags equal
    those from the original observation bit for bit: the rules compare the
    line count, an integer, only with an integer bound."""
    zero = torch.zeros_like(lane_row[..., 0])
    lane_obs = LaneObservation(
        left_fit=lane_row[..., 0:3], right_fit=lane_row[..., 3:6],
        left_found=lane_row[..., 6] != 0, right_found=lane_row[..., 7] != 0,
        left_confidence=zero, right_confidence=zero, offset_px=zero, has_offset=torch.zeros_like(zero, dtype=torch.bool),
    )
    return lane_obs, {k: feat_row[..., i] for i, k in enumerate(FEATURE_KEYS)}


# --- the entry point --------------------------------------------------------


def make_packed_tagging_step(cfg: PipelineConfig):
    """Build ``step(state, dets, table, vrow, lane_obs=None,
    frame_feats=None) -> (state', tag_f, tag_i)``, ``vrow`` the (11,)
    float32 vehicle-state row in VehicleState field order.

    CUDA tensors go through kernel K3, CPU tensors through the plain
    version.  ``lane_obs`` and ``frame_feats`` come together (frames mode)
    or not at all (detections mode).  Inputs with a leading lane axis are B
    taggers stepped at once: one launch on the card, the plain version lane
    by lane on the CPU."""
    rules = TaggingRules.from_config(cfg)

    def step(state, dets, table, vrow, lane_obs=None, frame_feats=None):
        if (lane_obs is None) != (frame_feats is None):
            raise ValueError(
                "lane_obs and frame_feats come together (frames mode) or not at "
                "all (detections mode)"
            )
        device = table.track_id.device
        if device.type == "cuda":
            lane_row, feat_row = frames_rows(lane_obs, frame_feats)
            return tagging_kernel.tagging_step(
                rules, state, dets, table, vrow, lane_row, feat_row
            )
        if device.type != "cpu":
            raise ValueError(f"tagging step: unsupported device {device}")
        if table.track_id.dim() > 1:
            return map_lanes(step, table.track_id.shape[0], state, dets, table, vrow, lane_obs, frame_feats)
        return tagging_step_plain(rules, state, dets, table, vrow, lane_obs, frame_feats)

    return step


def make_tagging_step(cfg: PipelineConfig):
    """Build the per-frame tagging step, with the JAX package's signature:
    ``step(state, dets, table, confirmed, n_confirmed, vstate,
    lane_obs=None, frame_feats=None) -> (state', tags)``.  ``confirmed``
    and ``n_confirmed`` are accepted and unused, as there: the detector
    derives the confirmed set from the table."""
    packed = make_packed_tagging_step(cfg)
    max_tracks = cfg.tracker.max_tracks

    def tagging_step(
        state, dets, table, confirmed, n_confirmed, vstate, lane_obs=None, frame_feats=None
    ):
        new_state, tag_f, tag_i = packed(
            state, dets, table, vehicle_row(vstate), lane_obs, frame_feats
        )
        return new_state, unpack_tags(tag_f, tag_i, max_tracks)

    return tagging_step
