"""Plain rule-based tagging of a frame in detections mode: the scene
classifier, the maneuver detector and the interaction detector.

The rules and their quirks, as the reference stack states them:

* the road type is the best-scoring of six types over seven weighted
  conditions, "urban" under confidence 0.3, smoothed by a majority vote
  over the last five frames (ties to the oldest), written back into the
  vote ring;
* the maneuver detector reads the last 10 yaw rates (swerve, lane change),
  the acceleration (braking, accelerating, stopped) and the heading change
  over 15 frames (turns), wrapped to [-180, 180);
* each confirmed track's distance comes from its box's bottom and height,
  its time to collision from the ego speed against its forward velocity,
  its interaction from a cascade (near miss, pedestrian, cyclist,
  following, cut-in from a ring of its centres);
* the primary interaction sorts risks by their names, descending.

Float arithmetic follows the program's stated float32 steps: a division
by a constant is a multiplication by its float32 reciprocal, and ``fma``
rounds a multiply-add once.  ``dtype`` is the float type (float32 for the
reference, bfloat16 for the control).  The state is a dict:
``scene_votes`` (W,), ``scene_count``, ``man_history`` (H, 6),
``man_count``, ``int_centers`` (T, 2 HI), ``int_len`` (T,),
``int_track_id`` (T,), ``frame_count``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

ROW = ("x", "y", "vx", "vy", "heading", "speed", "acceleration", "yaw_rate", "timestamp",
       "pos_uncertainty", "vel_uncertainty")
_ENTRY = [ROW.index(n) for n in ("speed", "heading", "acceleration", "yaw_rate", "x", "y")]
_CAR, _TRUCK, _PED, _CYC, _MOTO, _BUS, _TLIGHT, _SSIGN = range(8)
NUM_INTERACTIONS = 13
_NEAR_MISS, _PED_CROSS, _PED_WAIT, _CYC_NEAR, _FOLLOW, _CUT_IN = 9, 6, 7, 8, 1, 4
_RISK_DESC_STRING_RANK = (2, 3, 1, 0)  # low, medium, high, critical
_SCENE_WEIGHTS = np.asarray(
    [[0.0, 0.4, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.5, 0.0, 0.0, 0.0], [0.0, 0.3, 0.0, 0.2, 0.0, 0.0],
     [0.0, 0.0, 0.2, 0.3, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.3, 0.0], [0.0, 0.0, 0.0, 0.0, 0.3, 0.0],
     [0.0, 0.0, 0.2, 0.1, 0.0, 0.0]], np.float32)
_TOTAL_TERMS = tuple(int(i) for i in np.flatnonzero(_SCENE_WEIGHTS))
FLOAT_TAGS = (
    "road_type_confidence", "traffic_light_confidence", "stop_sign_confidence", "cond_day_confidence",
    "lateral_confidence", "longitudinal_confidence", "turning_confidence", "speed_kmh", "acceleration",
    "yaw_rate_deg", "closest_agent_distance", "min_ttc", "timestamp", "interaction_confidence",
    "track_interaction_confidence", "track_distance", "track_relative_speed", "track_ttc",
)


def _recip(c: float) -> float:
    return float(np.float32(1) / np.float32(c))


def constants(cfg: Dict) -> Dict[str, float]:
    """The rules' float32 constants from the configuration's tagging
    thresholds, frame size and tracker's ``min_hits``."""
    tg, h, w = cfg["tagging"], float(cfg["frame_height"]), float(cfg["frame_width"])
    c = dict(tg)
    c.update(min_hits=cfg["tracker"]["min_hits"], frame_height=h, inv_frame_height=_recip(h), half_width=w / 2.0,
             quarter_width=w / 4.0, three_quarter_width=3.0 * w / 4.0, inv_fps=_recip(tg["fps"]),
             deg_per_rad=180.0 / math.pi,
             inv_10=_recip(10.0), inv_20=_recip(20.0), inv_5=_recip(5.0), inv_3=_recip(3.0),
             inv_90=_recip(90.0), inv_45=_recip(45.0), inv_360=_recip(360.0))
    return {k: float(np.float32(v)) if isinstance(v, float) else v for k, v in c.items()}


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    return (a.double() * b + c).to(a.dtype)


def _seq_sum(values):
    total = values[0]
    for v in values[1:]:
        total = total + v
    return total


def _scene(k, state, dets, speed, dtype):
    dev = dets["bbox"].device
    W = k["scene_smoothing_window"]
    valid, cls = dets["valid"], dets["class_id"]
    any_dets = valid.any()
    hist = ((cls[:, None] == torch.arange(8, device=dev)) & valid[:, None]).sum(0)
    traffic_count = hist[_TLIGHT] + hist[_SSIGN]
    vehicle_count = hist[_CAR] + hist[_TRUCK] + hist[_BUS]
    false = torch.zeros((), dtype=torch.bool, device=dev)
    conds = torch.stack([false, false, any_dets & (traffic_count > 0), any_dets & (vehicle_count > 3),
                         any_dets & (vehicle_count <= 1), false, false]).to(dtype)
    weights = torch.as_tensor(_SCENE_WEIGHTS, device=dev).to(dtype)
    scores = _seq_sum([conds[r] * weights[r] for r in range(7)])
    products = (conds[:, None] * weights).reshape(-1)
    total = _seq_sum([products[i] for i in _TOTAL_TERMS]) + 0.001
    norm = torch.div(scores, total)
    best = torch.argmax(norm).to(torch.int32)
    conf = norm[best.long()]
    uncertain = conf < 0.3
    road_type = torch.where(uncertain, 3, best).to(torch.int32)

    count = state["scene_count"]
    slots = torch.arange(W, device=dev)
    widx = count % W
    votes = torch.where(slots == widx, road_type, state["scene_votes"])
    count1 = count + 1
    n_hist = torch.minimum(count1, torch.tensor(W, dtype=count1.dtype, device=dev))
    window = votes[(count1 - W + slots) % W]
    hit = (slots >= (W - n_hist))[None, :] & (window[None, :] == torch.arange(6, device=dev)[:, None])
    counts = hit.sum(1)
    first_pos = torch.where(hit, slots[None, :], W + 1).amin(1)
    max_count = counts.max()
    winner = torch.argmin(torch.where(counts == max_count, first_pos, W + 2)).to(torch.int32)
    smoothed = torch.where((n_hist >= 2) & (max_count > n_hist // 2), winner, road_type).to(torch.int32)
    votes = torch.where(slots == widx, smoothed, votes)

    pos = torch.arange(cls.shape[0], device=dev)

    def last_conf(class_id):
        m = valid & (cls == class_id)
        last = torch.where(m, pos, -1).max()
        return m.any(), torch.where(last >= 0, dets["confidence"].to(dtype)[last.clamp(min=0)], 0.0)

    has_tl, tl_conf = last_conf(_TLIGHT)
    has_ss, ss_conf = last_conf(_SSIGN)
    brightness = torch.tensor(128.0, dtype=dtype, device=dev)
    night = brightness < 60
    f = {"road_type_confidence": torch.where(uncertain, 0.3, conf), "traffic_light_confidence": tl_conf,
         "stop_sign_confidence": ss_conf, "cond_day_confidence": torch.where(brightness > 120, 0.8, 0.5)}
    i = {"road_type": smoothed, "road_type_raw": road_type, "lane_count": torch.tensor(2, device=dev),
         "has_traffic_light": has_tl & any_dets, "has_stop_sign": has_ss & any_dets,
         "has_pedestrian_area": any_dets & (hist[_PED] > 0), "cond_night": night, "cond_day": ~night,
         "cond_congested": speed < 2.0, "cond_clear": speed > 15.0,
         "cond_fog": torch.tensor(1000.0, dtype=dtype, device=dev) < 100.0}
    return votes, f, i


def _maneuver(k, state, entry):
    dev = entry.device
    H = k["maneuver_history"]
    speed, accel, yaw = entry[0], entry[2], entry[3]
    count = state["man_count"]
    slots = torch.arange(H, device=dev)
    hist = torch.where((slots == count % H)[:, None], entry[None, :], state["man_history"].to(entry.dtype))
    count1 = count + 1
    deg = k["deg_per_rad"]
    yaw_deg = yaw * deg

    last10 = hist[(count1 - 10 + torch.arange(10, device=dev)) % H, 3]
    have10 = count1 >= 10
    avg_yaw = _seq_sum([last10[j] for j in range(10)]) * k["inv_10"]
    centered = last10 - avg_yaw
    var = centered[0] * centered[0]
    for j in range(1, 10):
        var = _fma(centered[j], centered[j], var)
    std_yaw = torch.sqrt(var * k["inv_10"])
    avg_deg = avg_yaw * deg
    swerve = have10 & (std_yaw > 0.1)
    lc_left = have10 & ~swerve & (avg_deg > k["lane_change_yaw_deg"])
    lc_right = have10 & ~swerve & (avg_deg < -k["lane_change_yaw_deg"])
    lateral = torch.where(swerve, 3, torch.where(lc_left, 1, torch.where(lc_right, 2, 0)))
    lat_conf = torch.where(swerve, torch.clamp(std_yaw * 5.0, max=0.9),
                           torch.where(lc_left | lc_right, torch.clamp(avg_deg.abs() * k["inv_20"], max=0.9), 0.8))

    stopped = speed < k["stopped_speed"]
    hard = accel < k["hard_brake"]
    brake = accel < k["brake"]
    acc = accel > k["accel"]
    longitudinal = torch.where(stopped, 4, torch.where(hard, 3, torch.where(brake, 2, torch.where(acc, 1, 0))))
    lon_conf = torch.where(stopped, 0.95, torch.where(
        hard, torch.clamp(accel.abs() * k["inv_5"], max=0.95),
        torch.where(brake, torch.clamp(accel.abs() * k["inv_3"], max=0.9),
                    torch.where(acc, torch.clamp(accel * k["inv_3"], max=0.9), 0.8))))

    have15 = count1 >= 15
    hc = (hist[(count1 - 1) % H, 1] - hist[(count1 - 15) % H, 1]) * deg
    hc = _fma(torch.floor((hc + 180.0) * k["inv_360"]), -360.0, hc)
    u_turn, t_left, t_right = hc.abs() > 120, hc > 60, hc < -60
    c_left, c_right = hc > 15, hc < -15
    inst_left, inst_right = yaw_deg > k["turn_yaw_rate_deg"], yaw_deg < -k["turn_yaw_rate_deg"]
    turning_hist = torch.where(u_turn, 3, torch.where(t_left, 1, torch.where(
        t_right, 2, torch.where(c_left, 4, torch.where(c_right, 5, -1)))))
    conf_hist = torch.where(u_turn, 0.8, torch.where(
        t_left | t_right, torch.clamp(hc.abs() * k["inv_90"], max=0.9),
        torch.where(c_left | c_right, torch.clamp(hc.abs() * k["inv_45"], max=0.8), 0.0)))
    turning_inst = torch.where(inst_left, 4, torch.where(inst_right, 5, 0))
    conf_inst = torch.where(inst_left | inst_right, 0.6, 0.8)
    use_hist = have15 & (turning_hist >= 0)
    f = {"lateral_confidence": lat_conf, "longitudinal_confidence": lon_conf,
         "turning_confidence": torch.where(have15, torch.where(use_hist, conf_hist, conf_inst), 0.5),
         "speed_kmh": speed * 3.6, "acceleration": accel, "yaw_rate_deg": yaw_deg}
    i = {"lateral": lateral, "longitudinal": longitudinal,
         "turning": torch.where(have15, torch.where(use_hist, turning_hist, turning_inst), 0)}
    return hist, f, i


def _interaction(k, state, table, speed, dtype):
    dev = table["bbox"].device
    HI, T = k["interaction_history"], table["track_id"].shape[0]
    tid, cls, bbox = table["track_id"], table["class_id"], table["bbox"].to(dtype)
    confirmed = (tid > 0) & (table["hits"] >= k["min_hits"])

    box_h = bbox[:, 3] - bbox[:, 1]
    base_d = _fma(_fma(-bbox[:, 3], k["inv_frame_height"], 1.0), 50.0, 5.0)
    size_f = torch.div(torch.tensor(100.0, dtype=dtype, device=dev), box_h + 10.0)
    dist = torch.where(box_h <= 0, 50.0, torch.clamp((base_d + size_f) * 0.5, 2.0, 100.0))
    rel = torch.where(table["vel_count"] > 0, speed - table["velocity"].to(dtype)[:, 1], 0.0)
    has_ttc = rel > 0.1
    ttc = torch.where(has_ttc, torch.div(dist, torch.where(has_ttc, rel, 1.0)), math.inf)
    has_ttc = has_ttc & (ttc > 0)

    lens = torch.where(state["int_track_id"] == tid, state["int_len"], 0)
    cx = (bbox[:, 0] + bbox[:, 2]) * 0.5
    cy = (bbox[:, 1] + bbox[:, 3]) * 0.5
    cols = torch.arange(2 * HI, device=dev)
    write = ((cols // 2)[None, :] == (lens % HI)[:, None]) & confirmed[:, None]
    val = torch.where((cols % 2 == 0)[None, :], cx[:, None], cy[:, None])
    int_centers = torch.where(write, val, state["int_centers"].to(dtype))
    hist_len = torch.where(confirmed, lens + 1, lens)
    oldest = torch.where(hist_len < HI, 0, hist_len % HI)
    newest = (hist_len - 1) % HI
    start_x = int_centers.gather(1, (2 * oldest).long()[:, None])[:, 0]
    end_x = int_centers.gather(1, (2 * newest).long()[:, None])[:, 0]
    half_w = k["half_width"]
    cut_drift = (end_x - half_w).abs() < (start_x - half_w).abs()

    near_miss = dist < k["near_miss_distance"]
    ped_close = (cls == _PED) & (dist < k["pedestrian_danger_distance"])
    ped_center = (cx - half_w).abs() < k["quarter_width"]
    cyc_near = (cls == _CYC) & (dist < 15.0)
    is_veh = (cls == _CAR) | (cls == _TRUCK) | (cls == _BUS)
    in_front = (cx > k["quarter_width"]) & (cx < k["three_quarter_width"])
    following = is_veh & in_front & (dist > k["following_distance_min"]) & (dist < k["following_distance_max"])
    cut_in = is_veh & (hist_len >= 10) & cut_drift & (dist < k["cut_in_distance"])
    follow_risk = torch.where(has_ttc & (ttc < k["ttc_warning"]), 2, torch.where(dist < 10.0, 1, 0))

    itype = torch.full((T,), -1, dtype=torch.int32, device=dev)
    iconf = torch.zeros((T,), dtype=dtype, device=dev)
    irisk = torch.zeros((T,), dtype=torch.int32, device=dev)
    for cond, t_val, c_val, r_val in (
        (near_miss, _NEAR_MISS, 0.9, 3),
        (ped_close & ped_center, _PED_CROSS, 0.8, torch.where(dist < 8.0, 2, 1)),
        (ped_close & ~ped_center, _PED_WAIT, 0.6, 0),
        (cyc_near, _CYC_NEAR, 0.7, torch.where(dist < 8.0, 1, 0)),
        (following, _FOLLOW, 0.75, follow_risk),
        (cut_in, _CUT_IN, 0.7, 1),
    ):
        do = cond & (itype < 0) & confirmed
        itype = torch.where(do, t_val, itype)
        iconf = torch.where(do, c_val, iconf)
        irisk = torch.where(do, r_val, irisk).to(torch.int32)
    has_int = itype >= 0

    conf_hist = ((cls[:, None] == torch.arange(8, device=dev)) & confirmed[:, None]).sum(0)
    inf = torch.tensor(math.inf, dtype=dtype, device=dev)
    min_dist = torch.where(confirmed, dist, inf).min()
    min_ttc = torch.where(confirmed & has_ttc, ttc, inf).min()
    desc_rank = torch.tensor(_RISK_DESC_STRING_RANK, device=dev)[irisk.long()]
    any_int = has_int.any()
    m1 = torch.where(has_int, desc_rank, -1).max()
    e1 = has_int & (desc_rank == m1)
    m2 = torch.where(e1, iconf, inf).min()
    e2 = e1 & (iconf == m2)
    primary_slot = torch.argmin(torch.where(e2, tid, torch.iinfo(torch.int32).max))
    primary = torch.where(any_int, itype[primary_slot], -1)
    max_risk = torch.where(has_int, irisk, 0).max()
    has_min_ttc = torch.isfinite(min_ttc)
    overall = torch.where(any_int, torch.where(has_min_ttc & (min_ttc < k["ttc_critical"]), 3, max_risk), 0)
    match = (itype[None, :] == torch.arange(NUM_INTERACTIONS, device=dev)[:, None]) & has_int[None, :]
    present = (match & (iconf > 0.5)[None, :]).any(1)
    last_slot = torch.argmax(torch.where(match, tid[None, :], -1), dim=1)
    f = {"closest_agent_distance": torch.where(torch.isfinite(min_dist), min_dist, 0.0),
         "min_ttc": torch.where(has_min_ttc, min_ttc, 0.0),
         "interaction_confidence": torch.where(match.any(1), iconf[last_slot], 0.0),
         "track_interaction_confidence": iconf, "track_distance": dist, "track_relative_speed": rel,
         "track_ttc": torch.where(has_ttc, ttc, 0.0)}
    i = {"primary_interaction": primary, "overall_risk": overall, "agent_count": confirmed.sum(),
         "pedestrian_count": conf_hist[_PED], "cyclist_count": conf_hist[_CYC],
         "vehicle_count": conf_hist[_CAR] + conf_hist[_TRUCK] + conf_hist[_BUS] + conf_hist[_MOTO],
         "has_min_ttc": has_min_ttc, "interaction_present": present, "track_interaction_type": itype,
         "track_interaction_risk": irisk, "track_has_ttc": has_ttc}
    return int_centers, hist_len, f, i


def step(k: Dict, state: Dict[str, torch.Tensor], dets: Dict, table: Dict, vrow: torch.Tensor,
         dtype=torch.float32):
    """One frame: (state', tags) with ``k`` from `constants`; ``vrow`` the
    (11,) vehicle row in ``ROW`` order.  Tags are a dict by name, the
    float tags in ``dtype``."""
    entry = vrow.to(dtype)[_ENTRY]
    speed = entry[0]
    votes, sf, si = _scene(k, state, dets, speed, dtype)
    hist, mf, mi = _maneuver(k, state, entry)
    centers, lens, itf, iti = _interaction(k, state, table, speed, dtype)
    new_state = {
        "scene_votes": votes.to(torch.int32), "scene_count": state["scene_count"] + 1,
        "man_history": hist, "man_count": state["man_count"] + 1, "int_centers": centers,
        "int_len": lens.to(torch.int32), "int_track_id": table["track_id"],
        "frame_count": state["frame_count"] + 1,
    }
    timestamp = state["frame_count"].to(dtype) * k["inv_fps"]
    return new_state, {**sf, **mf, **itf, "timestamp": timestamp, **si, **mi, **iti}
