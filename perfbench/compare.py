"""The check that decides ``correct``: the plain reference against what the
timed path produced on the segments sampled from the seed.

Each sampled segment carries the frames and ego measurements handed over,
the program's state when it was handed over, the head logits of its tower
pass and the outputs that came back.  Every layer is judged by itself:

* the tower: the reference detector on the same frames and weights;
* decode and NMS: the reference on the program's head logits (greedy NMS
  is discontinuous, so it is judged on its own input; the tower's gap is
  judged above);
* tracker, tagging: the reference from the program's state at the
  segment's start, on the program's detection tables; tagging on the
  program's vehicle rows;
* the ego estimator: the reference (float64) from the program's filter
  state at the segment's start, on the same measurements;
* the planner: the reference (float64) from each frame's vehicle row;
* the state handed on to the next segment: the tracker table, the filter
  and the tagging state that ``run`` returns, against the reference's at
  the segment's end (the lane state is off this path).

Besides, the drive's first segment, from the initial state, is followed
from end to end: the reference fed its own tables and vehicle rows
(`chain_numbers`).  A sound bf16 tower parts from that chain at the first
near-tie, so its reading is reported and not held to a limit.

The control is the same reference in the next precision down: the tower in
fp8, decode, tracker and tagging in bfloat16, the estimator and planner in
bfloat16.  Its numbers are read by the same comparison.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .reference import ego, nms, planner, tagging, tracker, yolov8
from .reference.geometry import pairwise_iou

REFERENCE = {"tower": "float32", "decode": torch.float32, "stack": torch.float32, "filter": torch.float64}
CONTROL = {"tower": "fp8", "decode": torch.bfloat16, "stack": torch.bfloat16, "filter": torch.bfloat16}
NUMBERS = ("tower_gap", "nms_mismatch", "track_mismatch", "ego_gap", "plan_gap", "tag_gap")
TRACK_FIELDS = {
    "track_id": "track_id", "track_bbox": "bbox", "track_class_id": "class_id",
    "track_confidence": "confidence", "track_hits": "hits", "track_misses": "misses", "track_age": "age",
    "track_velocity": "velocity", "track_vel_count": "vel_count",
}
TABLE_FIELDS = ("bbox", "class_id", "confidence", "valid")


def letterbox_geometry(height: int, width: int, size: int):
    scale = min(size / height, size / width)
    nh, nw = int(round(height * scale)), int(round(width * scale))
    return scale, ((size - nw) // 2, (size - nh) // 2)


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest gap over the reference's largest magnitude (at least 1);
    infinite where either side is not finite."""
    got, want = got.double(), want.double()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        return math.inf
    if want.numel() == 0:
        return 0.0
    return float((got - want).abs().max() / want.abs().max().clamp_min(1.0))


def _elem_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest gap of an entry over that entry's reference magnitude (at
    least 1); infinite where either side is not finite."""
    got, want = got.double(), want.double()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        return math.inf
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def _mismatch(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.to(want.dtype) != want).sum())


class Reference:
    """The reference of one cell: its detector built once, the stack's
    settings from the configuration and traffic."""

    def __init__(self, config: Dict, traffic: Dict, pipeline: Dict, weights: Dict[str, torch.Tensor],
                 precision: Dict):
        self.config, self.traffic, self.pipeline, self.precision = config, traffic, pipeline, precision
        self.detector = yolov8.build(config, weights, precision["tower"])
        self.geometry = letterbox_geometry(traffic["frame_height"], traffic["frame_width"], config["img_size"])
        self.tag_constants = tagging.constants(pipeline)

    def outputs(self, cap: Dict, own: bool = False) -> Dict:
        """The reference's outputs on one sampled segment, following the
        program's inputs as the module docstring says; with ``own``, fed
        its own head logits, tables and vehicle rows from the frames on."""
        dev = cap["heads"][0][0].device
        frames = cap["frames"].to(dev)
        out = {"heads": yolov8.head_outputs(self.detector, frames, self.config["img_size"])}
        heads = out["heads"] if own else cap["heads"]
        out["tables"] = nms.tables(heads, self.traffic, *self.geometry, dtype=self.precision["decode"])
        prog = cap["outs"]
        detections = out["tables"] if own else prog["detections"]
        F = frames.shape[0]
        rows = None if own else program_rows(prog)
        table = {k: v.clone() for k, v in cap["state"]["tracks"].items()}
        tags_state = {k: v.clone() for k, v in cap["state"]["tagging"].items()}
        ks = dict(cap["state"]["kalman"])
        trk_cfg = self.pipeline["tracker"]
        tracks, ego_rows, plans, tags = [], [], [], []
        dtype = self.precision["stack"]
        for f in range(F):
            dets = {k: detections[k][f] for k in TABLE_FIELDS}
            table, match, order, n = tracker.step(table, dets, trk_cfg, dtype)
            tracks.append((table, match, order, n))
            ks, row = ego.step(ks, cap["ego"][f].to(dev), self.pipeline["estimator"], self.precision["filter"])
            ego_rows.append(row)
            vrow = row if own else rows[f]
            start = vrow[[0, 1, 4, 5]]  # x, y, heading, speed
            plans.append(planner.plan(start, self.pipeline["planner"], self.precision["filter"]))
            tags_state, t = tagging.step(self.tag_constants, tags_state, dets, table, vrow, dtype)
            tags.append(t)
        out.update(tracks=tracks, ego=torch.stack(ego_rows), plans=plans, tags=tags,
                   final={"tracks": table, "kalman": ks, "tagging": tags_state})
        return out


def program_rows(prog: Dict) -> torch.Tensor:
    """The program's vehicle rows, (F, 11) in the reference's field order."""
    vs = prog["vehicle_state"]
    return torch.stack([getattr(vs, name) for name in ego.ROW_FIELDS], dim=-1).float()


def program_outputs(cap: Dict) -> Dict:
    """What the timed path produced on one sampled segment, in the
    reference's layout."""
    prog = cap["outs"]
    F = prog["track_id"].shape[0]
    tracks = []
    for f in range(F):
        table = {name: prog[key][f] for key, name in TRACK_FIELDS.items()}
        tracks.append((table, prog["match"][f], prog["confirmed_order"][f], prog["num_confirmed"][f]))
    tags = [{k: v[f] for k, v in prog["tags"].items()} for f in range(F)]
    plans = [{"costs": prog["plan_costs"][f], "best": prog["plan_best"][f],
              "best_positions": prog["plan_best_positions"][f], "best_velocities": prog["plan_best_velocities"][f]}
             for f in range(F)]
    final = {k: cap["final"][k] for k in ("tracks", "kalman", "tagging")}
    return {"heads": cap["heads"], "tables": {k: prog["detections"][k] for k in TABLE_FIELDS},
            "tracks": tracks, "ego": program_rows(prog), "plans": plans, "tags": tags, "final": final}


def _tag_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], floats) -> float:
    """The largest relative gap of the float entries named in ``floats``;
    1 where any other entry differs."""
    gap = 0.0
    for name, w in want.items():
        if name in floats:
            gap = max(gap, _rel_gap(got[name], w))
        elif _mismatch(got[name], w.to(torch.int64) if w.dtype != torch.bool else w):
            gap = max(gap, 1.0)
    return gap


def state_numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """The state handed on at a segment's end, against the reference's:
    the tracker table's entries that differ, the filter's largest gap of
    an entry, and the tagging state's largest gap (an int entry that
    differs counts 1)."""
    wt, wk, wg = want["tracks"], want["kalman"], want["tagging"]
    return {
        "track_mismatch": sum(_mismatch(got["tracks"][k], w) for k, w in wt.items()),
        "ego_gap": max(_elem_gap(got["kalman"][k], w) for k, w in wk.items()),
        "tag_gap": _tag_gap(got["tagging"], wg, {k for k, w in wg.items() if w.is_floating_point()}),
    }


def numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """The numbers compared for one segment: ``got`` is the program's (or
    the control's) outputs, ``want`` the reference's."""
    tower = max(float((g.double() - w.double()).abs().max() / w.double().abs().max())
                for gs, ws in zip(got["heads"], want["heads"]) for g, w in zip(gs, ws))
    nms_bad = sum(_mismatch(got["tables"][k], want["tables"][k]) for k in TABLE_FIELDS)

    track_bad = 0
    for (gt, gm, go, gn), (wt, wm, wo, wn) in zip(got["tracks"], want["tracks"]):
        track_bad += sum(_mismatch(gt[name], wt[name]) for name in TRACK_FIELDS.values())
        track_bad += _mismatch(gm, wm) + _mismatch(go, wo) + _mismatch(gn, wn)

    plan_gap = 0.0
    for gp, wp in zip(got["plans"], want["plans"]):
        best = int(gp["best"])
        costs = wp["costs"].double()
        regret = float((costs[best] - costs[int(wp["best"])]) / costs.abs().max().clamp_min(1.0))
        plan_gap = max(plan_gap, regret, _rel_gap(gp["costs"], wp["costs"]),
                       _rel_gap(gp["best_positions"], wp["positions"][best]),
                       _rel_gap(gp["best_velocities"], wp["velocities"][best]))

    # An int or bool tag that differs counts as a gap of 1: in drive
    # traffic the control moves the float tags but may leave every discrete
    # one as it was, so only the two together separate it from the program.
    tag_gap = max(_tag_gap(gt, wt, tagging.FLOAT_TAGS) for gt, wt in zip(got["tags"], want["tags"]))

    ego_gap = max(_rel_gap(got["ego"][:, i], want["ego"][:, i]) for i in range(want["ego"].shape[1]))
    state = state_numbers(got["final"], want["final"])
    return {"tower_gap": tower, "nms_mismatch": nms_bad, "track_mismatch": track_bad + state["track_mismatch"],
            "ego_gap": max(ego_gap, state["ego_gap"]), "plan_gap": plan_gap, "tag_gap": max(tag_gap, state["tag_gap"])}


TRACK_INTS = ("track_id", "class_id", "hits", "misses", "age", "vel_count")


def chain_numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """The program's outputs against the reference's own chain from the
    frames: ``chain_frames``, the frames from the first on which every
    discrete output agrees (which detections are valid and their classes,
    track ids and counters, the match, the confirmed order and count, the
    chosen plan, the int and bool tags), and ``chain_gap``, the largest
    relative gap of the continuous outputs on those frames (valid
    detections' boxes and confidences, tracks' boxes, confidences and
    velocities, float tags, vehicle rows, plan costs); and over the whole
    segment ``chain_detections``, the share of the reference's detections
    that the program's tables hold, of the same class at an IoU of 0.9 or
    more (1 where the reference has none)."""
    frames, gap = 0, 0.0
    gtab, wtab = got["tables"], want["tables"]
    held, total = 0, 0
    for f in range(wtab["valid"].shape[0]):
        gv, wv = gtab["valid"][f], wtab["valid"][f]
        iou = pairwise_iou(wtab["bbox"][f][wv].double(), gtab["bbox"][f][gv].double())
        same = wtab["class_id"][f][wv][:, None] == gtab["class_id"][f][gv][None, :]
        held += int((torch.where(same, iou, 0.0) >= 0.9).any(dim=1).sum())
        total += int(wv.sum())
    for f, ((gt, gm, go, gn), (wt, wm, wo, wn)) in enumerate(zip(got["tracks"], want["tracks"])):
        valid = wtab["valid"][f]
        same = (torch.equal(gtab["valid"][f], valid)
                and not _mismatch(gtab["class_id"][f][valid], wtab["class_id"][f][valid])
                and not any(_mismatch(gt[k], wt[k]) for k in TRACK_INTS)
                and not (_mismatch(gm, wm) or _mismatch(go, wo) or _mismatch(gn, wn))
                and int(got["plans"][f]["best"]) == int(want["plans"][f]["best"])
                and _tag_gap(got["tags"][f], want["tags"][f], tagging.FLOAT_TAGS) < 1.0)
        if not same:
            break
        frames += 1
        gap = max(gap, _rel_gap(gtab["bbox"][f][valid], wtab["bbox"][f][valid]),
                  _rel_gap(gtab["confidence"][f][valid], wtab["confidence"][f][valid]),
                  *(_rel_gap(gt[k], wt[k]) for k in ("bbox", "confidence", "velocity")),
                  _tag_gap(got["tags"][f], want["tags"][f], tagging.FLOAT_TAGS),
                  _elem_gap(got["ego"][f], want["ego"][f]),
                  _rel_gap(got["plans"][f]["costs"], want["plans"][f]["costs"]))
    return {"chain_frames": frames, "chain_gap": gap, "chain_detections": held / total if total else 1.0}


def worst(per_segment: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst over the segments: the largest gap, the sum of
    mismatches."""
    out = {}
    for name in NUMBERS:
        values = [n[name] for n in per_segment]
        out[name] = sum(values) if name.endswith("mismatch") else max(values)
    return out


def judge(captures: List[Dict], config: Dict, traffic: Dict, pipeline: Dict, weights, control: bool = False):
    """The worst numbers over the sampled segments: the program's against
    the reference, with ``control`` also the control's against it, and the
    chain's reading on the drive's first segment (None where it was not
    captured)."""
    ref = Reference(config, traffic, pipeline, weights, REFERENCE)
    ctl = Reference(config, traffic, pipeline, weights, CONTROL) if control else None
    got, ctl_got, chain = [], [], None
    for cap in captures:
        want = ref.outputs(cap)
        got.append(numbers(program_outputs(cap), want))
        if cap["index"] == 0:
            chain = chain_numbers(program_outputs(cap), ref.outputs(cap, own=True))
        if ctl is not None:
            c = ctl.outputs(cap)
            c["plans"] = [dict(p, best_positions=p["positions"][int(p["best"])],
                               best_velocities=p["velocities"][int(p["best"])]) for p in c["plans"]]
            ctl_got.append(numbers(c, want))
    return worst(got), (worst(ctl_got) if control else None), chain
