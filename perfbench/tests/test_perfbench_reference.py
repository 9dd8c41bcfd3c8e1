"""The plain reference against the port on the CPU at small sizes, stage
by stage, and what it may import."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import compare, harness
from perfbench.reference import tracker, yolov8
from perfbench.tests.conftest import PERFBENCH, ROOT, tiny_config, tiny_traffic
from perfbench.traffic import road

PORT = "multimodal_autonomous_driving_perception_and_planning_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "multimodal_autonomous_driving_perception_and_planning_tpu"}


def _weights_and_frames(seed, n=6):
    cfg = tiny_config()
    frames = torch.from_numpy(road.road_frames(seed, n, 96, 128))
    return cfg, harness.make_weights(cfg, seed, torch.device("cpu"), frames[:4]), frames


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_detector_matches_the_port_in_float32(seed):
    from multimodal_autonomous_driving_perception_and_planning_torch.models import yolov8 as port

    cfg, w, frames = _weights_and_frames(seed)
    want = yolov8.head_outputs(yolov8.build(cfg, w), frames, 128)
    model = port.YOLOv8(variant="n", dtype=torch.float32)
    model.load_state_dict(w)
    x, _, _ = port.preprocess(frames, 128)
    with torch.no_grad():
        got = model(x)
    for gs, ws in zip(got, want):
        for g, r in zip(gs, ws):
            assert float((g - r).abs().max() / r.abs().max()) <= 1e-6


@pytest.mark.parametrize("base", ["drive", "crowd"])
def test_tables_match_the_port_bit_for_bit(base):
    """Decode, NMS, taxonomy and frame coordinates on the port's bf16
    head logits: the reference equals the port's plain path exactly."""
    from multimodal_autonomous_driving_perception_and_planning_torch.models import yolov8 as port

    cfg, w, frames = _weights_and_frames(11)
    traffic = tiny_traffic(base)
    _, detect = port.make_yolo_detector(variant="n", img_size=128, max_det=traffic["max_detections"],
                                        score_threshold=traffic["score_threshold"],
                                        iou_threshold=traffic["iou_threshold"], pre_topk=traffic["pre_topk"],
                                        device="cpu")
    heads = []
    hook = detect.model.register_forward_hook(lambda m, a, out: heads.append(out))
    got = detect(w, frames)
    hook.remove()
    want = __import__("perfbench.reference.nms", fromlist=["tables"]).tables(
        heads[0], traffic, *compare.letterbox_geometry(96, 128, 128))
    assert base == "drive" or int(got["valid"].sum()) > 0
    for k in compare.TABLE_FIELDS:
        assert torch.equal(got[k], want[k]), k


def _random_dets(rng, d, p_valid=0.7):
    xy = rng.uniform(0, 400, (d, 2))
    wh = rng.uniform(10, 120, (d, 2))
    return {"bbox": torch.tensor(np.concatenate([xy, xy + wh], 1), dtype=torch.float32),
            "class_id": torch.tensor(rng.integers(0, 8, d), dtype=torch.int32),
            "confidence": torch.tensor(rng.uniform(0.1, 1, d), dtype=torch.float32),
            "valid": torch.tensor(rng.uniform(0, 1, d) < p_valid)}


def test_tracker_matches_the_ports_plain_tracker():
    """Births, matches, misses and deaths over 80 frames of boxes that
    drift and overlap: every field equal to the port's plain tracker."""
    from multimodal_autonomous_driving_perception_and_planning_torch.config import TrackerConfig
    from multimodal_autonomous_driving_perception_and_planning_torch.tracking.tracker import (
        tracker_update_with_order,
    )
    from multimodal_autonomous_driving_perception_and_planning_torch.types import Detections, TrackTable

    cfg = TrackerConfig(max_tracks=24, max_age=5)
    rng = np.random.default_rng(0)
    port_table = TrackTable.empty(24, cfg.trajectory_length, "cpu")
    ref_table = {f: getattr(port_table, f).clone() for f in tracker.FLOAT_FIELDS + (
        "track_id", "class_id", "age", "hits", "misses", "traj_len", "vel_count", "next_id")}
    base = _random_dets(rng, 20)
    for _ in range(80):
        dets = dict(base, bbox=base["bbox"] + torch.tensor(rng.normal(0, 4, (20, 4)), dtype=torch.float32),
                    valid=torch.tensor(rng.uniform(0, 1, 20) < 0.7))
        port_table, match, order, n = tracker_update_with_order(port_table, Detections(**dets), cfg)
        ref_table, rmatch, rorder, rn = tracker.step(ref_table, dets, {"iou_threshold": cfg.iou_threshold,
                                                                      "max_age": cfg.max_age,
                                                                      "min_hits": cfg.min_hits})
        for f, v in ref_table.items():
            assert torch.equal(getattr(port_table, f), v), f
        assert torch.equal(match, rmatch) and torch.equal(order, rorder) and torch.equal(n, rn)


def test_segments_match_the_port_stage_by_stage(tiny_bench):
    """The harness's check on the port's plain CPU path, over four
    segments of a tiny crowd cell: no mismatch, and the float gaps at
    rounding (the estimator and planner references are float64)."""
    cell, config, traffic, limits, _, _ = harness.load_cell("tiny.crowd", tiny_bench)
    drive = harness.Drive(config, traffic, 2**31 + 7, torch.device("cpu"))
    caps = [drive.segment(capture=True)[1] for _ in range(4)]
    assert sum(int(c["outs"]["detections"]["valid"].sum()) for c in caps) > 0
    assert sum(int((c["outs"]["track_id"] > 0).sum()) for c in caps) > 0
    got, _, chain = compare.judge(caps, config, traffic, __import__("dataclasses").asdict(drive.cfg), drive.weights)
    assert got["nms_mismatch"] == got["track_mismatch"] == 0
    assert got["ego_gap"] < 1e-4 and got["plan_gap"] < 1e-5 and got["tag_gap"] < 1e-5
    assert 0 < got["tower_gap"] < limits["tower_gap"]
    assert chain is not None and 0 <= chain["chain_frames"] <= traffic["segment_frames"]


@pytest.mark.parametrize("base", ["drive", "crowd"])
def test_a_float32_program_follows_the_reference_chain(tiny_bench, base):
    """With the tower in float32 the program and the reference's own chain
    from the frames agree on every frame of the drive's first segment, at
    rounding; the state handed on matches too."""
    cell, config, traffic, limits, _, _ = harness.load_cell("tiny.crowd", tiny_bench)
    config = dict(config, compute_dtype="float32")
    traffic = tiny_traffic(base)
    drive = harness.Drive(config, traffic, 2**31 + 9, torch.device("cpu"))
    cap = drive.segment(capture=True)[1]
    assert int(cap["outs"]["detections"]["valid"].sum()) > 0
    ref = compare.Reference(config, traffic, __import__("dataclasses").asdict(drive.cfg), drive.weights,
                            compare.REFERENCE)
    prog = compare.program_outputs(cap)
    chain = compare.chain_numbers(prog, ref.outputs(cap, own=True))
    assert chain["chain_frames"] == traffic["segment_frames"] and chain["chain_gap"] < 1e-4, chain
    state = compare.state_numbers(prog["final"], ref.outputs(cap)["final"])
    assert state["track_mismatch"] == 0 and state["ego_gap"] < 1e-4 and state["tag_gap"] < 1e-5, state


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    names = {n.split(".")[0] for p in (PERFBENCH / "reference").glob("*.py") for n in _imports(p)}
    assert names <= {"__future__", "contextlib", "math", "typing", "numpy", "torch"}, names
    code = ("import sys; sys.path.insert(0, %r); import perfbench.reference.yolov8, perfbench.reference.nms, "
            "perfbench.reference.tracker, perfbench.reference.ego, perfbench.reference.planner, "
            "perfbench.reference.tagging; print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    loaded = json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                       check=True).stdout.replace("'", '"'))
    assert PORT not in loaded and not FORBIDDEN & set(loaded)


def test_a_run_imports_no_jax(tiny_bench):
    """Everything a run imports, in a fresh process: run.py, the harness,
    the port's runner, the check, the tracing and the metric readers (the
    card's trace itself needs a card)."""
    code = f"""
import sys, torch
sys.path.insert(0, {str(ROOT)!r})
torch.set_num_threads(2)
import importlib, json
import perfbench.run, perfbench.trace, perfbench.readings
from pathlib import Path
from perfbench import harness
for m in json.loads(Path({str(tiny_bench)!r}).read_text())["per_layer"]:
    importlib.import_module("perfbench.metrics." + m["name"])
r = harness.run_cell("tiny.crowd", 5, 0.5, False, torch.device("cpu"), bench_path=Path({str(tiny_bench)!r}))
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert PORT in loaded
    assert not FORBIDDEN & loaded, FORBIDDEN & loaded
