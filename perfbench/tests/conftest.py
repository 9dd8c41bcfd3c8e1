"""Fixtures of the benchmark's CPU tests: a cell cut to a size the CPU
runs in seconds (the YOLOv8 graph at scale n and 128 pixels, 4-frame
segments of 96x128 road frames), written beside its own BENCHMARK.json."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def tiny_config() -> dict:
    cfg = json.loads((PERFBENCH / "configs" / "yolov8m.json").read_text())
    cfg.update(name="tiny", variant="n", depth_multiple=0.33, width_multiple=0.25, max_channels=1024, img_size=128)
    # Class logits higher than the cells', so that a 128-pixel frame gives
    # the stack a few detections to track.
    cfg["calibration"] = dict(cfg["calibration"], class_logit_mean=-3.0)
    return cfg


def tiny_traffic(base: str = "crowd") -> dict:
    t = json.loads((PERFBENCH / "traffic" / f"{base}.json").read_text())
    t.update(segment_frames=4, pool_frames=16, frame_height=96, frame_width=128, pre_topk=336, max_detections=64,
             max_tracks=16, warmup_segments=2, sampled_segments=2, traced_segments=2, max_frames=4096)
    return t


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny_bench(tmp_path) -> Path:
    """A BENCHMARK.json with one tiny cell, ``tiny.crowd``, whose limits
    are yolov8m.crowd's; returns its path."""
    for sub in ("configs", "traffic", "limits"):
        (tmp_path / "perfbench" / sub).mkdir(parents=True)
    (tmp_path / "perfbench" / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (tmp_path / "perfbench" / "traffic" / "crowd.json").write_text(json.dumps(tiny_traffic()))
    limits = (PERFBENCH / "limits" / "yolov8m.crowd.json").read_text()
    (tmp_path / "perfbench" / "limits" / "tiny.crowd.json").write_text(limits)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "file": "perfbench/configs/tiny.json"}]
    bench["workloads"] = [{"name": "tiny.crowd", "config": "tiny", "traffic": "crowd", "chips": 1}]
    for m in bench["per_layer"]:
        m["workloads"] = ["tiny.crowd"]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path
