"""The port's utilities against the JAX package's (tests/test_utils.py's
frame-timer, nan-debug, validate and metrics cases): the same console
lines, the same JSONL records, the same leaf paths named for non-finite
values, and a NaN caught at the aten op that produced it (the port's
counterpart of ``jax_debug_nans``)."""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
from multimodal_autonomous_driving_perception_and_planning_torch import utils as ut
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn_t
from multimodal_autonomous_driving_perception_and_planning_torch.host import extract_frame
from multimodal_autonomous_driving_perception_and_planning_torch.utils.sanitizer import ENV_VALIDATE
from multimodal_autonomous_driving_perception_and_planning_tpu import utils as uj
from multimodal_autonomous_driving_perception_and_planning_tpu.utils.sanitizer import ENV_VALIDATE as ENV_VALIDATE_J


def test_utils_exports_match_jax():
    assert sorted(ut.__all__) == sorted(uj.__all__)
    assert ENV_VALIDATE == ENV_VALIDATE_J


def test_frame_timer_contract():
    t = ut.FrameTimer(report_every=5)
    for i in range(10):
        with t:
            time.sleep(0.001)
        line = t.maybe_report(i, 10, extra="Tracks: 3")
        if i + 1 in (5, 10):
            assert line is not None and line.startswith(f"Frame {i+1}/10 | FPS:")
            assert "Tracks: 3" in line
        else:
            assert line is None
    assert t.fps > 0
    assert "Processed 10 frames" in t.summary()


def test_nan_debug_trips_on_injected_nan():
    """Inside the scope the op that makes a NaN raises FloatingPointError
    naming it; outside, the same computation passes silently."""

    def bad(x):
        return torch.log(x) * 2.0  # log(-1) -> NaN

    x = torch.tensor(-1.0)
    with ut.nan_debug():
        assert float(torch.log(torch.tensor(2.0))) > 0  # clean ops pass
        with pytest.raises(FloatingPointError, match="aten.log"):
            bad(x)
    assert torch.isnan(bad(x))
    with ut.nan_debug(enable=False):
        assert torch.isnan(bad(x))


def test_validate_outputs_names_bad_leaf(monkeypatch):
    """The port's tree of dicts, tensors and the port's dataclasses; the
    leaf named as the JAX version names it on the same dict tree."""
    clean = {"a": torch.ones(3), "b": {"c": torch.zeros(2, 2)}}
    ut.validate_outputs(clean)  # no raise
    dirty = {"a": torch.ones(3), "b": {"c": torch.tensor([[1.0, np.nan], [np.inf, 0.0]])}}
    with pytest.raises(ValueError, match=r"\['b'\]\['c'\]: 2/4 non-finite") as got:
        ut.validate_outputs(dirty, name="scan outputs")
    with pytest.raises(ValueError) as want:
        uj.validate_outputs({"a": jnp.ones(3), "b": {"c": jnp.asarray(dirty["b"]["c"].numpy())}}, name="scan outputs")
    assert str(got.value) == str(want.value)

    vs = pt.types.VehicleState(*(torch.zeros(()) for _ in pt.types.VEHICLE_STATE_FIELDS))
    vs = pt.types.VehicleState(**{**vs.__dict__, "speed": torch.tensor(float("nan"))})
    with pytest.raises(ValueError, match=r"\['vehicle_state'\]\.speed: 1/1"):
        ut.validate_outputs({"vehicle_state": vs, "ids": torch.zeros(3, dtype=torch.int32), "rows": [np.ones(2)]})

    monkeypatch.setenv(ENV_VALIDATE, "0")
    ut.validate_if_enabled(dirty)  # gated off: no raise
    monkeypatch.setenv(ENV_VALIDATE, "1")
    with pytest.raises(ValueError):
        ut.validate_if_enabled(dirty)


def test_metrics_logger_jsonl(tmp_path):
    """The JSONL lines, and a FrameResult's standard metrics as the JAX
    logger writes them for the same record."""
    path = tmp_path / "m.jsonl"
    log = ut.MetricsLogger(str(path))
    log.log_frame(0, num_tracks=3, speed_kmh=36.0)
    log.log_frame(1, num_tracks=4, speed_kmh=37.0)
    log.close()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows[0]["frame"] == 0 and rows[1]["num_tracks"] == 4

    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    dets = syn_t.simulated_detection_stream(5)
    ego = syn_t.ego_motion_stream(5, seed=0).astype(np.float32)
    _, outs = pt.make_sequence_runner(cfg, device="cpu")(pt.initial_state(cfg, device="cpu"),
                                                          dict(dets, ego_measurement=ego))
    res = extract_frame(outs, dets, 4)
    got, want = ut.MetricsLogger(), uj.MetricsLogger()
    assert got.log_frame_result(res) == want.log_frame_result(res)
    assert got.records[0]["num_detections"] == len(res.detections)


def test_device_trace_writes_a_trace(tmp_path):
    """`device_trace` leaves a Chrome trace of the scope's ops."""
    with ut.device_trace(str(tmp_path)) as prof:
        torch.ones(8).add_(1).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert any("add_" in e.get("name", "") for e in trace["traceEvents"])
    assert any("add_" in e.key for e in prof.key_averages())
