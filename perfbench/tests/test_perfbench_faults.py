"""The check fails what it must: the program broken underneath the timed
path, and the control (the reference in the next precision down) in the
program's place.  A tiny crowd cell on the CPU, the port's plain path;
the run skips only the look for a card.  The exchange between cards has
no fault to plant: every cell runs on one card."""

from __future__ import annotations

import copy

import pytest
import torch

from perfbench import harness


def _run(bench, seed=2**31 + 3, control=False):
    return harness.run_cell("tiny.crowd", seed, 1.0, False, torch.device("cpu"), bench_path=bench, control=control)


def test_a_sound_run_is_correct(tiny_bench):
    r = _run(tiny_bench)
    assert r["correct"], r["checks"]


def _state_unchanged(monkeypatch):
    """The tracker step returns the table it was given."""
    from multimodal_autonomous_driving_perception_and_planning_torch import pipeline

    orig = pipeline.tracker_update_with_order

    def broken(table, dets, cfg, min_hits=None):
        _, match, order, n = orig(table, dets, cfg, min_hits)
        return table, match, order, n

    monkeypatch.setattr(pipeline, "tracker_update_with_order", broken)


def _state_handed_back(monkeypatch):
    """The runner returns the state it was given: each segment's outputs
    are sound, but the drive never moves on."""
    from multimodal_autonomous_driving_perception_and_planning_torch.perception import detector

    orig = detector.make_yolo_sequence_runner

    def make(*args, **kw):
        init, run = orig(*args, **kw)

        def broken(params, state, frames, ego, **opts):
            before = copy.deepcopy(state)
            _, outs = run(params, state, frames, ego, **opts)
            return before, outs

        return init, broken

    monkeypatch.setattr(detector, "make_yolo_sequence_runner", make)


def _half_batch(monkeypatch):
    """The tower sees half of each segment's frames and its answers stand
    for the other half."""
    from multimodal_autonomous_driving_perception_and_planning_torch.perception import detector

    orig = detector._detect_chunks

    def broken(detect_fn, params, frames, batch, dev, keep):
        frames = torch.as_tensor(frames).clone()
        half = frames.shape[0] // 2
        frames[half:] = frames[:half]
        return orig(detect_fn, params, frames, batch, dev, keep)

    monkeypatch.setattr(detector, "_detect_chunks", broken)


def _detection_altered(monkeypatch):
    """One coordinate of each frame's first detection moved by a pixel
    where the tables are made."""
    from multimodal_autonomous_driving_perception_and_planning_torch.models import yolov8

    orig = yolov8.tables_from_candidates

    def broken(*args, **kw):
        out = orig(*args, **kw)
        out["bbox"] = out["bbox"].clone()
        out["bbox"][:, 0, 0] += 1.0
        return out

    monkeypatch.setattr(yolov8, "tables_from_candidates", broken)


def _tag_altered(monkeypatch):
    """The road type, the first int tag, one more where the tagging step
    produces it."""
    from multimodal_autonomous_driving_perception_and_planning_torch import pipeline

    orig = pipeline.make_packed_tagging_step

    def make(cfg):
        step = orig(cfg)

        def broken(*args):
            state, tag_f, tag_i = step(*args)
            return state, tag_f, tag_i + (torch.arange(tag_i.shape[-1]) == 0).to(tag_i.dtype)

        return broken

    monkeypatch.setattr(pipeline, "make_packed_tagging_step", make)


@pytest.mark.parametrize("fault", [_state_unchanged, _state_handed_back, _half_batch, _detection_altered,
                                   _tag_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(tiny_bench)
    assert not r["correct"], r["checks"]


def test_the_control_fails_the_limits(tiny_bench):
    """The control's numbers against the cell's limits (yolov8m.crowd's):
    at least one over its limit."""
    r = _run(tiny_bench, control=True)
    over = {k: v for k, v in r["control"].items() if v > r["checks"][k]["limit"]}
    assert over, (r["control"], r["checks"])
