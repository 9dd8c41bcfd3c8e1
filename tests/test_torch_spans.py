"""The span recorder (utils/profiler.py) and the spans of the segment path:
off by default, outputs the same with it on, the tree of one run, its
counts, the buffer's bound, self times, and the spans in `device_trace`'s
Chrome trace on the trace's clock."""

import json
import threading

import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn
from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import SyntheticRoadGenerator
from multimodal_autonomous_driving_perception_and_planning_torch.perception.detector import (
    make_yolo_sequence_runner,
)
from multimodal_autonomous_driving_perception_and_planning_torch.types import stack_lanes, tree_leaves
from multimodal_autonomous_driving_perception_and_planning_torch.utils import profiler
from multimodal_autonomous_driving_perception_and_planning_torch.utils.profiler import SPANS, Span, SpanRecorder

T, BATCH, IMG = 6, 4, 64  # two chunks, the second padded with two zero frames
STEP_CHILDREN = ["track", "estimate", "plan", "tag", "write"]


@pytest.fixture(autouse=True)
def _recorder_off():
    SPANS.enable(False)
    SPANS.clear()
    yield
    SPANS.enable(False)
    SPANS.clear()


def _yolo_run(use_frames: bool):
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=use_frames, enable_tagging=True, emit_candidates=False,
                                    emit_trajectories=False)
    frames = SyntheticRoadGenerator().generate_frames(T)
    ego = syn.ego_motion_stream(T, seed=0).astype(np.float32)
    init_fn, run = make_yolo_sequence_runner(cfg, batch=BATCH, score_threshold=0.05, img_size=IMG, device="cpu")
    params = init_fn(torch.Generator().manual_seed(0))
    return lambda: run(params, pt.initial_state(cfg, device="cpu"), frames, ego, keep_candidates=True), frames


def _batched_run():
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    streams = [dict(syn.simulated_detection_stream(5, start_frame_count=1 + 7 * b),
                    ego_measurement=syn.ego_motion_stream(5, seed=b).astype(np.float32)) for b in range(2)]
    run = pt.make_batched_sequence_runner(cfg, device="cpu")
    inputs = {k: np.stack([s[k] for s in streams]) for k in streams[0]}
    return lambda: run(stack_lanes([pt.initial_state(cfg, device="cpu")] * 2), inputs)


def _leaves(result):
    """The final state's tensors and the outputs', by path (the NMS
    candidates' letterbox scale and pads as they are)."""
    state, outs = result
    return [("state", v) for v in tree_leaves(state)] + sorted(_flat(outs), key=lambda kv: kv[0])


def _flat(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(obj, (torch.Tensor, float, tuple)):
        yield prefix, obj
    else:
        for i, v in enumerate(tree_leaves(obj)):
            yield f"{prefix}{i}", v


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def test_the_recorder_is_off_by_default_and_records_nothing():
    assert not SPANS.enabled and SPANS.active() is None
    run, _ = _yolo_run(use_frames=False)
    run()
    spans, dropped, clock = SPANS.drain()
    assert spans == [] and dropped == 0 and clock is None


@pytest.mark.parametrize("case", ["yolo", "batched"])
def test_outputs_are_the_same_with_the_recorder_on(case):
    run = _yolo_run(use_frames=False)[0] if case == "yolo" else _batched_run()
    off = _leaves(run())
    SPANS.enable()
    on = _leaves(run())
    spans, _, _ = SPANS.drain()
    assert spans and spans[0].name == ("segment" if case == "yolo" else "frames")
    assert [k for k, _ in on] == [k for k, _ in off]
    for (k, a), (_, b) in zip(on, off):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        else:
            assert a == b, k


@pytest.fixture(scope="module")
def yolo_spans():
    """One recorded run of the YOLO runner with lanes: its spans and
    frames."""
    run, frames = _yolo_run(use_frames=True)
    SPANS.enable()
    try:
        run()
        spans, dropped, clock = SPANS.drain()
    finally:
        SPANS.enable(False)
    assert dropped == 0 and clock is not None
    return spans, frames


def test_one_run_has_the_segment_tree(yolo_spans):
    spans, _ = yolo_spans
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["segment"]
    seg = roots[0]
    assert _children(spans, seg) == ["detect"] * -(-T // BATCH) + ["frames"]
    for i, s in enumerate(spans):
        if s.name == "detect":
            assert _children(spans, i) == ["h2d", "tower", "decode", "nms"]
    frames = next(i for i, s in enumerate(spans) if s.name == "frames")
    assert _children(spans, frames) == ["inputs"] + ["step"] * T + ["unpack"]
    steps = [i for i, s in enumerate(spans) if s.name == "step"]
    assert [spans[i].counts["frame"] for i in steps] == list(range(T))
    for i in steps:
        assert _children(spans, i) == ["lanes"] + STEP_CHILDREN


def test_children_lie_within_their_parents_under_one_request(yolo_spans):
    spans, _ = yolo_spans
    assert len({s.request for s in spans}) == 1
    assert len({s.thread for s in spans}) == 1
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_the_spans_count_frames_padding_and_bytes(yolo_spans):
    spans, frames = yolo_spans
    seg = spans[0]
    assert seg.counts["frames"] == T and seg.counts["chunks"] == 2
    # The CPU runs no kernel: the launch counters do not move.
    counters = ("k1_launches", "k2_launches", "k3_launches", "k5_launches", "k6_launches")
    assert {k: seg.counts[k] for k in counters} == dict.fromkeys(counters, 0)
    detects = [s for s in spans if s.name == "detect"]
    assert [(d.counts["frames"], d.counts["padded"]) for d in detects] == [(4, 0), (2, 2)]
    h2d = [s for s in spans if s.name == "h2d"]
    # On the CPU the chunk stays where it is: nothing is copied.
    assert [h.counts["bytes"] for h in h2d] == [0, 0]
    assert all(s.counts["pool"] == min(256, sum((IMG // k) ** 2 for k in (8, 16, 32)))
               for s in spans if s.name == "nms")
    f = next(s for s in spans if s.name == "frames")
    assert f.counts == {"frames": T, "lanes": 1}


def test_h2d_counts_the_bytes_a_copy_moves(monkeypatch):
    """A chunk that moves to another device counts its bytes and whether
    its source is pinned (the CPU build has no pinned memory)."""
    from multimodal_autonomous_driving_perception_and_planning_torch.perception import detector

    frames = torch.arange(6 * 8 * 8 * 3, dtype=torch.uint8).reshape(6, 8, 8, 3)
    seen = []

    def detect_fn(params, chunk, return_candidates=False):
        seen.append(chunk.shape[0])
        return {k: torch.zeros(chunk.shape[0], 2) for k in detector.TABLE_KEYS}

    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k: self.clone())
    SPANS.enable()
    detector._detect_chunks(detect_fn, None, frames, 4, torch.device("meta"), False)
    spans, _, _ = SPANS.drain()
    h2d = [s.counts for s in spans if s.name == "h2d"]
    assert h2d == [{"bytes": frames[:4].nbytes, "pinned": False}, {"bytes": frames[4:].nbytes, "pinned": False}]
    assert seen == [4, 4]


def test_the_buffer_is_bounded_and_counts_what_it_drops():
    rec = SpanRecorder(capacity=3)
    rec.enable()
    with rec.span("root"):
        for i in range(4):
            with rec.span("child", i=i):
                pass
    spans, dropped, _ = rec.drain()
    assert [s.name for s in spans] == ["root", "child", "child"] and dropped == 2
    assert [s.counts for s in spans[1:]] == [{"i": 0}, {"i": 1}]
    assert rec.drain() == ([], 0, None)


def test_parents_are_kept_per_thread():
    rec = SpanRecorder()
    rec.enable()
    ready, done = threading.Event(), threading.Event()

    def worker():
        with rec.span("worker"):
            ready.set()
            done.wait(10)

    with rec.span("main"):
        th = threading.Thread(target=worker)
        th.start()
        assert ready.wait(10)
        with rec.span("main_child"):
            pass
        done.set()
        th.join(10)
    assert not th.is_alive()
    spans, _, _ = rec.drain()
    by = {s.name: s for s in spans}
    assert by["worker"].parent == -1 and by["worker"].request != by["main"].request
    assert spans[by["main_child"].parent].name == "main"
    assert by["worker"].thread != by["main"].thread


def test_a_torch_profiler_trace_turns_recording_on():
    assert SPANS.active() is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert SPANS.active() is SPANS
    assert SPANS.active() is None


def test_self_time_is_the_duration_less_the_children():
    spans = [
        Span("a", 0, 100, -1, 1, 1, {}),
        Span("b", 10, 30, 0, 1, 1, {}),
        Span("c", 40, 90, 0, 1, 1, {}),
        Span("d", 50, 60, 2, 1, 1, {}),
        Span("e", 70, None, 2, 1, 1, {}),
    ]
    assert profiler.self_times(spans) == [30, 20, 40, 10, 0]


def test_device_trace_writes_the_spans_on_the_trace_clock(tmp_path):
    """The spans of the scope land in the same Chrome trace, on a track of
    their own, and each aten op that ran inside the runner's ``frames``
    span lies inside it on the trace's clock."""
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    dets = syn.simulated_detection_stream(3)
    ego = syn.ego_motion_stream(3, seed=0).astype(np.float32)
    run = pt.make_sequence_runner(cfg, device="cpu")
    with profiler.device_trace(str(tmp_path)):
        run(pt.initial_state(cfg, device="cpu"), dict(dets, ego_measurement=ego))
    assert not SPANS.enabled
    (path,) = tmp_path.glob("*.pt.trace.json")
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in spans if e["args"]["parent"] == -1] == ["frames"]
    assert sum(e["name"] == "step" for e in spans) == 3
    assert all(e["pid"] == profiler.SPAN_PID for e in spans)
    assert trace["programSpansDropped"] == 0
    frames = next(e for e in spans if e["name"] == "frames")
    steps = [e for e in spans if e["name"] == "step"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")
           and any(s["ts"] <= e["ts"] < s["ts"] + s["dur"] for s in steps)]
    assert ops
    for e in ops:  # the clocks agree within a few microseconds
        assert frames["ts"] - 5 <= e["ts"] and e["ts"] + e["dur"] <= frames["ts"] + frames["dur"] + 5
