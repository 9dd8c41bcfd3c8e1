"""The span readers on a hand-made stretch: one 2-frame segment's program
spans, and a trace of runtime calls and device records with correlation
ids, the stretch's and the tower's markers among them.  Trace times below
are microseconds after ``T0``; a span's are mapped onto them by the clock
pair."""

from __future__ import annotations

import importlib

import pytest

from perfbench import spans as sp
from perfbench import trace
from multimodal_autonomous_driving_perception_and_planning_torch.utils.profiler import Span

BASE_NS = sp.kineto_base_ns(1.8e9)
T0 = 1e9  # the trace's ts of the spans' zero
PERF0 = 5_000_000_000
CLOCK = (BASE_NS + int(T0 * 1e3), PERF0)  # (real, perf): perf PERF0 reads T0 on the trace


def _span(name, a, b, parent, **counts):
    return Span(name, PERF0 + int(a * 1e3), PERF0 + int(b * 1e3), parent, 7, 1, counts)


SPANS = [
    _span("segment", 100, 1000, -1, frames=2),
    _span("detect", 110, 400, 0, frames=2, padded=0),
    _span("h2d", 120, 160, 1, bytes=1000, pinned=True),
    _span("tower", 170, 300, 1),
    _span("decode", 300, 320, 1),
    _span("nms", 320, 390, 1, pool=256),
    _span("frames", 400, 990, 0, frames=2, lanes=1),
    _span("inputs", 405, 420, 6),
    _span("step", 420, 700, 6, frame=0),
    _span("track", 430, 480, 8),
    _span("estimate", 480, 520, 8),
    _span("plan", 520, 600, 8),
    _span("tag", 600, 650, 8),
    _span("write", 650, 690, 8),
    _span("step", 700, 980, 6, frame=1),
    _span("plan", 750, 850, 14),
]


def _call(name, a, b, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": T0 + a, "dur": b - a,
            "args": {"correlation": corr}}


def _record(name, a, b, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": T0 + a, "dur": b - a, "args": {"correlation": corr}}


EVENTS = [
    _call("cudaLaunchKernel", 45, 48, 1), _record("void spin_kernel(long)", 50, 51, 1),
    _call("cudaMemcpyAsync", 121, 129, 31), _record("Memcpy HtoD (Pinned -> Device)", 125, 150, 31, "gpu_memcpy"),
    _call("cudaStreamSynchronize", 130, 155, 30),
    _call("cudaLaunchKernel", 200, 203, 10), _record("void spin_kernel(long)", 205, 206, 10),
    _call("cudaLaunchKernel", 250, 253, 12), _record("conv", 206, 280, 12),
    _call("cudaLaunchKernel", 290, 293, 11), _record("void spin_kernel(long)", 295, 296, 11),
    _call("cudaLaunchKernel", 440, 445, 22), _record("tracker_step", 446, 470, 22),
    _call("cudaLaunchKernel", 530, 535, 20), _record("plan_a", 540, 560, 20),
    _call("cudaLaunchKernel", 760, 765, 21), _record("plan_b", 770, 800, 21),
    _call("cudaStreamSynchronize", 1001, 1090, 40),  # the harness's, after the segment
    _call("cudaLaunchKernel", 1095, 1098, 99), _record("void spin_kernel(long)", 1100, 1101, 99),
]


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(trace, "_work", lambda *a: {})
    stretch = trace.Stretch(None, 1)
    stretch.events, stretch.launches = list(EVENTS), {"tracker": 2, "kalman": 2, "tagging": 2, "nms": 1}
    context = trace.Context(stretch, {}, {"segment_frames": 2}, [])
    context.stretch_ref = stretch  # keeps the stretch alive, as the harness's run does
    return context


def _joined(ctx, shift_us=0.0, spans=SPANS):
    clock = (CLOCK[0] + int(shift_us * 1e3), CLOCK[1])
    return sp.Joined(ctx, list(spans), 0, clock, BASE_NS, sp._stretch_events(ctx))


def test_the_stretch_events_are_found_from_the_context(ctx):
    assert sp._stretch_events(ctx) == EVENTS


def test_the_join_holds_each_record_to_the_innermost_span_of_its_launch(ctx):
    j = _joined(ctx)
    assert j.aligned and j.residual_us == {"tower opening": 0.0, "tower closing": 0.0, "track": 0.0}
    # The closing marker's launch ends 7 us before its tower span ends; K1's
    # starts 10 us after its track span starts.
    assert j.shift_bounds_us == pytest.approx([-7.0, 10.0])
    assert j.path(j.innermost(T0 + 442)) == "step/track"
    assert j.path(j.innermost(T0 + 410)) == "frames/inputs"
    assert j.path(j.innermost(T0 + 695)) == "frames/step"
    assert j.innermost(T0 + 1050) is None and j.innermost(T0 + 50) is None
    assert j.device_ms_per_frame("plan") == pytest.approx((20 + 30) / 1e3 / 2)
    assert j.device_ms_per_frame("tower") == pytest.approx(74 / 1e3 / 2)
    assert j.device_ms_per_frame("step") == pytest.approx((24 + 20 + 30) / 1e3 / 2)
    assert j.waits() == {"detect/h2d cudaStreamSynchronize": pytest.approx(25 / 1e3 / 2)}


EXPECTED = {
    "detect_host_ms_per_frame": 290 / 1e3 / 2,
    "step_host_ms_per_frame": 560 / 1e3 / 2,
    "planner_host_ms_per_frame": 180 / 1e3 / 2,
    "planner_device_ms_per_frame": 50 / 1e3 / 2,
    "host_wait_ms_per_frame": 25 / 1e3 / 2,
    # Idle intervals 51-125, 150-206, 280-446, 470-540, 560-770, 800-1100
    # (876 us); the steps (420-980) hold 26 + 70 + 210 + 180 us of them.
    "idle_in_step_pct": 100 * 486 / 876,
}
DEVICE = {"planner_device_ms_per_frame", "host_wait_ms_per_frame", "idle_in_step_pct"}


@pytest.mark.parametrize("name", sorted(EXPECTED))
@pytest.mark.parametrize("shift_us", [0.0, 100.0])
def test_each_reader_on_a_hand_made_stretch(ctx, monkeypatch, name, shift_us):
    """Each reader reads its value; a clock 100 us off puts K1's launch 90
    us outside its span, and every reader that joins spans to the trace
    then reads nothing."""
    clock = (CLOCK[0] + int(shift_us * 1e3), CLOCK[1])
    monkeypatch.setattr(sp, "recorded", lambda: (list(SPANS), 0, clock))
    monkeypatch.setattr(sp, "kineto_base_ns", lambda now: BASE_NS)
    value = importlib.import_module(f"perfbench.metrics.{name}").read(ctx)
    if shift_us and name in DEVICE:
        assert value is None
    else:
        assert value == pytest.approx(EXPECTED[name])


def test_a_clock_off_by_more_than_the_tolerance_is_refused(ctx):
    j = _joined(ctx, shift_us=100.0)
    assert not j.aligned and "a track launch lies 90.0 us outside" in j.why
    assert j.residual_us == pytest.approx({"tower opening": 70.0, "tower closing": 0.0, "track": 90.0})
    ok = _joined(ctx, shift_us=-40.0)  # the closing marker's launch 33 us out: within
    assert ok.aligned and ok.residual_us == pytest.approx({"tower opening": 0.0, "tower closing": 33.0, "track": 5.0})


def test_a_program_without_spans_reads_nothing(ctx, monkeypatch):
    monkeypatch.setattr(sp, "recorded", lambda: None)
    for name in EXPECTED:
        assert importlib.import_module(f"perfbench.metrics.{name}").read(ctx) is None


def test_spans_of_another_frame_count_are_not_the_stretch(ctx):
    j = _joined(ctx, spans=SPANS[:1] + [s._replace(counts={"frames": 3}) for s in SPANS[:1]])
    assert j.spans == [] and not j.aligned


def test_the_breakdown_splits_python_gaps_by_span(ctx):
    j = _joined(ctx)
    gaps = dict(j.breakdown()["idle_gaps"])
    # Each gap goes by its midpoint, as the trace's breakdown takes it.
    assert gaps == pytest.approx({
        sp.PYTHON: 74e-6,  # 51-125: before the segment
        "host Python in detect/tower": 56e-6,
        "host Python in detect/nms": 166e-6,
        "host Python in step/estimate": 70e-6,
        "host Python in step/write": 210e-6,
        "host Python in frames/step": 300e-6,
    })
    assert sum(gaps.values()) == pytest.approx(sum(v for _, v in ctx.breakdown()["idle_gaps"]))


@pytest.mark.parametrize("case", ["no spans", "clock refused"])
def test_a_breakdown_without_spans_on_the_clock_is_the_trace_s(ctx, case):
    j = _joined(ctx, spans=[]) if case == "no spans" else _joined(ctx, shift_us=100.0)
    assert j.breakdown() == ctx.breakdown()


def test_stages_give_host_and_self_ms_a_frame(ctx):
    j = _joined(ctx)
    st = j.stages()
    assert st["segment"] == pytest.approx([900 / 2e3, (900 - 290 - 590) / 2e3])
    assert st["step"] == pytest.approx([560 / 2e3, (560 - 260 - 100) / 2e3])
    assert st["plan"] == pytest.approx([180 / 2e3, 180 / 2e3])
    assert j.coverage() == pytest.approx(880 / 900)
    stats = j.stats()
    assert stats["dropped"] == 0 and stats["aligned"] and stats["stages"] == st
