"""The program's spans over the traced stretch, joined to its device trace.

The port records spans at the segment path's layer boundaries (its
``utils.profiler.SPANS``: ``segment``; ``detect`` with ``h2d``, ``tower``,
``decode`` and ``nms``; ``frames`` with ``inputs``, ``step`` and
``unpack``; under ``step`` ``lanes``, ``track``, ``estimate``, ``plan``,
``tag`` and ``write``) while a ``torch.profiler`` trace runs, so the
traced stretch's segments carry them and no other segment does.  The
readers of the span metrics share one `Joined` a stretch, built when the
first of them reads: it drains the program's recorder, keeps the spans of
the stretch's last segments (those whose frames make the stretch's
frames), and maps them onto the trace's clock.

Clock: a span's `time.perf_counter_ns` plus the recorder's offset to
CLOCK_REALTIME, less the trace's base time (Kineto's: the real time
rounded down to a multiple of 7,889,238 s, as ``baseTimeNanoseconds``),
is the trace's ``ts``.  Check: some kernels are launched only inside one
kind of span (the harness's tower markers inside ``tower``, K1, K2, K3
and K5 inside ``track``, ``estimate``, ``tag`` and ``nms``), so each such
kernel's launching runtime call (found through the kernel's correlation
id) has to fall inside one; if one lies more than `TOLERANCE_US` outside,
every reading that joins spans to the trace is refused, and standard
error says why.
Join: a device record belongs to the innermost span that holds the start
of its launching runtime call.

The Context keeps the stretch's device records but not its runtime calls'
correlation ids; the `trace.Stretch` that made it holds both, and shares
its ``launches`` dict with it, which is how `_stretch_events` finds it.
"""

from __future__ import annotations

import bisect
import gc
import json
import sys
import time
import weakref
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import trace

TOLERANCE_US = 50.0
TRIMONTH_S = 7_889_238
PYTHON = "host Python, between runtime calls"  # `trace.Context.breakdown`'s label
# Runtime calls in which the host waits for the card.
BLOCKING = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
    "cudaMemcpy2D", "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
    "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2",
})

# Kernels by a part of their names, and the span each is launched in.
ANCHORS = (("tracker_", "track"), ("kalman_step", "estimate"), ("tagging_step", "tag"), ("nms_", "nms"))

_JOINED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def kineto_base_ns(now_s: float) -> int:
    """The base time Kineto writes as a trace's ``baseTimeNanoseconds``."""
    return int(now_s) // TRIMONTH_S * TRIMONTH_S * 10**9


def recorded():
    """The program's recorded spans, the count it dropped and its clock
    pair, draining its recorder; None for a program without one."""
    try:
        from multimodal_autonomous_driving_perception_and_planning_torch.utils import profiler
    except ImportError:
        return None
    spans = getattr(profiler, "SPANS", None)
    return None if spans is None else spans.drain()


def _stretch_events(ctx) -> Optional[List[Dict]]:
    """The stretch's whole event list, from the `trace.Stretch` that made
    ``ctx`` (the owner of ``ctx.launches`` other than ``ctx``)."""
    launches = getattr(ctx, "launches", None)
    if launches is None:
        return None
    for owner in gc.get_referrers(launches):
        if owner is ctx:
            continue
        events = owner.get("events") if isinstance(owner, dict) else getattr(owner, "events", None)
        if isinstance(events, list) and (owner.get("launches") if isinstance(owner, dict)
                                         else getattr(owner, "launches", None)) is launches:
            return events
    return None


def joined(ctx) -> Optional["Joined"]:
    """The stretch's `Joined`, built once a context (its statistics to
    standard error then), or None where the program records no spans."""
    if ctx in _JOINED:
        return _JOINED[ctx]
    got = recorded()
    j = None
    if got is None or not got[0]:
        print("perfbench spans: the program recorded no spans", file=sys.stderr)
    else:
        spans, dropped, clock = got
        j = Joined(ctx, spans, dropped, clock, kineto_base_ns(time.time()), _stretch_events(ctx))
        print("perfbench spans " + json.dumps(j.stats()), file=sys.stderr)
    _JOINED[ctx] = j
    return j


class Joined:
    """The stretch's spans, their host times, and their join to the
    stretch's device records and runtime calls."""

    def __init__(self, ctx, spans, dropped: int, clock: Optional[Tuple[int, int]], base_ns: int,
                 events: Optional[List[Dict]]):
        self.ctx, self.dropped, self.frames = ctx, dropped, ctx.frames
        self.spans = _stretch_spans(spans, ctx.frames)
        self.why = None if self.spans else (
            f"no run of segments spans the stretch's {ctx.frames} frames in the {len(spans)} spans recorded")
        n = len(self.spans)
        self.children = [[] for _ in range(n)]
        for i, s in enumerate(self.spans):
            if s.parent >= 0:
                self.children[s.parent].append(i)
        offset_us = 0.0 if clock is None else (clock[0] - clock[1] - base_ns) / 1e3
        self.start = [s.start_ns / 1e3 + offset_us for s in self.spans]
        self.end = [s.end_ns / 1e3 + offset_us for s in self.spans]
        self.residual_us = self.shift_bounds_us = None
        self.calls: List[Dict] = []
        self.by_corr: Dict[int, Dict] = {}
        if self.spans:
            self._check(events)

    # -- host times -------------------------------------------------------

    def host_ms_per_frame(self, name: str) -> Optional[float]:
        ns = [s.end_ns - s.start_ns for s in self.spans if s.name == name]
        return sum(ns) / 1e6 / self.frames if ns else None

    def stages(self) -> Dict[str, List[float]]:
        """For every span name, host ms a frame and self ms a frame (less
        the time its child spans cover)."""
        from multimodal_autonomous_driving_perception_and_planning_torch.utils.profiler import self_times

        total, own = defaultdict(int), defaultdict(int)
        for s, self_ns in zip(self.spans, self_times(self.spans)):
            total[s.name] += s.end_ns - s.start_ns
            own[s.name] += self_ns
        return {k: [total[k] / 1e6 / self.frames, own[k] / 1e6 / self.frames] for k in total}

    def coverage(self) -> Optional[float]:
        """The least share of a ``segment`` span that its ``detect`` and
        ``frames`` spans cover."""
        shares = []
        for i, s in enumerate(self.spans):
            if s.name == "segment":
                inner = sum(self.spans[c].end_ns - self.spans[c].start_ns for c in self.children[i]
                            if self.spans[c].name in ("detect", "frames"))
                shares.append(inner / max(1, s.end_ns - s.start_ns))
        return min(shares) if shares else None

    # -- the trace's clock ------------------------------------------------

    @property
    def aligned(self) -> bool:
        return self.why is None

    def _check(self, events: Optional[List[Dict]]) -> None:
        """Index the runtime calls, and hold each anchor's launch to the
        spans it is launched in: the tower markers to ``tower``, K1, K2,
        K3 and K5 to ``track``, ``estimate``, ``tag`` and ``nms``."""
        if events is None:
            self.why = "the stretch's runtime calls are out of reach"
            return
        self.calls = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in trace.HOST_CATS),
                            key=lambda e: e["ts"])
        self.by_corr = {e["args"]["correlation"]: e for e in self.calls if "correlation" in e.get("args", {})}
        kernels = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"), key=lambda e: e["ts"])
        markers = [e for e in kernels if trace.MARKER in e.get("name", "")]
        towers = [i for i, s in enumerate(self.spans) if s.name == "tower"]
        inner = markers[1:-1]  # the first and last bracket the stretch
        if not towers or len(inner) != 2 * len(towers):
            self.why = f"{len(inner)} tower markers for {len(towers)} tower spans"
            return
        anchors = [("tower opening" if k % 2 == 0 else "tower closing", "tower", m) for k, m in enumerate(inner)]
        t0, t1 = markers[0]["ts"], markers[-1]["ts"]
        for part, name in ANCHORS:
            anchors += [(name, name, e) for e in kernels if part in e.get("name", "") and t0 <= e["ts"] <= t1]
        by_name = defaultdict(list)
        for i, s in enumerate(self.spans):
            by_name[s.name].append(i)
        worst: Dict[str, float] = {}
        lo, hi = -float("inf"), float("inf")
        for label, name, e in anchors:
            call = self.by_corr.get(e.get("args", {}).get("correlation"))
            if call is None or not by_name[name]:
                self.why = f"a {label} launch has no runtime call or no {name} span"
                return
            a, b = call["ts"], call["ts"] + call["dur"]
            r, i = min((max(0.0, self.start[i] - a, b - self.end[i]), i) for i in by_name[name])
            worst[label] = max(worst.get(label, 0.0), r)
            lo, hi = max(lo, b - self.end[i]), min(hi, a - self.start[i])
        self.residual_us = worst
        # Every shift of the spans' clock within these bounds keeps each
        # anchor's launch inside its span: how closely the anchors pin it.
        self.shift_bounds_us = [lo, hi]
        label = max(worst, key=worst.get)
        if worst[label] > TOLERANCE_US:
            self.why = (f"a {label} launch lies {worst[label]:.1f} us outside its span (tolerance "
                        f"{TOLERANCE_US:.0f} us): the spans and the trace disagree on the clock")

    def innermost(self, t: float) -> Optional[int]:
        """The innermost span holding trace time ``t``, or None."""
        i = bisect.bisect_right(self.start, t) - 1
        while i >= 0:
            if self.end[i] >= t:
                return i
            i = self.spans[i].parent
        return None

    def path(self, i: int) -> str:
        """The span's name under its parent's."""
        p = self.spans[i].parent
        return self.spans[i].name if p < 0 else f"{self.spans[p].name}/{self.spans[i].name}"

    def within(self, i: Optional[int], name: str) -> bool:
        """Whether span ``i`` is a ``name`` span or lies inside one."""
        while i is not None and i >= 0:
            if self.spans[i].name == name:
                return True
            i = self.spans[i].parent
        return False

    def device_ms_per_frame(self, name: str) -> Optional[float]:
        """Device ms a frame of the stretch's records launched inside a
        ``name`` span."""
        us = 0.0
        for e in self.ctx.device:
            call = self.by_corr.get(e.get("args", {}).get("correlation"))
            if call is not None and self.within(self.innermost(call["ts"]), name):
                us += e["dur"]
        return us / 1e3 / self.frames

    def waits(self) -> Dict[str, float]:
        """Host ms a frame inside blocking runtime calls that start inside
        a program span, by the span's path and the call."""
        by = defaultdict(float)
        for e in self.calls:
            if e["name"] in BLOCKING:
                i = self.innermost(e["ts"])
                if i is not None:
                    by[f"{self.path(i)} {e['name']}"] += e["dur"] / 1e3 / self.frames
        return dict(sorted(by.items(), key=lambda kv: -kv[1]))

    def idle_intervals(self) -> List[Tuple[float, float]]:
        """The stretch's device-idle intervals (between the merged busy
        intervals of `device_idle_pct`)."""
        out, prev = [], self.ctx._t0
        for s, e in list(self.ctx._merged) + [[self.ctx._t1, self.ctx._t1]]:
            if s > prev:
                out.append((prev, s))
            prev = max(prev, e)
        return out

    def idle_within_pct(self, name: str) -> Optional[float]:
        """Share of the device-idle time during which the host was inside
        a ``name`` span."""
        idle = self.idle_intervals()
        total = sum(e - s for s, e in idle)
        if not total:
            return None
        spans = trace._union([(self.start[i], self.end[i]) for i, s in enumerate(self.spans) if s.name == name])
        starts = [s for s, _ in spans]
        inside = 0.0
        for a, b in idle:
            j = max(0, bisect.bisect_right(starts, a) - 1)
            while j < len(spans) and spans[j][0] < b:
                inside += max(0.0, min(b, spans[j][1]) - max(a, spans[j][0]))
                j += 1
        return 100.0 * inside / total

    def breakdown(self) -> Dict:
        """`trace.Context.breakdown` with its "host Python" idle gaps split
        by the innermost program span open at the gap ("host Python in
        step/plan"); gaps outside every span keep their label."""
        base = self.ctx.breakdown()
        host_starts = [h[0] for h in self.ctx._host]
        gaps = defaultdict(float)
        for s, e in self.idle_intervals():
            mid = (s + e) / 2
            label = self.ctx._host_at(mid, host_starts)
            if label == PYTHON and self.aligned:
                i = self.innermost(mid)
                if i is not None:
                    label = f"host Python in {self.path(i)}"
            gaps[label] += (e - s) * 1e-6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:trace.TOP]
        return {"device_ops": base["device_ops"], "idle_gaps": [[k, v] for k, v in idle]}

    def stats(self) -> Dict:
        out = {"spans": len(self.spans), "dropped": self.dropped, "aligned": self.aligned}
        if self.why:
            out["why"] = self.why
        if self.residual_us is not None:
            out["residual_us"] = self.residual_us
            out["shift_bounds_us"] = self.shift_bounds_us
        if self.spans:
            out["stages"] = self.stages()
            out["coverage_min"] = self.coverage()
            out["segment_ms_per_frame"] = self.host_ms_per_frame("segment")
            out["stretch_ms_per_frame"] = 1e3 * self.ctx.window_s / self.frames
        if self.spans and self.aligned:
            out["waits_ms_per_frame"] = self.waits()
            out["idle_gaps"] = self.breakdown()["idle_gaps"]
        return out


def _stretch_spans(spans, frames: int):
    """The spans of the last root ``segment`` spans whose frames make
    ``frames``, their parents renumbered; [] where none do."""
    roots, got = [], 0
    for i in range(len(spans) - 1, -1, -1):
        s = spans[i]
        if s.parent == -1 and s.name == "segment" and s.end_ns is not None:
            roots.append(i)
            got += s.counts.get("frames", 0)
            if got >= frames:
                break
    if got != frames:
        return []
    requests = {spans[i].request for i in roots}
    keep = [i for i in range(min(roots), len(spans)) if spans[i].request in requests and spans[i].end_ns is not None]
    new = {old: k for k, old in enumerate(keep)}
    return [spans[i]._replace(parent=new.get(spans[i].parent, -1)) for i in keep]


def read_device(ctx, what) -> Optional[float]:
    """``what(joined)`` where the spans lie on the trace's clock, else None."""
    j = joined(ctx)
    if j is None or not j.spans or not j.aligned:
        return None
    return what(j)


def read_host(ctx, what) -> Optional[float]:
    """``what(joined)`` over the stretch's spans, else None."""
    j = joined(ctx)
    if j is None or not j.spans:
        return None
    return what(j)
