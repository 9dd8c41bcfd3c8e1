"""Profiling utilities.

The reference's observability is ad-hoc wall-clock FPS printing
(demo.py:94-95,167-195).  `FrameTimer` keeps that console contract
(rolling FPS every N frames, final summary) as a reusable component, and
`device_trace` wraps `torch.profiler` so that a pipeline run leaves a
trace of its ops and, where a card runs them, its kernels (the hand
kernels K1-K5 among them, by name), viewable in TensorBoard's profiler
plugin or in Perfetto.

`SPANS` records the program's spans: the stages of the segment path
(`perception.detector`, `models.yolov8`, `pipeline`) on the host's
monotonic clock, each with its parent, its request and its thread.  It
records while enabled or while a `torch.profiler` trace runs, and is off
otherwise: a site then costs one test.  A span never touches the device.
`device_trace` writes the spans of its scope into its Chrome trace as a
track of their own, on the trace's clock.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


class FrameTimer:
    """Rolling-FPS tracker matching the reference console contract."""

    def __init__(self, report_every: int = 50):
        self.report_every = report_every
        self.frame_times: List[float] = []
        self._start: Optional[float] = None
        self._t0 = time.time()

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.frame_times.append(time.perf_counter() - self._start)

    def maybe_report(self, frame_idx: int, total: int, extra: str = "") -> Optional[str]:
        """Returns the progress line every `report_every` frames, else None."""
        n = frame_idx + 1
        if n % self.report_every != 0:
            return None
        window = self.frame_times[-self.report_every:]
        fps = 1.0 / float(np.mean(window)) if window else 0.0
        line = f"Frame {n}/{total} | FPS: {fps:.1f}"
        if extra:
            line += f" | {extra}"
        return line

    @property
    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return 1.0 / float(np.mean(self.frame_times))

    def summary(self) -> str:
        total = time.time() - self._t0
        n = len(self.frame_times)
        avg_fps = n / total if total > 0 else 0.0
        avg_ms = float(np.mean(self.frame_times)) * 1e3 if n else 0.0
        return (
            f"Processed {n} frames in {total:.2f} seconds\n"
            f"Average FPS: {avg_fps:.1f}\n"
            f"Average frame time: {avg_ms:.1f} ms"
        )


class Span(NamedTuple):
    """One recorded span.  ``start_ns`` and ``end_ns`` are
    `time.perf_counter_ns` readings (``end_ns`` None while it is open);
    ``parent`` is the index of the enclosing span in the same drained
    list, -1 for a root; every span of one root's call shares its
    ``request``; ``thread`` is the native thread id."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    request: int
    thread: int
    counts: Dict[str, Any]


class SpanRecorder:
    """Spans in a bounded in-memory buffer, written out only when drained.

    A site asks `active` once (the recorder while it records, else None)
    and opens ``rec.span(name, **counts) if rec else NO_SPAN``; off, that
    is one test and no allocation.  Parents are kept per thread, so a
    worker thread's spans nest on their own.  Past ``capacity`` spans a
    span is dropped and counted in ``dropped``."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self.enabled = False
        self.dropped = 0
        # (time.time_ns(), time.perf_counter_ns()) read together when the
        # buffer took its first span: a span's reading plus their
        # difference is its CLOCK_REALTIME.
        self.clock: Optional[Tuple[int, int]] = None
        self._buf: List[list] = []
        self._generation = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._requests = itertools.count(1)

    def active(self) -> Optional["SpanRecorder"]:
        return self if self.enabled or _profiler_on() else None

    def enable(self, on: bool = True) -> None:
        self.enabled = on

    def span(self, name: str, **counts) -> "_OpenSpan":
        """A context that records ``name`` over its body; its ``counts``
        dict may take more counts before it closes."""
        return _OpenSpan(self, name, counts)

    def clear(self) -> None:
        with self._lock:
            self._buf, self.dropped, self.clock = [], 0, None
            self._generation += 1

    def drain(self) -> Tuple[List[Span], int, Optional[Tuple[int, int]]]:
        """The spans recorded since the last drain (in the order they
        opened), the count dropped and the clock pair; empties the buffer."""
        with self._lock:
            buf, dropped, clock = self._buf, self.dropped, self.clock
            self._buf, self.dropped, self.clock = [], 0, None
            self._generation += 1
        return [Span(*entry) for entry in buf], dropped, clock

    def _thread(self) -> Tuple[list, int]:
        """This thread's stack of open spans and its native id, read once
        a thread: `threading.get_native_id` is a system call, which on some
        hosts costs more than the rest of a span."""
        local = self._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.tid = threading.get_native_id()
        return stack, local.tid

    def _begin(self, name: str, counts: Dict[str, Any]) -> Tuple[int, int]:
        stack, tid = self._thread()
        parent, request = (stack[-1][1], stack[-1][2]) if stack else (-1, 0)
        with self._lock:
            gen = self._generation
            if stack and stack[-1][0] != gen:
                parent = -1  # the enclosing span was drained
            if not request:
                request = next(self._requests)
            if len(self._buf) >= self.capacity:
                self.dropped += 1
                index = -1
            else:
                if self.clock is None:
                    self.clock = _clock_pair()
                index = len(self._buf)
                self._buf.append([name, time.perf_counter_ns(), None, parent, request, tid, counts])
        stack.append((gen, index, request))
        return gen, index

    def _end(self, gen: int, index: int) -> None:
        end = time.perf_counter_ns()
        stack = self._local.stack
        if stack:
            stack.pop()
        with self._lock:
            if gen == self._generation and index >= 0:
                self._buf[index][2] = end


class _OpenSpan:
    __slots__ = ("rec", "name", "counts", "_token")

    def __init__(self, rec: SpanRecorder, name: str, counts: Dict[str, Any]):
        self.rec, self.name, self.counts = rec, name, counts

    def __enter__(self) -> "_OpenSpan":
        self._token = self.rec._begin(self.name, self.counts)
        return self

    def __exit__(self, *exc) -> bool:
        self.rec._end(*self._token)
        return False


NO_SPAN = contextlib.nullcontext()
SPANS = SpanRecorder()


def _profiler_on() -> bool:
    return _autograd_profiler._is_profiler_enabled


def _clock_pair() -> Tuple[int, int]:
    """CLOCK_REALTIME and the monotonic clock, read together: the real
    time between two monotonic readings."""
    a = time.perf_counter_ns()
    real = time.time_ns()
    b = time.perf_counter_ns()
    return real, (a + b) // 2


def self_times(spans: List[Span]) -> List[int]:
    """Each span's self time in ns: its duration less the part of it that
    its children cover (children of one parent do not overlap); 0 for a
    span still open."""
    covered = [0] * len(spans)
    for s in spans:
        if s.parent >= 0 and s.end_ns is not None:
            covered[s.parent] += s.end_ns - s.start_ns
    return [0 if s.end_ns is None else max(0, s.end_ns - s.start_ns - c) for s, c in zip(spans, covered)]


SPAN_PID = "Program spans"


def span_events(spans: List[Span], clock: Tuple[int, int], base_ns: int = 0) -> List[Dict[str, Any]]:
    """The closed spans as Chrome trace events ("X", category "span") on a
    trace's clock: ``ts`` in µs after ``base_ns`` of CLOCK_REALTIME, on a
    process track of their own, a thread each."""
    offset = clock[0] - clock[1] - base_ns
    events: List[Dict[str, Any]] = [{"ph": "M", "name": "process_name", "pid": SPAN_PID, "tid": 0,
                                     "args": {"name": SPAN_PID}}]
    for t in sorted({s.thread for s in spans}):
        events.append({"ph": "M", "name": "thread_name", "pid": SPAN_PID, "tid": t,
                       "args": {"name": f"thread {t}"}})
    for i, s in enumerate(spans):
        if s.end_ns is None:
            continue
        events.append({
            "ph": "X", "cat": "span", "name": s.name, "pid": SPAN_PID, "tid": s.thread,
            "ts": (s.start_ns + offset) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": dict(s.counts, index=i, parent=s.parent, request=s.request),
        })
    return events


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A `torch.profiler` trace of the scope, of the host's ops and, with a
    card, of its kernels, written to ``log_dir`` as a Chrome trace
    (``*.pt.trace.json``) when the scope ends; open it with TensorBoard's
    profiler plugin (``tensorboard --logdir <dir>``) or in Perfetto.  The
    program's spans of the scope go into the same file, on a track of
    their own ("Program spans").  Yields the profiler, whose
    ``key_averages()`` sums the time by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    def write(prof) -> None:
        os.makedirs(log_dir, exist_ok=True)
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
        path = os.path.join(log_dir, name)
        prof.export_chrome_trace(path)
        recorded, dropped, clock = SPANS.drain()
        if not recorded:
            return
        with open(path) as fh:
            trace = json.load(fh)
        trace["traceEvents"].extend(span_events(recorded, clock, int(trace.get("baseTimeNanoseconds", 0))))
        trace["programSpansDropped"] = dropped
        with open(path, "w") as fh:
            json.dump(trace, fh)

    was = SPANS.enabled
    SPANS.clear()
    SPANS.enable()
    try:
        with torch.profiler.profile(activities=activities, on_trace_ready=write) as prof:
            yield prof
    finally:
        SPANS.enable(was)
