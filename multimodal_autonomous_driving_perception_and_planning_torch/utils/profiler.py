"""Profiling utilities.

The reference's observability is ad-hoc wall-clock FPS printing
(demo.py:94-95,167-195).  `FrameTimer` keeps that console contract
(rolling FPS every N frames, final summary) as a reusable component, and
`device_trace` wraps `torch.profiler` so that a pipeline run leaves a
trace of its ops and, where a card runs them, its kernels (the hand
kernels K1-K5 among them, by name), viewable in TensorBoard's profiler
plugin or in Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch


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


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A `torch.profiler` trace of the scope, of the host's ops and, with a
    card, of its kernels, written to ``log_dir`` as a Chrome trace
    (``*.pt.trace.json``) when the scope ends; open it with TensorBoard's
    profiler plugin (``tensorboard --logdir <dir>``) or in Perfetto.
    Yields the profiler, whose ``key_averages()`` sums the time by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof
