"""Streaming pipeline driver: native decode overlapped with device compute.

The reference's hot loop is strictly serial: decode a frame, then run every
stage on it.  Here the native ring (`frame_ring.cpp`) produces frames on
C++ threads while the card runs the previous chunk.  Each chunk is drained
from the ring straight into one of two pinned host buffers, copied to its
device twin on a side stream (``copy_(non_blocking=True)``, then an
event), and the compute stream waits on that event before the runner takes
the device tensor uncopied.  A host buffer is drained into again only after
the copy that last read it has completed, and a device buffer is copied
into again only after the runner that last read it is done: the two races
of a double buffer.

    source = NativeFrameSource(...)          # C++ producer threads
    outs, stats = run_stream(cfg, source, total)

State chains across chunks (the checkpoint/resume contract), so the
chunked stream equals one whole run of `make_sequence_runner`.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from ..config import PipelineConfig
from ..pipeline import initial_state, make_sequence_runner
from ..types import tree_map
from ..utils.device import resolve_device


def _chunk_inputs(cfg: PipelineConfig, frames, start: int, dt: float, ego=None):
    """Inputs for frames [start, start+len): detections keyed off the
    reference's post-increment frame counter; ``ego`` rows come from the
    caller's IncrementalEgoMotion (bit-identical to slicing one monolithic
    seed-0 stream) or are regenerated from frame 0 when omitted.
    ``frames`` (F, H, W, 3) uint8, host or device, goes in as it is."""
    from ..data.synthetic import ego_motion_stream, simulated_detection_stream

    n = frames.shape[0]
    dets = simulated_detection_stream(
        n,
        height=cfg.frame_height,
        width=cfg.frame_width,
        capacity=cfg.detector.max_detections,
        start_frame_count=start + 1,
    )
    if ego is None:
        ego = ego_motion_stream(start + n, dt=dt, seed=0)[start:]
    inputs: Dict[str, Any] = {k: torch.from_numpy(v) for k, v in dets.items()}
    inputs["ego_measurement"] = torch.from_numpy(np.asarray(ego, np.float32))
    if cfg.use_frames:
        inputs["frame"] = frames
    return dets, inputs


def pad_tail(buf, n: int) -> None:
    """Fill a chunk's buffer (numpy or tensor) past its first ``n`` frames
    with its last frame, in place: every run takes a full chunk.  Safe only
    for the last chunk of a stream, whose state advanced through the padded
    frames is never consumed."""
    buf[n:] = buf[n - 1]


class FrameFeed:
    """Two host buffers of one chunk the ring drains into (pinned on the
    card) and, on the card, their device twins, a copy stream and the
    events that order the reuse of each buffer."""

    def __init__(self, source, chunk: int, dev: torch.device):
        shape = (chunk, source.height, source.width, 3)
        self.source, self.chunk, self.dev = source, chunk, dev
        self.card = dev.type == "cuda"
        self.host = [torch.empty(shape, dtype=torch.uint8, pin_memory=self.card) for _ in range(2)]
        if self.card:
            self.device_bufs = [torch.empty(shape, dtype=torch.uint8, device=dev) for _ in range(2)]
            self.copy_stream = torch.cuda.Stream(dev)
        self.copied = [None, None]  # the H2D copy out of host[s] done
        self.read = [None, None]  # the runner done with device_bufs[s]

    def fill(self, k: int, n: int) -> int:
        """Drain up to ``n`` frames of chunk ``k`` into its host buffer,
        padded to the chunk with the last frame; returns the frames drained."""
        s = k % 2
        if self.copied[s] is not None:
            self.copied[s].synchronize()
        buf = self.host[s]
        got = self.source.next_batch_into(buf[:n])
        if 0 < got < self.chunk:
            # A short batch means exhaustion (a stall raises in the
            # source): this is the last chunk.
            pad_tail(buf, got)
        return got

    def frames(self, k: int) -> torch.Tensor:
        """Chunk ``k``'s frames where the runner reads them: the host buffer
        on the CPU; on the card its device twin, copied on the side stream,
        which the compute stream waits for."""
        s = k % 2
        if not self.card:
            return self.host[s]
        compute = torch.cuda.current_stream(self.dev)
        with torch.cuda.stream(self.copy_stream):
            if self.read[s] is not None:
                self.copy_stream.wait_event(self.read[s])
            self.device_bufs[s].copy_(self.host[s], non_blocking=True)
            self.copied[s] = torch.cuda.Event()
            self.copied[s].record(self.copy_stream)
        compute.wait_event(self.copied[s])
        return self.device_bufs[s]

    def release(self, k: int) -> None:
        """Mark chunk ``k``'s device buffer free once the work queued on the
        compute stream so far is done."""
        if self.card:
            s = k % 2
            self.read[s] = torch.cuda.Event()
            self.read[s].record(torch.cuda.current_stream(self.dev))


def run_stream(
    cfg: PipelineConfig,
    source,
    total_frames: int,
    chunk: int = 64,
    dt: float = 1.0 / 30.0,
    collect_host: bool = True,
    runner=None,
    device="cuda",
):
    """Drive the pipeline from a NativeFrameSource with overlap.

    Returns (outs, stats): ``outs`` is the per-frame output dict of
    `make_sequence_runner`, stacked over all chunks as host tensors (None
    when ``collect_host`` is False; {} when the source yields zero
    frames), and ``stats`` holds frames / wall_s / decode_s / fps (decode_s
    is the host time blocked in the ring drain: time NOT overlapped with
    device execution).

    A producer stall surfaces as TimeoutError from the source rather than a
    silently truncated stream: a timeout-shortened mid-stream chunk would
    advance the carried state through padded frames and break the
    bit-identical contract.

    Every chunk has the same shape (the last one is padded with its last
    frame), so the buffers are allocated once.  Pass a prebuilt ``runner``
    (`make_sequence_runner(cfg, device)`) to reuse it across calls.  With
    ``device="cpu"`` the buffers are plain host tensors and nothing is
    pinned.
    """
    from ..data.synthetic import IncrementalEgoMotion

    dev = resolve_device(device)
    if runner is None:
        runner = make_sequence_runner(cfg, device=dev)
    state = initial_state(cfg, device=dev)
    ego_src = IncrementalEgoMotion(dt=dt, seed=0)
    feed = FrameFeed(source, chunk, dev)

    t_wall0 = time.perf_counter()
    decode_s = 0.0
    pending = None  # (outs of the last chunk, its valid frames)
    results = []

    def collect(outs, n):
        results.append(tree_map(lambda x: x[:n].cpu(), outs))

    start, k = 0, 0
    while start < total_frames:
        t0 = time.perf_counter()
        n = feed.fill(k, min(chunk, total_frames - start))
        decode_s += time.perf_counter() - t0
        if n == 0:
            break
        _, inputs = _chunk_inputs(cfg, feed.frames(k), start, dt, ego=ego_src.take(chunk))
        state, outs = runner(state, inputs)
        feed.release(k)
        # The last chunk's outputs come back while this one runs.
        if pending is not None and collect_host:
            collect(*pending)
        pending = (outs, n)
        start += n
        k += 1

    if pending is not None and collect_host:
        collect(*pending)
    elif feed.card:
        torch.cuda.synchronize(dev)

    wall = time.perf_counter() - t_wall0
    stats = {"frames": start, "wall_s": wall, "decode_s": decode_s, "fps": start / wall if wall > 0 else 0.0}
    if not collect_host:
        return None, stats
    if not results:  # zero frames produced (empty source / total_frames=0)
        return {}, stats
    return tree_map(lambda *xs: torch.cat(xs), *results), stats
