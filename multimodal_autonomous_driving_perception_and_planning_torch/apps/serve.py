"""Inference server over the pipeline's sequence runner.

    python -m multimodal_autonomous_driving_perception_and_planning_torch.apps.serve --batch 8

A stdlib HTTP server feeds fixed-size chunks to the runner.  Sessions carry
the runner's state across requests, so a client that streams a long drive
in chunks gets the results of one uninterrupted run (the exactness
contract that checkpoint/resume shares).  The endpoints, the wire format
and the metrics are the JAX package's server's (its apps/serve.py), so the
same clients and `tools/serve_loadgen.py` drive either.

Wire format: request and response bodies are ``npz`` (numpy savez).

Endpoints:
  GET  /healthz           liveness, device, chunk size
  GET  /info              configuration summary
  POST /session           create a session -> {"session": id}
  POST /infer?session=id  npz with bbox/class_id/confidence/valid/
                          ego_measurement (+frame with use_frames), each
                          with a leading time axis of the chunk size;
                          returns an npz of per-frame outputs
  POST /reset?session=id  reset the session's state
  GET  /session_state?session=id  the session's state as npz, its leaves
                          ``leaf0..leafN`` in the JAX package's order, so a
                          state exported by either server imports into the
                          other
  POST /session_state     import an exported state -> new session id
  GET  /metrics           request counters, inference latency
                          percentiles, uptime (JSON)
  DELETE /session?session=id  drop a session

Each session holds a whole `PipelineState` on the device, so the table of
sessions is bounded: at ``max_sessions`` the least recently used one is
evicted.  The server binds 127.0.0.1 by default; /session is
unauthenticated.

The server runs a serialized artifact of the runner, as the JAX package's
does: unless it is given the bytes (``artifact=``), it exports the frame
step at startup (`utils.export.export_sequence_runner`, a ``torch.export``
program that reaches kernels K1-K3 through the ``madpp`` custom ops),
loads it back (`utils.export.deserialize_runner`) and serves every
request from it.  /info reports the artifact's size.

Micro-batching (``--batch B``): concurrent /infer requests against
different sessions coalesce into one run of the artifact's batched runner
(the results of `pipeline.make_batched_sequence_runner`) over up to B
lanes, after a short collection window.  Each frame of that run launches
kernels K1, K2 and K3 once for all B lanes.  Unused lanes repeat lane 0
and are discarded.  Two queued chunks of the same session never share a run: they
chain in arrival order.  The runner runs on the card unless the server is
made with ``device="cpu"``.

Scale-out (``--dp D``, ``--batch`` a multiple of D): the lanes of each
run are spread over D ranks, one process a card (parallel/distributed.py),
each running the artifact's program of B/D lanes
(`utils.export.deserialize_runner` with ``dp``).  Rank 0 keeps the whole
HTTP contract, the sessions and the batcher; for each coalesced run it
scatters each rank's lanes (their states and chunks, packed into one byte
buffer a rank), runs its own, and gathers the new states and the served
outputs back.  The other ranks loop in `PipelineServer.serve_worker`.
Lanes need no collective but that transport, and a dp server answers as
the batch server does.  Start the ranks with ``torchrun``::

    python -m torch.distributed.run --nproc-per-node 2 -m \
        multimodal_autonomous_driving_perception_and_planning_torch.apps.serve --batch 8 --dp 2
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT_CONFIG
from ..parallel.distributed import byte_specs, pack_bytes, packed_size, unpack_bytes
from ..pipeline import initial_state
from ..types import lane_of, stack_lanes, tree_leaves, tree_unflatten
from ..utils.convert import state_from_leaves
from ..utils.device import resolve_device
from ..utils.export import deserialize_runner, example_sequence_inputs, export_sequence_runner

# Per-frame outputs returned to clients: tracks, ego state, plan, tags.
_OUTPUT_KEYS = (
    "track_id",
    "track_bbox",
    "track_class_id",
    "track_confidence",
    "confirmed_order",
    "num_confirmed",
    "plan_best",
    "plan_best_positions",
    "plan_best_velocities",
)
_VEHICLE_KEYS = ("x", "y", "speed", "heading", "acceleration", "yaw_rate")
_NUMPY_DTYPES = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copy tensors to the host with one synchronisation: on the card, each
    into pinned memory without blocking, then one wait for the stream."""
    if not tensors:
        return {}
    if next(iter(tensors.values())).device.type != "cuda":
        return {k: v.numpy() for k, v in tensors.items()}
    host = {}
    for k, v in tensors.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    torch.cuda.current_stream(next(iter(tensors.values())).device).synchronize()
    return {k: v.numpy() for k, v in host.items()}


def _served(outs) -> Dict[str, torch.Tensor]:
    """The outputs a run serves, by wire name, on the device."""
    device = {k: outs[k] for k in _OUTPUT_KEYS}
    vs = outs["vehicle_state"]
    for f in _VEHICLE_KEYS:
        device[f"vehicle_{f}"] = getattr(vs, f)
    for k, v in (outs.get("tags") or {}).items():
        device[f"tag_{k}"] = v
    return device


_STOP, _RUN = 0, 1


class _RankLanes:
    """A dp server's lanes over its ranks: rank 0 scatters each rank's
    share of a run (states and chunks, one byte buffer a rank), every rank
    runs its share with the artifact's program, and rank 0 gathers the new
    states and the served outputs back.  One ``broadcast`` of a command
    precedes each run, so that the other ranks know whether to run or to
    stop.  Every collective is issued by one thread a rank at a time."""

    def __init__(self, server: "PipelineServer", zeros: Dict[str, np.ndarray]):
        self.server, self.dp, self.rank = server, server.dp, server.rank
        self.local = server.batch // server.dp
        self.device = server.device
        self.in_keys = sorted(zeros)
        # The share of one rank, and the warm-up run that sizes the outputs.
        state = stack_lanes([server._initial_state()] * self.local)
        inputs = {k: torch.as_tensor(np.stack([zeros[k]] * self.local)).to(self.device) for k in self.in_keys}
        self.template, self.n_state = state, len(tree_leaves(state))
        self.in_specs = byte_specs(tree_leaves(state) + [inputs[k] for k in self.in_keys])
        new_state, served = self._run_local(state, inputs)
        self.out_keys = sorted(served)
        self.out_specs = byte_specs(tree_leaves(new_state) + [served[k] for k in self.out_keys])

    def _run_local(self, state, inputs):
        """This rank's lanes through the artifact's runner."""
        new_state, outs = self.server.run.local(state, inputs)
        return new_state, _served(outs)

    def _command(self, cmd: int = _STOP) -> int:
        """Rank 0's ``cmd``, broadcast; the other ranks' argument is unused."""
        c = torch.full((1,), cmd, dtype=torch.int64, device=self.device)
        dist.broadcast(c, src=0)
        return int(c.item())

    def _exchange(self, parts=None):
        """Scatter the rank buffers from rank 0, run this rank's share,
        gather the results to rank 0; returns them there (one buffer a
        rank), None elsewhere."""
        mine = torch.empty(packed_size(self.in_specs), dtype=torch.uint8, device=self.device)
        dist.scatter(mine, parts, src=0)
        leaves = unpack_bytes(mine, self.in_specs)
        state = tree_unflatten(self.template, leaves[: self.n_state])
        inputs = dict(zip(self.in_keys, leaves[self.n_state :]))
        new_state, served = self._run_local(state, inputs)
        out = pack_bytes(tree_leaves(new_state) + [served[k] for k in self.out_keys])
        gathered = [torch.empty_like(out) for _ in range(self.dp)] if self.rank == 0 else None
        dist.gather(out, gathered, dst=0)
        return gathered

    def run_shard(self) -> bool:
        """One command on ranks 1..dp-1: run a share, or stop (False)."""
        if self._command() == _STOP:
            return False
        self._exchange()
        return True

    def stop(self) -> None:
        self._command(_STOP)

    def run_all(self, state, inputs: Dict[str, np.ndarray]):
        """Rank 0: the whole batch's run over the ranks: ``(new_state,
        served)``, each with the batch's lane axis, on rank 0's device."""
        self._command(_RUN)
        whole = tree_leaves(state) + [torch.as_tensor(inputs[k]).to(self.device) for k in self.in_keys]
        parts = [pack_bytes([t[r * self.local : (r + 1) * self.local] for t in whole]) for r in range(self.dp)]
        per_rank = [unpack_bytes(buf, self.out_specs) for buf in self._exchange(parts)]
        merged = [torch.cat(col) for col in zip(*per_rank)]
        return tree_unflatten(self.template, merged[: self.n_state]), dict(zip(self.out_keys, merged[self.n_state :]))


class _BatchRequest:
    """One queued /infer awaiting a batched run."""

    __slots__ = ("sid", "inputs", "event", "outs", "error", "cancelled")

    def __init__(self, sid, inputs):
        self.sid = sid
        self.inputs = inputs
        self.event = threading.Event()
        self.outs = None
        self.error: Optional[Exception] = None
        self.cancelled = False  # the waiter timed out; must not advance its session


class _MicroBatcher:
    """Coalesces concurrent /infer requests into batched runs.

    Requests queue FIFO; the dispatcher thread waits ``window_s`` after the
    first arrival for the batch to fill, then runs up to ``batch`` lanes.
    At most one lane per session a run: a session's queued chunks chain in
    order.  The thread pins the server's device once, as PyTorch's current
    device and stream are per thread.
    """

    def __init__(self, server: "PipelineServer", window_s: float = 0.005):
        self.server = server
        self.window_s = float(window_s)
        self._queue: list = []
        self._cv = threading.Condition()
        self._closed = False
        self.dispatches = 0  # batched runs
        self.lanes_served = 0  # real (non-padding) lanes across runs
        self._thread = threading.Thread(target=self._loop, name="serve-microbatch", daemon=True)
        self._thread.start()

    def submit(self, req: _BatchRequest) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("server is shutting down")
            self._queue.append(req)
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=60)

    def cancel(self, req: _BatchRequest) -> None:
        """Drop a timed-out request: still queued, it is removed (its
        session never advances); already in a run, the cancelled flag makes
        `_dispatch_lanes` skip its state write-back, so the client's retry
        of the same chunk is not applied twice."""
        with self._cv:
            req.cancelled = True
            self._queue = [r for r in self._queue if r is not req]

    def record_dispatch(self, lanes: int) -> None:
        """One batched run, serving ``lanes`` real lanes."""
        with self._cv:
            self.dispatches += 1
            self.lanes_served += lanes

    def stats(self) -> Dict[str, int]:
        with self._cv:
            return {"dispatches": self.dispatches, "lanes_served": self.lanes_served}

    def _take_batch(self) -> list:
        """Pop up to ``batch`` requests, one per distinct session (FIFO)."""
        taken, seen, remaining = [], set(), []
        for req in self._queue:
            if req.cancelled:
                continue
            if len(taken) < self.server.batch and req.sid not in seen:
                taken.append(req)
                seen.add(req.sid)
            else:
                remaining.append(req)
        self._queue = remaining
        return taken

    def _loop(self) -> None:
        if self.server.device.type == "cuda":
            torch.cuda.set_device(self.server.device)
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                # Short fill window: gather whatever arrives meanwhile.
                deadline = time.time() + self.window_s
                while len({r.sid for r in self._queue}) < self.server.batch and not self._closed:
                    left = deadline - time.time()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                batch = self._take_batch()
            if batch:
                self.server._dispatch_lanes(batch)


class PipelineServer:
    """Owns the artifact's runner, the sessions and the device lock."""

    def __init__(
        self,
        cfg=None,
        chunk: int = 64,
        artifact: Optional[bytes] = None,
        max_sessions: int = 64,
        batch: int = 1,
        batch_window_ms: float = 5.0,
        dp: int = 1,
        device="cuda",
    ):
        if cfg is None:
            # Serving ships only _OUTPUT_KEYS; the candidates and rings
            # would be stacked a frame and then discarded.
            cfg = DEFAULT_CONFIG.replace(emit_candidates=False, emit_trajectories=False)
        self.cfg = cfg
        self.chunk = int(chunk)
        self.batch = int(batch)
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.dp = int(dp)
        if self.dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        if self.dp > 1 and self.batch % self.dp != 0:
            raise ValueError(f"batch={batch} must be a multiple of dp={dp}")
        self.device = resolve_device(device)
        self.rank = dist.get_rank() if self.dp > 1 and dist.is_initialized() else 0
        t0 = time.time()
        if artifact is None:
            artifact = export_sequence_runner(
                cfg, self.chunk, platforms=(self.device.type,), batch=self.batch, dp=self.dp
            )
        self.export_seconds = time.time() - t0
        self.artifact_bytes = len(artifact)
        t0 = time.time()
        # With dp > 1 the runner refuses a context without dp ranks.
        self.run = deserialize_runner(artifact, cfg, self.chunk, batch=self.batch, dp=self.dp,
                                      device=str(self.device))
        self.load_seconds = time.time() - t0
        self._initial_state = lambda: initial_state(self.cfg, self.device)
        # Requests are per-session chunks: the specs stay unbatched even on
        # a batched server (lanes stack at dispatch).
        self._example = example_sequence_inputs(self.cfg, self.chunk)
        self.sessions: "OrderedDict[str, Any]" = OrderedDict()  # LRU order
        self.max_sessions = int(max_sessions)
        self._next_id = 0
        self._lock = threading.Lock()  # one run at a time
        # Warm up before the socket binds: the first run builds the kernels.
        t0 = time.time()
        zeros = {k: np.zeros(spec.shape, _NUMPY_DTYPES[spec.dtype]) for k, spec in self._example.items()}
        with self._on_device():
            if self.dp > 1:
                self._lanes = _RankLanes(self, zeros)
            elif self.batch > 1:
                state = stack_lanes([self._initial_state()] * self.batch)
                _, outs = self.run(state, {k: np.stack([v] * self.batch) for k, v in zeros.items()})
                _to_host({"plan_best": outs["plan_best"]})
            else:
                _, outs = self.run(self._initial_state(), zeros)
                _to_host({"plan_best": outs["plan_best"]})
        self.warmup_seconds = time.time() - t0
        self.batcher: Optional[_MicroBatcher] = (
            _MicroBatcher(self, window_s=batch_window_ms / 1e3) if self.batch > 1 and self.rank == 0 else None
        )
        self.started_at = time.time()
        self.request_counts: Dict[str, int] = {}
        self._infer_seconds: list = []  # the last <= 1024 inference wall times

    def _on_device(self):
        """The server's card as the current device, in any thread."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()

    def close(self) -> None:
        """Stop the batcher and, on rank 0 of a dp server, the other ranks'
        `serve_worker` loops."""
        if self.batcher is not None:
            self.batcher.close()
            self.batcher = None
            if self.dp > 1:
                with self._on_device():
                    self._lanes.stop()

    def serve_worker(self) -> None:
        """Ranks 1..dp-1 of a dp server: run this rank's lanes of each run
        rank 0 dispatches, until rank 0 closes."""
        if self.dp == 1 or self.rank == 0:
            raise RuntimeError("serve_worker runs on ranks 1..dp-1 of a dp server")
        with self._on_device():
            while self._lanes.run_shard():
                pass

    # -- session management -------------------------------------------------
    def _add_session(self, state) -> str:
        with self._lock:
            while len(self.sessions) >= self.max_sessions:
                self.sessions.popitem(last=False)  # evict the least recently used
            sid = f"s{self._next_id}"
            self._next_id += 1
            self.sessions[sid] = state
        return sid

    def create_session(self) -> str:
        return self._add_session(self._initial_state())

    def reset_session(self, sid: str) -> None:
        with self._lock:
            if sid not in self.sessions:
                raise KeyError(sid)
            self.sessions[sid] = self._initial_state()
            self.sessions.move_to_end(sid)

    def delete_session(self, sid: str) -> None:
        with self._lock:
            if sid not in self.sessions:
                raise KeyError(sid)
            del self.sessions[sid]

    def count_request(self, route: str) -> None:
        with self._lock:
            self.request_counts[route] = self.request_counts.get(route, 0) + 1

    def metrics(self) -> Dict:
        with self._lock:
            lat = sorted(self._infer_seconds)
            counts = dict(self.request_counts)
            n_sessions = len(self.sessions)

        def pct(p: float):
            if not lat:
                return None
            return round(lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3, 3)

        out = {
            "uptime_seconds": round(time.time() - self.started_at, 1),
            "warmup_seconds": round(self.warmup_seconds, 2),
            "sessions": n_sessions,
            "requests": counts,
            "infer_latency_ms": {"count": len(lat), "p50": pct(0.5), "p99": pct(0.99)},
            "frames_per_chunk": self.chunk,
        }
        if self.batcher is not None:
            out["batching"] = {"batch": self.batch, "dp": self.dp, **self.batcher.stats()}
        return out

    def export_session(self, sid: str) -> Dict[str, np.ndarray]:
        """The session's state as named arrays ``leaf0..leafN`` in the JAX
        package's leaf order (npz-able)."""
        with self._lock:
            if sid not in self.sessions:
                raise KeyError(sid)
            state = self.sessions[sid]
            self.sessions.move_to_end(sid)
        with self._on_device():
            return _to_host({f"leaf{i}": leaf for i, leaf in enumerate(tree_leaves(state))})

    def import_session(self, arrays: Dict[str, np.ndarray]) -> str:
        """Restore an exported state, from this server or another (the JAX
        package's included), into a new session."""
        template = self._initial_state()
        n = len(tree_leaves(template))
        if sorted(arrays) != sorted(f"leaf{i}" for i in range(n)):
            raise ValueError(
                f"expected {n} state leaves named leaf0..leaf{n - 1}; got {sorted(arrays)[:5]}..."
            )
        state = state_from_leaves([arrays[f"leaf{i}"] for i in range(n)], template)
        return self._add_session(state)

    # -- inference ----------------------------------------------------------
    def _validate_inputs(self, arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        missing = [k for k in self._example if k not in arrays]
        if missing:
            raise ValueError(f"missing inputs: {missing}")
        inputs = {}
        for k, spec in self._example.items():
            a = np.asarray(arrays[k])
            if tuple(a.shape) != tuple(spec.shape):
                raise ValueError(f"input {k!r}: expected shape {tuple(spec.shape)}, got {a.shape}")
            inputs[k] = a.astype(_NUMPY_DTYPES[spec.dtype], copy=False)
        return inputs

    def _collect_result(self, outs) -> Dict[str, np.ndarray]:
        """The served outputs of a run on the host, with one
        synchronisation for all of them (a leading lane axis kept)."""
        return _to_host(_served(outs))

    def _record_latency(self, seconds: float) -> None:
        with self._lock:
            self._infer_seconds.append(seconds)
            if len(self._infer_seconds) > 1024:
                del self._infer_seconds[:-1024]

    def _dispatch_lanes(self, requests: list) -> None:
        """One batched run over the queued requests (each a distinct
        session).  Lanes beyond len(requests) repeat lane 0; their outputs
        are discarded.  Called from the _MicroBatcher thread."""
        with self._lock:
            live = []
            for req in requests:
                state = self.sessions.get(req.sid)
                if state is None:
                    req.error = KeyError(req.sid)
                    req.event.set()
                else:
                    live.append((req, state))
            if not live:
                return
            try:
                pad = self.batch - len(live)
                lane_states = [s for _, s in live] + [live[0][1]] * pad
                lane_inputs = [r.inputs for r, _ in live] + [live[0][0].inputs] * pad
                stacked = {k: np.stack([li[k] for li in lane_inputs]) for k in lane_inputs[0]}
                if self.dp > 1:
                    new_state, served = self._lanes.run_all(stack_lanes(lane_states), stacked)
                    host = _to_host(served)
                else:
                    new_state, outs = self.run(stack_lanes(lane_states), stacked)
                    host = self._collect_result(outs)
                for i, (req, _) in enumerate(live):
                    if req.cancelled:  # the waiter timed out mid-run: the
                        continue  # session must not silently advance
                    self.sessions[req.sid] = lane_of(new_state, i)
                    self.sessions.move_to_end(req.sid)
                    req.outs = {k: v[i] for k, v in host.items()}
                self.batcher.record_dispatch(sum(1 for r, _ in live if not r.cancelled))
            except Exception as e:  # noqa: BLE001 -- surface to every waiter
                for req, _ in live:
                    req.error = e
        for req, _ in live:
            req.event.set()

    def infer(self, sid: str, arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        inputs = self._validate_inputs(arrays)
        t0 = time.time()

        if self.batcher is not None:
            req = _BatchRequest(sid, inputs)
            self.batcher.submit(req)
            if not req.event.wait(timeout=600):
                self.batcher.cancel(req)
                raise TimeoutError("batched dispatch did not complete in 600s")
            if req.error is not None:
                raise req.error
            self._record_latency(time.time() - t0)
            return req.outs

        with self._lock, self._on_device():
            if sid not in self.sessions:
                raise KeyError(sid)
            new_state, outs = self.run(self.sessions[sid], inputs)
            self.sessions[sid] = new_state
            self.sessions.move_to_end(sid)
            result = self._collect_result(outs)
        self._record_latency(time.time() - t0)
        return result


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _npz_load(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class _HTTPServer(ThreadingHTTPServer):
    """The stdlib threading server with a listen backlog for many clients
    at once: each request opens a connection, and the default backlog of 5
    made the kernel reset connections when 8 sessions posted together
    (``tools/serve_loadgen.py --sessions 8``)."""

    request_queue_size = 128


def make_handler(server: PipelineServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            server.count_request(f"GET {path}")
            if path == "/metrics":
                self._json(200, server.metrics())
            elif path == "/healthz":
                self._json(
                    200,
                    {
                        "status": "ok",
                        "device": server.device.type,
                        "frames_per_chunk": server.chunk,
                        "batch": server.batch,
                        "dp": server.dp,
                    },
                )
            elif path == "/info":
                cfg = server.cfg
                self._json(
                    200,
                    {
                        "use_frames": cfg.use_frames,
                        "enable_tagging": cfg.enable_tagging,
                        "max_detections": cfg.detector.max_detections,
                        "max_tracks": cfg.tracker.max_tracks,
                        "frame_size": [cfg.frame_width, cfg.frame_height],
                        "artifact_bytes": server.artifact_bytes,
                        "sessions": len(server.sessions),
                        "max_sessions": server.max_sessions,
                    },
                )
            elif path == "/session_state":
                q = parse_qs(urlparse(self.path).query)
                try:
                    out = server.export_session(q["session"][0])
                    self._send(200, _npz_bytes(out), "application/octet-stream")
                except KeyError as e:
                    self._json(404, {"error": f"unknown session {e}"})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            server.count_request(f"POST {url.path}")
            q = parse_qs(url.query)
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            try:
                if url.path == "/session":
                    self._json(200, {"session": server.create_session()})
                elif url.path == "/reset":
                    server.reset_session(q["session"][0])
                    self._json(200, {"status": "reset"})
                elif url.path == "/infer":
                    out = server.infer(q["session"][0], _npz_load(body))
                    self._send(200, _npz_bytes(out), "application/octet-stream")
                elif url.path == "/session_state":
                    sid = server.import_session(_npz_load(body))
                    self._json(200, {"session": sid})
                else:
                    self._json(404, {"error": "not found"})
            except KeyError as e:
                self._json(404, {"error": f"unknown session {e}"})
            except Exception as e:  # noqa: BLE001 -- surface to the client
                self._json(400, {"error": str(e)})

        def do_DELETE(self):
            url = urlparse(self.path)
            server.count_request(f"DELETE {url.path}")
            q = parse_qs(url.query)
            try:
                if url.path == "/session":
                    server.delete_session(q["session"][0])
                    self._json(200, {"status": "deleted"})
                else:
                    self._json(404, {"error": "not found"})
            except KeyError as e:
                self._json(404, {"error": f"unknown session {e}"})

    return Handler


def serve(
    cfg=None,
    chunk: int = 64,
    port: int = 8701,
    block: bool = True,
    artifact: Optional[bytes] = None,
    host: str = "127.0.0.1",
    max_sessions: int = 64,
    batch: int = 1,
    batch_window_ms: float = 5.0,
    dp: int = 1,
    device="cuda",
):
    """Start the inference server; returns the HTTPServer when non-blocking
    (``port=0`` takes a free port: ``httpd.server_address``).  With ``dp >
    1`` every rank of the process group calls this: rank 0 serves HTTP,
    the other ranks run their lanes until rank 0 closes, and return None."""
    ps = PipelineServer(
        cfg=cfg,
        chunk=chunk,
        artifact=artifact,
        max_sessions=max_sessions,
        batch=batch,
        batch_window_ms=batch_window_ms,
        dp=dp,
        device=device,
    )
    if ps.rank != 0:
        ps.serve_worker()
        return None
    httpd = _HTTPServer((host, port), make_handler(ps))
    httpd.pipeline_server = ps
    batched = f", {batch}-session micro-batching" if batch > 1 else ""
    if dp > 1:
        batched += f", lanes over {dp} ranks"
    print(
        f"Serving the pipeline artifact ({ps.artifact_bytes} bytes) on {ps.device} ({chunk}-frame "
        f"chunks{batched}) on :{httpd.server_address[1]} (export {ps.export_seconds:.1f}s, "
        f"load {ps.load_seconds:.1f}s, warmup {ps.warmup_seconds:.1f}s)",
        flush=True,
    )
    if block:
        try:
            httpd.serve_forever()
        finally:
            ps.close()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="pipeline inference server")
    parser.add_argument("--port", type=int, default=8701)
    parser.add_argument("--chunk", type=int, default=64)
    parser.add_argument("--no-tagging", action="store_true")
    parser.add_argument(
        "--host", default="127.0.0.1", help="bind address; 0.0.0.0 only behind an authenticating proxy"
    )
    parser.add_argument("--max-sessions", type=int, default=64)
    parser.add_argument(
        "--batch",
        type=int,
        default=1,
        help="micro-batch size: coalesce concurrent /infer requests from up to B sessions into one run",
    )
    parser.add_argument(
        "--batch-window-ms", type=float, default=5.0, help="how long a run waits for more sessions to coalesce"
    )
    parser.add_argument(
        "--dp", type=int, default=1,
        help="ranks to spread each run's lanes over, one card a rank (start them with torchrun; "
        "--batch a multiple of --dp)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    cfg = DEFAULT_CONFIG.replace(
        use_frames=False,
        enable_tagging=not args.no_tagging,
        emit_candidates=False,
        emit_trajectories=False,
    )
    device = args.device
    if args.dp > 1:
        import os

        from ..parallel.distributed import init_ranks

        if int(os.environ.get("WORLD_SIZE", "1")) != args.dp:
            parser.error(
                f"--dp {args.dp} runs {args.dp} ranks: start them with "
                f"python -m torch.distributed.run --nproc-per-node {args.dp} -m {__spec__.name} --dp {args.dp} ..."
            )
        device = str(init_ranks(args.device))
    serve(
        cfg=cfg,
        chunk=args.chunk,
        port=args.port,
        host=args.host,
        max_sessions=args.max_sessions,
        batch=args.batch,
        batch_window_ms=args.batch_window_ms,
        dp=args.dp,
        device=device,
    )


if __name__ == "__main__":
    main()
