"""The port's inference server (apps/serve.py) against the JAX package's
runner, on the CPU.

The cases of tests/test_serve.py: sessions and chunk chaining over HTTP,
LRU eviction and delete, session export and import (a carry exported from
a JAX state too, and the port's carry continued by JAX), the micro-batched
server against JAX lane by lane and against the unbatched server, partial
fill and padding, timeout-cancel, stress chaining under jitter, the load
generator end to end, and the dp server over two gloo ranks (and refused
without them).  The server runs in the
serving configuration (detections mode, tagging on) with ``device="cpu"``,
where the kernels' plain versions run.  Each chunk's outputs are held to
the jitted JAX `make_sequence_runner` on the same chunks, chained:
discrete outputs and tags bit for bit, floats at atol 1e-4 (PARITY.md).
"""

import contextlib
import io
import json
import random
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch.apps.serve import (
    PipelineServer,
    _BatchRequest,
    _npz_bytes,
    _npz_load,
    serve,
)
from multimodal_autonomous_driving_perception_and_planning_torch.utils.export import export_sequence_runner
from multimodal_autonomous_driving_perception_and_planning_tpu.data.synthetic import (
    ego_motion_stream,
    simulated_detection_stream,
)

CHUNK = 4
ATOL = 1e-4
_VEHICLE = ("x", "y", "speed", "heading", "acceleration", "yaw_rate")
_SERVED = (
    "track_id", "track_bbox", "track_class_id", "track_confidence", "confirmed_order",
    "num_confirmed", "plan_best", "plan_best_positions", "plan_best_velocities",
)


def _config(pkg):
    return pkg.DEFAULT_CONFIG.replace(
        use_frames=False, enable_tagging=True, emit_candidates=False, emit_trajectories=False
    )


CFG = _config(pt)


def _chunk_arrays(start, n=CHUNK, seed=0):
    dets = simulated_detection_stream(n, start_frame_count=start + 1)
    ego = ego_motion_stream(start + n, dt=1.0 / 30.0, seed=seed)[start:]
    return {**dets, "ego_measurement": ego.astype(np.float32)}


def _session_chunks(seed, n_chunks, n=CHUNK):
    # Built on one thread: the synthetic streams draw from numpy's global RNG.
    return [_chunk_arrays(c * n, n, seed=seed) for c in range(n_chunks)]


@pytest.fixture(scope="module")
def artifact():
    """``artifact(batch)``: one exported artifact a lane count, shared by
    the file's servers; the servers of
    `test_serve_sessions_and_chunk_chaining` and
    `test_given_artifact_serves_as_an_exported_one` export their own."""
    made = {}

    def get(batch):
        if batch not in made:
            made[batch] = export_sequence_runner(CFG, CHUNK, platforms=("cpu",), batch=batch)
        return made[batch]

    return get


@pytest.fixture(scope="module")
def jax_run():
    """The jitted JAX runner in the serving configuration (one compile a
    chunk length)."""
    return pj.make_sequence_runner(_config(pj), donate=False)


def _served_jax(outs):
    """The JAX runner's outputs as the server returns them."""
    got = {k: np.asarray(outs[k]) for k in _SERVED}
    got.update({f"vehicle_{f}": np.asarray(getattr(outs["vehicle_state"], f)) for f in _VEHICLE})
    got.update({f"tag_{k}": np.asarray(v) for k, v in outs["tags"].items()})
    return got


def _jax_chain(jax_run, chunks, state=None):
    """Each chunk's served outputs from the JAX runner, the state chained."""
    state = pj.initial_state(_config(pj)) if state is None else state
    served = []
    for c in chunks:
        state, outs = jax_run(state, {k: jnp.asarray(v) for k, v in c.items()})
        served.append(_served_jax(outs))
    return state, served


def _assert_matches_jax(got, want, where):
    assert sorted(got) == sorted(want), (where, set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (where, k)
        if want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=f"{where}: {k}")
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where}: {k}")


def _assert_state_matches_jax(exported, state_j, where):
    """A session's exported leaves against a JAX state's: the track table's
    ids, lifecycle counters and rings, the filter, lanes and tagging
    memory; integers and flags exact, floats within ATOL."""
    leaves = jax.tree_util.tree_leaves(state_j)
    assert sorted(exported) == sorted(f"leaf{i}" for i in range(len(leaves)))
    for i, want in enumerate(leaves):
        _assert_matches_jax({"leaf": exported[f"leaf{i}"]}, {"leaf": np.asarray(want)}, f"{where}: leaf{i}")


def _assert_equal(got, want, where):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where}: {k}")


def _drive(ps, sids, chunks, jitter=None):
    """Each session's chunks in order, the sessions concurrently; returns
    {session: [outputs a chunk]}."""
    got = {s: [None] * len(chunks[s]) for s in sids}
    errors = []

    def run(s):
        try:
            for c, arrays in enumerate(chunks[s]):
                if jitter is not None:
                    time.sleep(jitter[s].uniform(0.0, 0.02))
                got[s][c] = ps.infer(sids[s], arrays)
        except Exception as e:  # noqa: BLE001
            errors.append(f"session {s}: {e!r}")

    threads = [threading.Thread(target=run, args=(s,)) for s in sids]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads), "a client thread did not finish"
    assert not errors, errors
    return got


def _post(url, data=b""):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read(), r.headers.get("Content-Type", "")


def test_serve_sessions_and_chunk_chaining(jax_run):
    httpd = serve(cfg=CFG, chunk=CHUNK, port=0, block=False, device="cpu")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "device": "cpu", "frames_per_chunk": CHUNK, "batch": 1, "dp": 1}
        with urllib.request.urlopen(f"{base}/info", timeout=60) as r:
            info = json.loads(r.read())
        assert info["artifact_bytes"] == httpd.pipeline_server.artifact_bytes > 0
        assert info["use_frames"] is False
        assert info["max_detections"] == CFG.detector.max_detections
        assert info["frame_size"] == [CFG.frame_width, CFG.frame_height]

        sid = json.loads(_post(f"{base}/session")[0])["session"]
        chunks = _session_chunks(0, 2)
        outs = []
        for arrays in chunks:
            raw, ctype = _post(f"{base}/infer?session={sid}", _npz_bytes(arrays))
            assert ctype == "application/octet-stream"
            outs.append(_npz_load(raw))

        # The two chunks chain as the JAX runner's state does.
        _, want = _jax_chain(jax_run, chunks)
        for c in range(2):
            _assert_matches_jax(outs[c], want[c], f"chunk {c}")

        # Reset gives a fresh run: chunk 0 again reproduces chunk 0.
        _post(f"{base}/reset?session={sid}")
        again = _npz_load(_post(f"{base}/infer?session={sid}", _npz_bytes(chunks[0]))[0])
        _assert_equal(again, outs[0], "after reset")

        # Shape errors answer 400 with a message; unknown sessions 404.
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/infer?session={sid}", _npz_bytes({"bbox": np.zeros((3, 2))}))
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/infer?session=nope", _npz_bytes(chunks[0]))
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.pipeline_server.close()


def test_given_artifact_serves_as_an_exported_one(jax_run, artifact):
    """A server given artifact bytes serves what a server that exported its
    own at startup serves, chunk for chunk, and both serve JAX's outputs."""
    own = PipelineServer(cfg=CFG, chunk=CHUNK, device="cpu")
    given = PipelineServer(cfg=CFG, chunk=CHUNK, artifact=artifact(1), device="cpu")
    assert own.artifact_bytes > 0 and given.artifact_bytes == len(artifact(1))
    chunks = _session_chunks(5, 2)
    sid_own, sid_given = own.create_session(), given.create_session()
    _, want = _jax_chain(jax_run, chunks)
    for c, arrays in enumerate(chunks):
        got = given.infer(sid_given, arrays)
        _assert_equal(got, own.infer(sid_own, arrays), f"chunk {c}")
        _assert_matches_jax(got, want[c], f"chunk {c}")


def test_session_lru_eviction_and_delete(artifact):
    ps = PipelineServer(cfg=CFG, chunk=CHUNK, artifact=artifact(1), max_sessions=3, device="cpu")
    sids = [ps.create_session() for _ in range(3)]
    assert len(ps.sessions) == 3
    ps.reset_session(sids[0])  # s1 becomes the least recently used
    s_new = ps.create_session()
    assert len(ps.sessions) == 3
    assert sids[1] not in ps.sessions
    assert sids[0] in ps.sessions and s_new in ps.sessions
    ps.delete_session(s_new)
    assert s_new not in ps.sessions
    with pytest.raises(KeyError):
        ps.delete_session(s_new)


def test_session_export_import_continues_exactly(jax_run, artifact):
    ps = PipelineServer(cfg=CFG, chunk=CHUNK, artifact=artifact(1), max_sessions=4, device="cpu")
    sid = ps.create_session()
    chunks = _session_chunks(0, 2)
    ps.infer(sid, chunks[0])
    exported = _npz_load(_npz_bytes(ps.export_session(sid)))  # npz round trip
    assert sorted(exported) == sorted(f"leaf{i}" for i in range(30))

    out_live = ps.infer(sid, chunks[1])
    sid2 = ps.import_session(exported)
    _assert_equal(ps.infer(sid2, chunks[1]), out_live, "restored session")
    _, want = _jax_chain(jax_run, chunks)
    _assert_matches_jax(out_live, want[1], "chunk 1")

    with pytest.raises(ValueError, match="leaf"):
        ps.import_session({"leaf0": np.zeros(3)})
    m = ps.metrics()
    assert m["infer_latency_ms"]["count"] == 3 and m["infer_latency_ms"]["p50"] > 0
    assert m["sessions"] == 2 and m["uptime_seconds"] >= 0
    ps.count_request("GET /healthz")
    assert ps.metrics()["requests"] == {"GET /healthz": 1}


def test_carry_crosses_between_jax_and_the_port(jax_run, artifact):
    """A JAX state exported as leaf0..leafN (jax.tree_util.tree_leaves
    order) imports into the port's server and continues as JAX does; the
    port's exported carry continues in JAX the same way."""
    chunks = _session_chunks(3, 3)
    state_j, want = _jax_chain(jax_run, chunks[:2])
    mid_j = pj.initial_state(_config(pj))
    mid_j, _ = jax_run(mid_j, {k: jnp.asarray(v) for k, v in chunks[0].items()})

    ps = PipelineServer(cfg=CFG, chunk=CHUNK, artifact=artifact(1), device="cpu")
    carry = {f"leaf{i}": np.asarray(leaf) for i, leaf in enumerate(jax.tree_util.tree_leaves(mid_j))}
    sid = ps.import_session(_npz_load(_npz_bytes(carry)))
    _assert_matches_jax(ps.infer(sid, chunks[1]), want[1], "JAX carry in the port")

    exported = ps.export_session(sid)
    treedef = jax.tree_util.tree_structure(mid_j)
    back = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(exported[f"leaf{i}"]) for i in range(len(exported))])
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(state_j)):
        assert a.dtype == b.dtype and a.shape == b.shape
    _, cont = _jax_chain(jax_run, chunks[2:], state=back)
    _, ref = _jax_chain(jax_run, chunks[2:], state=state_j)
    _assert_matches_jax(cont[0], ref[0], "port carry in JAX")
    _assert_matches_jax(ps.infer(sid, chunks[2]), ref[0], "port continues")


def test_microbatched_server_matches_jax_and_coalesces(jax_run, artifact):
    """--batch 3 with 3 sessions x 2 chained chunks: each lane equals the
    JAX runner and the port's unbatched server; concurrent requests
    coalesce into fewer runs than requests."""
    seeds = (0, 7, 11)
    chunks = {s: _session_chunks(s, 2) for s in seeds}
    ref = PipelineServer(cfg=CFG, chunk=CHUNK, artifact=artifact(1), max_sessions=4, batch=1, device="cpu")
    # A generous window: the first chunks of all three must land in one run.
    ps = PipelineServer(cfg=CFG, chunk=CHUNK, artifact=artifact(3), max_sessions=4, batch=3, batch_window_ms=500.0, device="cpu")
    try:
        expected = {}
        for s in seeds:
            rsid = ref.create_session()
            expected[s] = [ref.infer(rsid, c) for c in chunks[s]]
        sids = {s: ps.create_session() for s in seeds}
        got = _drive(ps, sids, chunks)
        for s in seeds:
            state_j, want = _jax_chain(jax_run, chunks[s])
            for c in range(2):
                _assert_matches_jax(got[s][c], want[c], f"seed {s} chunk {c}")
                _assert_equal(got[s][c], expected[s][c], f"seed {s} chunk {c} unbatched")
            _assert_state_matches_jax(ps.export_session(sids[s]), state_j, f"seed {s} state")
        m = ps.metrics()["batching"]
        assert m["batch"] == 3 and m["lanes_served"] == 6
        assert 2 <= m["dispatches"] < 6
        with pytest.raises(KeyError):
            ps.infer("nope", chunks[0][0])
    finally:
        ps.close()


def test_batched_partial_fill_and_padding(jax_run, artifact):
    """One request on a batch-4 server (lanes padded with lane 0) gives
    exactly the unbatched result, and JAX's."""
    ref = PipelineServer(cfg=CFG, chunk=CHUNK, artifact=artifact(1), max_sessions=2, batch=1, device="cpu")
    ps = PipelineServer(cfg=CFG, chunk=CHUNK, artifact=artifact(4), max_sessions=2, batch=4, batch_window_ms=1.0, device="cpu")
    try:
        chunk = _chunk_arrays(0)
        expected = ref.infer(ref.create_session(), chunk)
        got = ps.infer(ps.create_session(), chunk)
        _assert_equal(got, expected, "padded lane")
        _assert_matches_jax(got, _jax_chain(jax_run, [chunk])[1][0], "padded lane against JAX")
        assert ps.metrics()["batching"]["dispatches"] == 1
    finally:
        ps.close()


def test_batched_timeout_cancel_never_advances_session(jax_run, artifact):
    ref = PipelineServer(cfg=CFG, chunk=CHUNK, artifact=artifact(1), max_sessions=2, batch=1, device="cpu")
    ps = PipelineServer(cfg=CFG, chunk=CHUNK, artifact=artifact(2), max_sessions=2, batch=2, batch_window_ms=1000.0, device="cpu")
    try:
        chunk0 = _chunk_arrays(0)
        expected = ref.infer(ref.create_session(), chunk0)
        sid = ps.create_session()
        # What infer() does when its wait times out: enqueue, then cancel.
        req = _BatchRequest(sid, ps._validate_inputs(chunk0))
        ps.batcher.submit(req)
        ps.batcher.cancel(req)
        got = ps.infer(sid, chunk0)
        _assert_equal(got, expected, "after a cancelled request")
        _assert_matches_jax(got, _jax_chain(jax_run, [chunk0])[1][0], "after a cancelled request, against JAX")
        assert ps.metrics()["batching"]["lanes_served"] == 1
    finally:
        ps.close()


def test_microbatch_stress_chaining_under_jitter(jax_run, artifact):
    """6 sessions x 4 chained chunks with jittered arrivals on a batch-4
    server: every chunk of every session as the JAX runner chains it."""
    n_sessions, n_chunks = 6, 4
    chunks = {s: _session_chunks(s, n_chunks) for s in range(n_sessions)}
    ps = PipelineServer(cfg=CFG, chunk=CHUNK, artifact=artifact(4), max_sessions=n_sessions, batch=4, batch_window_ms=5.0, device="cpu")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the client and dispatcher threads finely
    try:
        jitter = {s: random.Random(100 + s) for s in range(n_sessions)}
        got = _drive(ps, {s: ps.create_session() for s in range(n_sessions)}, chunks, jitter)
        for s in range(n_sessions):
            _, want = _jax_chain(jax_run, chunks[s])
            for c in range(n_chunks):
                _assert_matches_jax(got[s][c], want[c], f"session {s} chunk {c}")
        m = ps.metrics()["batching"]
        assert m["lanes_served"] == n_sessions * n_chunks
        assert m["dispatches"] <= n_sessions * n_chunks
    finally:
        sys.setswitchinterval(switch)
        ps.close()


def test_serve_loadgen_end_to_end(artifact):
    """tools/serve_loadgen.py drives the port's batched server over HTTP
    and reports a clean JSON line, coalescing seen in the server's metrics."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    try:
        import serve_loadgen
    finally:
        sys.path.pop(0)
    httpd = serve(cfg=CFG, chunk=CHUNK, artifact=artifact(2), port=0, block=False, batch=2, batch_window_ms=100.0, device="cpu")
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve_loadgen.main(
                ["--url", f"http://127.0.0.1:{httpd.server_address[1]}", "--sessions", "2", "--chunks", "2"]
            )
        assert rc == 0
        out = json.loads(buf.getvalue())
        assert out["metric"] == "serve_http_fps" and out["value"] > 0
        assert out["completed_requests"] == 4 and not out["errors"]
        assert out["warmup_chunks"] == 1
        m = out["server_metrics"]["batching"]
        assert m["lanes_served"] == 5 and m["dispatches"] >= 3
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.pipeline_server.close()


def test_dp_above_one_is_refused():
    """A dp server needs a process group of dp ranks (test_dp_server_*
    runs one): without one, dp > 1 raises, naming the group; a batch that
    does not split over dp and a batch of 0 raise at construction."""
    with pytest.raises(ValueError, match="dp=2 over the 1 rank.*no torch.distributed process group"):
        PipelineServer(cfg=CFG, chunk=CHUNK, batch=4, dp=2, device="cpu")
    with pytest.raises(ValueError, match="multiple of dp=2"):
        PipelineServer(cfg=CFG, chunk=CHUNK, batch=3, dp=2, device="cpu")
    with pytest.raises(ValueError):
        PipelineServer(cfg=CFG, chunk=CHUNK, batch=0, device="cpu")


def test_dp_server_matches_jax_and_the_unbatched_server(jax_run, artifact, tmp_path):
    """tests/test_serve.py's dp case: a dp=2, batch=4 server over two gloo
    ranks, two sessions driven concurrently for two chained chunks each,
    so that lanes of states gathered from both ranks feed the next run:
    every served output equals the unbatched server's bit for bit and
    JAX's runner (discrete bit for bit, floats within ATOL), each
    session's state JAX's, and the run spans both ranks."""
    import test_torch_ranks as ranks

    from multimodal_autonomous_driving_perception_and_planning_torch.parallel.distributed import spawn

    seeds = (0, 7)
    chunks = {s: _session_chunks(s, 2) for s in seeds}
    got = spawn(ranks.dp_server_rank, 2, str(tmp_path), CFG, CHUNK, 4, chunks, backend="gloo",
                threads=1, timeout=ranks.RANK_TIMEOUT)
    assert got[1] is None
    got = got[0]
    assert not got["errors"] and not got["alive"], got["errors"]
    ref = PipelineServer(cfg=CFG, chunk=CHUNK, artifact=artifact(1), max_sessions=2, batch=1, device="cpu")
    for s in seeds:
        rsid = ref.create_session()
        state_j, want = _jax_chain(jax_run, chunks[s])
        for c in range(2):
            _assert_equal(got["got"][s][c], ref.infer(rsid, chunks[s][c]), f"seed {s} chunk {c} unbatched")
            _assert_matches_jax(got["got"][s][c], want[c], f"seed {s} chunk {c}")
        _assert_state_matches_jax(got["states"][s], state_j, f"seed {s} state")
    m = got["batching"]
    assert (m["dp"], m["batch"], m["lanes_served"]) == (2, 4, 4) and m["dispatches"] >= 2


def test_dp_artifact_runs_each_ranks_lanes(tmp_path):
    """A dp=2, batch=4 artifact: each of two ranks runs its 2 lanes of the
    whole batch and returns them as DTensors, whose gathered whole equals
    the batch-4 artifact's run bit for bit; in one process (a single-rank
    context) it is refused."""
    import test_torch_ranks as ranks

    from multimodal_autonomous_driving_perception_and_planning_torch.parallel.distributed import spawn
    from multimodal_autonomous_driving_perception_and_planning_torch.types import stack_lanes, tree_leaves

    data = export_sequence_runner(CFG, CHUNK, platforms=("cpu",), batch=4, dp=2)
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.export import deserialize_runner

    with pytest.raises(ValueError, match="process group"):
        deserialize_runner(data, CFG, CHUNK, batch=4, dp=2, device="cpu")
    streams = [_chunk_arrays(0, seed=s) for s in (0, 3, 5, 7)]
    inputs = {k: np.stack([st[k] for st in streams]) for k in streams[0]}
    state = stack_lanes([pt.initial_state(CFG, device="cpu")] * 4)
    leaves = [t.numpy() for t in tree_leaves(state)]
    got = spawn(ranks.dp_runner_rank, 2, str(tmp_path), data, CFG, CHUNK, 4, leaves, inputs, backend="gloo",
                threads=1, timeout=ranks.RANK_TIMEOUT)
    batch4 = export_sequence_runner(CFG, CHUNK, platforms=("cpu",), batch=4)
    want_state, want = deserialize_runner(batch4, CFG, CHUNK, batch=4)(state, inputs)
    for rank, r in enumerate(got):
        assert r["lanes_per_rank"] == 2
        np.testing.assert_array_equal(r["local_track_id"], want["track_id"][2 * rank : 2 * rank + 2].numpy())
        whole_state, whole = r["whole"]
        for a, b in zip(tree_leaves(whole_state), tree_leaves(want_state)):
            np.testing.assert_array_equal(a, b.numpy())
        for k in ("track_id", "plan_costs", "num_confirmed"):
            np.testing.assert_array_equal(whole[k], want[k].numpy(), err_msg=k)
        for k, v in want["tags"].items():
            np.testing.assert_array_equal(whole["tags"][k], v.numpy(), err_msg=k)


def test_many_clients_connect_at_once(artifact):
    """128 clients open their connections at once, three times: every
    request is answered within 10 s.  Each request is a connection, and the stdlib server's
    default listen backlog of 5 made the kernel drop or reset the
    overflow (the load generator's 8 sessions saw a reset on the card)."""
    httpd = serve(cfg=CFG, chunk=CHUNK, artifact=artifact(1), port=0, block=False, device="cpu")
    url = f"http://127.0.0.1:{httpd.server_address[1]}/healthz"
    try:
        for _ in range(3):
            n, errors = 128, []
            barrier = threading.Barrier(n)

            def get():
                try:
                    barrier.wait(timeout=30)
                    with urllib.request.urlopen(url, timeout=10) as r:
                        assert json.loads(r.read())["status"] == "ok"
                except Exception as e:  # noqa: BLE001
                    errors.append(repr(e))

            threads = [threading.Thread(target=get) for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors[:3]
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.pipeline_server.close()


def test_server_runs_on_the_card_by_default():
    """No device given: the server takes the card, and refuses without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal shows only without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineServer(cfg=CFG, chunk=CHUNK)
