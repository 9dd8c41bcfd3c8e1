"""The port's native frame ring and chunked stream driver.

tests/test_runtime.py's 11 cases on the port (its own copy of
frame_ring.cpp, built at first use into ``runtime/build/``), and against
the JAX package: the port's ring gives JAX's ring's bytes in synthetic and
raw-file modes; `run_stream` on the CPU over a raw file (120x160, 20
frames, chunk 8, so the last chunk is padded) gives one whole run of the
port's runner exactly, and JAX's `run_stream` on the same file with
discrete outputs equal and floats within atol 1e-4 (PARITY.md), lane fits
by their x at three rows within 1e-3 px; `next_batch_into` fills a tensor
in place.
"""

import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn_t
from multimodal_autonomous_driving_perception_and_planning_torch.runtime import NativeFrameSource, build_runtime
from multimodal_autonomous_driving_perception_and_planning_torch.runtime.stream import run_stream
from multimodal_autonomous_driving_perception_and_planning_tpu.data.frames import SyntheticRoadGenerator as RoadJ
from multimodal_autonomous_driving_perception_and_planning_tpu.runtime import NativeFrameSource as SourceJ
from multimodal_autonomous_driving_perception_and_planning_tpu.runtime.stream import run_stream as run_stream_j

ATOL = 1e-4
X_ATOL = 1e-3
DISCRETE = ("track_id", "track_class_id", "track_hits", "track_misses", "track_age", "track_vel_count",
            "confirmed_order", "num_confirmed", "match", "plan_best")
FLOAT = ("track_bbox", "track_confidence", "track_velocity", "plan_costs", "plan_best_positions",
         "plan_best_velocities")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_builds_and_streams_synthetic():
    build_runtime()
    with NativeFrameSource(width=320, height=240, slots=4, num_frames=10) as src:
        frames = []
        while True:
            f = src.next_frame()
            if f is None:
                break
            frames.append(f)
        assert len(frames) == 10
        assert frames[0].shape == (240, 320, 3)
        assert frames[0][0, 0, 0] > 150  # bright sky blue channel
        assert frames[0][-1, 0, 1] in (60, 110)  # road gray or grass green
        assert not np.array_equal(frames[0], frames[9])  # the drifting vehicle
        assert src.produced == 10 and src.consumed == 10


def test_batch_drain_overlaps_producer():
    with NativeFrameSource(width=160, height=120, slots=4, num_frames=25) as src:
        b1 = src.next_batch(10)
        b2 = src.next_batch(10)
        b3 = src.next_batch(10)  # only 5 left
        assert b1.shape == (10, 120, 160, 3)
        assert b2.shape[0] == 10
        assert b3.shape[0] == 5
        assert src.consumed == 25


def test_rawfile_mode_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (6, 60, 80, 3), np.uint8)
    raw = tmp_path / "frames.raw"
    raw.write_bytes(frames.tobytes())
    with NativeFrameSource(width=80, height=60, slots=3, num_frames=6, raw_path=str(raw)) as src:
        np.testing.assert_array_equal(src.next_batch(6), frames)
        assert src.next_frame(timeout_ms=200) is None


def test_rawfile_truncated_stream_ends_cleanly(tmp_path):
    raw = tmp_path / "short.raw"
    raw.write_bytes(np.zeros((3, 60, 80, 3), np.uint8).tobytes())
    with NativeFrameSource(width=80, height=60, slots=3, num_frames=10, raw_path=str(raw)) as src:
        assert src.next_batch(10).shape[0] == 3


def test_missing_rawfile_raises(tmp_path):
    """A bad raw path is an error, not a silent empty stream."""
    with pytest.raises(FileNotFoundError):
        NativeFrameSource(width=80, height=60, slots=3, num_frames=5, raw_path=str(tmp_path / "nope.raw"))


def test_invalid_ring_dimensions_raise():
    for kw in ({"slots": 0}, {"width": 0}, {"height": -1}):
        with pytest.raises(ValueError):
            NativeFrameSource(num_frames=1, **kw)


def test_incremental_ego_motion_bit_identical():
    """IncrementalEgoMotion chunks equal one monolithic seed-0 stream, bit
    for bit (the chunked stream driver depends on it)."""
    want = syn_t.ego_motion_stream(100, dt=1.0 / 30.0, seed=0)
    inc = syn_t.IncrementalEgoMotion(dt=1.0 / 30.0, seed=0)
    got = np.concatenate([inc.take(n) for n in (7, 1, 30, 62)])
    np.testing.assert_array_equal(got, want)


def _stream_case(tmp_path, h=120, w=160, total=20):
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=True, enable_tagging=True, frame_height=h, frame_width=w)
    frames = RoadJ(width=w, height=h).generate_frames(total)
    raw = tmp_path / "clip.raw"
    raw.write_bytes(frames.tobytes())
    return cfg, frames, raw


def _port_stream(cfg, raw, total, chunk, h=120, w=160, **kw):
    with NativeFrameSource(width=w, height=h, slots=4, num_frames=total, raw_path=str(raw), **kw) as src:
        return run_stream(cfg, src, total, chunk=chunk, device="cpu")


def test_run_stream_chunked_matches_monolithic_scan(tmp_path):
    """Chunked streaming (native ring -> the runner with state chained
    across chunks, the last chunk padded) equals one whole run exactly."""
    total, chunk = 20, 8  # 8 + 8 + 4
    cfg, frames, raw = _stream_case(tmp_path, total=total)
    outs, stats = _port_stream(cfg, raw, total, chunk)
    assert stats["frames"] == total and stats["fps"] > 0 and stats["decode_s"] >= 0

    dets = syn_t.simulated_detection_stream(total, height=120, width=160, capacity=cfg.detector.max_detections)
    inputs = dict(dets, ego_measurement=syn_t.ego_motion_stream(total, seed=0).astype(np.float32), frame=frames)
    _, ref = pt.make_sequence_runner(cfg, device="cpu")(pt.initial_state(cfg, device="cpu"), inputs)
    for k, v in ref.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(outs[k], v), k
    for k, v in ref["tags"].items():
        assert torch.equal(outs["tags"][k], v), k
    for name in ("lane_obs", "vehicle_state"):
        for a, b in zip(pt.types.tree_leaves(outs[name]), pt.types.tree_leaves(ref[name])):
            assert torch.equal(a, b), name


def test_native_frames_feed_lane_detector():
    """The C++ synthetic frames exercise the port's lane step."""
    from multimodal_autonomous_driving_perception_and_planning_torch.perception.lanes import make_lane_step
    from multimodal_autonomous_driving_perception_and_planning_torch.types import LaneState

    with NativeFrameSource(width=640, height=480, slots=4, num_frames=1) as src:
        frame = src.next_frame()
    step = make_lane_step(pt.DEFAULT_CONFIG, "cpu")
    _, obs, _ = step(LaneState.initial("cpu"), torch.from_numpy(frame.astype(np.int32)))
    assert bool(obs.left_found) and bool(obs.right_found)


def test_multithreaded_producers_are_order_and_content_exact():
    """N producer threads fill disjoint sequenced slots: the drained stream
    is byte-identical to the single-thread stream, in frame order."""
    n = 48
    with NativeFrameSource(width=320, height=240, num_frames=n, slots=8, threads=1) as one:
        want = one.next_batch(n)
    with NativeFrameSource(width=320, height=240, num_frames=n, slots=8, threads=6) as many:
        got = many.next_batch(n)
    assert want.shape[0] == n and got.shape[0] == n
    np.testing.assert_array_equal(got, want)


def test_multithreaded_rawfile_pread(tmp_path):
    """Raw-file mode preads frame offsets from per-thread descriptors:
    order-exact under concurrency, truncation still ends the stream."""
    w, h, n = 64, 32, 20
    frames = np.random.default_rng(0).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    raw = tmp_path / "frames.raw"
    raw.write_bytes(frames.tobytes())
    with NativeFrameSource(width=w, height=h, num_frames=n, slots=4, raw_path=str(raw), threads=4) as src:
        np.testing.assert_array_equal(src.next_batch(n), frames)
    with NativeFrameSource(width=w, height=h, num_frames=n + 7, slots=4, raw_path=str(raw), threads=4) as src:
        got = src.next_batch(n + 7, timeout_ms=2000)
    assert got.shape[0] == n
    np.testing.assert_array_equal(got, frames)


# --- against the JAX package -------------------------------------------------


@pytest.mark.parametrize("threads", [1, 4])
def test_ring_gives_jax_rings_bytes_synthetic(threads):
    n = 24
    with NativeFrameSource(width=320, height=240, num_frames=n, slots=5, threads=threads) as src:
        got = src.next_batch(n)
    with SourceJ(width=320, height=240, num_frames=n, slots=5, threads=threads) as src:
        want = src.next_batch(n)
    assert got.shape == want.shape == (n, 240, 320, 3)
    np.testing.assert_array_equal(got, want)


def test_ring_gives_jax_rings_bytes_rawfile(tmp_path):
    frames = RoadJ(width=160, height=120).generate_frames(9)
    raw = tmp_path / "road.raw"
    raw.write_bytes(frames.tobytes())
    kw = dict(width=160, height=120, num_frames=12, slots=3, raw_path=str(raw), threads=2)
    with NativeFrameSource(**kw) as src:
        got = src.next_batch(12)
    with SourceJ(**kw) as src:
        want = src.next_batch(12)
    assert got.shape[0] == want.shape[0] == 9
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, frames)


def test_next_batch_into_fills_a_tensor():
    with NativeFrameSource(width=160, height=120, num_frames=7, slots=3) as a, \
            NativeFrameSource(width=160, height=120, num_frames=7, slots=3) as b:
        buf = torch.full((5, 120, 160, 3), 7, dtype=torch.uint8)
        ptr = buf.data_ptr()
        assert a.next_batch_into(buf) == 5 and buf.data_ptr() == ptr
        np.testing.assert_array_equal(buf.numpy(), b.next_batch(5))
        tail = torch.zeros((4, 120, 160, 3), dtype=torch.uint8)
        assert a.next_batch_into(tail) == 2  # exhausted after 7
        np.testing.assert_array_equal(tail[:2].numpy(), b.next_batch(5))
        assert int(tail[2:].sum()) == 0
        for bad in (torch.zeros((2, 120, 160, 3), dtype=torch.int32), torch.zeros((2, 120, 161, 3), dtype=torch.uint8),
                    torch.zeros((2, 160, 120, 3), dtype=torch.uint8).transpose(1, 2)):
            with pytest.raises(ValueError):
                a.next_batch_into(bad)


def test_run_stream_matches_jax_run_stream(tmp_path):
    """Both packages' `run_stream` on the same raw file, DEFAULT_CONFIG at
    120x160 with frames and tagging, 20 frames in chunks of 8."""
    total, chunk = 20, 8
    cfg, frames, raw = _stream_case(tmp_path, total=total)
    outs, _ = _port_stream(cfg, raw, total, chunk)
    cfg_j = pj.DEFAULT_CONFIG.replace(use_frames=True, enable_tagging=True, frame_height=120, frame_width=160)
    with SourceJ(width=160, height=120, slots=4, num_frames=total, raw_path=str(raw)) as src:
        want, stats = run_stream_j(cfg_j, src, total, chunk=chunk)
    assert stats["frames"] == total
    for k in DISCRETE:
        a, b = outs[k].numpy(), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape[0] == total, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in FLOAT:
        np.testing.assert_allclose(outs[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL, err_msg=k)
    for f in pt.types.VEHICLE_STATE_FIELDS:
        np.testing.assert_allclose(getattr(outs["vehicle_state"], f).numpy(),
                                   np.asarray(getattr(want["vehicle_state"], f)), rtol=0, atol=ATOL, err_msg=f)
    assert set(outs["tags"]) == set(want["tags"]) and len(want["tags"]) == 43
    for k, b in want["tags"].items():
        a, b = outs["tags"][k].numpy(), np.asarray(b)
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5 if "ttc" in k else 0.0, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    lo_t, lo_j = outs["lane_obs"], want["lane_obs"]
    for k in ("left_found", "right_found", "has_offset", "left_confidence", "right_confidence", "offset_px"):
        np.testing.assert_array_equal(getattr(lo_t, k).numpy(), np.asarray(getattr(lo_j, k)), err_msg=k)
    for k in ("left_fit", "right_fit"):
        a, b = getattr(lo_t, k).numpy().astype(np.float64), np.asarray(getattr(lo_j, k)).astype(np.float64)
        for y in (120.0, 96.0, 72.0):
            np.testing.assert_allclose(a @ [y * y, y, 1.0], b @ [y * y, y, 1.0], rtol=0, atol=X_ATOL, err_msg=k)
    assert bool(lo_t.left_found.any())


def test_run_stream_empty_source_and_slots_below_a_chunk(tmp_path):
    """Zero frames give ({}, stats); a ring of fewer slots than a chunk with
    four producer threads gives the same stream as a deep ring."""
    cfg, frames, raw = _stream_case(tmp_path, total=12)
    with NativeFrameSource(width=160, height=120, slots=2, num_frames=0, raw_path=str(raw)) as src:
        outs, stats = run_stream(cfg, src, 5, chunk=4, device="cpu")
    assert outs == {} and stats["frames"] == 0
    shallow, _ = _port_stream(cfg, raw, 12, 8, threads=4)
    with NativeFrameSource(width=160, height=120, slots=16, num_frames=12, raw_path=str(raw), threads=1) as src:
        deep, _ = run_stream(cfg, src, 12, chunk=8, device="cpu")
    for k in DISCRETE + FLOAT:
        assert torch.equal(shallow[k], deep[k]), k
    with NativeFrameSource(width=160, height=120, slots=2, num_frames=12, raw_path=str(raw)) as src:
        none, stats = run_stream(cfg, src, 12, chunk=8, collect_host=False, device="cpu")
    assert none is None and stats["frames"] == 12
