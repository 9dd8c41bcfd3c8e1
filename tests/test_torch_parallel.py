"""The port's cross-rank pieces (parallel/mesh.py, parallel/tp.py) against
the JAX package's, on the CPU.

The cases of tests/test_multicamera.py and tests/test_vlm.py's sharded
BLIP.  The JAX side runs in this process over the 8 virtual CPU devices
that tests/conftest.py sets; the port's ranks are spawned processes on
gloo (parallel/distributed.py `spawn`, the rank functions of
tests/test_torch_ranks.py), each with one intra-op thread, meeting at a
``file://`` rendezvous under ``tmp_path`` and joined with a timeout.

Tolerances: discrete outputs bit for bit; each camera equals its own
single run of the port bit for bit (the planner's floats included, as on
one device, tests/test_torch_multicamera.py); against JAX, floats within
PARITY.md's 1e-4, plan costs within JAX's own rtol 1e-5 and an atol of
1e-6 for the costs near 0 (across the frameworks they differ by up to
1.3e-7 there, a relative 1e-3), the lane fits
within JAX's rtol 1e-4 and atol 1e-6, the tensor-parallel YOLO's tables
within JAX's atol 1e-3, and BLIP's tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
import test_torch_ranks as ranks
from multimodal_autonomous_driving_perception_and_planning_torch.parallel.distributed import spawn
from multimodal_autonomous_driving_perception_and_planning_torch.utils.convert import (
    blip_state_from_flax,
    yolo_state_from_flax,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.data.synthetic import (
    ego_motion_stream,
    simulated_detection_stream,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.parallel import mesh as mesh_j

ATOL = 1e-4
_DISCRETE = ("track_id", "track_hits", "track_misses", "confirmed_order", "num_confirmed", "match", "plan_best")
_FLOAT = ("track_bbox", "track_velocity", "plan_costs", "plan_best_positions")



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_yolo.py pins: the suite
    runs several workers on the same cores, and torch's default of one
    thread a core in each made the frames-mode steps wait on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spawn(fn, world, tmp_path, *args):
    return spawn(fn, world, str(tmp_path), *args, backend="gloo", threads=1, timeout=ranks.RANK_TIMEOUT)


def _camera_stream(cam, num_frames):
    dets = simulated_detection_stream(num_frames, start_frame_count=1 + 7 * cam)
    ego = ego_motion_stream(num_frames, seed=cam)
    return {**{k: np.asarray(v) for k, v in dets.items()}, "ego_measurement": ego.astype(np.float32)}


def _inputs(n_cameras, num_frames, frames=None):
    streams = [_camera_stream(c, num_frames) for c in range(n_cameras)]
    out = {k: np.stack([s[k] for s in streams]) for k in streams[0]}
    if frames is not None:
        out["frame"] = frames
    return out, streams


def _jax_multicamera(n_cam, inputs, **cfg_kw):
    cfg = pj.DEFAULT_CONFIG.replace(**cfg_kw)
    runner = mesh_j.make_multicamera_runner(cfg, mesh_j.make_camera_mesh(n_cam))
    _, outs, fleet = runner(mesh_j.stack_states(cfg, n_cam), {k: jnp.asarray(v) for k, v in inputs.items()})
    return outs, np.asarray(fleet["fleet_confirmed_per_frame"])


def _assert_like_jax(outs, outs_j):
    for k in _DISCRETE:
        np.testing.assert_array_equal(outs[k], np.asarray(outs_j[k]), err_msg=k)
    for k in _FLOAT:
        np.testing.assert_allclose(outs[k], np.asarray(outs_j[k]), rtol=0, atol=ATOL, err_msg=k)


def _assert_camera_is_its_single_run(outs, cam, single):
    for k in _DISCRETE + _FLOAT:
        np.testing.assert_array_equal(outs[k][cam], single[k].numpy(), err_msg=f"camera {cam}: {k}")


def test_eight_camera_sharded_pipeline(tmp_path):
    """8 cameras over 4 ranks (2 a rank), distinct streams: the cameras do
    not all agree (a transpose guard), the fleet count is the sum over
    cameras on every rank, and every output is JAX's sharded runner's."""
    n, frames = 8, 30
    kw = dict(use_frames=False, enable_tagging=False)
    inputs, _ = _inputs(n, frames)
    got = _spawn(ranks.camera_mesh_rank, 4, tmp_path, kw, inputs)
    outs, fleet = got[0]["outs"], got[0]["fleet"]
    assert got[0]["mesh"] == (4, ("camera",))
    nc = outs["num_confirmed"]
    assert nc.shape == (n, frames)
    tid = outs["track_id"]
    assert any(not np.array_equal(tid[c], tid[0]) or not np.array_equal(nc[c], nc[0]) for c in range(1, n))
    assert fleet.dtype == np.int32
    for r in got:
        np.testing.assert_array_equal(r["fleet"], nc.sum(axis=0))
        np.testing.assert_array_equal(r["outs"]["track_id"], tid)
    outs_j, fleet_j = _jax_multicamera(n, inputs, **kw)
    np.testing.assert_array_equal(fleet, fleet_j)
    _assert_like_jax(outs, outs_j)


def test_every_camera_matches_its_single_run(tmp_path):
    """4 cameras over 4 ranks: each camera equals the port's single run of
    its stream bit for bit, and JAX's sharded runner (track ids bit for
    bit, plan costs within rtol 1e-5)."""
    n_cam = 4
    kw = dict(use_frames=False, enable_tagging=False)
    inputs, streams = _inputs(n_cam, 20)
    got = _spawn(ranks.camera_mesh_rank, n_cam, tmp_path, kw, inputs)
    outs = got[0]["outs"]
    cfg = pt.DEFAULT_CONFIG.replace(**kw)
    run = pt.make_sequence_runner(cfg, device="cpu")
    outs_j, _ = _jax_multicamera(n_cam, inputs, **kw)
    for cam in range(n_cam):
        final, single = run(pt.initial_state(cfg, device="cpu"), streams[cam])
        _assert_camera_is_its_single_run(outs, cam, single)
        assert got[cam]["local_next_id"].tolist() == [int(final.tracks.next_id)]
        np.testing.assert_array_equal(outs["track_id"][cam], np.asarray(outs_j["track_id"])[cam])
        np.testing.assert_allclose(outs["plan_costs"][cam], np.asarray(outs_j["plan_costs"])[cam], rtol=1e-5,
                                   atol=1e-6)


def test_multicamera_frames_mode_full_stack(tmp_path):
    """Frames mode at 120x160 over 2 ranks, one camera a rank with a dash
    phase of its own: each camera equals its single run, the lane fits
    JAX's within rtol 1e-4 and atol 1e-6, and the cameras differ."""
    from multimodal_autonomous_driving_perception_and_planning_tpu.data.frames import SyntheticRoadGenerator

    h, w, frames_n, n_cam = 120, 160, 6, 2
    clips = []
    for cam in range(n_cam):
        gen = SyntheticRoadGenerator(width=w, height=h)
        clips.append(gen.generate_frames(frames_n + 3 * cam)[3 * cam :])
    clips = np.stack(clips).astype(np.int32)
    inputs, streams = _inputs(n_cam, frames_n, frames=clips)
    kw = dict(use_frames=True, enable_tagging=True, frame_height=h, frame_width=w)
    got = _spawn(ranks.camera_mesh_rank, n_cam, tmp_path, kw, inputs)
    outs = got[0]["outs"]
    assert "lane_obs" in outs
    outs_j, _ = _jax_multicamera(n_cam, inputs, **kw)
    _assert_like_jax(outs, outs_j)
    np.testing.assert_allclose(outs["lane_obs"].left_fit, np.asarray(outs_j["lane_obs"].left_fit), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(outs["lane_obs"].left_found, np.asarray(outs_j["lane_obs"].left_found))
    cfg = pt.DEFAULT_CONFIG.replace(**kw)
    run = pt.make_sequence_runner(cfg, device="cpu")
    for cam in range(n_cam):
        _, single = run(pt.initial_state(cfg, device="cpu"), {**streams[cam], "frame": clips[cam]})
        _assert_camera_is_its_single_run(outs, cam, single)
        np.testing.assert_array_equal(outs["lane_obs"].left_fit[cam], single["lane_obs"].left_fit.numpy())
        for k, v in single["tags"].items():
            np.testing.assert_array_equal(outs["tags"][k][cam], v.numpy(), err_msg=f"camera {cam}: tag {k}")
    a = outs["lane_obs"].left_confidence
    assert not np.array_equal(a[0], a[1]) or not np.array_equal(outs["track_id"][0], outs["track_id"][1])


def test_tensor_parallel_yolo_matches_unsharded(tmp_path):
    """yolov8n over a (data=2, model=2) mesh of 4 ranks at 160 px, float32,
    on JAX's seeded weights: every rank's tables within atol 1e-3 of JAX's
    unsharded detector and of the port's; the default mesh of 4 ranks is
    JAX's (1, 4); each rank holds half of every sharded conv."""
    from multimodal_autonomous_driving_perception_and_planning_torch.models import yolov8 as yt
    from multimodal_autonomous_driving_perception_and_planning_tpu.models.yolov8 import make_yolo_detector

    init_raw, detect_raw = make_yolo_detector(img_size=160, max_det=8, compute_dtype=jnp.float32)
    variables = jax.jit(init_raw)(jax.random.PRNGKey(0))
    frames = np.random.default_rng(0).integers(0, 255, (4, 120, 160, 3)).astype(np.float32)
    ref = jax.jit(jax.vmap(detect_raw, in_axes=(None, 0)))(variables, jnp.asarray(frames))
    state = {k: v.numpy() for k, v in yolo_state_from_flax(jax.tree_util.tree_map(np.asarray, variables)).items()}
    kw = dict(img_size=160, max_det=8, compute_dtype=torch.float32)
    got = _spawn(ranks.tp_yolo_rank, 4, tmp_path, state, frames, 2, 2, kw)
    _, detect_t = yt.make_yolo_detector(device="cpu", **kw)
    port = detect_t({k: torch.as_tensor(v) for k, v in state.items()}, frames)
    assert (got[0]["mesh"], got[0]["default_mesh"]) == ((2, 2), (1, 4))
    assert got[0]["local_shapes"] == {"b0.conv.weight": (8, 3, 3, 3)}  # 16 stem channels over model=2
    for r in got:
        tables = r["tables"]
        assert sorted(tables) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(tables[k].astype(np.float32), np.asarray(ref[k], np.float32), atol=1e-3,
                                       err_msg=k)
            np.testing.assert_allclose(tables[k].astype(np.float32), port[k].numpy().astype(np.float32), atol=1e-3,
                                       err_msg=f"port {k}")
    assert int(got[0]["tables"]["valid"].sum()) > 0


def test_sharded_blip_matches_unsharded(tmp_path):
    """tests/test_vlm.py's case: BlipConfig.tiny() on JAX's seeded weights,
    every linear layer that divides sharded over 2 ranks; tokens and length
    equal to JAX's unsharded decode, and the first step's logits the
    unsharded port's within ATOL (a misplaced column moves them by O(1))."""
    from multimodal_autonomous_driving_perception_and_planning_torch.models import blip as tb
    from multimodal_autonomous_driving_perception_and_planning_tpu.models import blip as jb

    cfg = jb.BlipConfig.tiny()
    init_fn, caption = jb.make_caption_fn(cfg, max_new_tokens=6)
    params = init_fn(jax.random.PRNGKey(0), prompt_capacity=4)
    frame = np.random.default_rng(0).integers(0, 255, (48, 64, 3)).astype(np.uint8)
    px = np.asarray(jb.preprocess_bgr(jnp.asarray(frame), cfg.image_size))
    prompt = np.asarray([cfg.bos_token_id, 5, 7, 0], np.int32)
    ref_ids, ref_len = jax.jit(caption)(params, jnp.asarray(px), jnp.asarray(prompt), jnp.asarray(3))
    state = {k: v.numpy() for k, v in blip_state_from_flax(jax.tree_util.tree_map(np.asarray, params)).items()}
    px_t = np.ascontiguousarray(px.transpose(0, 3, 1, 2))
    got = _spawn(ranks.tp_blip_rank, 2, tmp_path, state, tb.BlipConfig.tiny(), 6, px_t, prompt, 3)
    for r in got:
        np.testing.assert_array_equal(r["ids"], np.asarray(ref_ids))
        assert r["length"] == int(ref_len)
        assert r["sharded_linears"] > 0
        np.testing.assert_allclose(r["logits"], r["whole_logits"], rtol=0, atol=ATOL)
