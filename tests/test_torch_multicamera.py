"""The port's multi-camera runner (parallel/mesh.py) against the JAX
package's, on the CPU.

The cases of tests/test_multicamera.py: every camera carries a distinct
stream; the fleet count is the sum over cameras; each camera equals its
own single run; frames mode at 120x160 with two cameras.  The JAX runner
shards the cameras over the virtual CPU mesh tests/conftest.py provides;
the port runs them as lanes of one batched runner (``device="cpu"``, the
kernels' plain versions).  Discrete outputs are bit-identical to JAX,
floats within atol 1e-4 (PARITY.md), and each camera equals the port's
own single run bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch.parallel.mesh import (
    make_camera_mesh,
    make_multicamera_runner,
    stack_states,
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


def _run_both(n_cam, inputs, **cfg_kw):
    cfg_j = pj.DEFAULT_CONFIG.replace(**cfg_kw)
    runner_j = mesh_j.make_multicamera_runner(cfg_j, mesh_j.make_camera_mesh(n_cam))
    _, outs_j, fleet_j = runner_j(mesh_j.stack_states(cfg_j, n_cam), {k: jnp.asarray(v) for k, v in inputs.items()})
    cfg_t = pt.DEFAULT_CONFIG.replace(**cfg_kw)
    runner_t = make_multicamera_runner(cfg_t, make_camera_mesh(device="cpu"))
    final_t, outs_t, fleet_t = runner_t(stack_states(cfg_t, n_cam, device="cpu"), inputs)
    return (outs_j, fleet_j), (final_t, outs_t, fleet_t), cfg_t


def _assert_like_jax(outs_t, outs_j):
    for k in _DISCRETE:
        np.testing.assert_array_equal(outs_t[k].numpy(), np.asarray(outs_j[k]), err_msg=k)
    for k in _FLOAT:
        np.testing.assert_allclose(outs_t[k].numpy(), np.asarray(outs_j[k]), rtol=0, atol=ATOL, err_msg=k)


def _assert_camera_is_its_single_run(outs_t, cam, single):
    for k in _DISCRETE + _FLOAT:
        assert torch.equal(outs_t[k][cam], single[k]), f"camera {cam}: {k}"


def test_eight_camera_fleet_sum_with_distinct_streams():
    n, frames = 8, 30
    inputs, _ = _inputs(n, frames)
    (outs_j, fleet_j), (_, outs_t, fleet_t), _ = _run_both(n, inputs, use_frames=False, enable_tagging=False)
    nc = outs_t["num_confirmed"].numpy()
    assert nc.shape == (n, frames)
    tid = outs_t["track_id"].numpy()
    assert any(not np.array_equal(tid[c], tid[0]) or not np.array_equal(nc[c], nc[0]) for c in range(1, n))
    fleet = fleet_t["fleet_confirmed_per_frame"]
    assert fleet.dtype == torch.int32
    np.testing.assert_array_equal(fleet.numpy(), nc.sum(axis=0))
    np.testing.assert_array_equal(fleet.numpy(), np.asarray(fleet_j["fleet_confirmed_per_frame"]))
    _assert_like_jax(outs_t, outs_j)


def test_every_camera_matches_its_single_run():
    n_cam = 4
    inputs, streams = _inputs(n_cam, 20)
    (outs_j, _), (final_t, outs_t, _), cfg = _run_both(n_cam, inputs, use_frames=False, enable_tagging=True)
    _assert_like_jax(outs_t, outs_j)
    run = pt.make_sequence_runner(cfg, device="cpu")
    for cam in range(n_cam):
        final, single = run(pt.initial_state(cfg, device="cpu"), streams[cam])
        _assert_camera_is_its_single_run(outs_t, cam, single)
        for k, v in single["tags"].items():
            assert torch.equal(outs_t["tags"][k][cam], v), f"camera {cam}: tag {k}"
        assert torch.equal(final_t.tracks.next_id[cam], final.tracks.next_id)


def test_multicamera_frames_mode_full_stack():
    """Frames mode: each camera runs the lane step on its own frames (a
    different dash phase) and equals its own single run."""
    from multimodal_autonomous_driving_perception_and_planning_tpu.data.frames import SyntheticRoadGenerator

    h, w, frames_n, n_cam = 120, 160, 6, 2
    clips = []
    for cam in range(n_cam):
        gen = SyntheticRoadGenerator(width=w, height=h)
        clips.append(gen.generate_frames(frames_n + 3 * cam)[3 * cam :])
    clips = np.stack(clips).astype(np.int32)  # (C, T, H, W, 3)
    inputs, streams = _inputs(n_cam, frames_n, frames=clips)
    kw = dict(use_frames=True, enable_tagging=True, frame_height=h, frame_width=w)
    (outs_j, _), (_, outs_t, _), cfg = _run_both(n_cam, inputs, **kw)

    assert "lane_obs" in outs_t
    _assert_like_jax(outs_t, outs_j)
    np.testing.assert_allclose(
        outs_t["lane_obs"].left_confidence.numpy(), np.asarray(outs_j["lane_obs"].left_confidence), rtol=0, atol=ATOL
    )
    np.testing.assert_array_equal(outs_t["lane_obs"].left_found.numpy(), np.asarray(outs_j["lane_obs"].left_found))
    run = pt.make_sequence_runner(cfg, device="cpu")
    for cam in range(n_cam):
        _, single = run(pt.initial_state(cfg, device="cpu"), {**streams[cam], "frame": clips[cam]})
        _assert_camera_is_its_single_run(outs_t, cam, single)
        assert torch.equal(outs_t["lane_obs"].left_fit[cam], single["lane_obs"].left_fit)
    a = outs_t["lane_obs"].left_confidence.numpy()
    assert not np.array_equal(a[0], a[1]) or not np.array_equal(
        outs_t["track_id"][0].numpy(), outs_t["track_id"][1].numpy()
    )


def test_a_mesh_of_more_than_one_card_is_refused():
    """A camera mesh of more than one rank needs a process group of that
    many ranks (tests/test_torch_parallel.py runs one): without one it
    raises, naming the group, and never runs on one device instead.  One
    device needs no group."""
    with pytest.raises(RuntimeError, match="process group"):
        make_camera_mesh(2, device="cpu")
    mesh = make_camera_mesh(device="cpu")
    assert mesh.devices == (torch.device("cpu"),) and mesh.axis_names == ("camera",)
    assert mesh.device_mesh is None and mesh.size == 1
