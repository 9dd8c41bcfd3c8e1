"""The port's CLI demo (`apps.demo`) on the CPU.

tests/test_demo.py's 5 cases on the port: the console contract and the
video writer, the YOLO smoke (and YOLO with seeded weights from an
``.npz``, so that the detector really runs), a video file, segmented resume
equal to one monolithic run, and the multi-camera grid.  Then the port's
`run_demo` host records against JAX's `run_demo` records on the same 60
detections-mode frames (ints and strings equal, floats within atol 1e-4,
PARITY.md; the candidates by cost, as tests/test_torch_host_stack.py
compares them), and the six-component ``--test`` suite.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import multimodal_autonomous_driving_perception_and_planning_torch as pt
from multimodal_autonomous_driving_perception_and_planning_torch.apps import demo
from multimodal_autonomous_driving_perception_and_planning_torch.types import tree_leaves
from multimodal_autonomous_driving_perception_and_planning_torch.utils.checkpoint import restore_pipeline_state

CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame_count(path) -> int:
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def test_run_demo_console_contract_and_writer(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    result = demo.run_demo(num_frames=60, save_video=True, display=False, synthetic=True, use_frames=False,
                           enable_tagging=True, smooth_tracks=True, **CPU)
    out = capsys.readouterr().out
    assert "Starting processing pipeline..." in out
    assert "Frame 50/60 | FPS:" in out and "Speed:" in out
    assert "Kalman bank: smoothing" in out
    assert "Demo Complete!" in out and "Processed 60 frames" in out
    video = tmp_path / "output_demo.mp4"
    assert video.exists() and video.stat().st_size > 50_000
    assert _frame_count(video) == 60 == result["frames_written"] == len(result["records"])


def test_run_demo_yolo_smoke(tmp_path, monkeypatch, capsys):
    """--yolo without weights falls back to the simulated detector, as the
    JAX demo does; with an ``.npz`` of seeded yolov8n weights the port's
    YOLO detector runs (160-pixel letterbox on the CPU)."""
    monkeypatch.chdir(tmp_path)
    common = dict(num_frames=2, save_video=False, display=False, synthetic=True, use_frames=False,
                  enable_tagging=False, yolo=True, yolo_img_size=160, **CPU)
    demo.run_demo(**common)
    out = capsys.readouterr().out
    assert "YOLO detector (weights: random init)" in out and "falling back to simulated mode" in out
    assert "Demo Complete!" in out and "Processed 2 frames" in out

    from multimodal_autonomous_driving_perception_and_planning_torch.utils.weights import save_npz_state_dict

    npz = str(tmp_path / "yolov8n_seeded.npz")
    save_npz_state_dict(npz, chip_smoke.ultralytics_state_from_port(chip_smoke.yolo_params("cpu")), variant="n")
    result = demo.run_demo(weights=npz, **common)
    out = capsys.readouterr().out
    assert f"YOLO detector (weights: {npz})" in out and "falling back" not in out
    assert "Processed 2 frames" in out and len(result["records"]) == 2


def test_run_demo_with_video_file(tmp_path, monkeypatch, capsys):
    """--video file -> VideoDataLoader -> the frames path -> console summary."""
    import cv2

    from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import SyntheticRoadGenerator

    src = str(tmp_path / "road.mp4")
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 30, (640, 480))
    for f in SyntheticRoadGenerator(640, 480).generate_frames(8):
        writer.write(f)
    writer.release()
    monkeypatch.chdir(tmp_path)
    result = demo.run_demo(video_path=src, num_frames=6, save_video=False, display=False, use_frames=True,
                           enable_tagging=True, **CPU)
    out = capsys.readouterr().out
    assert "Video info: 8 frames, 30.0 FPS, 640x480" in out
    assert "Demo Complete!" in out and "Processed 6 frames" in out
    assert any(r.lane_left is not None for r in result["records"])


def test_run_demo_segmented_resume_equals_monolithic(tmp_path, monkeypatch, capsys):
    """--save-state / --resume / --start-frame: two 8-frame segments chained
    through a checkpoint end in exactly the state one 16-frame run ends in
    (track table, Kalman state, tagging rings, frame counter)."""
    monkeypatch.chdir(tmp_path)
    common = dict(display=False, synthetic=True, use_frames=False, enable_tagging=True, **CPU)
    demo.run_demo(num_frames=8, save_state=str(tmp_path / "seg1"), **common)
    demo.run_demo(num_frames=8, start_frame=8, resume=str(tmp_path / "seg1"), save_state=str(tmp_path / "seg2"),
                  **common)
    demo.run_demo(num_frames=16, save_state=str(tmp_path / "mono"), **common)
    assert "Resumed pipeline state" in capsys.readouterr().out
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    template = pt.initial_state(cfg, **CPU)
    seg = restore_pipeline_state(str(tmp_path / "seg2"), template)
    mono = restore_pipeline_state(str(tmp_path / "mono"), template)
    for i, (a, b) in enumerate(zip(tree_leaves(seg), tree_leaves(mono))):
        assert torch.equal(a, b), f"leaf{i}"


def test_run_multicamera_demo_smoke(tmp_path, monkeypatch, capsys):
    """--cameras N: the camera runner as a CLI surface: grid video written,
    fleet counts printed."""
    monkeypatch.chdir(tmp_path)
    result = demo.run_multicamera_demo(num_cameras=2, num_frames=12, save_video=True, display=False,
                                       enable_tagging=False, **CPU)
    out = capsys.readouterr().out
    assert "2 feeds through the camera-sharded runner" in out
    assert "Rendered 12 frames x 2 cameras" in out
    video = tmp_path / "output_multicam.mp4"
    assert video.exists() and video.stat().st_size > 10_000
    assert _frame_count(video) == 12 == result["frames_written"]
    fleet = [sum(len(result["records"][c][f].tracks) for c in range(2)) for f in range(12)]
    assert fleet == result["fleet_counts"].tolist()


def test_run_demo_records_equal_jax_run_demo(tmp_path, monkeypatch, capsys):
    """The same 60 detections-mode frames with tagging through both
    packages' `run_demo`: the port's host records equal JAX's."""
    from multimodal_autonomous_driving_perception_and_planning_tpu import host as host_j
    from multimodal_autonomous_driving_perception_and_planning_tpu.apps.demo import run_demo as run_demo_j

    monkeypatch.chdir(tmp_path)
    recs_j = []
    extract_j = host_j.extract_frame

    def recording(outs, dets, f):
        recs_j.append(extract_j(outs, dets, f))
        return recs_j[-1]

    monkeypatch.setattr(host_j, "extract_frame", recording)
    kw = dict(num_frames=60, display=False, synthetic=True, use_frames=False, enable_tagging=True)
    run_demo_j(**kw)
    recs_t = demo.run_demo(**kw, **CPU)["records"]
    capsys.readouterr()
    assert len(recs_t) == len(recs_j) == 60
    assert sum(len(r.tracks) for r in recs_t) > 100
    for f, (got, want) in enumerate(zip(recs_t, recs_j)):
        for part in ("detections", "tracks", "vehicle_state", "optimal_trajectory", "tags"):
            chip_smoke.same_records(getattr(got, part), getattr(want, part), f"frame {f} {part}")
        chip_smoke.same_records([c.cost for c in got.candidate_trajectories],
                                [c.cost for c in want.candidate_trajectories], f"frame {f} candidates")
        assert sorted(c.trajectory_type for c in got.candidate_trajectories) == sorted(
            c.trajectory_type for c in want.candidate_trajectories)


def test_component_test_suite(capsys):
    demo.main(["--test", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[Test 6] BEV Renderer ✓" in out and "All component tests passed." in out
