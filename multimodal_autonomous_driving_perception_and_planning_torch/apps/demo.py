"""Headless / windowed CLI demo on the port.

    python -m multimodal_autonomous_driving_perception_and_planning_torch.apps.demo --synthetic --frames 300 --no-display

The port's counterpart of the JAX package's apps/demo.py (the root
``demo.py`` stays the JAX package's), with the same flags and console
contract: init banner, progress line every 50 frames with FPS / track count
/ speed, final FPS summary, q/p keyboard control, side-by-side video
export.  The demo runs in two halves.  The device half (`run_device`)
builds the inputs (the simulated detector, or YOLO through the port's
`ObjectDetector` under ``--yolo``), runs `make_sequence_runner` over the
whole clip on the card (kernels K1, K2 and K3 a frame, K5 a YOLO chunk),
saves or resumes the carry, smooths the tracks with the Kalman bank and
turns every frame's outputs into host records (`host.extract_frame`).  The
render half draws those records with cv2 (`viz`), shows and writes them.

The JAX demo reports a compile step (``runner.lower().compile()``) and
enables a persistent compile cache; the port has neither: it reports the
kernels' build, one warm run, and the timed run closed by
``torch.cuda.synchronize()``.  ``--test`` runs the six-component smoke
suite the reference README documents.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device

WARM_FRAMES = 8  # the warm run's frames, from a fresh state


def _build_inputs(frames: np.ndarray, num_frames: int, dt: float, use_frames: bool, cfg, detector=None,
                  start_frame: int = 0):
    """The detection tables and the runner's inputs for ``num_frames``
    frames starting at ``start_frame``: YOLO tables on the device from
    ``detector`` in YOLO mode, the simulated detector's numpy tables
    otherwise, the seed-0 ego stream sliced at ``start_frame``."""
    from ..data.synthetic import ego_motion_stream, simulated_detection_stream

    if detector is not None and detector.mode == "yolo":
        if frames.shape[1] < 32 or frames.shape[2] < 32:
            raise ValueError(
                "YOLO mode needs real camera frames; got placeholder "
                f"{frames.shape[1]}x{frames.shape[2]} images (--no-lanes "
                "disables frame generation — drop it or use --video)"
            )
        dets = detector.detect_stream(frames)
    else:
        dets = simulated_detection_stream(
            num_frames,
            height=cfg.frame_height,
            width=cfg.frame_width,
            capacity=cfg.detector.max_detections,
            start_frame_count=start_frame + 1,
        )
    # Generate-then-slice keeps the segment's measurements bit-identical to
    # the same rows of one monolithic stream (the chunk-chaining contract).
    ego = ego_motion_stream(start_frame + num_frames, dt=dt, seed=0)[start_frame:]
    inputs: Dict[str, Any] = dict(dets, ego_measurement=ego.astype(np.float32))
    if use_frames:
        inputs["frame"] = np.ascontiguousarray(frames, dtype=np.uint8)  # uint8 to the card
    return dets, inputs


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class DeviceRun:
    """What the device half hands the render half."""

    dets: Dict[str, np.ndarray]  # the detection tables, on the host
    outs: Dict[str, Any]  # the runner's outputs, on the device
    final: Any  # the final PipelineState
    records: List[Any]  # host.FrameResult a frame
    smoothed: Optional[Dict[str, np.ndarray]]  # the Kalman bank's, on the host
    build_s: float  # the kernels' build (or load) on the card; 0 on the CPU
    warm_frames: int  # the warm run's frames (none on the CPU)
    warm_s: float
    device_s: float  # the timed run, closed by a synchronize
    records_s: float  # extract_frame over every frame

    @property
    def device_fps(self) -> float:
        return len(self.records) / max(self.device_s, 1e-9)


def run_device(
    cfg,
    frames: np.ndarray,
    total: int,
    dt: float = 1.0 / 30.0,
    device="cuda",
    detector=None,
    start_frame: int = 0,
    resume: Optional[str] = None,
    save_state: Optional[str] = None,
    smooth_tracks: bool = False,
) -> DeviceRun:
    """The demo's device half over ``total`` frames (``frames`` (T, H, W,
    3) uint8; placeholders when ``cfg.use_frames`` is off and no YOLO
    detector reads them)."""
    from ..host import extract_frame, to_numpy
    from ..pipeline import initial_state, make_sequence_runner
    from ..types import tree_map

    dev = resolve_device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        from ..kernels import build

        build.kernels()
    build_s = time.perf_counter() - t0

    dets, inputs = _build_inputs(frames, total, dt, cfg.use_frames, cfg, detector=detector, start_frame=start_frame)
    runner = make_sequence_runner(cfg, device=dev)
    init = initial_state(cfg, device=dev)
    if resume:
        # Continue a prior segment: the carry (track table, Kalman state,
        # lane EMA, tagging rings, frame counter) restores exactly, so
        # segment N+1 equals the same frames of one monolithic run.
        from ..utils.checkpoint import restore_pipeline_state

        init = restore_pipeline_state(resume, init)
        print(f"      Resumed pipeline state from {resume}")

    warm, warm_s = 0, 0.0
    if dev.type == "cuda":  # the CPU runs the plain versions: nothing to warm
        warm = min(total, WARM_FRAMES)
        t0 = time.perf_counter()
        runner(initial_state(cfg, device=dev), {k: v[:warm] for k, v in inputs.items()})
        _sync(dev)
        warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    final, outs = runner(init, inputs)
    _sync(dev)
    device_s = time.perf_counter() - t0

    if save_state:
        from ..utils.checkpoint import save_pipeline_state

        save_pipeline_state(save_state, final)
        print(f"      Saved pipeline state to {save_state} "
              f"(resume with --resume {save_state} --start-frame {start_frame + total})")

    smoothed = None
    if smooth_tracks:
        # Opt-in per-agent Kalman bank (no reference analog; see
        # tracking/kalman_bank.py): smoothed centers drawn as yellow dots.
        from ..tracking.kalman_bank import make_kalman_bank

        bank = make_kalman_bank(cfg, device=dev)
        smoothed = {k: to_numpy(v) for k, v in bank(
            {k: outs[k] for k in ("track_id", "track_bbox", "track_velocity", "track_vel_count")}).items()}
        n_smoothed = int(smoothed["valid"].any(axis=0).sum())
        print(f"Kalman bank: smoothing {n_smoothed} track slots on device")

    dets = {k: to_numpy(v) for k, v in dets.items()}
    t0 = time.perf_counter()
    host_outs = tree_map(lambda x: x.cpu(), outs)  # one copy a key, not one a frame
    records = [extract_frame(host_outs, dets, f) for f in range(total)]
    records_s = time.perf_counter() - t0
    return DeviceRun(dets, outs, final, records, smoothed, build_s, warm, warm_s, device_s, records_s)


def _synthetic_frames(cfg, n: int, start_frame: int, need_pixels: bool) -> np.ndarray:
    from ..data.frames import SyntheticRoadGenerator

    if not need_pixels:
        return np.zeros((n, 1, 1, 3), np.uint8)
    # Generate-then-slice: frame start_frame+i here equals frame
    # start_frame+i of a run that started at 0 (segmented resume).
    return SyntheticRoadGenerator(cfg.frame_width, cfg.frame_height).generate_frames(start_frame + n)[start_frame:]


def run_demo(
    video_path: str = None,
    num_frames: int = None,
    save_video: bool = False,
    display: bool = True,
    synthetic: bool = False,
    use_frames: bool = True,
    enable_tagging: bool = True,
    smooth_tracks: bool = False,
    yolo: bool = False,
    weights: str = None,
    yolo_img_size: int = 640,
    start_frame: int = 0,
    resume: str = None,
    save_state: str = None,
    device="cuda",
) -> Dict[str, Any]:
    """The demo over a synthetic clip or a video file, on ``device``.
    Returns the run's summary: ``records`` (the host records of every
    frame), ``frames`` rendered, ``device_fps`` and ``render_fps`` and
    ``frames_written``."""
    from .. import DEFAULT_CONFIG
    from ..viz import BEVRenderer, OverlayRenderer

    dev = resolve_device(device)
    print("=" * 60)
    print("Multimodal Autonomous Driving Perception & Planning Demo (CUDA)")
    print("=" * 60)

    cfg = DEFAULT_CONFIG.replace(use_frames=use_frames, enable_tagging=enable_tagging)

    print("\n[1/6] Initializing perception modules...")
    print("[2/6] Initializing tracking module...")
    print("[3/6] Initializing state estimation...")
    print("[4/6] Initializing motion planner...")
    print(f"      (every stage runs on {dev.type.upper()}; on the card kernels K1-K3 launch once a frame)")
    print("[5/6] Initializing visualization...")
    bev = BEVRenderer(cfg.bev)
    overlay = OverlayRenderer()

    dt = 1.0 / 30.0
    if synthetic or video_path is None:
        total = num_frames or 300
        print(f"[6/6] Generating {total} synthetic road frames...")
        # YOLO mode reads pixels even with the lane stack off (--no-lanes).
        frames = _synthetic_frames(cfg, total, start_frame, use_frames or yolo)
    else:
        print(f"[6/6] Loading video: {video_path}")
        from ..data.video import VideoDataLoader

        try:
            loader = VideoDataLoader(video_path, target_size=(cfg.frame_width, cfg.frame_height))
        except FileNotFoundError:
            print(f"\nError: Video file not found: {video_path}")
            sys.exit(1)
        except ValueError as e:
            print(f"\nError: Could not open video: {e}")
            sys.exit(1)
        info = loader.get_info()
        print(f"      Video info: {loader.total_frames} frames, {loader.fps:.1f} FPS, {info['width']}x{info['height']}")
        avail = max(0, loader.total_frames - start_frame)
        total = avail if num_frames is None else min(num_frames, avail)
        dt = loader.dt
        frames = loader.load_frames(total, start=start_frame)
        total = len(frames)
        loader.release()

    print("\n" + "=" * 60)
    print("Starting processing pipeline...")
    print("=" * 60)

    detector = None
    if yolo:
        from ..perception.detector import ObjectDetector

        print(f"      YOLO detector (weights: {weights or 'random init'})")
        detector = ObjectDetector(mode="yolo", model_path=weights or "", cfg=cfg, img_size=yolo_img_size, device=dev)
    run = run_device(cfg, frames, total, dt, dev, detector=detector, start_frame=start_frame, resume=resume,
                     save_state=save_state, smooth_tracks=smooth_tracks)
    print(
        f"Device run: {total} frames in {run.device_s * 1e3:.1f} ms ({run.device_fps:.0f} frames/s on "
        f"{dev.type.upper()}; kernel build {run.build_s:.1f}s, warm run {run.warm_s:.2f}s on "
        f"{run.warm_frames} frames)"
    )

    import cv2

    # The writer is opened lazily at the first composed frame so its size
    # always matches (the reference hardcodes 1240x480 against 1400x600
    # side-by-side frames and silently drops every frame, demo.py:84-91).
    video_writer = None
    out_path = "output_demo.mp4"
    if save_video:
        print(f"\nSaving video to: {out_path}")

    frame_times: List[float] = []
    written = 0
    start = time.time()
    for f, res in enumerate(run.records):
        fs = time.time()
        camera = frames[f].copy() if use_frames else np.zeros((cfg.frame_height, cfg.frame_width, 3), np.uint8)
        camera = viz_camera(camera, res)
        if run.smoothed is not None:
            for x, y in run.smoothed["positions"][f][run.smoothed["valid"][f]]:
                cv2.circle(camera, (int(x), int(y)), 4, (0, 255, 255), -1)
        fps = 1.0 / (frame_times[-1] if frame_times else 0.033)
        camera = overlay.draw_info_panel(camera, res.vehicle_state, fps=fps, frame_num=f)
        camera = overlay.draw_detection_summary(camera, res.detections)
        if res.lane_offset is not None:
            camera = overlay.draw_lane_offset_indicator(camera, res.lane_offset)
        combined = overlay.create_side_by_side(camera, bev_view(bev, res), ("Camera View", "Bird's Eye View"))

        if display:
            cv2.imshow("Multimodal AV Demo (CUDA)", combined)
            key = cv2.waitKey(1) & 0xFF
            if key == ord("q"):
                print("\nUser interrupted.")
                break
            if key == ord("p"):
                print("Paused. Press any key to continue...")
                cv2.waitKey(0)
        if save_video:
            if video_writer is None:
                video_writer = cv2.VideoWriter(
                    out_path,
                    cv2.VideoWriter_fourcc(*"mp4v"),
                    # The source's rate, not a hardcoded 30.
                    round(1.0 / dt) if dt > 0 else 30.0,
                    (combined.shape[1], combined.shape[0]),
                )
            video_writer.write(combined)
            written += 1

        frame_times.append(time.time() - fs)
        if (f + 1) % 50 == 0:
            avg_fps = 1.0 / np.mean(frame_times[-50:])
            print(
                f"Frame {f + 1}/{total} | FPS: {avg_fps:.1f} | Tracks: {len(res.tracks)} | "
                f"Speed: {res.vehicle_state.speed * 3.6:.1f} km/h"
            )

    if video_writer is not None:
        video_writer.release()
    if display:
        cv2.destroyAllWindows()

    wall = time.time() - start
    n_done = len(frame_times)
    print("\n" + "=" * 60)
    print("Demo Complete!")
    print("=" * 60)
    print(f"Processed {n_done} frames in {wall:.2f} seconds")
    print(f"Average FPS: {n_done / wall if wall > 0 else 0:.1f} (host render loop)")
    print(f"Average frame time: {np.mean(frame_times) * 1000:.1f} ms")
    print(f"Device pipeline: {run.device_fps:.1f} frames/s (detect+lane+track+estimate+plan+tag)")
    if save_video:
        print(f"\nVideo saved to: {out_path}")
    return {"records": run.records, "frames": n_done, "device_fps": run.device_fps, "device_s": run.device_s,
            "render_s": wall, "render_fps": n_done / wall if wall > 0 else 0.0, "frames_written": written,
            "records_s": run.records_s, "build_s": run.build_s, "warm_s": run.warm_s}


def viz_camera(camera: np.ndarray, res) -> np.ndarray:
    """The camera view's layers of one record: detections, lanes, tracks."""
    from ..viz import draw_detections, draw_lanes, draw_tracks

    camera = draw_detections(camera, res.detections)
    camera = draw_lanes(camera, res.lane_left, res.lane_right)
    return draw_tracks(camera, res.tracks)


def bev_view(bev, res) -> np.ndarray:
    """The bird's-eye view of one record, as the demo and the dashboards draw it."""
    return bev.render(
        ego_state=res.vehicle_state,
        tracks=res.tracks,
        planned_trajectory=res.optimal_trajectory,
        candidate_trajectories=res.candidate_trajectories[:10],
        show_grid=True,
    )


@dataclasses.dataclass
class MulticamRun:
    """What the multi-camera demo's device half hands its grid loop."""

    outs_per_cam: List[Dict[str, Any]]  # each camera's outputs, on the device
    dets_per_cam: List[Dict[str, np.ndarray]]
    fleet_counts: np.ndarray  # (T,) confirmed tracks over all cameras
    n_dev: int
    device_s: float


def run_multicamera_device(cfg, num_cameras: int, num_frames: int, device="cuda") -> MulticamRun:
    """C distinct synthetic feeds through the camera runner
    (`parallel.mesh`): the camera axis the lane axis of kernels K1, K2 and
    K3 (one launch a frame for a rank's cameras).  Under a process group
    of ranks (parallel/distributed.py) whose count divides C, the cameras
    spread over every rank and every rank gets every camera's outputs back
    (the JAX package takes the largest device count that divides C; a
    camera mesh here spans every rank or one).  Otherwise, one card."""
    import torch.distributed as dist

    from ..data.synthetic import ego_motion_stream, simulated_detection_stream
    from ..parallel.mesh import gather_cameras, make_camera_mesh, make_multicamera_runner, stack_states
    from ..types import lane_of

    dev = resolve_device(device)
    C, T = int(num_cameras), int(num_frames)
    # Distinct deterministic feeds a camera: the detection stream is
    # counter-keyed, so disjoint counter ranges give unrelated traffic.
    per_cam = [
        simulated_detection_stream(T, height=cfg.frame_height, width=cfg.frame_width,
                                   capacity=cfg.detector.max_detections, start_frame_count=c * 100_000 + 1)
        for c in range(C)
    ]
    dets = {k: np.stack([d[k] for d in per_cam]) for k in per_cam[0]}
    ego = np.stack([ego_motion_stream(T, dt=1.0 / 30.0, seed=c) for c in range(C)]).astype(np.float32)
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    n_dev = ranks if C % ranks == 0 else 1
    runner = make_multicamera_runner(cfg, make_camera_mesh(n_dev, device=dev))
    states = stack_states(cfg, C, device=dev)
    t0 = time.perf_counter()
    _, outs, fleet = runner(states, dict(dets, ego_measurement=ego))
    fleet_counts = fleet["fleet_confirmed_per_frame"].cpu().numpy()  # waits for the card
    device_s = time.perf_counter() - t0
    outs = gather_cameras(outs)
    return MulticamRun([lane_of(outs, c) for c in range(C)], [{k: v[c] for k, v in dets.items()} for c in range(C)],
                       fleet_counts, n_dev, device_s)


def run_multicamera_demo(
    num_cameras: int = 4,
    num_frames: int = None,
    save_video: bool = False,
    display: bool = True,
    enable_tagging: bool = True,
    device="cuda",
) -> Dict[str, Any]:
    """Multi-camera rig demo: C distinct synthetic feeds through the camera
    runner (`run_multicamera_device`), rendered as a BEV grid.  No
    reference analog (the reference is single-stream).  Returns the
    summary: ``records`` (C lists of host records), ``frames_written``,
    ``device_s`` and ``render_s``."""
    from .. import DEFAULT_CONFIG
    from ..host import extract_frame
    from ..viz import BEVRenderer

    C = int(num_cameras)
    T = num_frames or 120
    cfg = DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=enable_tagging)

    print("=" * 60)
    print(f"Multi-camera demo: {C} feeds through the camera-sharded runner")
    print("=" * 60)
    run = run_multicamera_device(cfg, C, T, device)
    print(
        f"Device run: {C} cameras x {T} frames in {run.device_s * 1e3:.1f} ms "
        f"({C * T / max(run.device_s, 1e-9):.0f} frames/s aggregate on {run.n_dev} device(s))"
    )

    import cv2

    bev = BEVRenderer(cfg.bev)
    cols = int(np.ceil(np.sqrt(C)))
    rows = int(np.ceil(C / cols))
    tile = 400
    video_writer = None
    written = 0
    out_path = "output_multicam.mp4"
    if save_video:
        print(f"Saving video to: {out_path}")
    records = [[] for _ in range(C)]
    start = time.time()
    for f in range(T):
        grid = np.zeros((rows * tile, cols * tile, 3), np.uint8)
        for c in range(C):
            res = extract_frame(run.outs_per_cam[c], run.dets_per_cam[c], f)
            records[c].append(res)
            img = cv2.resize(bev_view(bev, res), (tile, tile))
            cv2.putText(img, f"cam {c}", (8, 22), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 1)
            r, col = divmod(c, cols)
            grid[r * tile:(r + 1) * tile, col * tile:(col + 1) * tile] = img
        cv2.putText(grid, f"frame {f}  fleet tracks: {int(run.fleet_counts[f])}", (8, rows * tile - 10),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 255, 0), 1)
        if display:
            cv2.imshow("Multi-camera BEV grid (CUDA)", grid)
            if (cv2.waitKey(1) & 0xFF) == ord("q"):
                break
        if save_video:
            if video_writer is None:
                video_writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                                               (grid.shape[1], grid.shape[0]))
            video_writer.write(grid)
            written += 1
        if (f + 1) % 50 == 0:
            print(f"Frame {f + 1}/{T} | fleet tracks: {int(run.fleet_counts[f])}")
    host_time = time.time() - start
    if video_writer is not None:
        video_writer.release()
        print(f"Video saved: {out_path}")
    if display:
        cv2.destroyAllWindows()
    print(f"Rendered {T} frames x {C} cameras in {host_time:.2f}s (host grid loop)")
    return {"records": records, "frames_written": written, "device_s": run.device_s, "render_s": host_time,
            "fleet_counts": run.fleet_counts}


def run_component_test(device="cuda"):
    """The six-component smoke suite the reference README documents."""
    from .. import DEFAULT_CONFIG, initial_state, make_pipeline_step
    from ..data.frames import SyntheticRoadGenerator
    from ..data.synthetic import simulated_detection_stream
    from ..perception.lanes import make_lane_step
    from ..pipeline import detections_from_arrays
    from ..types import LaneState
    from ..viz import BEVRenderer

    dev = resolve_device(device)
    print("Running component tests...\n")
    cfg = DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)

    dets = simulated_detection_stream(1)
    assert dets["valid"][0].sum() >= 3
    print("[Test 1] Object Detector ✓")

    lane_step = make_lane_step(DEFAULT_CONFIG, dev)
    frame = torch.from_numpy(SyntheticRoadGenerator().generate_frame_with_vehicles()).to(dev)
    _, obs, _ = lane_step(LaneState.initial(dev), frame)
    assert bool(obs.left_found) and bool(obs.right_found)
    print("[Test 2] Lane Detector ✓")

    step = make_pipeline_step(cfg, dev)
    state = initial_state(cfg, dev)
    inputs = {
        "detections": detections_from_arrays({k: v[0] for k, v in dets.items()}, dev),
        "ego_measurement": torch.tensor([0.33, 0.0, 10.0, 0.0], dtype=torch.float32, device=dev),
    }
    state, out = step(state, inputs)
    assert int(state.tracks.next_id) > 1
    print("[Test 3] Multi-Object Tracker ✓")

    assert float(out["vehicle_state"].speed) >= 0
    print("[Test 4] State Estimator ✓")

    assert int(out["plan_best"]) >= 0 and out["plan_costs"].shape[0] == 21
    print("[Test 5] Motion Planner ✓")

    img = BEVRenderer().render()
    assert img.shape == (600, 600, 3)
    print("[Test 6] BEV Renderer ✓")

    print("\nAll component tests passed.")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Multimodal AV Perception & Planning Demo (PyTorch/CUDA port)")
    parser.add_argument("--video", type=str, default=None, help="Path to input video file")
    parser.add_argument("--synthetic", action="store_true", help="Use the synthetic road-scene generator")
    parser.add_argument("--frames", type=int, default=None, help="Number of frames to process (default: all)")
    parser.add_argument("--save-video", action="store_true", help="Save output to output_demo.mp4")
    parser.add_argument("--no-display", action="store_true", help="Don't open a display window")
    parser.add_argument("--no-lanes", action="store_true", help="Skip on-device lane detection / scene features")
    parser.add_argument("--no-tagging", action="store_true", help="Skip the on-device tagging stage")
    parser.add_argument("--smooth-tracks", action="store_true",
                        help="Opt-in per-agent Kalman smoothing bank (yellow dots = smoothed track centers)")
    parser.add_argument("--test", action="store_true", help="Run the six-component smoke test and exit")
    parser.add_argument("--yolo", action="store_true",
                        help="Detect with the on-device YOLOv8 instead of the simulated detector")
    parser.add_argument("--weights", type=str, default=None,
                        help="YOLO weights: .npz from tools/export_weights.py or a torch state_dict .pt")
    parser.add_argument("--img-size", type=int, default=640, help="YOLO letterbox size (speed/accuracy knob)")
    parser.add_argument("--cameras", type=int, default=1,
                        help="Run N synthetic camera feeds through the camera runner and render a BEV grid")
    parser.add_argument("--start-frame", type=int, default=0, help="First frame index to process (segmented runs)")
    parser.add_argument("--resume", type=str, default=None,
                        help="Restore the pipeline carry saved by --save-state and continue from it")
    parser.add_argument("--save-state", type=str, default=None,
                        help="Save the final pipeline carry for --resume")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    if args.test:
        run_component_test(args.device)
        return

    if args.cameras > 1:
        run_multicamera_demo(
            num_cameras=args.cameras,
            num_frames=args.frames,
            save_video=args.save_video,
            display=not args.no_display,
            enable_tagging=not args.no_tagging,
            device=args.device,
        )
        return

    if args.video is None and not args.synthetic:
        # The reference README documents bare ``python demo.py`` running on
        # synthetic data (README.md:69-75).
        print("No --video given; using the synthetic road-scene generator.")
        args.synthetic = True

    run_demo(
        video_path=args.video,
        num_frames=args.frames,
        save_video=args.save_video,
        display=not args.no_display,
        synthetic=args.synthetic,
        use_frames=not args.no_lanes,
        enable_tagging=not args.no_tagging,
        smooth_tracks=args.smooth_tracks,
        yolo=args.yolo,
        weights=args.weights,
        yolo_img_size=args.img_size,
        start_frame=args.start_frame,
        resume=args.resume,
        save_state=args.save_state,
        device=args.device,
    )


if __name__ == "__main__":
    main()
