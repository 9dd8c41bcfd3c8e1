#!/usr/bin/env python3
"""Drive the PyTorch port's detections-mode path on a CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the device: name, count, and ``nvidia-smi``'s name and power limit;
  2. the kernels build from the sources in the checkout (kernels/build.py);
  3. kernel K1 (tracker step) against its plain version on the card,
     exact on every output, over random, tie-quantized and saturated
     streams at (T, D) = (64, 16) and (128, 64) and the synthetic stream;
  4. kernel K2 (ego Kalman step) against its plain version on the card,
     step by step over a 300-frame chain with unmeasured frames;
  5. the main path: `make_sequence_runner` on the card over the 300-frame
     synthetic stream in bench.py's configuration, against the same runner
     on the CPU, with each kernel's launches counted in that run;
  6. times: each kernel and its plain version by CUDA events at the main
     path's shapes, beside the kernel's bound, and the main path's frames/s.
Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero.  Without a card it exits 1 at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
from multimodal_autonomous_driving_perception_and_planning_torch.data.synthetic import (
    ego_motion_stream,
    simulated_detection_stream,
)
from multimodal_autonomous_driving_perception_and_planning_torch.estimation.ego import (
    _estimator_step_fused,
    _estimator_step_xla,
)
from multimodal_autonomous_driving_perception_and_planning_torch.kernels import build
from multimodal_autonomous_driving_perception_and_planning_torch.ops import (
    kalman_kernel,
    tracker_kernel,
)
from multimodal_autonomous_driving_perception_and_planning_torch.ops.kalman import (
    make_constant_accel_model,
)
from multimodal_autonomous_driving_perception_and_planning_torch.tracking.tracker import (
    confirmed_order,
    tracker_update,
)
from multimodal_autonomous_driving_perception_and_planning_torch.types import (
    Detections,
    KalmanState,
    VEHICLE_STATE_FIELDS,
    TrackTable,
)
from multimodal_autonomous_driving_perception_and_planning_torch.utils.convert import (
    kalman_model_from_numpy,
)

PKG = "multimodal_autonomous_driving_perception_and_planning_torch"
JAX_PKG = "multimodal_autonomous_driving_perception_and_planning_tpu"
NUM_FRAMES = 300
MAIN_ATOL = 1e-4  # PARITY.md budget: card against CPU over the whole run
K2_ATOL, K2_RTOL = 1e-5, 1e-6  # kernel K2 against its plain version, per step
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the float32 rate outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12  # the data sheet's float64 rate outside the tensor cores
PROFILED = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

TABLE_FIELDS = (
    "track_id", "bbox", "class_id", "confidence", "age", "hits", "misses",
    "trajectory", "traj_len", "velocity", "vel_count", "next_id",
)
MAIN_DISCRETE = (
    "track_id", "track_class_id", "track_hits", "track_misses", "track_age",
    "track_vel_count", "confirmed_order", "num_confirmed", "match", "plan_best",
)
MAIN_FLOAT = (
    "track_bbox", "track_confidence", "track_velocity", "plan_costs",
    "plan_best_positions", "plan_best_velocities",
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bench_config():
    """bench.py:146-151: detections in, no frames, no tagging, serving outputs."""
    return pt.DEFAULT_CONFIG.replace(
        use_frames=False, enable_tagging=False, emit_candidates=False, emit_trajectories=False
    )


def synthetic_inputs(num_frames: int = NUM_FRAMES) -> dict:
    dets = simulated_detection_stream(num_frames)
    ego = ego_motion_stream(num_frames, dt=1.0 / 30.0, seed=0).astype(np.float32)
    return dict(dets, ego_measurement=ego)


def random_dets(rng, d_cap: int, device, p_valid: float = 0.6) -> Detections:
    """Tie-heavy detections: coordinates quantized to 20 px give exact IoU
    ties (the cases of tests/test_tracker_pallas.py)."""
    cx, cy = rng.uniform(0, 600, d_cap), rng.uniform(0, 400, d_cap)
    w, h = rng.uniform(30, 150, d_cap), rng.uniform(30, 150, d_cap)
    cx, cy, w, h = (np.round(v / 20) * 20 for v in (cx, cy, w, h))
    bbox = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)
    return Detections(
        bbox=torch.tensor(bbox, dtype=torch.float32, device=device),
        class_id=torch.tensor(rng.integers(0, 8, d_cap), dtype=torch.int32, device=device),
        confidence=torch.tensor(rng.uniform(0.5, 1.0, d_cap), dtype=torch.float32, device=device),
        valid=torch.tensor(rng.random(d_cap) < p_valid, device=device),
    )


def frame_dets(inputs: dict, f: int, device) -> Detections:
    return pt.detections_from_arrays({k: inputs[k][f] for k in ("bbox", "class_id", "confidence", "valid")}, device)


def plain_tracker_step(table, dets, cfg):
    new_table, match = tracker_update(table, dets, cfg)
    order, n_confirmed = confirmed_order(new_table, cfg.min_hits)
    return new_table, match, order, n_confirmed


def _tracker_case(name, cfg, dets_fn, steps, device) -> dict:
    """Step K1 and the plain version side by side from the same table; every
    output must be equal at every step."""
    table = TrackTable.empty(cfg.max_tracks, cfg.trajectory_length, device)
    max_alive = 0
    for step in range(steps):
        dets = dets_fn(step)
        want = plain_tracker_step(table, dets, cfg)
        got = tracker_kernel.tracker_step(table, dets, cfg, cfg.min_hits)
        pairs = [(f, getattr(got[0], f), getattr(want[0], f)) for f in TABLE_FIELDS]
        pairs += list(zip(("match", "order", "n_confirmed"), got[1:], want[1:]))
        for field, a, b in pairs:
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"K1 {name} step {step}: {field} differs from the plain version")
        table = want[0]
        max_alive = max(max_alive, int((table.track_id > 0).sum()))
    return {"case": name, "T": cfg.max_tracks, "steps": steps, "max_alive": max_alive}


def check_tracker_kernel(device, steps: int = 50) -> list:
    """K1 against its plain version: churn at (64, 16) and (128, 64), a
    saturated (64, 16) table, and the synthetic stream at the default size."""
    cases = []
    for t_cap, d_cap, seed in ((64, 16, 1), (128, 64, 2)):
        cfg = pt.TrackerConfig(iou_threshold=0.1, max_age=2, min_hits=3, max_tracks=t_cap)
        rng = np.random.default_rng(seed)
        cases.append(_tracker_case(
            f"churn_{t_cap}x{d_cap}", cfg, lambda s, rng=rng, d=d_cap: random_dets(rng, d, device), steps, device
        ))
    cfg = pt.TrackerConfig(iou_threshold=0.3, max_age=30, min_hits=3, max_tracks=64)
    rng = np.random.default_rng(3)
    cases.append(_tracker_case(
        "saturated_64x16", cfg, lambda s: random_dets(rng, 16, device, p_valid=1.0), steps, device
    ))
    if cases[-1]["max_alive"] != 64:
        raise AssertionError("the saturated case never filled its table")
    inputs = synthetic_inputs()
    cases.append(_tracker_case(
        "synthetic_64x16", pt.TrackerConfig(), lambda s: frame_dets(inputs, s, device), NUM_FRAMES, device
    ))
    return cases


def _kalman_close(got, want, scale=1.0):
    """|got - want| * scale <= atol + rtol |want * scale|, and the worst raw error."""
    err = (got - want).abs()
    ok = bool((err * scale <= K2_ATOL + K2_RTOL * (want * scale).abs()).all())
    return ok, float(err.max())


def check_kalman_kernel(device, frames: int = NUM_FRAMES) -> dict:
    """K2 against its plain version, step by step from the plain chain's
    state, every seventh frame unmeasured.  x, P and the reported fields are
    held at atol 1e-5 + rtol 1e-6 (positions reach 100 m, where one float32
    step is 8e-6); acceleration and yaw rate are finite differences over
    dt, so that bound holds for them times dt."""
    cfg = pt.DEFAULT_CONFIG.estimator
    model = kalman_model_from_numpy(
        *make_constant_accel_model(cfg.dt, cfg.process_noise, cfg.measurement_noise, cfg.accel_noise_scale),
        device=device,
    )
    ego = torch.tensor(ego_motion_stream(frames, dt=1.0 / 30.0, seed=0), dtype=torch.float32, device=device)
    ks = KalmanState.initial(cfg.initial_covariance, device)
    worst = {}
    for f in range(frames):
        has = torch.tensor(f % 7 != 3, device=device)
        want_ks, want_vs = _estimator_step_xla(ks, model, ego[f], has, cfg)
        got_ks, got_vs = _estimator_step_fused(ks, model, ego[f], has, cfg)
        checks = [("state.x", got_ks.x, want_ks.x, 1.0), ("state.P", got_ks.P, want_ks.P, 1.0)]
        for name in VEHICLE_STATE_FIELDS:
            scale = cfg.dt if name in ("acceleration", "yaw_rate") else 1.0
            checks.append((name, getattr(got_vs, name), getattr(want_vs, name), scale))
        for name, a, b, scale in checks:
            ok, err = _kalman_close(a, b, scale)
            worst[name] = max(worst.get(name, 0.0), err)
            if not ok:
                raise AssertionError(f"K2 frame {f}: {name} {a.tolist()} vs plain {b.tolist()}")
        ks = want_ks
    return {"frames": frames, "unmeasured": sum(f % 7 == 3 for f in range(frames)), "max_abs_err": worst}


def check_main_path(device, inputs: dict) -> dict:
    """The runner on the card against the same runner on the CPU; the
    kernels' counts are zeroed just before the card run and read after."""
    cfg = bench_config()
    _, want = pt.make_sequence_runner(cfg, device="cpu")(pt.initial_state(cfg, device="cpu"), inputs)
    run = pt.make_sequence_runner(cfg, device=device)
    state = pt.initial_state(cfg, device=device)
    tracker_kernel.launches = kalman_kernel.launches = 0
    _, got = run(state, inputs)
    torch.cuda.synchronize()
    launches = {"tracker_step": tracker_kernel.launches, "kalman_step": kalman_kernel.launches}
    for k in MAIN_DISCRETE:
        if not torch.equal(got[k].cpu(), want[k]):
            raise AssertionError(f"main path: {k} on the card differs from the CPU run")
    errs = {}
    for k in MAIN_FLOAT:
        errs[k] = float((got[k].cpu() - want[k]).abs().max())
    for name in VEHICLE_STATE_FIELDS:
        errs[f"vehicle_state.{name}"] = float(
            (getattr(got["vehicle_state"], name).cpu() - getattr(want["vehicle_state"], name)).abs().max()
        )
    bad = {k: v for k, v in errs.items() if not v <= MAIN_ATOL}
    if bad:
        raise AssertionError(f"main path: beyond atol {MAIN_ATOL}: {bad}")
    for k, v in got.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"main path: {k} is not finite")
    if launches != {"tracker_step": NUM_FRAMES, "kalman_step": NUM_FRAMES}:
        raise AssertionError(f"main path: kernel launches {launches}, expected {NUM_FRAMES} each")
    return {"frames": NUM_FRAMES, "launches": launches, "max_abs_err": errs,
            "num_confirmed_last": int(got["num_confirmed"][-1]), "plan_best_last": int(got["plan_best"][-1])}


def time_cuda(fn, reps: int, warmup: int = 20) -> float:
    """Milliseconds per call by CUDA events over ``reps`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel_name: str, reps: int = 200) -> float:
    """Mean device time of the kernel named ``kernel_name`` over ``reps``
    calls, from the profiler's trace of the card."""
    with torch.profiler.profile(activities=PROFILED) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel_name in e.name
    ]
    if len(times) != reps:
        raise AssertionError(f"the profiler saw {len(times)} launches of {kernel_name}, expected {reps}")
    return sum(times) / len(times) / 1e3


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _table_tensors(table):
    return [getattr(table, f) for f in TABLE_FIELDS]


def measure_kernels(device, inputs: dict, reps: int = 2000) -> dict:
    """Each kernel and its plain version at the main path's shapes: the
    tracker table after 100 synthetic frames with frame 101's detections,
    the ego filter after 100 frames with a measured frame."""
    cfg = bench_config()
    table = TrackTable.empty(cfg.tracker.max_tracks, cfg.tracker.trajectory_length, device)
    for f in range(100):
        table = plain_tracker_step(table, frame_dets(inputs, f, device), cfg.tracker)[0]
    dets = frame_dets(inputs, 100, device)
    out = tracker_kernel.tracker_step(table, dets, cfg.tracker, cfg.tracker.min_hits)
    t_cap, d_cap = cfg.tracker.max_tracks, inputs["bbox"].shape[1]
    k1_bytes = _nbytes(*_table_tensors(table), dets.bbox, dets.class_id, dets.confidence, dets.valid) + _nbytes(
        *_table_tensors(out[0]), out[1], out[2], out[3]
    )
    # Counted from the kernel's loops on this run's data: 16 operations an
    # IoU pair, a row and a column scan of the matrix each association round
    # (at most matches + 1 rounds, as each round but the last accepts a
    # pair), and two stable ranks over the slots.
    rounds = int((out[1] >= 0).sum()) + 1
    k1_ops = t_cap * d_cap * (16 + 2 * rounds) + 2 * t_cap * t_cap
    def launch_k1():
        return tracker_kernel.tracker_step(table, dets, cfg.tracker, cfg.tracker.min_hits)

    k1 = {
        "ms": time_cuda(launch_k1, reps),
        "device_ms": device_ms(launch_k1, "tracker_step_kernel"),
        "plain_ms": time_cuda(lambda: plain_tracker_step(table, dets, cfg.tracker), reps // 10),
        "bytes": k1_bytes, "operations": k1_ops, "peak_ops_per_s": PEAK_F32_PER_S,
    }

    est = cfg.estimator
    model = kalman_model_from_numpy(
        *make_constant_accel_model(est.dt, est.process_noise, est.measurement_noise, est.accel_noise_scale),
        device=device,
    )
    ego = torch.tensor(inputs["ego_measurement"], device=device)
    ks = KalmanState.initial(est.initial_covariance, device)
    has = torch.ones((), dtype=torch.bool, device=device)
    for f in range(100):
        ks, _ = _estimator_step_xla(ks, model, ego[f], has, est)
    z = ego[100]
    x, P, vs = kalman_kernel.kalman_step(ks, model, z, has, est.dt, est.speed_heading_hold)
    k2_bytes = _nbytes(ks.x, ks.P, ks.time, ks.prev_heading, z, has, model.F, model.Q, model.R) + _nbytes(x, P, vs)
    # Float64 operations of a measured step, counted from the
    # kernel's loops: predict 573, first extraction 4, innovation covariance
    # and Cholesky 46, gain 192, state update 58, Joseph form 1416, reported
    # extraction 14.
    k2_ops = 573 + 4 + 46 + 192 + 58 + 1416 + 14
    def launch_k2():
        return _estimator_step_fused(ks, model, z, has, est)

    k2 = {
        "ms": time_cuda(launch_k2, reps),
        "device_ms": device_ms(launch_k2, "kalman_step_kernel"),
        "plain_ms": time_cuda(lambda: _estimator_step_xla(ks, model, z, has, est), reps // 10),
        "bytes": k2_bytes, "operations": k2_ops, "peak_ops_per_s": PEAK_F64_PER_S,
    }
    for m in (k1, k2):
        t_bytes = m["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = m["operations"] / m["peak_ops_per_s"] * 1e3
        m["bound_ms"], m["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return {"tracker_step": k1, "kalman_step": k2}


def measure_main_path(device, inputs: dict, repeats: int = 3) -> dict:
    """Frames/s of the main path over the 300-frame stream on the host
    clock, ending in a synchronise; the best of a few runs after a warm one."""
    cfg = bench_config()
    run = pt.make_sequence_runner(cfg, device=device)
    xs = {k: torch.as_tensor(v).to(device) for k, v in inputs.items()}
    run(pt.initial_state(cfg, device=device), xs)
    times = []
    for _ in range(repeats):
        state = pt.initial_state(cfg, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state, xs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    # One more run under the profiler: the device's busy share of the wall
    # time and the device work items (kernels, copies) a frame.
    with torch.profiler.profile(activities=PROFILED) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(pt.initial_state(cfg, device=device), xs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in on_device)
    return {
        "frames": NUM_FRAMES, "seconds": times, "frames_per_s": NUM_FRAMES / min(times),
        "profiled": {"wall_us": wall_us, "device_busy_us": busy_us, "busy_share": busy_us / wall_us,
                     "device_items_per_frame": len(on_device) / NUM_FRAMES},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(smi, flush=True)
    emit({"phase": "device", "name": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib = build.kernels()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "binding": type(lib).__name__})

    emit({"phase": "tracker_kernel", "cases": check_tracker_kernel(device), "result": "exact"})
    k2 = check_kalman_kernel(device)
    emit({"phase": "kalman_kernel", **k2})

    inputs = synthetic_inputs()
    main_path = check_main_path(device, inputs)
    emit({"phase": "main_path", **main_path})

    times = measure_kernels(device, inputs)
    fps = measure_main_path(device, inputs)
    emit({"phase": "times", "card": smi, "kernels": times, "main_path": fps})

    sources = {
        "tracker_step": (f"{PKG}/kernels/csrc/tracker_step.cu", f"{JAX_PKG}/ops/tracker_pallas.py:51", 0.0),
        "kalman_step": (f"{PKG}/kernels/csrc/kalman_step.cu", f"{JAX_PKG}/ops/kalman_pallas.py:43",
                        max(k2["max_abs_err"].values())),
    }
    kernels = []
    for name, (source, replaces, err) in sources.items():
        m = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_path["launches"][name], "max_abs_err": err,
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None,
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
