"""Kernel K6's dispatch and its schedule, on the CPU.

K6 (kernels/csrc/plan_step.cu) runs only on the card.  Here: which path
each caller takes (the tensor ops on the CPU and in the exported frame
step, the kernel's wrapper elsewhere on the card), that the segment span
counts K6's launches, that the C launcher, the binding and the wrapper
agree on the call, and `k6_model`, the kernel's schedule written out in
numpy float32 (a warp a candidate, a lane a waypoint in chunks of 32, the
warp scan with its carry, neighbours by shuffles, lane sums reduced by an
xor butterfly, the order by counting), held to the plain version at the
tolerances the card tests use (chip_smoke.py `check_planner_kernel`).
This file imports no JAX.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_autonomous_driving_perception_and_planning_torch import pipeline
from multimodal_autonomous_driving_perception_and_planning_torch.config import DEFAULT_CONFIG, PlannerConfig
from multimodal_autonomous_driving_perception_and_planning_torch.kernels import build
from multimodal_autonomous_driving_perception_and_planning_torch.ops import planner_kernel, quintic
from multimodal_autonomous_driving_perception_and_planning_torch.perception import detector
from multimodal_autonomous_driving_perception_and_planning_torch.planning import planner
from multimodal_autonomous_driving_perception_and_planning_torch.types import VEHICLE_STATE_FIELDS, PlanResult

F32 = np.float32
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "multimodal_autonomous_driving_perception_and_planning_torch"


def _up(a: np.ndarray, carry) -> np.ndarray:
    """`__shfl_up_sync(a, 1)` over a chunk's 32 lanes, lane 0 taking
    ``carry`` (the previous chunk's lane 31)."""
    return np.concatenate([np.asarray([carry], F32), a[:-1]])


def _warp_sum(a: np.ndarray) -> F32:
    """plan_step.cu `warp_sum`: the xor butterfly, every lane ending with
    the total; lane 0's."""
    a = a.copy()
    for d in (16, 8, 4, 2, 1):
        a = (a + a[np.arange(32) ^ d]).astype(F32)
    return a[0]


def k6_model(state, cfg, ref=None, ref_valid=None, obs=None, obs_valid=None):
    """One lane of K6, as plan_step.cu computes it, in numpy float32:
    ``state`` (x, y, heading, speed).  Returns the fields of the plan and
    the order and best."""
    lat, tv = (t.numpy() for t in quintic.candidate_grid(
        cfg.num_samples, cfg.lateral_range, tuple(cfg.target_velocities), CPU))
    t, alpha, blend = (x.numpy() for x in quintic._time_grid(cfg.planning_horizon, cfg.dt, CPU))
    C, N = lat.shape[0], t.shape[0]
    x0, y0, h0, v0 = (F32(v) for v in state)
    dt, cruise = F32(cfg.dt), F32(cfg.cruise_velocity)
    c, sn = np.cos(h0).astype(F32), np.sin(h0).astype(F32)
    hn = F32(h0 + F32(np.pi / 2))
    cp, sp = np.cos(hn).astype(F32), np.sin(hn).astype(F32)
    ref_any = ref is not None and (ref_valid is None or bool(np.any(ref_valid)))
    pos = np.zeros((C, N, 2), F32)
    head, vel, curv = (np.zeros((C, N), F32) for _ in range(3))
    cost = np.zeros(C, F32)
    lanes = np.arange(32)
    for k in range(C):
        dvel = F32(tv[k] - v0)
        vel0 = F32(v0 + F32(dvel * alpha[0]))
        carry = xc = yc = vc = tc = hc = F32(0)
        sums = {n: np.zeros(32, F32) for n in ("vel", "acc", "curv", "ref", "obs")}
        for base in range(0, N + 1, 32):
            i = base + lanes
            live = i < N
            ii = np.minimum(i, N - 1)
            v = np.where(live, (v0 + (dvel * alpha[ii]).astype(F32)).astype(F32), F32(0)).astype(F32)
            ti = np.where(live, t[ii], F32(0)).astype(F32)
            cum = v.copy()
            for d in (1, 2, 4, 8, 16):
                cum = np.where(lanes >= d, (np.roll(cum, d) + cum).astype(F32), cum).astype(F32)
            cum = (carry + cum).astype(F32)
            carry = cum[31]
            s = ((cum - vel0).astype(F32) * dt).astype(F32)
            lo = (lat[k] * blend[ii]).astype(F32)
            x = np.where(live, ((x0 + (s * c).astype(F32)).astype(F32) + (lo * cp).astype(F32)).astype(F32), F32(0))
            y = np.where(live, ((y0 + (s * sn).astype(F32)).astype(F32) + (lo * sp).astype(F32)).astype(F32), F32(0))
            x, y = x.astype(F32), y.astype(F32)
            pos[k, i[live], 0], pos[k, i[live], 1], vel[k, i[live]] = x[live], y[live], v[live]
            e = (v - cruise).astype(F32)
            sums["vel"] = np.where(live, sums["vel"] + e * e, sums["vel"]).astype(F32)
            if ref is not None:
                d = np.sqrt(((x[:, None] - ref[None, :, 0]) ** 2 + (y[:, None] - ref[None, :, 1]) ** 2).astype(F32))
                if ref_valid is not None:
                    d = np.where(ref_valid[None, :], d, F32(np.inf))
                m = d.min(axis=1).astype(F32)
                sums["ref"] = np.where(live, sums["ref"] + m * m, sums["ref"]).astype(F32)
            if obs is not None:
                rad = obs[None, :, 2]
                dist = np.sqrt(((x[:, None] - obs[None, :, 0]) ** 2 + (y[:, None] - obs[None, :, 1]) ** 2).astype(F32))
                r2, r4 = (rad * F32(2)).astype(F32), (rad * F32(4)).astype(F32)
                hard = np.where(dist < r2, ((r2 - dist) * F32(1000)).astype(F32), F32(0))
                with np.errstate(divide="ignore"):
                    inv = (F32(1) / ((dist - rad).astype(F32) + F32(0.1)).astype(F32)).astype(F32)
                soft = np.where((dist >= r2) & (dist < r4), (inv * F32(10)).astype(F32), F32(0))
                pen = (hard + soft).astype(F32)
                if obs_valid is not None:
                    pen = np.where(obs_valid[None, :], pen, F32(0))
                for o in range(pen.shape[1]):
                    sums["obs"] = np.where(live, sums["obs"] + pen[:, o], sums["obs"]).astype(F32)
            xm, ym, vm, tm = _up(x, xc), _up(y, yc), _up(v, vc), _up(ti, tc)
            mid = (i >= 1) & (i < N)
            h = np.where(mid, np.arctan2((y - ym).astype(F32), (x - xm).astype(F32)).astype(F32), F32(0))
            hm = _up(h, hc)
            h = np.where(i == N, hm, h).astype(F32)
            out = (i >= 1) & (i <= N)
            head[k, i[out] - 1] = h[out]
            inner = (i >= 2) & (i < N)
            with np.errstate(divide="ignore", invalid="ignore"):
                kap = np.where(inner, ((h - hm).astype(F32) / ((vm * dt).astype(F32) + F32(1e-6)).astype(F32)).astype(F32),
                               F32(0))
            curv[k, i[out] - 1] = kap[out]
            sums["curv"] = np.where(out, sums["curv"] + kap * kap, sums["curv"]).astype(F32)
            dts = (ti - tm).astype(F32)
            with np.errstate(divide="ignore", invalid="ignore"):
                a = np.where(dts > 0, ((v - vm).astype(F32) / dts).astype(F32), F32(0))
            sums["acc"] = np.where(mid, sums["acc"] + a * a, sums["acc"]).astype(F32)
            xc, yc, vc, tc, hc = x[31], y[31], v[31], ti[31], h[31]
        tot = {n: _warp_sum(a) for n, a in sums.items()}
        total = F32(tot["vel"] * F32(cfg.w_velocity))
        total = F32(total + F32(tot["acc"] * F32(cfg.w_acceleration)))
        total = F32(total + F32(tot["curv"] * F32(cfg.w_curvature)))
        if ref is not None:
            total = F32(total + F32((tot["ref"] if ref_any else F32(0)) * F32(cfg.w_lateral)))
        if obs is not None:
            total = F32(total + tot["obs"])
        cost[k] = total

    def before(a, j, b, i):
        if np.isnan(a) != np.isnan(b):
            return bool(np.isnan(b))
        if not np.isnan(a) and a != b:
            return bool(a < b)
        return j < i

    order = np.empty(C, np.int32)
    for i in range(C):
        order[sum(before(cost[j], j, cost[i], i) for j in range(C))] = i
    return {"positions": pos, "headings": head, "velocities": vel, "curvatures": curv, "costs": cost,
            "order": order, "best": int(order[0])}


STATES = chip_smoke.PLANNER_STATES


def _plan_of(fields: dict, cfg) -> tuple:
    """`k6_model`'s fields (lane axes in front) as the kernel's wrapper
    returns them: (the plan, the chosen positions, the chosen velocities)."""
    lat, tv = quintic.candidate_grid(cfg.num_samples, cfg.lateral_range, tuple(cfg.target_velocities), CPU)
    t = quintic._time_grid(cfg.planning_horizon, cfg.dt, CPU)[0]
    f = {k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()}
    best = f["best"].to(torch.int32)
    pr = PlanResult(positions=f["positions"], headings=f["headings"], velocities=f["velocities"],
                    curvatures=f["curvatures"], timestamps=t, costs=f["costs"], lateral_offsets=lat,
                    target_velocities=tv, best=best, order=f["order"])
    flat = best.reshape(-1).long()
    lanes = torch.arange(flat.numel())
    N = f["velocities"].shape[-1]
    pos = f["positions"].reshape(-1, lat.shape[0], N, 2)[lanes, flat].reshape(best.shape + (N, 2))
    vel = f["velocities"].reshape(-1, lat.shape[0], N)[lanes, flat].reshape(best.shape + (N,))
    return pr, pos, vel


def model_plan_step(state, cfg, reference_positions=None, reference_valid=None, obstacles=None,
                    obstacles_valid=None, fields=planner_kernel.STATE_FIELDS) -> tuple:
    """`planner_kernel.plan_step` with `k6_model` in the kernel's place,
    lane by lane."""
    lead = tuple(state.shape[:-1])
    flat = state.reshape(-1, state.shape[-1]).numpy()
    extra = {"ref": reference_positions, "ref_valid": reference_valid, "obs": obstacles, "obs_valid": obstacles_valid}
    lanes = []
    for b in range(flat.shape[0]):
        pick = {k: v.numpy().reshape(flat.shape[0], *v.shape[len(lead):])[b] for k, v in extra.items() if v is not None}
        lanes.append(k6_model(flat[b, list(fields)], cfg, **pick))
    return _plan_of({k: np.stack([np.asarray(m[k]) for m in lanes]).reshape(lead + np.asarray(lanes[0][k]).shape)
                     for k in lanes[0]}, cfg)


def _hold(label: str, fields: dict, pr, cfg) -> dict:
    return chip_smoke.hold_plan(label, chip_smoke.plan_fields(*_plan_of(fields, cfg)), chip_smoke.plan_fields(pr),
                                cfg.dt)


@pytest.mark.parametrize("name", list(STATES))
def test_k6_model_matches_plain_on_the_default_grid(name):
    cfg = PlannerConfig()
    got = k6_model(STATES[name], cfg)
    _hold(name, got, planner.plan_plain(torch.tensor(STATES[name], dtype=torch.float32), cfg), cfg)
    assert np.array_equal(got["curvatures"][:, [0, -1]], np.zeros((21, 2), F32))
    assert np.array_equal(got["headings"][:, -1], got["headings"][:, -2])


@pytest.mark.parametrize("case", ["ref_none", "ref_some", "ref_all", "obstacles"])
def test_k6_model_matches_plain_with_references_and_obstacles(case):
    cfg = PlannerConfig()
    state = STATES["plain"]
    arrays = chip_smoke.planner_inputs(case, cfg.max_reference_points, cfg.max_obstacles)
    names = {"reference_positions": "ref", "reference_valid": "ref_valid", "obstacles": "obs",
             "obstacles_valid": "obs_valid"}
    got = k6_model(state, cfg, **{names[k]: v for k, v in arrays.items()})
    pr = planner.plan_plain(torch.tensor(state), cfg, **{k: torch.from_numpy(v) for k, v in arrays.items()})
    _hold(case, got, pr, cfg)
    if case == "obstacles":
        bare = planner.plan_plain(torch.tensor(state), cfg).costs.numpy()
        assert np.all(got["costs"] >= bare - 1e-3) and np.any(got["costs"] > bare + 1.0)


def test_k6_model_takes_grids_beyond_a_warp():
    """C = 55 candidates (more than the block's 32 warps) of N = 81
    waypoints (three chunks of 32)."""
    wide = chip_smoke.PLANNER_WIDE
    got = k6_model(STATES["plain"], wide)
    pr = planner.plan_plain(torch.tensor(STATES["plain"]), wide)
    assert pr.costs.shape == (55,) and pr.positions.shape == (55, 81, 2)
    _hold("wide", got, pr, wide)


def test_k6_model_ties_go_by_index():
    """All costs equal (every weight 0) and two equal minima (a target
    speed listed twice): the order is the stable one, best the first; a
    NaN start: every cost NaN, the index order."""
    zero = dataclasses.replace(PlannerConfig(), w_velocity=0.0, w_acceleration=0.0, w_curvature=0.0)
    got = k6_model(STATES["plain"], zero)
    assert got["order"].tolist() == list(range(21)) and got["best"] == 0
    twice = PlannerConfig(target_velocities=(10.0, 10.0))
    got = k6_model(STATES["plain"], twice)
    pr = planner.plan_plain(torch.tensor(STATES["plain"]), twice)
    assert got["costs"][got["best"]] == got["costs"][got["best"] + 1]
    assert got["best"] % 2 == 0 and got["best"] == int(pr.best)
    nan = k6_model((float("nan"), 0.0, 0.0, 10.0), PlannerConfig())
    assert np.isnan(nan["costs"]).all() and nan["order"].tolist() == list(range(21))


def test_card_check_holds_the_kernels_schedule(monkeypatch):
    """chip_smoke.py `check_planner_kernel`, the card test of K6, run here
    with `k6_model` in the kernel's place (1 and 8 lanes): every case
    within its bars, and each lane of a batch its one-lane launch."""
    monkeypatch.setattr(planner_kernel, "plan_step", model_plan_step)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cases = chip_smoke.check_planner_kernel(CPU, lane_counts=(1, 8))
    assert [c["case"] for c in cases] == list(STATES) + [
        "nan_start", "ref_none", "ref_some", "ref_all", "obstacles", "all_costs_equal", "two_equal_minima",
        "wide_55x81", "lanes_1", "lanes_8"]
    assert cases[-1]["lanes"] == 8 and cases[-3]["C"] == 55 and cases[-3]["N"] == 81


def test_plan_on_the_cpu_runs_the_tensor_ops(monkeypatch):
    """`plan` and `plan_from_row` on CPU tensors are the plain version,
    bit for bit, and never reach the kernel's wrapper."""
    monkeypatch.setattr(planner_kernel, "plan_step", lambda *a, **k: pytest.fail("K6 on a CPU state"))
    before = planner_kernel.launches
    cfg = PlannerConfig()
    state = torch.tensor(STATES["plain"])
    got, want = planner.plan(state, cfg), planner.plan_plain(state, cfg)
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    rows = torch.zeros((3, len(VEHICLE_STATE_FIELDS)))
    rows[:, list(planner_kernel.ROW_FIELDS)] = torch.tensor([STATES["plain"], STATES["zero_speed"], STATES["far_off"]])
    pr, best_pos, best_vel = planner.plan_from_row(rows, cfg)
    for b in range(3):
        one = planner.plan_plain(rows[b, list(planner_kernel.ROW_FIELDS)], cfg)
        assert torch.equal(best_pos[b], one.positions[int(one.best)])
        assert torch.equal(best_vel[b], one.velocities[int(one.best)])
        assert int(pr.best[b]) == int(one.best)
    assert planner_kernel.launches == before


@pytest.mark.parametrize("ops", [False, True])
def test_frame_step_plans_through_the_path_of_its_kind(monkeypatch, ops):
    """The frame step calls `plan_from_row` (K6 on the card), and with
    ``ops``, the program utils/export.py traces, `plan_from_row_plain` by
    name: the exported program holds no call of the kernel library."""
    called = []
    for name in ("plan_from_row", "plan_from_row_plain"):
        fn = getattr(planner, name)
        monkeypatch.setattr(planner, name, lambda *a, _fn=fn, _name=name, **k: called.append(_name) or _fn(*a, **k))
    cfg = DEFAULT_CONFIG
    step = pipeline._make_frame_step(cfg, CPU, ops=ops)
    inputs = {k: torch.as_tensor(v[0]) for k, v in _stream(cfg, 1).items()}
    dets = pipeline.Detections(bbox=inputs.pop("bbox"), class_id=inputs.pop("class_id"),
                               confidence=inputs.pop("confidence"), valid=inputs.pop("valid"))
    _, out, _ = step(pipeline.initial_state(cfg, device="cpu"), dict(inputs, detections=dets))
    # On the CPU `plan_from_row` runs `plan_from_row_plain` in turn.
    assert called == (["plan_from_row_plain"] if ops else ["plan_from_row", "plan_from_row_plain"])
    assert out["plan_best_positions"].shape == (cfg.planner.num_waypoints, 2)


def _stream(cfg, frames: int) -> dict:
    D = cfg.detector.max_detections
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 400, (frames, D, 2)).astype(F32)
    return {
        "bbox": np.concatenate([xy, xy + 40], axis=-1),
        "class_id": rng.integers(0, 5, (frames, D)).astype(np.int32),
        "confidence": rng.uniform(0.3, 1, (frames, D)).astype(F32),
        "valid": rng.uniform(size=(frames, D)) < 0.5,
        "ego_measurement": np.tile(np.asarray([0.0, 0.0, 9.0, 0.5], F32), (frames, 1)),
    }


def test_segment_spans_carry_k6_launches():
    assert set(detector._kernel_launches()) == {"k1_launches", "k2_launches", "k3_launches", "k5_launches",
                                                "k6_launches"}
    before = detector._kernel_launches()["k6_launches"]
    planner_kernel.launches += 2
    try:
        assert detector._kernel_launches()["k6_launches"] == before + 2
    finally:
        planner_kernel.launches -= 2


def test_plan_step_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA kernel"):
        planner_kernel.plan_step(torch.zeros(4), PlannerConfig())


def test_launcher_binding_and_wrapper_agree_on_the_call():
    """The C launcher's parameters, the binding's count and the ctypes
    argument types describe one call: 12 pointers, 10 ints, 6 floats and
    the stream; the wrapper's output layout is the kernel's `carve`."""
    src = (PKG / "kernels" / "csrc" / "plan_step.cu").read_text()
    params = [p.split()[:-1] for p in re.search(r'extern "C" int madpp_plan_step\(([^)]*)\)', src).group(1).split(",")]
    assert [p[-1] for p in params] == ["void*"] * 12 + ["int"] * 10 + ["float"] * 6 + ["void*"]
    assert 'if (a.size() != 29) throw std::invalid_argument("plan_step takes 29 arguments")' in (
        PKG / "kernels" / "csrc" / "bindings.cpp").read_text()
    assert "[vp] * 12 + [ci] * 10 + [cf] * 6 + [vp]" in (PKG / "kernels" / "build.py").read_text()
    assert "plan_step.cu" in build.CUDA_SOURCES
    fshapes, ishapes = planner_kernel.output_shapes(21, 51, (8,))
    assert [s[1:] for s in fshapes] == [(21, 51, 2), (21, 51), (21, 51), (21, 51), (21,), (51, 2), (51,)]
    assert ishapes == ((8, 21), (8,))
    assert len(fshapes) == len(planner_kernel.FLOAT_FIELDS) and len(ishapes) == len(planner_kernel.INT_FIELDS)
    assert planner_kernel.ROW_FIELDS == (0, 1, 4, 5)
