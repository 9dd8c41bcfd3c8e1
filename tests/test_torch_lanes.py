"""The port's lane step (perception/lanes.py) against the JAX package's.

The cases of tests/test_lanes.py, on the port: the Hough finds a drawn
line, one segment a physical line, the overflow flags, the ground-truth
lanes recovered, the EMA, a blank frame, the edge capacity and row band,
the reduced scene pass's tag equivalence, a single-sided lane and the
single short segment's stable fit.  Where a case runs the JAX package's
function, the port's is held to it on the same input: the discrete
outputs bit for bit, the fits by the x they give at rows h, 0.8h and 0.6h
within 1e-3 px.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import SyntheticRoadGenerator
from multimodal_autonomous_driving_perception_and_planning_torch.ops.hough import hough_segments
from multimodal_autonomous_driving_perception_and_planning_torch.ops.image import (
    bgr_to_gray_u8,
    canny,
    gaussian_blur5_u8,
    median_u8,
    trapezoid_roi_mask,
)
from multimodal_autonomous_driving_perception_and_planning_torch.perception import lanes as lt
from multimodal_autonomous_driving_perception_and_planning_torch.types import LaneState
from multimodal_autonomous_driving_perception_and_planning_tpu import DEFAULT_CONFIG as CFG_J
from multimodal_autonomous_driving_perception_and_planning_tpu.perception import lanes as lj
from multimodal_autonomous_driving_perception_and_planning_tpu.types import LaneState as LaneStateJ

CFG = pt.DEFAULT_CONFIG
H = CFG.frame_height
ROWS = (H, 0.8 * H, 0.6 * H)
X_ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the same
    cores, and torch's default of one thread a core each makes them wait
    on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x_at(fit, y):
    fit = np.asarray(fit, np.float64)
    return fit[..., 0] * y * y + fit[..., 1] * y + fit[..., 2]


@pytest.fixture(scope="module")
def jax_lane_step():
    return jax.jit(lj.make_lane_step(CFG_J))


def _steps(jax_lane_step, frames):
    """Both lane steps over ``frames`` from the initial state: per frame the
    port's and JAX's (obs, feats)."""
    st, sj = LaneState.initial("cpu"), LaneStateJ.initial()
    step = lt.make_lane_step(CFG, "cpu")
    out = []
    for f in frames:
        st, obs_t, feats_t = step(st, torch.as_tensor(f))
        sj, obs_j, feats_j = jax_lane_step(sj, jnp.asarray(f))
        out.append(((obs_t, feats_t), (obs_j, feats_j)))
    return out


def _assert_obs_match(obs_t, obs_j):
    for k in ("left_found", "right_found", "has_offset"):
        assert bool(getattr(obs_t, k)) == bool(getattr(obs_j, k)), k
    for k in ("left_confidence", "right_confidence", "offset_px"):
        assert float(getattr(obs_t, k)) == float(getattr(obs_j, k)), k
    for k in ("left_fit", "right_fit"):
        for y in ROWS:
            assert abs(_x_at(getattr(obs_t, k).numpy(), y) - _x_at(getattr(obs_j, k), y)) <= X_ATOL, (k, y)


def test_hough_finds_a_drawn_line():
    img = np.zeros((480, 640), np.uint8)
    cv2.line(img, (100, 400), (300, 100), 255, 1)
    hl = hough_segments(torch.as_tensor(img > 0), vote_threshold=50, min_line_length=50.0)
    valid = hl.valid.numpy()
    assert valid.any()
    seg = hl.segments.numpy()[np.argmax(hl.votes.numpy() * valid)]
    ends = {tuple(seg[:2]), tuple(seg[2:])}
    for want in ((100, 400), (300, 100)):
        assert min(np.hypot(e[0] - want[0], e[1] - want[1]) for e in ends) < 6.0, (seg, want)


def test_hough_one_segment_per_physical_line():
    edges = np.zeros((60, 80), bool)
    edges[30, 20:40] = True
    hl = hough_segments(torch.as_tensor(edges), vote_threshold=5, min_line_length=10, num_thetas=180, max_lines=8,
                        edge_capacity=256)
    valid = hl.valid.numpy()
    assert valid.sum() == 1, hl.segments.numpy()[valid]
    np.testing.assert_allclose(hl.segments.numpy()[valid][0], [20.0, 30.0, 39.0, 30.0], atol=1.5)


def test_hough_overflow_flag():
    img = np.zeros((480, 640), np.uint8)
    cv2.line(img, (100, 400), (300, 100), 255, 1)
    assert not bool(hough_segments(torch.as_tensor(img > 0), vote_threshold=50, min_line_length=50.0).overflow)
    noise = np.random.default_rng(0).random((480, 640)) > 0.5
    assert bool(hough_segments(torch.as_tensor(noise), vote_threshold=1, min_line_length=1.0).overflow)


def test_lane_step_recovers_ground_truth_lanes(jax_lane_step):
    """On the port's own road frame: the lanes of `lane_x_at`, the offset
    near 0, sane features; and the JAX lane step's outputs on it."""
    gen = SyntheticRoadGenerator()
    frame = gen.generate_frame_with_vehicles()
    ((obs, feats), (obs_j, feats_j)), = _steps(jax_lane_step, [frame])
    assert bool(obs.left_found) and bool(obs.right_found)
    for side, fit in (("left", obs.left_fit.numpy()), ("right", obs.right_fit.numpy())):
        for y in (H * 0.99, H * 0.62):
            assert abs(_x_at(fit, y) - gen.lane_x_at(side, y)) < 15.0, (side, y)
    assert bool(obs.has_offset) and abs(float(obs.offset_px)) < 12.0
    assert 0.0 <= float(feats["center_edge_density"]) <= 1.0
    assert float(feats["brightness"]) > 30.0
    assert float(feats["green_ratio"]) > 0.05
    _assert_obs_match(obs, obs_j)
    assert int(feats["num_long_lines"]) == int(feats_j["num_long_lines"])
    for k in ("center_edge_density", "green_ratio"):
        assert float(feats[k]) == float(feats_j[k]), k
    for k in ("brightness", "laplacian_var", "avg_line_length"):  # sums in XLA's own float32 order
        np.testing.assert_allclose(float(feats[k]), float(feats_j[k]), rtol=1e-5, err_msg=k)


def test_lane_step_ema_smoothing(jax_lane_step):
    gen = SyntheticRoadGenerator()
    f1, f2 = gen.generate_frame_with_vehicles(), gen.generate_frame_with_vehicles()
    (o1, _), (o2, _) = [t for t, _ in _steps(jax_lane_step, [f1, f2])]
    _, raw, _ = lt.make_lane_step(CFG, "cpu")(LaneState.initial("cpu"), torch.as_tensor(f2))
    d = (o2.left_fit - o1.left_fit).abs()
    d_raw = (raw.left_fit - o1.left_fit).abs()
    assert (d <= d_raw + 1e-6).all()
    for (obs_t, _), (obs_j, _) in _steps(jax_lane_step, [f1, f2]):
        _assert_obs_match(obs_t, obs_j)


def test_lane_step_no_lanes_in_blank_frame(jax_lane_step):
    blank = np.zeros((CFG.frame_height, CFG.frame_width, 3), np.int32)
    state, obs, _ = lt.make_lane_step(CFG, "cpu")(LaneState.initial("cpu"), torch.as_tensor(blank))
    assert not bool(obs.left_found) and not bool(obs.right_found)
    assert not bool(state.left_valid)
    ((obs_t, _), (obs_j, _)), = _steps(jax_lane_step, [blank])
    _assert_obs_match(obs_t, obs_j)


def test_edge_capacity_and_row_range():
    img = np.zeros((480, 640), np.uint8)
    cv2.line(img, (100, 400), (300, 300), 255, 1)
    cv2.line(img, (400, 300), (550, 420), 255, 1)
    edges = torch.as_tensor(img > 0)

    def run(**kw):
        return hough_segments(edges, vote_threshold=30, min_line_length=30.0, **kw)

    base, small = run(edge_capacity=8192), run(edge_capacity=1024)
    banded = run(edge_capacity=1024, row_range=(288, 480))
    assert not base.edges_overflow and not small.edges_overflow and not banded.edges_overflow
    for a in ("segments", "valid", "votes", "length"):
        np.testing.assert_array_equal(getattr(small, a).numpy(), getattr(base, a).numpy())
        np.testing.assert_array_equal(getattr(banded, a).numpy(), getattr(base, a).numpy())
    noisy = torch.as_tensor(np.random.default_rng(1).random((480, 640)) > 0.5)
    assert bool(hough_segments(noisy, vote_threshold=50, min_line_length=50.0, edge_capacity=1024).edges_overflow)


def test_reduced_scene_pass_tag_equivalent():
    """The port's runner with the default reduced scene pass and with the
    full-resolution, refined one: the same road-type and condition tags
    over 40 frames, and the same lane fits."""
    from multimodal_autonomous_driving_perception_and_planning_torch.data.synthetic import (
        ego_motion_stream,
        simulated_detection_stream,
    )

    n = 40
    base = CFG.replace(use_frames=True, enable_tagging=True)
    assert base.lanes.scene_downsample == 2 and not base.lanes.scene_refine
    full = base.replace(lanes=base.lanes.__class__(**{**base.lanes.__dict__, "scene_downsample": 1,
                                                      "scene_refine": True}))
    inputs = dict(simulated_detection_stream(n), ego_measurement=ego_motion_stream(n, seed=0).astype(np.float32),
                  frame=SyntheticRoadGenerator(base.frame_width, base.frame_height).generate_frames(n))
    outs = {}
    for name, cfg in (("reduced", base), ("full", full)):
        _, outs[name] = pt.make_sequence_runner(cfg, device="cpu")(pt.initial_state(cfg, device="cpu"), inputs)
    r, fl = outs["reduced"]["tags"], outs["full"]["tags"]
    np.testing.assert_array_equal(r["road_type"].numpy(), fl["road_type"].numpy())
    np.testing.assert_array_equal(r["road_type_raw"].numpy(), fl["road_type_raw"].numpy())
    np.testing.assert_allclose(r["road_type_confidence"].numpy(), fl["road_type_confidence"].numpy(), atol=1e-6)
    for k in ("cond_night", "cond_day", "cond_congested", "cond_clear", "cond_fog"):
        np.testing.assert_array_equal(r[k].numpy(), fl[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(outs["reduced"]["lane_obs"].left_fit.numpy(), outs["full"]["lane_obs"].left_fit.numpy())


def test_lane_step_single_sided_lane(jax_lane_step):
    frame = np.zeros((CFG.frame_height, CFG.frame_width, 3), np.uint8)
    cv2.line(frame, (160, 470), (280, 295), (255, 255, 255), 3)
    state, obs, _ = lt.make_lane_step(CFG, "cpu")(LaneState.initial("cpu"), torch.as_tensor(frame))
    assert bool(obs.left_found) and not bool(obs.right_found) and not bool(obs.has_offset)
    fit = obs.left_fit.numpy()
    for y in (460.0, 310.0):
        assert abs(_x_at(fit, y) - (160 + (280 - 160) * (470 - y) / (470 - 295))) < 10.0, y
    assert bool(state.left_valid) and not bool(state.right_valid)
    ((obs_t, _), (obs_j, _)), = _steps(jax_lane_step, [frame])
    _assert_obs_match(obs_t, obs_j)


@pytest.mark.parametrize("seg", [[100.0, 415.8, 147.4, 400.0], [100.0, 377.0, 242.0, 330.0]], ids=["50px", "150px"])
def test_single_short_segment_fit_is_stable(seg):
    """A single 50 px (and 150 px) segment: the per-fit standardised basis
    tracks the float64 least-squares solution inside the support band, and
    the port's fit gives JAX's x there within 1e-3 px."""
    lines = np.zeros((64, 4), np.float32)
    valid = np.zeros(64, bool)
    lines[0], valid[0] = seg, True
    (lf, lok, _), _ = lt._separate_and_fit(torch.as_tensor(lines), torch.as_tensor(valid), 640, 480)
    (lf_j, _, _), _ = jax.jit(lambda l, v: lj._separate_and_fit(l, v, 640, 480))(jnp.asarray(lines), jnp.asarray(valid))
    assert bool(lok)
    t = np.linspace(0, 1, 8)
    sx = seg[0] + (seg[2] - seg[0]) * t
    sy = seg[1] + (seg[3] - seg[1]) * t
    ref, *_ = np.linalg.lstsq(np.stack([sy * sy, sy, np.ones_like(sy)], -1), sx, rcond=None)
    for yv in (sy.min(), sy.mean(), sy.max()):
        assert abs(_x_at(lf.numpy(), yv) - _x_at(ref, yv)) < 0.1, yv
        assert abs(_x_at(lf.numpy(), yv) - _x_at(lf_j, yv)) <= X_ATOL, yv


def test_perception_exports_the_lane_step():
    """The port's perception package exports what the JAX package's does,
    the same functions as perception/lanes.py."""
    import multimodal_autonomous_driving_perception_and_planning_torch.perception as pp
    import multimodal_autonomous_driving_perception_and_planning_tpu.perception as pj

    assert sorted(pp.__all__) == sorted(pj.__all__) == ["fit_lane_polynomial", "make_lane_step"]
    assert pp.make_lane_step is lt.make_lane_step and pp.fit_lane_polynomial is lt.fit_lane_polynomial


def test_lane_step_runs_on_the_card_by_default(monkeypatch):
    """`make_lane_step` runs on the card unless the caller asks for the
    CPU: without a card it refuses, with ``"cpu"`` it builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lt.make_lane_step(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lt.make_lane_step(CFG, "cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        lt.make_lane_step(CFG, "meta")
    assert callable(lt.make_lane_step(CFG, "cpu"))


def test_fit_lane_polynomial_matches_jax():
    """The public single-system fit on weighted lane-like samples: x at the
    three rows within 1e-3 px, b and c within rtol 1e-4 of JAX's."""
    rng = np.random.default_rng(7)
    ys = rng.uniform(0.6 * H, H, 64).astype(np.float32)
    xs = (2e-4 * ys * ys - 0.9 * ys + 420.0 + rng.normal(0, 0.5, 64)).astype(np.float32)
    wgt = (rng.random(64) > 0.25).astype(np.float32)
    got = lt.fit_lane_polynomial(torch.as_tensor(xs), torch.as_tensor(ys), torch.as_tensor(wgt), float(H)).numpy()
    want = np.asarray(jax.jit(lambda x, y, w: lj.fit_lane_polynomial(x, y, w, float(H)))(xs, ys, wgt))
    assert got.shape == want.shape == (3,)
    for y in ROWS:
        assert abs(_x_at(got, y) - _x_at(want, y)) <= X_ATOL, y
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4, atol=0)


def test_curvature_gap_follows_its_conditioning():
    """Why the fits' curvature coefficient a is held at rtol 1e-3 and not
    1e-4.  On the road frames' lane segments (the port's, fed to both
    fits), the normal equations are well conditioned (cond(G) < 10 in the
    standardised basis), but a is not: on these straight lanes the
    curvature's whole share of x over the band, |a| var(y), is about 1e-4
    of |x|, so a rounding of x-sized float32 sums moves a by up to
    eps32 kappa_a, kappa_a = max|x| / (|a| var(y)).  The port's a stands
    within that of JAX's (and of the float64 fit), and within 1e-3; b and
    c within 1e-4 and x at the three rows within 1e-3 px."""
    lc = CFG.lanes
    w = CFG.frame_width
    roi = torch.as_tensor(trapezoid_roi_mask(H, w, lc.roi_bottom_frac, lc.roi_top_frac, lc.roi_top_y_frac))
    fit_j = jax.jit(lambda seg, v: lj._separate_and_fit(seg, v, w, H, min_abs_slope=lc.min_abs_slope))
    t8 = lt.linspace01(8).astype(np.float64)
    readings = []
    for frame in SyntheticRoadGenerator(draw_adjacent_dash=True).generate_frames(8):
        blurred = gaussian_blur5_u8(bgr_to_gray_u8(torch.as_tensor(frame)))
        med = median_u8(blurred)
        low = torch.floor(torch.clamp(torch.tensor(0.7) * med, min=0.0))
        high = torch.floor(torch.clamp(torch.tensor(1.3) * med, max=255.0))
        hl = hough_segments(canny(blurred, low, high) & roi, vote_threshold=lc.hough_threshold,
                            min_line_length=lc.hough_min_line_length, max_lines=lc.max_lines,
                            edge_capacity=lc.lane_edge_capacity, row_range=(int(H * lc.roi_top_y_frac), H))
        sides_t = lt._separate_and_fit(hl.segments, hl.valid, w, H, min_abs_slope=lc.min_abs_slope)
        sides_j = fit_j(jnp.asarray(hl.segments.numpy()), jnp.asarray(hl.valid.numpy()))
        x1, y1, x2, y2 = hl.segments.numpy().astype(np.float64).T
        dx = x2 - x1
        slope = (y2 - y1) / np.where(dx == 0, 1.0, dx)
        usable = hl.valid.numpy() & (dx != 0) & (np.abs(slope) >= lc.min_abs_slope)
        mid = (x1 + x2) * 0.5
        for (fit_t, found, _), (fit_jx, _, _), sel in zip(
            sides_t, sides_j, (usable & (slope < 0) & (mid < w / 2), usable & (slope > 0) & (mid > w / 2))
        ):
            if not bool(found):
                continue
            sx = (x1[sel, None] + dx[sel, None] * t8).ravel()
            sy = (y1[sel, None] + (y2 - y1)[sel, None] * t8).ravel()
            ref = np.polyfit(sy, sx, 2)
            tt = (sy - sy.mean()) / sy.std()
            basis = np.stack([tt * tt, tt, np.ones_like(tt)], -1)
            a_t, a_j = fit_t.numpy().astype(np.float64), np.asarray(fit_jx, np.float64)
            kappa = np.abs(sx).max() / (abs(ref[0]) * sy.var())
            readings.append((np.linalg.cond(basis.T @ basis), kappa, abs(a_t[0] - a_j[0]) / abs(a_j[0]),
                             abs(a_t[0] - ref[0]) / abs(ref[0])))
            for y in ROWS:
                assert abs(_x_at(a_t, y) - _x_at(a_j, y)) <= X_ATOL, y
            np.testing.assert_allclose(a_t[1:], a_j[1:], rtol=1e-4, atol=0)
    cond_g, kappa, gap_j, gap_64 = np.asarray(readings).T
    eps32 = float(np.finfo(np.float32).eps) / 2
    assert len(readings) >= 12 and (cond_g < 10).all()
    assert (gap_j <= eps32 * kappa).all() and (gap_64 <= eps32 * kappa).all()
    assert (gap_j <= 1e-3).all() and (kappa > 1e3).all()
    print(f"fits {len(readings)}: cond(G) {cond_g.min():.3g}-{cond_g.max():.3g}, kappa_a {kappa.min():.3g}-"
          f"{kappa.max():.3g}, a port-JAX {gap_j.max():.3g}, port-float64 {gap_64.max():.3g} (relative)")


@pytest.mark.parametrize("n", range(1, 65))
def test_linspace_matches_jnp(n):
    """The fit's sample grid, `linspace01`, equals jnp.linspace(0, 1, n) in
    float32 bit for bit, jitted or not, where torch.linspace rounds some
    values otherwise (at 8 samples, two)."""
    got = lt.linspace01(n)
    for want in (np.asarray(jnp.linspace(0.0, 1.0, n)), np.asarray(jax.jit(lambda: jnp.linspace(0.0, 1.0, n))())):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if n == 8:
        assert (torch.linspace(0.0, 1.0, 8).numpy() != got).sum() == 2


@pytest.mark.parametrize("fit_samples", (2, 5, 16))
def test_separate_and_fit_takes_any_sample_count(fit_samples):
    """`_separate_and_fit` at 2, 5 and 16 samples a segment against JAX's
    on the lane segments of 8 road frames, at the bars of the 8-sample
    test (`test_curvature_gap_follows_its_conditioning`): found and the
    confidences exact, x at rows h, 0.8h and 0.6h within 1e-3 px, b and c
    within rtol 1e-4."""
    lc = CFG.lanes
    w = CFG.frame_width
    roi = torch.as_tensor(trapezoid_roi_mask(H, w, lc.roi_bottom_frac, lc.roi_top_frac, lc.roi_top_y_frac))
    fit_j = jax.jit(lambda seg, v: lj._separate_and_fit(seg, v, w, H, min_abs_slope=lc.min_abs_slope,
                                                        fit_samples=fit_samples))
    fits = 0
    for frame in SyntheticRoadGenerator(draw_adjacent_dash=True).generate_frames(8):
        blurred = gaussian_blur5_u8(bgr_to_gray_u8(torch.as_tensor(frame)))
        med = median_u8(blurred)
        low = torch.floor(torch.clamp(torch.tensor(0.7) * med, min=0.0))
        high = torch.floor(torch.clamp(torch.tensor(1.3) * med, max=255.0))
        hl = hough_segments(canny(blurred, low, high) & roi, vote_threshold=lc.hough_threshold,
                            min_line_length=lc.hough_min_line_length, max_lines=lc.max_lines,
                            edge_capacity=lc.lane_edge_capacity, row_range=(int(H * lc.roi_top_y_frac), H))
        sides_t = lt._separate_and_fit(hl.segments, hl.valid, w, H, min_abs_slope=lc.min_abs_slope,
                                       fit_samples=fit_samples)
        sides_j = fit_j(jnp.asarray(hl.segments.numpy()), jnp.asarray(hl.valid.numpy()))
        for (fit_t, found_t, conf_t), (fit_jx, found_j, conf_j) in zip(sides_t, sides_j):
            assert bool(found_t) == bool(found_j) and float(conf_t) == float(conf_j)
            if not bool(found_t):
                continue
            fits += 1
            a_t, a_j = fit_t.numpy().astype(np.float64), np.asarray(fit_jx, np.float64)
            for y in ROWS:
                assert abs(_x_at(a_t, y) - _x_at(a_j, y)) <= X_ATOL, (fit_samples, y)
            np.testing.assert_allclose(a_t[1:], a_j[1:], rtol=1e-4, atol=0)
    assert fits >= 12
