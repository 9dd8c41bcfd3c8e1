"""The port's Hough transform (ops/hough.py) against the JAX package's,
jitted.

The edge compaction, the accumulator, the peaks, the pool and the votes
must be equal bit for bit, and so must the feature-only segments of the
scene pass; the refined lane segments lean on ``atan2``, ``cos`` and
``sin`` of data, where torch and XLA stand ulps apart, and are held within
atol 1e-4.  The float arithmetic the port copies from compiled XLA is
pinned on its own: XLA's ``cos``/``sin`` tables of every theta grid, and
the contraction of
``rho``, the supports and the projections into fused multiply-adds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_autonomous_driving_perception_and_planning_torch.ops import hough as ht
from multimodal_autonomous_driving_perception_and_planning_torch.ops.geometry import fma32
from multimodal_autonomous_driving_perception_and_planning_tpu.ops import hough as hj

ATOL = 1e-4
FIELDS = ("segments", "valid", "votes", "length", "overflow", "edges_overflow")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the same
    cores, and torch's default of one thread a core each makes them wait
    on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_hough(**kw):
    return jax.jit(lambda e: hj.hough_segments(e, **kw))


def _both(edges, refine=True, **kw):
    """HoughLines of the port and of jitted JAX on one numpy edge map."""
    want = _jax_hough(refine=refine, **kw)(jnp.asarray(edges))
    got = ht.hough_segments(torch.as_tensor(edges), refine=refine, **kw)
    return got, want


def _assert_lines_match(got, want, exact_floats):
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        if f in ("segments", "length") and not exact_floats:
            assert a.dtype == b.dtype, f
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=f)
        else:
            assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f)


def _theta_grid(num_thetas=180):
    return jnp.arange(num_thetas, dtype=jnp.float32) * (jnp.pi / num_thetas)


def test_xla_trig_tables_regenerate():
    """The carried tables are XLA's cos and sin of the theta grid, jitted
    as `hough_segments` computes them; torch's own cos and sin, and the
    correctly rounded values, differ from them on a few angles."""
    cos_j, sin_j = (np.asarray(jax.jit(f)(_theta_grid())) for f in (jnp.cos, jnp.sin))
    cos_t, sin_t = (t.numpy() for t in ht.theta_tables(180, torch.device("cpu")))
    np.testing.assert_array_equal(cos_t, cos_j)
    np.testing.assert_array_equal(sin_t, sin_j)
    theta = torch.arange(180, dtype=torch.float32) * (np.pi / 180)
    np.testing.assert_array_equal(theta.numpy(), np.asarray(_theta_grid()))
    assert (torch.cos(theta).numpy() != cos_j).any() and (torch.sin(theta).numpy() != sin_j).any()
    exact = np.cos(theta.numpy().astype(np.float64)).astype(np.float32)
    assert (exact != cos_j).any()


def test_xla_trig_tables_regenerate_90():
    """The 90-theta tables (tests/test_config_sweep.py's frames case) are
    XLA's cos and sin of that grid, jitted as `hough_segments` computes
    them."""
    cos_j, sin_j = (np.asarray(jax.jit(f)(_theta_grid(90))) for f in (jnp.cos, jnp.sin))
    cos_t, sin_t = (t.numpy() for t in ht.theta_tables(90, torch.device("cpu")))
    np.testing.assert_array_equal(cos_t, cos_j)
    np.testing.assert_array_equal(sin_t, sin_j)


THETA_GRIDS = (1, 2, 3, 45, 60, 90, 120, 180, 360, 720)


@pytest.mark.parametrize("num_thetas", THETA_GRIDS)
def test_theta_tables_match_jax_on_any_grid(num_thetas):
    """`theta_tables` of any grid equals jitted JAX's ``cos`` and ``sin`` of
    that grid bit for bit (`sincosf`, glibc's algorithm, which XLA's CPU
    backend calls), and the grid equals JAX's; at 90 and 180 thetas the
    computed tables are the carried ones."""
    grid = np.asarray(_theta_grid(num_thetas))
    np.testing.assert_array_equal(ht.theta_grid(num_thetas), grid)
    cos_t, sin_t = (t.numpy() for t in ht.theta_tables(num_thetas, torch.device("cpu")))
    for got, fn in ((cos_t, jnp.cos), (sin_t, jnp.sin)):
        want = np.asarray(jax.jit(lambda fn=fn: fn(_theta_grid(num_thetas)))())
        assert got.dtype == np.float32 and got.shape == (num_thetas,)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if num_thetas in ht.CARRIED_TABLES:
        carried = (np.asarray(v, np.float32) for v in ht.CARRIED_TABLES[num_thetas])
        for got, want in zip((cos_t, sin_t), carried):
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_sincosf_matches_jax_on_every_grid_to_720_and_beyond_them():
    """`sincosf` against jitted JAX over every theta grid from 1 to 720
    thetas (259,560 angles) and 200,000 uniform arguments in [-10, 10]
    (both quadrant signs, the small-argument branches): bit for bit, where
    torch's float32 ``cos`` differs on some of them."""
    rng = np.random.default_rng(0)
    x = np.concatenate([ht.theta_grid(n) for n in range(1, 721)]
                       + [rng.uniform(-10, 10, 200_000).astype(np.float32),
                          np.array([0.0, -0.0, 2.0**-13, -(2.0**-13), 0.74, 0.8, 119.0, -119.0], np.float32)])
    for cosine, fn in ((True, jnp.cos), (False, jnp.sin)):
        want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
        np.testing.assert_array_equal(ht.sincosf(x, cosine).view(np.uint32), want.view(np.uint32))
    assert (torch.cos(torch.from_numpy(x)).numpy() != np.asarray(jax.jit(jnp.cos)(jnp.asarray(x)))).any()
    with pytest.raises(ValueError, match=r"\|y\| < 120"):
        ht.sincosf(np.array([120.0], np.float32), True)


@pytest.mark.parametrize(
    "n,density,cap",
    [(1000, 0.01, 64), (307200, 0.002, 256), (500, 0.9, 64), (256, 0.0, 16), (8192, 0.5, 128), (5000, 0.2, 256)],
    ids=["sparse", "frame_sized", "dense_overflow", "empty", "half", "longer_than_capacity"],
)
def test_compact_mask_matches_jax(n, density, cap):
    """tests/test_ops.py:129's cases, and a mask with four times as many
    set entries as the capacity: the first ``cap`` set indices in order, 0
    past the end, and the total, as JAX's `compact_mask` selects them."""
    mask = np.random.default_rng(n).random(n) < density
    idx_j, valid_j = jax.jit(hj.compact_mask, static_argnums=1)(jnp.asarray(mask), cap)
    idx, valid, total = ht.compact_mask(torch.as_tensor(mask), cap)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    want = np.flatnonzero(mask)[:cap]
    np.testing.assert_array_equal(idx.numpy()[: len(want)], want)
    assert int(total) == int(mask.sum())


def _band_pixels(k=8192, seed=0):
    """``k`` pixels of the lane band (x 0-639, y 288-479), as float32."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 640, k).astype(np.float32), rng.integers(288, 480, k).astype(np.float32))


def _fma_model(a, b, c):
    """fma(a, b, c) in numpy: the float32 product is exact in float64, and
    the sums here are exact there too."""
    p = a.astype(np.float64) * b
    s = p + c
    assert ((s - p) == c).all()
    return s.astype(np.float32)


def test_rho_is_contracted_like_compiled_jax():
    """``rho = cos x + sin y`` under jit is fma(cos, x, round(sin y)), and
    so is the port's: the floats and the rounded bins equal compiled JAX
    and the numpy model, while the expression op for op rounds some bins
    otherwise."""
    x, y = _band_pixels()
    rho_j = np.asarray(jax.jit(
        lambda x, y: jnp.cos(_theta_grid())[:, None] * x[None, :] + jnp.sin(_theta_grid())[:, None] * y[None, :]
    )(x, y))
    cos_t, sin_t = ht.theta_tables(180, torch.device("cpu"))
    rho_t = ht.project(cos_t, sin_t, torch.as_tensor(x), torch.as_tensor(y)).numpy()
    c, s = cos_t.numpy()[:, None], sin_t.numpy()[:, None]
    model = _fma_model(c, x[None, :], s * y[None, :])
    np.testing.assert_array_equal(rho_t, rho_j)
    np.testing.assert_array_equal(rho_t, model)
    op_by_op = c * x[None, :] + s * y[None, :]
    assert (op_by_op != rho_j).mean() > 0.05
    assert (np.round(op_by_op) != np.round(rho_j)).any()


def _lines(seed, n=64):
    """``n`` grid lines (table angles, integer rho) through the band and
    TLS-like directions (cos, sin of a random angle, made with jnp)."""
    rng = np.random.default_rng(seed)
    t_idx = rng.integers(0, 180, n)
    cos_t, sin_t = (t.numpy() for t in ht.theta_tables(180, torch.device("cpu")))
    phi = jnp.asarray(rng.uniform(-np.pi / 2, np.pi / 2, n).astype(np.float32))
    dirx, diry = np.array(jnp.cos(phi)), np.array(jnp.sin(phi))
    mx, my = rng.uniform(0, 640, n).astype(np.float32), rng.uniform(288, 480, n).astype(np.float32)
    line_rho = rng.integers(-300, 700, n).astype(np.float32)
    return cos_t[t_idx], sin_t[t_idx], line_rho, dirx, diry, mx, my


def test_supports_and_projections_contracted_like_compiled_jax():
    """The coarse support d0 = |ct x + st y - rho|, the refined normal's
    rho and tight support d1 (normal (-diry, dirx)), and the projections
    of both modes (direction (dirx, diry), and (-st, ct) feature-only),
    each as `hough_segments` writes it under jit, against the port's
    contracted forms: bit for bit."""
    x, y = _band_pixels(2048, seed=1)
    ct, st, line_rho, dirx, diry, mx, my = _lines(2)

    def jax_forms(ct, st, line_rho, dirx, diry, mx, my, x, y):
        nx, ny = -diry, dirx
        rho_ref = nx * mx + ny * my
        return dict(
            d0=jnp.abs(ct[:, None] * x[None, :] + st[:, None] * y[None, :] - line_rho[:, None]),
            rho_ref=rho_ref,
            d1=jnp.abs(nx[:, None] * x[None, :] + ny[:, None] * y[None, :] - rho_ref[:, None]),
            t_par=dirx[:, None] * x[None, :] + diry[:, None] * y[None, :],
            t_mean=dirx * mx + diry * my,
            t_par_feature=(-st)[:, None] * x[None, :] + ct[:, None] * y[None, :],
            t_mean_feature=(-st) * mx + ct * my,
        )

    want = {k: np.asarray(v) for k, v in jax.jit(jax_forms)(ct, st, line_rho, dirx, diry, mx, my, x, y).items()}
    T = {k: torch.as_tensor(v) for k, v in dict(ct=ct, st=st, line_rho=line_rho, dirx=dirx, diry=diry, mx=mx,
                                                 my=my, x=x, y=y).items()}
    rho_ref = fma32(T["dirx"], T["my"], -(T["diry"] * T["mx"]))
    got = dict(
        d0=(ht.project(T["ct"], T["st"], T["x"], T["y"]) - T["line_rho"][:, None]).abs(),
        rho_ref=rho_ref,
        d1=(ht.project(T["diry"], T["dirx"], T["x"], T["y"], neg_a=True) - rho_ref[:, None]).abs(),
        t_par=ht.project(T["dirx"], T["diry"], T["x"], T["y"]),
        t_mean=fma32(T["dirx"], T["mx"], T["diry"] * T["my"]),
        t_par_feature=ht.project(T["st"], T["ct"], T["x"], T["y"], neg_a=True),
        t_mean_feature=fma32(T["ct"], T["my"], -(T["st"] * T["mx"])),
    )
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # The numpy model of d0, and the op-for-op form that differs from it.
    model = np.abs(_fma_model(ct[:, None], x[None, :], st[:, None] * y[None, :]) - line_rho[:, None])
    np.testing.assert_array_equal(got["d0"].numpy(), model)
    op_by_op = np.abs(ct[:, None] * x[None, :] + st[:, None] * y[None, :] - line_rho[:, None])
    assert (op_by_op != want["d0"]).any()
    model = np.abs(_fma_model(dirx[:, None], y[None, :], -(diry[:, None] * x[None, :])) - want["rho_ref"][:, None])
    np.testing.assert_array_equal(got["d1"].numpy(), model)
    # And the projections: the direction's own product fused, or where it
    # is negated (-st), the other one.
    np.testing.assert_array_equal(want["t_par"], _fma_model(dirx[:, None], x[None, :], diry[:, None] * y[None, :]))
    np.testing.assert_array_equal(want["t_par_feature"], _fma_model(ct[:, None], y[None, :], -(st[:, None] * x[None, :])))


EDGE_FRAMES = ("road", "noise")


@pytest.fixture(scope="module")
def frame_edges():
    """The lane pass's masked edges and the scene pass's half-resolution
    edges of a road frame and a noise frame, made by the JAX package's
    image ops."""
    from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import SyntheticRoadGenerator
    from multimodal_autonomous_driving_perception_and_planning_tpu.ops import image as ij

    roi = ij.trapezoid_roi_mask(480, 640)

    @jax.jit
    def edges(frame):
        gray = ij.bgr_to_gray_u8(frame)
        blurred = ij.gaussian_blur5_u8(gray)
        med = ij.median_u8(blurred)
        lane = ij.canny(blurred, jnp.floor(jnp.maximum(0.0, 0.7 * med)), jnp.floor(jnp.minimum(255.0, 1.3 * med)))
        return lane & roi, ij.canny(ij.downsample2_u8(gray), jnp.float32(50.0), jnp.float32(150.0))

    frames = {
        "road": SyntheticRoadGenerator(draw_adjacent_dash=True).generate_frames(3)[2],
        "noise": np.random.default_rng(4).integers(0, 256, (480, 640, 3)).astype(np.uint8),
    }
    return {name: tuple(np.array(e) for e in edges(jnp.asarray(f))) for name, f in frames.items()}

LANE_KW = dict(vote_threshold=50, min_line_length=50.0, num_thetas=180, max_lines=64, edge_capacity=2048,
               row_range=(288, 480))
SCENE_KW = dict(vote_threshold=50, min_line_length=50.0, num_thetas=180, max_lines=32, edge_capacity=1024)


@pytest.mark.parametrize("num_thetas", (180, 60, 360))
@pytest.mark.parametrize("name", EDGE_FRAMES)
def test_lane_pass_matches_jax(frame_edges, name, num_thetas):
    """The lane pass (ROI edges, rows 288-479, 2048 pixels, refined
    segments), at the default grid of 180 thetas and at 60 and 360: votes,
    valid and both flags bit for bit, segments within atol 1e-4.  The
    accumulator equals a numpy histogram of compiled JAX's rounded ``rho``
    over the port's edge list."""
    kw = dict(LANE_KW, num_thetas=num_thetas)
    edges = frame_edges[name][0]
    got = ht.hough_segments(torch.as_tensor(edges), refine=True, **kw)
    want = _jax_hough(refine=True, **kw)(jnp.asarray(edges))
    _assert_lines_match(got, want, exact_floats=False)
    x, y, v, _ = ht.compact_edges(torch.as_tensor(edges), kw["edge_capacity"], kw["row_range"])
    acc = ht.vote(x, y, v, num_thetas, 800)
    x, y, v = x.numpy(), y.numpy(), v.numpy()
    grid = _theta_grid(num_thetas)
    rho_j = np.asarray(jax.jit(
        lambda x, y: jnp.cos(grid)[:, None] * x[None, :] + jnp.sin(grid)[:, None] * y[None, :]
    )(x, y))
    bins = np.round(rho_j).astype(np.int64) + 800
    hist = np.zeros((num_thetas, 1601), np.int64)
    np.add.at(hist, (np.broadcast_to(np.arange(num_thetas)[:, None], bins.shape)[:, v], bins[:, v]), 1)
    np.testing.assert_array_equal(acc.numpy(), hist)
    if name == "road":
        assert got.valid.any() and not bool(got.edges_overflow)
    else:
        assert bool(got.edges_overflow)


@pytest.mark.parametrize("num_thetas", (180, 60, 360))
@pytest.mark.parametrize("name", EDGE_FRAMES)
def test_scene_pass_matches_jax_bit_for_bit(frame_edges, name, num_thetas):
    """The scene pass (half resolution, 1024 pixels, feature-only), at 180,
    60 and 360 thetas: every field, segments and lengths included, bit for
    bit."""
    got, want = _both(frame_edges[name][1], refine=False, **dict(SCENE_KW, num_thetas=num_thetas))
    _assert_lines_match(got, want, exact_floats=True)


def test_vote_ties_on_a_plateau():
    """Two parallel 20-pixel lines and a lone one: every peak of each
    plateau ties, broken toward the first bin in scan order; the pool's
    top-k keeps tied votes in scan order, as lax.top_k does."""
    edges = np.zeros((60, 80), bool)
    edges[10, 10:30] = True
    edges[20, 10:30] = True
    edges[45, 40:60] = True
    kw = dict(vote_threshold=5, min_line_length=10.0, num_thetas=180, max_lines=8, edge_capacity=256)
    got, want = _both(edges, **kw)
    _assert_lines_match(got, want, exact_floats=False)
    assert int(got.valid.sum()) >= 3  # the three lines, and a diagonal across the pair
    got, want = _both(edges, refine=False, **kw)
    _assert_lines_match(got, want, exact_floats=True)


def test_line_near_the_theta_wrap():
    """Near-vertical lines, whose normals lie at theta 0 and about 179
    degrees: the 5x5 peak window wraps across the theta axis (rho flips
    sign there), as jnp.roll wraps it."""
    edges = np.zeros((120, 160), bool)
    rows = np.arange(10, 110)
    edges[rows, 40] = True  # vertical: theta 0
    edges[rows, (100 + (rows - 10) * 0.02).astype(int)] = True  # slightly tilted: theta ~179
    edges[rows, (130 - (rows - 10) * 0.02).astype(int)] = True  # the other way: theta ~1
    kw = dict(vote_threshold=20, min_line_length=20.0, num_thetas=180, max_lines=16, edge_capacity=512)
    got = ht.hough_segments(torch.as_tensor(edges), **kw)
    want = _jax_hough(refine=True, **kw)(jnp.asarray(edges))
    _assert_lines_match(got, want, exact_floats=False)
    x, y, v, _ = ht.compact_edges(torch.as_tensor(edges), kw["edge_capacity"])
    acc = ht.vote(x, y, v, 180, 200)  # ceil(hypot(120, 160)) = 200
    scores, flat_idx, _ = ht.select_peaks(acc, kw["vote_threshold"], kw["max_lines"])
    np.testing.assert_array_equal(scores.numpy(), got.votes.numpy())
    theta = flat_idx.numpy()[got.valid.numpy()] // acc.shape[1]
    assert (theta == 0).any() and (theta > 170).any()
    got, want = _both(edges, refine=False, **kw)
    _assert_lines_match(got, want, exact_floats=True)
