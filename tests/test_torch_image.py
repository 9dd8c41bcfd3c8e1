"""The port's image ops (ops/image.py) against the JAX package's, jitted.

Each function gets the same numpy frames on both sides: road frames from
both generators (the JAX package's cv2 one and the port's numpy one, with
the scrolling dashes), a seeded noise frame and a blank one.  The integer
and exact-float stages (gray, downsample, blur, median, Sobel, both Canny
maps) must be equal bit for bit; the Laplacian variance and the
brightness, which XLA sums in float32 in an order of its own, within rtol
1e-5.  The cases of tests/test_image_ops.py (against cv2) run on the port
too, and the two liberties the port takes (hysteresis in blocks of rounds,
the dilation as a max pool) are shown equal to the JAX formulation.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import (
    SyntheticRoadGenerator as RoadT,
)
from multimodal_autonomous_driving_perception_and_planning_torch.ops import image as it
from multimodal_autonomous_driving_perception_and_planning_tpu.data.frames import (
    SyntheticRoadGenerator as RoadJ,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.ops import image as ij

H, W = 480, 640


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the same
    cores, and torch's default of one thread a core each makes them wait
    on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames():
    gen = RoadT(draw_adjacent_dash=True)
    dashed = gen.generate_frames(6)[5]
    rng = np.random.default_rng(0)
    return {
        "road_cv2": RoadJ().generate_frame_with_vehicles(),
        "road_numpy_dashed": dashed,
        "noise": rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
        "blank": np.zeros((H, W, 3), np.uint8),
    }


FRAMES = _frames()


@pytest.fixture(scope="module")
def jax_ops():
    """The JAX stages, jitted once for the module."""

    def lane(frame):
        gray = ij.bgr_to_gray_u8(frame)
        blurred = ij.gaussian_blur5_u8(gray)
        med = ij.median_u8(blurred)
        low = jnp.floor(jnp.maximum(0.0, 0.7 * med))
        high = jnp.floor(jnp.minimum(255.0, 1.3 * med))
        small = ij.downsample2_u8(gray)
        dx, dy = ij.sobel3(blurred)
        return dict(gray=gray, blurred=blurred, median=med, low=low, high=high, dx=dx, dy=dy,
                    edges=ij.canny(blurred, low, high), small=small,
                    scene_edges=ij.canny(small, jnp.float32(50.0), jnp.float32(150.0)),
                    brightness=jnp.mean(gray.astype(jnp.float32)),
                    laplacian_var=ij.laplacian_variance(gray),
                    green_ratio=ij.bgr_to_hsv_green_ratio(frame))

    return jax.jit(lane)


def _port_stages(frame):
    f = torch.as_tensor(frame)
    gray = it.bgr_to_gray_u8(f)
    blurred = it.gaussian_blur5_u8(gray)
    med = it.median_u8(blurred)
    low = torch.floor(torch.clamp(torch.tensor(0.7, dtype=torch.float32) * med, min=0.0))
    high = torch.floor(torch.clamp(torch.tensor(1.3, dtype=torch.float32) * med, max=255.0))
    small = it.downsample2_u8(gray)
    dx, dy = it.sobel3(blurred)
    return dict(gray=gray, blurred=blurred, median=med, low=low, high=high, dx=dx, dy=dy,
                edges=it.canny(blurred, low, high), small=small, scene_edges=it.canny(small, 50.0, 150.0),
                brightness=it.mean_u8(gray), laplacian_var=it.laplacian_variance(gray),
                green_ratio=it.bgr_to_hsv_green_ratio(f))


EXACT = ("gray", "blurred", "median", "low", "high", "dx", "dy", "edges", "small", "scene_edges", "green_ratio")


@pytest.mark.parametrize("name", list(FRAMES))
def test_stages_match_jax(jax_ops, name):
    """Every stage of the lane and scene passes' image half on one frame:
    bit for bit but the two float32 sums, which stand within rtol 1e-5."""
    frame = FRAMES[name]
    want = {k: np.asarray(v) for k, v in jax_ops(jnp.asarray(frame)).items()}
    got = {k: v.numpy() for k, v in _port_stages(frame).items()}
    for k in EXACT:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("brightness", "laplacian_var"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    if name == "blank":
        assert not got["edges"].any() and float(got["laplacian_var"]) == 0.0
    else:
        assert got["edges"].any()


def test_frames_as_int32_match_uint8(jax_ops):
    """The runner accepts int32 frames too: the same stages as uint8."""
    frame = FRAMES["road_cv2"]
    a, b = _port_stages(frame), _port_stages(frame.astype(np.int32))
    for k in EXACT:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


# --- tests/test_image_ops.py on the port -----------------------------------


@pytest.fixture(scope="module")
def frame():
    return RoadT().generate_frame_with_vehicles()


def test_gray_matches_cv2_bitexact(frame):
    want = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(it.bgr_to_gray_u8(torch.as_tensor(frame)).numpy(), want.astype(np.int32))


def test_gaussian_blur_matches_cv2_within_1lsb(frame):
    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    want = cv2.GaussianBlur(gray, (5, 5), 0).astype(np.int32)
    diff = np.abs(it.gaussian_blur5_u8(torch.as_tensor(gray.astype(np.int32))).numpy() - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02


def test_median_matches_numpy(frame):
    blurred = cv2.GaussianBlur(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY), (5, 5), 0)
    assert float(it.median_u8(torch.as_tensor(blurred.astype(np.int32)))) == float(np.median(blurred))
    odd = blurred[:, :-1]  # an odd pixel count: the middle order statistic
    assert float(it.median_u8(torch.as_tensor(odd[:-1].astype(np.int32)))) == float(np.median(odd[:-1]))


def test_canny_overlaps_cv2(frame):
    blurred = cv2.GaussianBlur(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY), (5, 5), 0)
    med = np.median(blurred)
    low, high = int(max(0, 0.7 * med)), int(min(255, 1.3 * med))
    want = cv2.Canny(blurred, low, high) > 0
    got = it.canny(torch.as_tensor(blurred.astype(np.int32)), float(low), float(high)).numpy()
    kernel = np.ones((3, 3), np.uint8)
    want_d = cv2.dilate(want.astype(np.uint8), kernel) > 0
    got_d = cv2.dilate(got.astype(np.uint8), kernel) > 0
    assert (got & want_d).sum() / max(1, got.sum()) > 0.9
    assert (want & got_d).sum() / max(1, want.sum()) > 0.9


def test_roi_mask_matches_fillpoly():
    """Against cv2.fillPoly to the boundary pixel, and equal to the JAX
    package's mask."""
    v = np.array([[(int(W * 0.1), H), (int(W * 0.4), int(H * 0.6)), (int(W * 0.6), int(H * 0.6)), (int(W * 0.9), H)]],
                 np.int32)
    want = np.zeros((H, W), np.uint8)
    cv2.fillPoly(want, v, 255)
    got = it.trapezoid_roi_mask(H, W)
    assert (got == (want > 0)).mean() > 0.995
    np.testing.assert_array_equal(got, ij.trapezoid_roi_mask(H, W))


def test_laplacian_variance_close(frame):
    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    want = cv2.Laplacian(gray, cv2.CV_64F).var()
    np.testing.assert_allclose(float(it.laplacian_variance(torch.as_tensor(gray.astype(np.int32)))), want, rtol=1e-3)


def test_green_ratio_close(frame):
    hsv = cv2.cvtColor(frame, cv2.COLOR_BGR2HSV)
    want = (cv2.inRange(hsv, (35, 40, 40), (85, 255, 255)) > 0).mean()
    np.testing.assert_allclose(float(it.bgr_to_hsv_green_ratio(torch.as_tensor(frame))), want, atol=0.002)


# --- the port's liberties ---------------------------------------------------


def _chain_image(length: int) -> np.ndarray:
    """A vertical step edge whose contrast is strong on its first rows and
    weak below: hysteresis grows the strong edge down the weak chain one
    row a round, ``length`` rows in all."""
    img = np.zeros((length + 40, 64), np.int32)
    img[10 : 10 + length, 32:] = 60  # weak: |dx| 240 > low, < high
    img[10:14, 32:] = 200  # strong seed
    return img


def _fixpoint_one_round_at_a_time(gray, low, high, iters=64):
    """The JAX package's loop in torch, one round and one check at a time,
    from the port's own strong and weak maps (no blocks)."""
    g = torch.as_tensor(gray)
    edges_strong = it.canny(g, high, high, hysteresis_iters=0)  # keep & (mag > high): no growth
    edges_weak = it.canny(g, low, low, hysteresis_iters=0)  # keep & (mag > low)
    s = edges_strong
    for _ in range(iters):
        grown = (F.max_pool2d(s.float()[None, None], 3, 1, 1)[0, 0] > 0) & edges_weak | s
        if torch.equal(grown, s):
            break
        s = grown
    return s


@pytest.mark.parametrize("length", [6, 20, 100], ids=["within_a_block", "three_blocks", "past_the_cap"])
def test_hysteresis_blocks_equal_the_fixpoint_loop(length):
    """Rounds in blocks of 8, the flag read once a block, give the JAX
    `while_loop`'s result: at the fixpoint (6 and 20 rows of chain) and at
    the cap of 64 rounds (100 rows), where both stop with the chain cut."""
    gray = _chain_image(length)
    low, high = 100.0, 400.0
    got, rounds, syncs = it.canny_rounds(torch.as_tensor(gray), low, high)
    stats = {"rounds": rounds, "syncs": syncs}
    np.testing.assert_array_equal(it.canny(torch.as_tensor(gray), low, high).numpy(), got.numpy())
    want_jax = np.asarray(jax.jit(ij.canny)(jnp.asarray(gray), jnp.float32(low), jnp.float32(high)))
    np.testing.assert_array_equal(got.numpy(), want_jax)
    np.testing.assert_array_equal(got.numpy(), _fixpoint_one_round_at_a_time(gray, low, high).numpy())
    assert stats["rounds"] == 8 * stats["syncs"]
    grown_rows = int(got.any(1).sum())
    if length == 100:
        assert stats == {"rounds": 64, "syncs": 8}
        assert grown_rows < length  # the cap cut the chain, as in JAX
    else:
        assert stats["rounds"] < 64 and grown_rows >= length


def _rolled_dilation(m: torch.Tensor) -> torch.Tensor:
    out = m.clone()
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di or dj:
                out |= torch.roll(m, (di, dj), (0, 1))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_max_pool_dilation_equals_rolled_dilation(seed):
    """The 8-neighbour dilation of the JAX package (``jnp.roll``, wrapping)
    and the port's 3x3 max pool differ only on border pixels, which the
    weak map (zero on the border) masks away; on random masks with set
    border pixels, both grown maps are equal."""
    rng = np.random.default_rng(seed)
    s = torch.as_tensor(rng.random((48, 64)) < 0.1)
    weak = torch.as_tensor(rng.random((48, 64)) < 0.5)
    weak[0], weak[-1], weak[:, 0], weak[:, -1] = False, False, False, False
    pooled = F.max_pool2d(s.float()[None, None], 3, 1, 1)[0, 0] > 0
    rolled = _rolled_dilation(s)
    border = ~(torch.zeros_like(s).index_fill_(0, torch.arange(1, 47), True)
               & torch.zeros_like(s).index_fill_(1, torch.arange(1, 63), True))
    assert (pooled != rolled).any() and not (pooled != rolled)[~border].any()
    np.testing.assert_array_equal((pooled & weak | s).numpy(), (rolled & weak | s).numpy())
