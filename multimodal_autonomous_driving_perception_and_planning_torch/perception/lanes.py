"""Lane detection and the scene classifier's frame features, as tensor ops.

Port of the JAX package's perception/lanes.py (reference
src/perception/lane_detector.py:178-218):

  gray -> 5x5 Gaussian -> median-adaptive Canny -> trapezoid ROI mask
  -> deterministic Hough segments -> slope/midpoint left-right split
  -> quadratic fit x(y) -> EMA against the previous fit,

and the scene features (a second, fixed-threshold Canny and Hough pass at
half resolution, plus the HSV, brightness and Laplacian statistics) that
the tagging step reads in frames mode.  The JAX package has no kernel on
this path; it runs as torch ops on the card and on the CPU alike.

The fit's products are elementwise products and sums, not matmuls, so
TF32 never touches them.  Where XLA contracts a product-sum (the sample
grid, the EMA, the bottom-row evaluation), the port does too (`fma32`).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops.geometry import fma32
from ..ops.hough import hough_segments, theta_tables
from ..ops.image import (
    bgr_to_gray_u8,
    bgr_to_hsv_green_ratio,
    canny,
    downsample2_u8,
    gaussian_blur5_u8,
    laplacian_variance,
    mean_bool,
    mean_u8,
    median_u8,
    trapezoid_roi_mask,
)
from ..types import LaneObservation, LaneState
from ..utils.device import resolve_device

def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def linspace01(n: int) -> np.ndarray:
    """jnp.linspace(0, 1, n) in float32, as JAX computes it: iota * (1 / (n
    - 1)), XLA's reciprocal multiply for its division by the step count,
    with the end point 1 (torch.linspace rounds some values otherwise)."""
    if n == 1:
        return np.zeros(1, np.float32)
    step = np.float32(1.0) / np.float32(n - 1)
    return np.append(np.arange(n - 1, dtype=np.float32) * step, np.float32(1.0))


@functools.lru_cache(maxsize=None)
def _linspace(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(linspace01(n)).to(device)


def _solve3(g: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve by the adjugate: g (..., 3, 3), rhs (..., 3) ->
    (..., 3); a singular system (no usable segment) gives zeros."""
    c00 = g[..., 1, 1] * g[..., 2, 2] - g[..., 1, 2] * g[..., 2, 1]
    c01 = g[..., 1, 2] * g[..., 2, 0] - g[..., 1, 0] * g[..., 2, 2]
    c02 = g[..., 1, 0] * g[..., 2, 1] - g[..., 1, 1] * g[..., 2, 0]
    det = g[..., 0, 0] * c00 + g[..., 0, 1] * c01 + g[..., 0, 2] * c02
    c10 = g[..., 0, 2] * g[..., 2, 1] - g[..., 0, 1] * g[..., 2, 2]
    c11 = g[..., 0, 0] * g[..., 2, 2] - g[..., 0, 2] * g[..., 2, 0]
    c12 = g[..., 0, 1] * g[..., 2, 0] - g[..., 0, 0] * g[..., 2, 1]
    c20 = g[..., 0, 1] * g[..., 1, 2] - g[..., 0, 2] * g[..., 1, 1]
    c21 = g[..., 0, 2] * g[..., 1, 0] - g[..., 0, 0] * g[..., 1, 2]
    c22 = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] * g[..., 1, 0]
    adj_rows = (
        torch.stack([c00, c10, c20], -1),
        torch.stack([c01, c11, c21], -1),
        torch.stack([c02, c12, c22], -1),
    )
    sol = torch.stack([(row * rhs).sum(-1) for row in adj_rows], -1)
    safe = det.abs() > 1e-20
    sol = sol / torch.where(safe, det, 1.0)[..., None]
    return torch.where(safe[..., None], sol, 0.0)


def _fit_batched(xs: torch.Tensor, ys: torch.Tensor, wgt: torch.Tensor, height: float) -> torch.Tensor:
    """Weighted quadratic fits x = a y^2 + b y + c over shared samples:
    xs, ys (P,), wgt (..., P) -> (..., 3) in np.polyfit order.  Normal
    equations in a basis centred and scaled per fit, two steps of iterative
    refinement, then the coefficients mapped back to raw y."""
    del height  # the basis is standardised per fit
    n = torch.clamp(wgt.sum(-1), min=1.0)
    m = (wgt * ys).sum(-1) / n
    var = (wgt * (ys - m[..., None]) ** 2).sum(-1) / n
    s = torch.sqrt(torch.clamp(var, min=1e-12))
    t = (ys - m[..., None]) / s[..., None]
    A = torch.stack([t * t, t, torch.ones_like(t)], -1)  # (..., P, 3)
    Aw = A * wgt[..., None]
    bw = xs * wgt
    G = (Aw[..., :, :, None] * Aw[..., :, None, :]).sum(-3)
    r = (Aw * bw[..., None]).sum(-2)
    coeffs = _solve3(G, r)
    for _ in range(2):  # the residual through the tall matrix each step
        pred = (Aw * coeffs[..., None, :]).sum(-1)
        resid = (Aw * (bw - pred)[..., None]).sum(-2)
        coeffs = coeffs + _solve3(G, resid)
    at, bt, ct = coeffs[..., 0], coeffs[..., 1], coeffs[..., 2]
    a = at / (s * s)
    b = bt / s - 2.0 * at * m / (s * s)
    c = at * m * m / (s * s) - bt * m / s + ct
    return torch.stack([a, b, c], -1)


def fit_lane_polynomial(xs: torch.Tensor, ys: torch.Tensor, wgt: torch.Tensor, height: float) -> torch.Tensor:
    """Weighted quadratic fit x = a y^2 + b y + c as [a, b, c]; see
    `_fit_batched`."""
    return _fit_batched(xs, ys, wgt, height)


def _separate_and_fit(lines, valid, width: int, height: int, min_abs_slope: float = 0.3, fit_samples: int = 8):
    """The slope/midpoint split (lane_detector.py:105-134) and each side's
    fit over ``fit_samples`` points along every kept segment, both sides in
    one batched solve.  Returns ((fit, found, conf) left, (...) right)."""
    dev = lines.device
    x1, y1, x2, y2 = lines.unbind(-1)
    dx = x2 - x1
    vertical = dx == 0
    slope = (y2 - y1) / torch.where(vertical, 1.0, dx)
    usable = valid & ~vertical & (slope.abs() >= min_abs_slope)
    mid = (x1 + x2) * 0.5
    cx = width / 2.0
    left = usable & (slope < 0) & (mid < cx)
    right = usable & (slope > 0) & (mid > cx)

    t = _linspace(fit_samples, torch.device(dev))[None, :]
    L, S = lines.shape[0], t.shape[1]
    sx = fma32(dx[:, None].expand(L, S), t.expand(L, S), x1[:, None].expand(L, S)).reshape(-1)
    sy = fma32((y2 - y1)[:, None].expand(L, S), t.expand(L, S), y1[:, None].expand(L, S)).reshape(-1)

    masks = torch.stack([left, right])
    n = masks.to(torch.int32).sum(1)
    w = masks.to(torch.float32).repeat_interleave(fit_samples, dim=1)
    coeffs = _fit_batched(sx, sy, w, float(height))
    found = n > 0
    conf = torch.clamp(n.to(torch.float32) * 0.1, max=1.0)  # XLA's n / 10: a reciprocal multiply
    return (coeffs[0], found[0], conf[0]), (coeffs[1], found[1], conf[1])


def make_scene_features(cfg: PipelineConfig):
    """The scene classifier's frame features (scene_classifier.py:145-257):
    a second, fixed-threshold Canny and feature-only Hough pass, at
    1/``scene_downsample`` resolution with its thresholds scaled, plus the
    HSV green ratio, the brightness and the Laplacian variance:
    ``scene_features(frame, gray) -> dict``."""
    lc = cfg.lanes
    s = max(1, int(lc.scene_downsample))

    def scene_features(frame: torch.Tensor, gray: torch.Tensor) -> Dict[str, torch.Tensor]:
        if s > 1:
            gray_s = downsample2_u8(gray) if s == 2 else gray[::s, ::s]
        else:
            gray_s = gray
        hs, ws = gray_s.shape
        edges2 = canny(gray_s, 50.0, 150.0)
        center_density = mean_bool(edges2[hs // 3 : 2 * hs // 3, ws // 3 : 2 * ws // 3])
        scene_hl = hough_segments(
            edges2,
            vote_threshold=max(1, 100 // s),
            min_line_length=100.0 / s,
            num_thetas=lc.num_thetas,
            max_lines=lc.scene_max_lines,
            edge_capacity=max(256, lc.scene_edge_capacity // (s * s)),
            refine=lc.scene_refine,
        )
        n_lines = scene_hl.valid.to(torch.int32).sum()
        # The float64 sum of at most 32 float32 lengths is exact, so the card
        # and the CPU round one value (XLA sums in float32, an ulp or two away).
        total = torch.where(scene_hl.valid, scene_hl.length, 0.0).double().sum().float()
        avg_len = total / torch.clamp(n_lines, min=1).to(torch.float32)
        return {
            "center_edge_density": center_density,
            "num_long_lines": n_lines,
            "avg_line_length": avg_len * float(s),
            "green_ratio": bgr_to_hsv_green_ratio(frame),
            "brightness": mean_u8(gray),
            "laplacian_var": laplacian_variance(gray),
        }

    return scene_features


def make_lane_step(cfg: PipelineConfig, device="cuda"):
    """Build ``lane_step(state, frame) -> (state', obs, feats)`` for
    (H, W, 3) BGR frames on ``device`` (the card unless the caller asks for
    ``"cpu"``): the lane fits with their EMA, the LaneObservation, and the
    scene features.

    ``torch.export`` traces the step: its only data-dependent host read,
    the Canny hysteresis's flag in both passes, runs under a
    ``while_loop`` there (ops/image.py `canny_rounds`)."""
    device = resolve_device(device)
    h, w = cfg.frame_height, cfg.frame_width
    lc = cfg.lanes
    theta_tables(lc.num_thetas, device)  # the grid's tables, made when the step is built
    roi = torch.as_tensor(
        trapezoid_roi_mask(h, w, lc.roi_bottom_frac, lc.roi_top_frac, lc.roi_top_y_frac), device=device
    )
    sf = lc.smoothing_factor
    sf_t, rest_t = _f32(sf, device), _f32(1 - sf, device)
    c07, c13 = _f32(0.7, device), _f32(1.3, device)
    yb = _f32(float(h), device)
    scene_features = make_scene_features(cfg)

    def ema(found_before, found, prev, fit):
        """sf * prev + (1 - sf) * fit, contracted as XLA does."""
        return torch.where(found_before & found, fma32(sf_t.expand(3), prev, rest_t * fit), fit)

    def at_bottom(fit):
        """The fit at the frame's bottom row, truncated (the reference
        int-casts the rasterised points)."""
        return torch.trunc(fma32(fit[0] * yb, yb, fit[1] * yb) + fit[2])

    def lane_step(state: LaneState, frame: torch.Tensor):
        gray = bgr_to_gray_u8(frame)
        blurred = gaussian_blur5_u8(gray)
        med = median_u8(blurred)
        low = torch.floor(torch.clamp(c07 * med, min=0.0))  # int() truncation
        high = torch.floor(torch.clamp(c13 * med, max=255.0))
        edges = canny(blurred, low, high)
        masked = edges & roi
        hl = hough_segments(
            masked,
            vote_threshold=lc.hough_threshold,
            min_line_length=lc.hough_min_line_length,
            num_thetas=lc.num_thetas,
            max_lines=lc.max_lines,
            edge_capacity=lc.lane_edge_capacity,
            row_range=(int(h * lc.roi_top_y_frac), h),
        )
        (lf, l_found, l_conf), (rf, r_found, r_conf) = _separate_and_fit(
            hl.segments, hl.valid, w, h, min_abs_slope=lc.min_abs_slope
        )
        left_fit = ema(state.left_valid, l_found, state.left_fit, lf)
        right_fit = ema(state.right_valid, r_found, state.right_fit, rf)
        new_state = LaneState(
            left_fit=torch.where(l_found, left_fit, state.left_fit),
            right_fit=torch.where(r_found, right_fit, state.right_fit),
            left_valid=state.left_valid | l_found,
            right_valid=state.right_valid | r_found,
        )
        both = l_found & r_found
        lane_center = (at_bottom(left_fit) + at_bottom(right_fit)) * 0.5
        offset = torch.where(both, w / 2.0 - lane_center, 0.0)
        obs = LaneObservation(
            left_fit=left_fit,
            right_fit=right_fit,
            left_found=l_found,
            right_found=r_found,
            left_confidence=l_conf,
            right_confidence=r_conf,
            offset_px=offset,
            has_offset=both,
        )
        return new_state, obs, scene_features(frame, gray)

    return lane_step
