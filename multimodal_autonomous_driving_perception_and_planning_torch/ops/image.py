"""Image ops of the frames path, as tensor ops.

Port of the JAX package's ops/image.py: grayscale, 2x downsample, 5x5
Gaussian blur, median, Sobel, Canny (L1 gradient, sector NMS, hysteresis),
Laplacian variance, the trapezoid ROI mask and the HSV green ratio.  Each
function takes one frame and gives what the JAX function gives under
``jit``, bit for bit: the integer and exact-float stages trivially, the
means as XLA's CPU code rounds them.  The JAX package's radix one-hot
matmul histogram (a TPU workaround) is an ``index_add_`` here.

The sums of ``brightness`` and ``laplacian_variance`` run in integers, so
that the card and the CPU give one value; XLA sums in float32 in an order
of its own, which stands within rtol 1e-5 of them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# OpenCV's tan(22.5 degrees) sectoring constant, as a float32 (torch
# rounds a Python number to the tensor's float32 before multiplying).
_TG22 = float(np.float32(0.4142135623730951))


def bgr_to_gray_u8(frame: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 or int BGR -> (H, W) uint8-valued int32 gray, with
    OpenCV's fixed-point weights (B*1868 + G*9617 + R*4899 + 2^13) >> 14."""
    f = frame.to(torch.int32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    return (b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14


def downsample2_u8(gray: torch.Tensor) -> torch.Tensor:
    """(H, W) uint8-valued int32 -> (H//2, W//2), the 2x2 box mean with
    round-half-up integer arithmetic ((a+b+c+d+2) >> 2)."""
    h, w = gray.shape
    g = gray[: (h // 2) * 2, : (w // 2) * 2].to(torch.int32)
    s = g[0::2, 0::2] + g[0::2, 1::2] + g[1::2, 0::2] + g[1::2, 1::2]
    return (s + 2) >> 2


def _reflect101_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """REFLECT_101 border (OpenCV's default, numpy's "reflect")."""
    return F.pad(x[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]


def _sep_conv(x: torch.Tensor, k) -> torch.Tensor:
    """Separable 2D convolution with a REFLECT_101 border, float32, the
    taps summed in the JAX package's order (Python ``sum``, from 0)."""
    n = len(k)
    pad = n // 2
    h, w = x.shape
    xp = _reflect101_pad(x.to(torch.float32), pad)
    xr = sum(xp[:, i : i + w] * k[i] for i in range(n))
    return sum(xr[i : i + h, :] * k[i] for i in range(n))


def gaussian_blur5_u8(gray: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur(gray, (5, 5), 0): the binomial [1, 4, 6, 4, 1] / 16
    taps (every partial sum is exact in float32), rounded half to even."""
    k = [float(np.float32(v / 16.0)) for v in (1.0, 4.0, 6.0, 4.0, 1.0)]
    return torch.round(_sep_conv(gray, k)).to(torch.int32)


def median_u8(img: torch.Tensor) -> torch.Tensor:
    """Exact median of a uint8-valued image from its 256-bin histogram,
    np.median's mean of the two middle order statistics for an even pixel
    count; a float32 scalar."""
    flat = img.reshape(-1).clamp(0, 255)
    n = flat.shape[0]
    hist = torch.zeros(256, dtype=torch.int32, device=img.device)
    hist.index_add_(0, flat.reshape(-1).long(), torch.ones_like(flat, dtype=torch.int32))
    cdf = torch.cumsum(hist, 0, dtype=torch.int32)
    v_lo = (cdf <= (n - 1) // 2).sum()  # the first bin whose cdf exceeds k
    v_hi = (cdf <= n // 2).sum()
    return (v_lo + v_hi).to(torch.float32) * 0.5


def sobel3(gray: torch.Tensor):
    """3x3 Sobel dx, dy with a REFLECT_101 border (cv2.Sobel defaults)."""
    g = gray.to(torch.float32)
    smooth, diff = (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)
    gp = _reflect101_pad(g, 1)
    h, w = gray.shape

    def conv_rc(row_k, col_k):
        xr = sum(gp[:, i : i + w] * row_k[i] for i in range(3))
        return sum(xr[i : i + h, :] * col_k[i] for i in range(3))

    return conv_rc(diff, smooth), conv_rc(smooth, diff)


def _shift(a: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    return torch.roll(a, (di, dj), (0, 1))


# Hysteresis rounds between two reads of the "changed" flag.
HYSTERESIS_BLOCK = 8


def canny(gray: torch.Tensor, low, high, hysteresis_iters: int = 64) -> torch.Tensor:
    """Canny edge map (L1 gradient, like cv2.Canny's default) of an (H, W)
    uint8-valued image, with scalar thresholds ``low`` and ``high``
    (tensors or numbers); an (H, W) bool map.  See `canny_rounds`."""
    return canny_rounds(gray, low, high, hysteresis_iters)[0]


def canny_rounds(gray: torch.Tensor, low, high, hysteresis_iters: int = 64):
    """`canny`'s edge map, with the hysteresis rounds it ran and the host
    reads it made: (edges, rounds, reads).

    Hysteresis grows the strong edges through the weak ones to their
    fixpoint, at most ``hysteresis_iters`` rounds, as the JAX package's
    ``while_loop`` does.  A round after the fixpoint changes nothing, so
    the rounds run in blocks of `HYSTERESIS_BLOCK` and the flag is read
    once a block: the result is the JAX one, with one host read a block.

    Under ``torch.export`` (utils/export.py) the same blocks run in
    `hysteresis_traced`, a ``while_loop`` the trace keeps, and ``rounds``
    and ``reads`` are int32 tensors: the same map bit for bit.  There
    ``reads`` counts the blocks, the eager path's reads; the loop itself
    reads once more when it runs past the first block.
    """
    strong, weak = _canny_masks(gray, low, high)
    # The 8-neighbour dilation is a 3x3 max pool.  The JAX package rolls,
    # which wraps at the border; only border pixels see the wrap, and
    # ``weak`` is zero there.
    weak_f = weak.to(torch.float32)
    s = strong.to(torch.float32)
    if torch.compiler.is_exporting():
        s, rounds = hysteresis_traced(s, weak_f, hysteresis_iters)
        return s > 0, rounds, (rounds + HYSTERESIS_BLOCK - 1) // HYSTERESIS_BLOCK
    rounds = syncs = 0
    while rounds < hysteresis_iters:
        before = s
        for _ in range(min(HYSTERESIS_BLOCK, hysteresis_iters - rounds)):
            s = _grow(s, weak_f)
            rounds += 1
        syncs += 1
        if torch.equal(s, before):
            break
    return s > 0, rounds, syncs


def _canny_masks(gray: torch.Tensor, low, high):
    """The strong and weak edge masks: the L1 gradient magnitude after
    sector non-maximum suppression, above ``high`` and ``low``, zero on the
    one-pixel border."""
    dx, dy = sobel3(gray)
    adx, ady = dx.abs(), dy.abs()
    mag = adx + ady
    horiz = ady < _TG22 * adx  # gradient ~horizontal: compare left/right
    vert = adx < _TG22 * ady
    diag_sign = (dx * dy) >= 0
    keep_h = (mag > _shift(mag, 0, 1)) & (mag >= _shift(mag, 0, -1))
    keep_v = (mag > _shift(mag, 1, 0)) & (mag >= _shift(mag, -1, 0))
    keep_d45 = (mag > _shift(mag, 1, 1)) & (mag >= _shift(mag, -1, -1))
    keep_d135 = (mag > _shift(mag, 1, -1)) & (mag >= _shift(mag, -1, 1))
    keep = torch.where(horiz, keep_h, torch.where(vert, keep_v, torch.where(diag_sign, keep_d45, keep_d135)))

    h, w = gray.shape
    interior = torch.zeros((h, w), dtype=torch.bool, device=gray.device)
    interior[1 : h - 1, 1 : w - 1] = True
    return keep & (mag > high) & interior, keep & (mag > low) & interior


def _grow(s: torch.Tensor, weak_f: torch.Tensor) -> torch.Tensor:
    """One hysteresis round: the 8-neighbour dilation of ``s`` within the
    weak mask, joined with ``s``."""
    return torch.maximum(F.max_pool2d(s[None, None], 3, 1, 1)[0, 0] * weak_f, s)


def hysteresis_traced(s: torch.Tensor, weak_f: torch.Tensor, iters: int):
    """`canny_rounds`' hysteresis as ``torch.export`` traces it, from the
    strong map ``s`` and the weak mask ``weak_f`` (float32 0/1): the blocks
    of `HYSTERESIS_BLOCK` rounds under ``torch._higher_order_ops.while_loop``
    (the counterpart of the JAX package's ``lax.while_loop``), which
    carries ``(s, changed, rounds)``.  The first block runs before the loop,
    so the loop reads its flag once a block, as the eager blocks do, but
    for one read: torch's eager ``while_loop`` reads its first condition
    twice when the loop runs.  A round past ``iters`` leaves ``s`` as it
    is.  Returns ``(s, rounds)``,
    ``rounds`` an int32 tensor, the eager path's count."""
    from torch._higher_order_ops import while_loop

    def block(s, rounds):
        before = s
        for k in range(HYSTERESIS_BLOCK):
            s = torch.where(rounds + k < iters, _grow(s, weak_f), s)
        return s, (s != before).any(), torch.clamp(rounds + HYSTERESIS_BLOCK, max=iters)

    rounds = torch.zeros((), dtype=torch.int32, device=s.device)
    if iters <= 0:
        return s, rounds
    s, changed, rounds = block(s, rounds)
    s, _, rounds = while_loop(
        lambda s, changed, rounds: changed & (rounds < iters),
        lambda s, changed, rounds: block(s, rounds),
        (s, changed, rounds),
    )
    return s, rounds


def laplacian_variance(gray: torch.Tensor) -> torch.Tensor:
    """Variance of the 3x3 Laplacian ([[0,1,0],[1,-4,1],[0,1,0]], a
    REFLECT_101 border), the fog heuristic's statistic; a float32 scalar.
    The Laplacian is integer-valued, so its sums run exactly in int64 and
    the variance (n S2 - S1^2) / n^2 is rounded once from float64."""
    g = gray.to(torch.int64)
    gp = F.pad(g[None, None].to(torch.float64), (1, 1, 1, 1), mode="reflect")[0, 0].to(torch.int64)
    h, w = gray.shape
    lap = gp[0:h, 1 : w + 1] + gp[2 : h + 2, 1 : w + 1] + gp[1 : h + 1, 0:w] + gp[1 : h + 1, 2 : w + 2] - 4 * g
    n = h * w
    s1, s2 = lap.sum(), (lap * lap).sum()
    return _div64(n * s2 - s1 * s1, n * n)


def _div64(num: torch.Tensor, den: int) -> torch.Tensor:
    """``num / den`` in float64, rounded to float32.  The divisor is a
    tensor: on the card ``tensor / number`` is a reciprocal multiply."""
    d = torch.full((), float(den), dtype=torch.float64, device=num.device)
    return (num.to(torch.float64) / d).to(torch.float32)


def mean_u8(gray: torch.Tensor) -> torch.Tensor:
    """Mean of an integer image, its sum exact in int64, rounded once to
    float32 (the scene features' ``brightness``)."""
    return _div64(gray.to(torch.int64).sum(), gray.numel())


def mean_bool(mask: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` of a bool map under ``jit``: the exact count times the
    float32 reciprocal of the pixel count, as XLA's CPU code computes it."""
    return mask.sum(dtype=torch.int32).to(torch.float32) * float(np.float32(1.0 / mask.numel()))


def trapezoid_roi_mask(
    height: int,
    width: int,
    bottom_frac: float = 0.1,
    top_frac: float = 0.4,
    top_y_frac: float = 0.6,
) -> np.ndarray:
    """The front-camera trapezoid (0.1w, h) - (0.4w, 0.6h) - (0.6w, 0.6h) -
    (0.9w, h), filled, rasterised with half-plane tests: a host numpy
    (H, W) bool mask."""
    v = np.asarray(
        [
            [int(width * bottom_frac), height],
            [int(width * top_frac), int(height * top_y_frac)],
            [int(width * (1.0 - top_frac)), int(height * top_y_frac)],
            [int(width * (1.0 - bottom_frac)), height],
        ],
        np.float32,
    )
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    mask = np.ones((height, width), bool)
    for i in range(4):
        x1, y1 = v[i]
        x2, y2 = v[(i + 1) % 4]
        # Counter-clockwise in image coordinates (y down): interior points
        # have non-negative edge cross products.
        mask &= (x2 - x1) * (ys - y1) - (y2 - y1) * (xs - x1) >= 0
    return mask


def bgr_to_hsv_green_ratio(frame: torch.Tensor) -> torch.Tensor:
    """Fraction of pixels within cv2.inRange(hsv, (35, 40, 40), (85, 255,
    255)), OpenCV's uint8 HSV convention (H in [0, 180)), H and S rounded
    half to even before the comparison; a float32 scalar."""
    f = frame.to(torch.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    diff = v - mn
    safe = torch.where(diff > 0, diff, 1.0)
    s = torch.where(v > 0, diff / torch.where(v > 0, v, 1.0) * 255.0, 0.0)
    h = torch.where(
        v == r,
        60.0 * (g - b) / safe,
        torch.where(v == g, 120.0 + 60.0 * (b - r) / safe, 240.0 + 60.0 * (r - g) / safe),
    )
    h = torch.where(h < 0, h + 360.0, h) * 0.5
    h8, s8 = torch.round(h), torch.round(s)
    return mean_bool((h8 >= 35) & (h8 <= 85) & (s8 >= 40) & (v >= 40))
