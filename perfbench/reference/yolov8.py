"""Plain YOLOv8 at Ultralytics' published scales, the letterbox and the
decode: the benchmark's own copy, which imports nothing of the program.

The layer graph is ``ultralytics/cfg/models/v8/yolov8.yaml`` (C2f backbone
with SPPF, PAN neck, decoupled anchor-free head with DFL box regression),
NCHW.  Parameter names follow the program's state dict (``b0`` ... ``b9``,
``n12`` ... ``n21``, ``head.cv2_<i>_<j>``), so the benchmark hands one set
of seeded weights to both.  BatchNorm is inference BatchNorm with epsilon
1e-3: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

``precision`` selects how the convolutions multiply: ``"float32"`` (the
reference, TF32 off) or ``"fp8"`` (the control: each convolution's input
and kernel rounded to float8 e4m3 with a per-tensor scale, products summed
in float32, as an fp8 tensor-core convolution computes them).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

REG_MAX = 16
STRIDES = (8, 16, 32)
BN_EPSILON = 1e-3
FP8_MAX = 448.0  # largest finite float8 e4m3


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Conv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride, self.padding = stride, kernel // 2
        self.fp8 = False

    def forward(self, x):
        w = self.weight
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        y = F.conv2d(x, w, None, self.stride, self.padding)
        return y if self.bias is None else y + self.bias.view(1, -1, 1, 1)


class BatchNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + BN_EPSILON) * self.weight
        return (x - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class ConvBN(nn.Module):
    """Ultralytics' ``Conv``: convolution, BatchNorm, SiLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride)
        self.bn = BatchNorm(out_ch)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, ch: int, shortcut: bool):
        super().__init__()
        self.cv1 = ConvBN(ch, ch, 3)
        self.cv2 = ConvBN(ch, ch, 3)
        self.add = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n: int, shortcut: bool):
        super().__init__()
        self.c, self.n = out_ch // 2, n
        self.cv1 = ConvBN(in_ch, 2 * self.c, 1)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(self.c, shortcut))
        self.cv2 = ConvBN((2 + n) * self.c, out_ch, 1)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, : self.c], y[:, self.c :]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        c = in_ch // 2
        self.cv1 = ConvBN(in_ch, c, 1)
        self.cv2 = ConvBN(4 * c, out_ch, 1)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, stride=1, padding=2))
        return self.cv2(torch.cat(pools, dim=1))


class Head(nn.Module):
    def __init__(self, num_classes: int, channels):
        super().__init__()
        c2 = max(16, channels[0] // 4, REG_MAX * 4)
        c3 = max(channels[0], min(num_classes, 100))
        for i, ch in enumerate(channels):
            self.add_module(f"cv2_{i}_0", ConvBN(ch, c2, 3))
            self.add_module(f"cv2_{i}_1", ConvBN(c2, c2, 3))
            self.add_module(f"cv2_{i}_2", Conv(c2, 4 * REG_MAX, 1, bias=True))
            self.add_module(f"cv3_{i}_0", ConvBN(ch, c3, 3))
            self.add_module(f"cv3_{i}_1", ConvBN(c3, c3, 3))
            self.add_module(f"cv3_{i}_2", Conv(c3, num_classes, 1, bias=True))

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            box, cls = x, x
            for j in range(3):
                box = getattr(self, f"cv2_{i}_{j}")(box)
                cls = getattr(self, f"cv3_{i}_{j}")(cls)
            outs.append((box, cls))
        return outs


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOv8(nn.Module):
    """The detector: (B, 3, S, S) float input in [0, 1] -> per scale
    (box logits (B, 64, h, w), class logits (B, C, h, w))."""

    def __init__(self, depth: float, width: float, max_ch: int, num_classes: int = 80):
        super().__init__()

        def ch(c):
            return make_divisible(min(c, max_ch) * width)

        def nd(n):
            return max(1, round(n * depth))

        self.b0 = ConvBN(3, ch(64), 3, 2)
        self.b1 = ConvBN(ch(64), ch(128), 3, 2)
        self.b2 = C2f(ch(128), ch(128), nd(3), True)
        self.b3 = ConvBN(ch(128), ch(256), 3, 2)
        self.b4 = C2f(ch(256), ch(256), nd(6), True)
        self.b5 = ConvBN(ch(256), ch(512), 3, 2)
        self.b6 = C2f(ch(512), ch(512), nd(6), True)
        self.b7 = ConvBN(ch(512), ch(1024), 3, 2)
        self.b8 = C2f(ch(1024), ch(1024), nd(3), True)
        self.b9 = SPPF(ch(1024), ch(1024))
        self.n12 = C2f(ch(1024) + ch(512), ch(512), nd(3), False)
        self.n15 = C2f(ch(512) + ch(256), ch(256), nd(3), False)
        self.n16 = ConvBN(ch(256), ch(256), 3, 2)
        self.n18 = C2f(ch(256) + ch(512), ch(512), nd(3), False)
        self.n19 = ConvBN(ch(512), ch(512), 3, 2)
        self.n21 = C2f(ch(512) + ch(1024), ch(1024), nd(3), False)
        self.head = Head(num_classes, (ch(256), ch(512), ch(1024)))

    def forward(self, x):
        p3 = self.b4(self.b3(self.b2(self.b1(self.b0(x)))))
        p4 = self.b6(self.b5(p3))
        p5 = self.b9(self.b8(self.b7(p4)))
        n4 = self.n12(torch.cat([_up(p5), p4], dim=1))
        o3 = self.n15(torch.cat([_up(n4), p3], dim=1))
        o4 = self.n18(torch.cat([self.n16(o3), n4], dim=1))
        o5 = self.n21(torch.cat([self.n19(o4), p5], dim=1))
        return self.head([o3, o4, o5])


def from_config(config: Dict) -> YOLOv8:
    """The detector a configuration file states, on the meta device."""
    with torch.device("meta"):
        return YOLOv8(config["depth_multiple"], config["width_multiple"], config["max_channels"],
                      config["num_classes"])


def parameter_shapes(config: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and buffer of the detector, by name, with its shape."""
    model = from_config(config)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@contextlib.contextmanager
def _full_float32():
    """Float32 convolutions and matmuls without TF32, the caller's flags
    restored after."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def build(config: Dict, weights: Dict[str, torch.Tensor], precision: str = "float32"):
    """The detector on the weights' device, loaded with ``weights``."""
    if precision not in ("float32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    device = next(iter(weights.values())).device
    model = from_config(config).to_empty(device=device)
    model.load_state_dict({k: v.float() for k, v in weights.items()}, strict=True)
    for mod in model.modules():
        if isinstance(mod, Conv):
            mod.fp8 = precision == "fp8"
    return model.eval()


def letterbox_input(frames_bgr: torch.Tensor, size: int) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """(B, H, W, 3) BGR uint8 frames -> the network's (B, 3, size, size)
    RGB input in [0, 1]: an aspect-preserving bilinear (antialiased) resize
    and a centred pad of 114, as Ultralytics' letterbox."""
    x = frames_bgr.flip(-1).float().permute(0, 3, 1, 2)
    h, w = x.shape[-2:]
    scale = min(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=True)
    py, px = (size - nh) // 2, (size - nw) // 2
    out = x.new_full((x.shape[0], 3, size, size), 114.0)
    out[:, :, py : py + nh, px : px + nw] = x
    return out / 255.0, scale, (px, py)


@torch.inference_mode()
def head_outputs(model: YOLOv8, frames_bgr: torch.Tensor, size: int,
                 block: int = 8) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The head's float32 logits on ``frames_bgr``, ``block`` frames a pass."""
    parts = []
    with _full_float32():
        for i in range(0, frames_bgr.shape[0], block):
            x, _, _ = letterbox_input(frames_bgr[i : i + block], size)
            parts.append(model(x))
    return [tuple(torch.cat([p[s][k] for p in parts]) for k in range(2)) for s in range(len(parts[0]))]


def decode(outputs, dtype=torch.float32):
    """Per-scale head logits -> (B, N, 4) xyxy boxes in network pixels and
    (B, N, C) class logits, anchors scale by scale in row-major order.  The
    DFL expectation is a softmax over 16 bins of each side's distance,
    around grid-cell centres, times the stride; computed in ``dtype``."""
    boxes, logits = [], []
    for (box, cls), stride in zip(outputs, STRIDES):
        box, cls = box.to(dtype), cls.to(dtype)
        b, _, h, w = box.shape
        bins = torch.arange(REG_MAX, dtype=dtype, device=box.device)
        dist = box.reshape(b, 4, REG_MAX, h * w).permute(0, 3, 1, 2)
        dist = torch.softmax(dist, dim=-1) @ bins
        ay = (torch.arange(h, dtype=dtype, device=box.device) + 0.5)[:, None].expand(h, w).reshape(-1)
        ax = (torch.arange(w, dtype=dtype, device=box.device) + 0.5)[None, :].expand(h, w).reshape(-1)
        boxes.append(torch.stack([(ax - dist[..., 0]) * stride, (ay - dist[..., 1]) * stride,
                                  (ax + dist[..., 2]) * stride, (ay + dist[..., 3]) * stride], dim=-1))
        logits.append(cls.reshape(b, cls.shape[1], h * w).transpose(1, 2))
    return torch.cat(boxes, dim=1), torch.cat(logits, dim=1)
