"""YOLOv8 detection model in PyTorch, NCHW.

The standard YOLOv8 layout (CSP backbone with C2f blocks and SPPF, PAN
neck, decoupled anchor-free head with DFL box regression) as
`nn.Module`s, ported from the JAX package's Flax model.  Submodules carry
the Flax module names (``b0`` ... ``b9``, ``n12`` ... ``n21``,
``head.cv2_0_0``), so a Flax path maps to a port path by a rename
(utils/convert.py `yolo_state_from_flax`).

Inference only, with Flax's numerics: parameters stay float32 and the
model's ``dtype`` is the compute dtype, to which every conv casts its input
and its kernel; BatchNorm (epsilon 1e-3, running statistics) computes
``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32 and casts to
the compute dtype at the end; the head returns float32, and decode, the
sigmoid and NMS run in float32.  The convolutions are
`torch.nn.functional.conv2d` (the JAX package leaves them to XLA); the
greedy-NMS keep mask is kernel K5 on the card (ops/nms.py).

COCO class ids are translated to the pipeline's 8-way driving taxonomy by
``COCO_TO_TAXONOMY``, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..ops.nms import nms
from ..utils.device import float32_matmuls, resolve_device
from ..utils.profiler import NO_SPAN, SPANS

# depth multiple, width multiple, max-channel cap.
YOLOV8_VARIANTS = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}

REG_MAX = 16
STRIDES = (8, 16, 32)
STOP_POINTS = ("b0", "b2", "b4", "b6", "b9", "neck")
BN_EPSILON = 1e-3

# COCO id -> taxonomy id for the classes the AV stack consumes.
COCO_TO_TAXONOMY = {
    0: 2,  # person -> pedestrian
    1: 3,  # bicycle -> cyclist
    2: 0,  # car
    3: 4,  # motorcycle
    5: 5,  # bus
    7: 1,  # truck
    9: 6,  # traffic light
    11: 7,  # stop sign
}


def _make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


class Conv(nn.Module):
    """Flax ``nn.Conv``: an OIHW ``weight``, "same" padding, an optional
    bias added after the convolution.  Input, kernel and bias take the
    input's dtype, which is the model's compute dtype."""

    def __init__(self, in_ch: int, features: int, kernel: int = 1, stride: int = 1, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_ch, kernel, kernel))
        if bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)
        self.stride, self.padding = stride, kernel // 2

    def forward(self, x):
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).view(1, -1, 1, 1)
        return y


class BatchNorm(nn.Module):
    """Inference BatchNorm in Flax's order and promotion: float32
    arithmetic on the running statistics, cast to the input's dtype at the
    end."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + BN_EPSILON) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU: ultralytics' Conv block."""

    def __init__(self, in_ch: int, features: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel, stride)
        self.bn = BatchNorm(features)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBN(in_ch, features, 3)
        self.cv2 = ConvBN(features, features, 3)
        self.add = shortcut and in_ch == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block with n bottlenecks (``m0`` ...), dense concat."""

    def __init__(self, in_ch: int, features: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        self.c, self.n = features // 2, n
        self.cv1 = ConvBN(in_ch, 2 * self.c, 1)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(self.c, self.c, shortcut))
        self.cv2 = ConvBN((2 + n) * self.c, features, 1)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, : self.c], y[:, self.c :]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 max pools."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        c = features // 2
        self.cv1 = ConvBN(in_ch, c, 1)
        self.cv2 = ConvBN(4 * c, features, 1)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, stride=1, padding=2))
        return self.cv2(torch.cat(pools, dim=1))


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class DetectHead(nn.Module):
    """Decoupled anchor-free head: DFL box branch + class branch per scale
    (``cv2_<i>_<j>`` and ``cv3_<i>_<j>``)."""

    def __init__(self, num_classes: int, channels: Sequence[int]):
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

    def forward(self, feats: List[torch.Tensor]):
        outs = []
        for i, x in enumerate(feats):
            box, cls = x, x
            for j in range(3):
                box = getattr(self, f"cv2_{i}_{j}")(box)
                cls = getattr(self, f"cv3_{i}_{j}")(cls)
            # Decode (DFL softmax, sigmoid, NMS) runs in float32.
            outs.append((box.float(), cls.float()))
        return outs


class YOLOv8(nn.Module):
    """Full detector on NCHW input; returns per-scale (box_logits
    (B, 64, h, w), cls_logits (B, C, h, w)), float32.

    ``stop_after`` (profiling and tests): return the named block's
    activation instead, as the JAX model does.
    """

    def __init__(self, num_classes: int = 80, variant: str = "n", dtype: torch.dtype = torch.float32,
                 stop_after: str = ""):
        super().__init__()
        if stop_after and stop_after not in STOP_POINTS:
            raise ValueError(f"unknown stop_after={stop_after!r}")
        self.dtype, self.stop_after = dtype, stop_after
        depth, width, max_ch = YOLOV8_VARIANTS[variant]

        def ch(c):
            return _make_divisible(min(c, max_ch) * width)

        def nd(n):
            return max(1, round(n * depth))

        # Backbone.
        self.b0 = ConvBN(3, ch(64), 3, 2)  # P1/2
        self.b1 = ConvBN(ch(64), ch(128), 3, 2)  # P2/4
        self.b2 = C2f(ch(128), ch(128), nd(3), True)
        self.b3 = ConvBN(ch(128), ch(256), 3, 2)  # P3/8
        self.b4 = C2f(ch(256), ch(256), nd(6), True)
        self.b5 = ConvBN(ch(256), ch(512), 3, 2)  # P4/16
        self.b6 = C2f(ch(512), ch(512), nd(6), True)
        self.b7 = ConvBN(ch(512), ch(1024), 3, 2)  # P5/32
        self.b8 = C2f(ch(1024), ch(1024), nd(3), True)
        self.b9 = SPPF(ch(1024), ch(1024))
        # PAN neck.
        self.n12 = C2f(ch(1024) + ch(512), ch(512), nd(3), False)
        self.n15 = C2f(ch(512) + ch(256), ch(256), nd(3), False)  # P3 out
        self.n16 = ConvBN(ch(256), ch(256), 3, 2)
        self.n18 = C2f(ch(256) + ch(512), ch(512), nd(3), False)  # P4 out
        self.n19 = ConvBN(ch(512), ch(512), 3, 2)
        self.n21 = C2f(ch(512) + ch(1024), ch(1024), nd(3), False)  # P5 out
        self.head = DetectHead(num_classes, (ch(256), ch(512), ch(1024)))

    def forward(self, x):
        if self.dtype != torch.float32:
            return self._forward(x)
        # float32 is the parity dtype: full float32 convolutions (cuDNN's
        # default is TF32), the caller's flags restored after.
        with float32_matmuls():
            return self._forward(x)

    def _forward(self, x):
        stop = self.stop_after
        x = self.b0(x.to(self.dtype))
        if stop == "b0":
            return x
        x = self.b2(self.b1(x))
        if stop == "b2":
            return x
        p3 = self.b4(self.b3(x))
        if stop == "b4":
            return p3
        p4 = self.b6(self.b5(p3))
        if stop == "b6":
            return p4
        p5 = self.b9(self.b8(self.b7(p4)))
        if stop == "b9":
            return p5
        n4 = self.n12(torch.cat([_upsample2(p5), p4], dim=1))
        o3 = self.n15(torch.cat([_upsample2(n4), p3], dim=1))
        o4 = self.n18(torch.cat([self.n16(o3), n4], dim=1))
        o5 = self.n21(torch.cat([self.n19(o4), p5], dim=1))
        if stop == "neck":
            return (o3, o4, o5)
        return self.head([o3, o4, o5])


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's initializers, in place and in registration order: conv
    kernels ``lecun_normal`` (a normal truncated at two standard deviations,
    scaled to variance 1 / fan_in), conv biases 0, BatchNorm scale 1, bias 0,
    mean 0, var 1.  ``generator`` must live on the parameters' device."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv):
                fan_in = mod.weight[0].numel()
                nn.init.trunc_normal_(mod.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
                mod.weight.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_predictions(
    outputs: List[Tuple[torch.Tensor, torch.Tensor]],
    img_size: int,
    apply_sigmoid: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scale NCHW head outputs -> flat (B, N, 4) xyxy boxes + (B, N, C)
    class probabilities (or raw logits with ``apply_sigmoid=False``).

    DFL: softmax over REG_MAX bins per side -> expected distance, scaled by
    stride around grid-center anchors.  ``img_size`` is unused, as in the
    JAX package.
    """
    del img_size
    all_boxes, all_cls = [], []
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=outputs[0][0].device)
    for (box_logits, cls_logits), stride in zip(outputs, STRIDES):
        b, _, h, w = box_logits.shape
        dist = box_logits.reshape(b, 4, REG_MAX, h * w).permute(0, 3, 1, 2)
        dist = torch.softmax(dist, dim=-1) @ bins  # (b, hw, 4) l,t,r,b
        ys = (torch.arange(h, dtype=torch.float32, device=bins.device) + 0.5)[:, None]
        xs = (torch.arange(w, dtype=torch.float32, device=bins.device) + 0.5)[None, :]
        ax = xs.expand(h, w).reshape(-1)
        ay = ys.expand(h, w).reshape(-1)
        x1 = (ax - dist[..., 0]) * stride
        y1 = (ay - dist[..., 1]) * stride
        x2 = (ax + dist[..., 2]) * stride
        y2 = (ay + dist[..., 3]) * stride
        all_boxes.append(torch.stack([x1, y1, x2, y2], dim=-1))
        cls = cls_logits.reshape(b, cls_logits.shape[1], h * w).transpose(1, 2)
        all_cls.append(torch.sigmoid(cls) if apply_sigmoid else cls)
    return torch.cat(all_boxes, dim=1), torch.cat(all_cls, dim=1)


def _letterbox_nchw(x: torch.Tensor, size: int, pad_value: float = 114.0):
    """`letterbox` on a float (B, C, H, W) batch."""
    h, w = x.shape[-2], x.shape[-1]
    scale = min(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) != (h, w):
        # jax.image.resize antialiases by default.
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=True)
    pad_y, pad_x = (size - nh) // 2, (size - nw) // 2
    out = x.new_full((x.shape[0], x.shape[1], size, size), pad_value)
    out[:, :, pad_y : pad_y + nh, pad_x : pad_x + nw] = x
    return out, scale, (pad_x, pad_y)


def letterbox(image, size: int = 640, pad_value: float = 114.0):
    """Aspect-preserving resize + pad of an (H, W, C) image, or a (B, H, W,
    C) batch, to (size, size), float32 in the input's layout.

    Returns (padded, scale, (pad_x, pad_y)) for mapping boxes back.
    """
    x = torch.as_tensor(image).float()
    batched = x.dim() == 4
    x = (x if batched else x[None]).permute(0, 3, 1, 2)
    out, scale, pad = _letterbox_nchw(x, size, pad_value)
    out = out.permute(0, 2, 3, 1)
    return (out if batched else out[0]), scale, pad


def preprocess(frames_bgr: torch.Tensor, img_size: int):
    """(B, H, W, 3) BGR frames of any dtype -> the network's (B, 3, img_size,
    img_size) float32 RGB input in [0, 1], the letterbox scale and pads."""
    x = frames_bgr.flip(-1).float().permute(0, 3, 1, 2)
    padded, scale, pad = _letterbox_nchw(x, img_size)
    return padded / 255.0, scale, pad


def candidates_from_outputs(outputs, scale: float, pad: Tuple[int, int]) -> Dict[str, Any]:
    """Head outputs -> the NMS candidates of each frame: boxes (B, N, 4) in
    network coordinates, scores (B, N) and classes (B, N) int32.

    Max and argmax on the logits, one sigmoid on the winner: sigmoid is
    strictly increasing, so this equals the max of the sigmoids bit for bit,
    and argmax takes the first maximum in both libraries.
    """
    boxes, logits = decode_predictions(outputs, 0, apply_sigmoid=False)
    return {
        "boxes": boxes,
        "scores": torch.sigmoid(logits.amax(dim=-1)),
        "classes": logits.argmax(dim=-1).to(torch.int32),
        "scale": scale,
        "pad": pad,
    }


def taxonomy_map(num_classes: int = 80) -> np.ndarray:
    """COCO id -> taxonomy id, -1 for the classes the stack drops."""
    coco_ids = np.full((num_classes,), -1, np.int32)
    for coco, tax in COCO_TO_TAXONOMY.items():
        if coco < num_classes:
            coco_ids[coco] = tax
    return coco_ids


def tables_from_candidates(
    cands: Dict[str, Any],
    iou_threshold: float,
    score_threshold: float,
    max_det: int,
    pre_topk: int,
    taxonomy: Optional[np.ndarray] = None,
) -> Dict[str, torch.Tensor]:
    """NMS over each frame's candidates (kernel K5 for CUDA tensors), then
    back to frame coordinates: the fixed-capacity (B, max_det) detection
    tables the pipeline takes.  ``taxonomy`` maps classes (`taxonomy_map`)
    and drops the unmapped ones."""
    res = nms(
        cands["boxes"], cands["scores"], cands["classes"],
        iou_threshold=iou_threshold, score_threshold=score_threshold,
        max_det=max_det, pre_topk=pre_topk,
    )
    dev = res.boxes.device
    pad_x, pad_y = cands["pad"]
    offset = torch.tensor([pad_x, pad_y, pad_x, pad_y], dtype=torch.float32, device=dev)
    # A tensor on the device divides exactly; a Python number on CUDA
    # would be a reciprocal multiply.
    out_boxes = (res.boxes - offset) / torch.tensor(cands["scale"], dtype=torch.float32, device=dev)
    valid, classes = res.valid, res.classes
    if taxonomy is not None:
        mapped = torch.as_tensor(taxonomy, device=dev)[classes.long()]
        valid = valid & (mapped >= 0)
        classes = mapped.clamp_min(0)
    return {
        "bbox": torch.where(valid[..., None], out_boxes, 0.0),
        "class_id": torch.where(valid, classes, 0),
        "confidence": torch.where(valid, res.scores, 0.0),
        "valid": valid,
    }


def make_yolo_detector(
    variant: str = "n",
    num_classes: int = 80,
    img_size: int = 640,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.25,
    max_det: int = 32,
    map_to_taxonomy: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    pre_topk: int = 256,
    device="cuda",
):
    """Build (init_fn, detect_fn).

    ``init_fn(generator)`` returns seeded parameters, a ``state_dict`` of
    `YOLOv8` on ``device`` (Flax's initializers; ``generator`` is a CPU
    `torch.Generator`).  ``detect_fn(params, frames_bgr)`` takes (B, H, W, 3)
    frames, or one (H, W, 3) frame, and returns the fixed-capacity detection
    tables in frame coordinates; with ``return_candidates=True`` it also
    returns the NMS candidates (`candidates_from_outputs`).

    ``compute_dtype`` defaults to bfloat16; parameters and the decode / NMS
    tail stay float32.  ``pre_topk`` bounds the NMS candidate pool (top-K by
    score out of the 8400 anchors at 640).  ``detect_fn.model`` is the
    `YOLOv8` it runs the parameters through (parallel/tp.py hooks its
    layers).
    """
    dev = resolve_device(device)
    model = YOLOv8(num_classes=num_classes, variant=variant, dtype=compute_dtype)
    taxonomy = taxonomy_map(num_classes) if map_to_taxonomy else None

    def init_fn(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        fresh = YOLOv8(num_classes=num_classes, variant=variant)
        init_params(fresh, generator)
        return {k: v.to(dev) for k, v in fresh.state_dict().items()}

    @torch.inference_mode()
    def detect_fn(params: Dict[str, torch.Tensor], frames_bgr, return_candidates: bool = False):
        frames = torch.as_tensor(frames_bgr).to(dev)
        single = frames.dim() == 3
        rec = SPANS.active()
        with rec.span("tower") if rec else NO_SPAN:
            x, scale, pad = preprocess(frames[None] if single else frames, img_size)
            outputs = functional_call(model, params, (x,), strict=True)
        with rec.span("decode") if rec else NO_SPAN:
            cands = candidates_from_outputs(outputs, scale, pad)
        with rec.span("nms", pool=min(pre_topk, cands["scores"].shape[-1])) if rec else NO_SPAN:
            tables = tables_from_candidates(cands, iou_threshold, score_threshold, max_det, pre_topk, taxonomy)
        if single:
            tables = {k: v[0] for k, v in tables.items()}
        return (tables, cands) if return_candidates else tables

    detect_fn.model = model
    return init_fn, detect_fn


# ---------------------------------------------------------------------------
# Weight import
# ---------------------------------------------------------------------------

# Port module path per ultralytics model.N index (yolov8 yaml layer order).
_ULTRA_LAYER_TO_PORT = {
    0: "b0", 1: "b1", 2: "b2", 3: "b3", 4: "b4", 5: "b5", 6: "b6",
    7: "b7", 8: "b8", 9: "b9", 12: "n12", 15: "n15", 16: "n16",
    18: "n18", 19: "n19", 21: "n21", 22: "head",
}
_BN_ATTRS = ("weight", "bias", "running_mean", "running_var")


def infer_variant_from_state_dict(state_dict: Dict[str, Any]) -> str:
    """Infer the YOLOv8 variant from the stem conv's out-channel count,
    ``_make_divisible(64 * width)`` (n=16, s=32, m=48, l=64, x=80).  Raises
    ValueError when no stem conv is present or the width is not a known
    variant."""
    by_stem = {_make_divisible(64 * width): v for v, (_, width, _) in YOLOV8_VARIANTS.items()}
    for key in ("model.0.conv.weight", "0.conv.weight"):
        w = state_dict.get(key)
        if w is not None:
            out_ch = int(w.shape[0])  # OIHW
            if out_ch in by_stem:
                return by_stem[out_ch]
            raise ValueError(
                f"stem conv has {out_ch} out-channels; not a known yolov8 variant width ({sorted(by_stem)})"
            )
    raise ValueError("no stem conv ('model.0.conv.weight') in state dict")


def load_torch_state_dict(state_dict: Dict[str, Any], variant: str = "n", num_classes: int = 80):
    """An ultralytics YOLOv8 ``model.state_dict()`` as a state dict of the
    port's `YOLOv8`: keys renamed (``model.2.m.0.cv1.conv.weight`` ->
    ``b2.m0.cv1.conv.weight``, ``model.22.cv2.0.2.weight`` ->
    ``head.cv2_0_2.weight``), values as float32 tensors, no transposes (both
    are OIHW).  The DFL conv (fixed arange weights) is implicit in
    `decode_predictions`, and BatchNorm's ``num_batches_tracked`` is dropped.

    ``variant`` is checked against the stem width when the dict has a stem.
    """
    if "model.0.conv.weight" in state_dict or "0.conv.weight" in state_dict:
        inferred = infer_variant_from_state_dict(state_dict)
        if inferred != variant:
            raise ValueError(
                f"state dict is a yolov8{inferred} (stem width), but variant={variant!r} was requested"
            )
    del num_classes  # the class count is carried by the cv3 tower shapes
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[0] == "model":
            parts = parts[1:]
        layer = int(parts[0])
        if layer not in _ULTRA_LAYER_TO_PORT:
            continue
        base, rest = _ULTRA_LAYER_TO_PORT[layer], parts[1:]
        if base == "head":
            if rest[0] == "dfl":
                continue
            tower, i, j = rest[:3]
            prefix, rest = [base, f"{tower}_{i}_{j}"], rest[3:]
        else:
            prefix = [base]
        path = _port_path(rest)
        if path is None:
            continue
        value = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        out[".".join(prefix + path)] = value.detach().to("cpu", torch.float32)
    return out


def _port_path(rest: List[str]) -> Optional[List[str]]:
    """The port's path of one entry inside a block (``m.<i>`` bottlenecks
    become ``m<i>``), or None for an entry the port does not keep."""
    path, i = [], 0
    while i < len(rest):
        if rest[i] == "m" and i + 1 < len(rest) and rest[i + 1].isdigit():
            path.append(f"m{rest[i + 1]}")
            i += 2
        else:
            path.append(rest[i])
            i += 1
    *mods, attr = path
    if mods and mods[-1] == "bn":
        return path if attr in _BN_ATTRS else None
    return path if attr in ("weight", "bias") else None
