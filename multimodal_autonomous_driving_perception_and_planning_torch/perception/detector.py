"""YOLO detection frontends: camera frames -> detection tables -> the
pipeline.

Detection maps a batch of frames to a (T, D, ...) detection stream on the
device, in chunks of ``batch`` frames (the conv tower, decode, and NMS with
kernel K5 once a chunk); the frame loop of `pipeline.make_sequence_runner`
then consumes the tables without leaving the device.  Port of the JAX
package's perception/detector.py, with the reference-named per-frame
``ObjectDetector`` over the host records (host.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..data.synthetic import simulated_detection_stream, simulated_detections_for_frame
from ..host import CLASS_COLORS, CLASS_NAMES, HostDetection, to_numpy
from ..models.yolov8 import infer_variant_from_state_dict, load_torch_state_dict, make_yolo_detector
from ..pipeline import make_sequence_runner
from ..utils.device import resolve_device
from ..utils.profiler import NO_SPAN, SPANS
from ..viz.draw import draw_detections

TABLE_KEYS = ("bbox", "class_id", "confidence", "valid")


def _detect_chunks(detect_fn, params, frames, batch: int, dev: torch.device, keep_candidates: bool):
    """Run ``detect_fn`` over ``batch``-frame chunks, the last padded with
    zero frames as the JAX package pads it, so that every chunk has one
    shape.  Returns the (T, D, ...) tables and, with ``keep_candidates``,
    the (T, N, ...) candidates of every frame."""
    frames = torch.as_tensor(frames)
    t = frames.shape[0]
    tables, cands = [], []
    rec = SPANS.active()
    for start in range(0, t, batch):
        src = frames[start : start + batch]
        n = src.shape[0]
        with rec.span("detect", frames=n, padded=batch - n) if rec else NO_SPAN:
            with _h2d_span(rec, src, dev):
                chunk = src.to(dev)
            if n < batch:
                pad = chunk.new_zeros((batch - n,) + tuple(chunk.shape[1:]))
                chunk = torch.cat([chunk, pad])
            out = detect_fn(params, chunk, return_candidates=keep_candidates)
        if keep_candidates:
            out, c = out
            cands.append(c)
        tables.append(out)
    stream = {k: torch.cat([tab[k] for tab in tables])[:t] for k in TABLE_KEYS}
    if not keep_candidates:
        return stream, None
    candidates = {k: torch.cat([c[k] for c in cands])[:t] for k in ("boxes", "scores", "classes")}
    candidates.update(scale=cands[0]["scale"], pad=cands[0]["pad"])
    return stream, candidates


def _h2d_span(rec, src: torch.Tensor, dev: torch.device):
    """The ``h2d`` span of a chunk's upload: the bytes it moves (none when
    the chunk is on the device already) and whether its source is pinned."""
    if rec is None:
        return NO_SPAN
    copied = src.device.type != dev.type
    return rec.span("h2d", bytes=src.nbytes if copied else 0, pinned=copied and src.is_pinned())


def _kernel_launches() -> Dict[str, int]:
    """The launch counters of kernels K1, K2, K3, K5 and K6 (tracker,
    estimator, tagging, NMS, planner), as `segment` spans count them."""
    from ..ops import kalman_kernel, nms_kernel, planner_kernel, tagging_kernel, tracker_kernel

    return {"k1_launches": tracker_kernel.launches, "k2_launches": kalman_kernel.launches,
            "k3_launches": tagging_kernel.launches, "k5_launches": nms_kernel.launches,
            "k6_launches": planner_kernel.launches}


def make_yolo_frontend(
    cfg: PipelineConfig,
    variant: str = "n",
    batch: int = 8,
    score_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    img_size: int = 640,
    device="cuda",
):
    """Build (init_fn, stream_fn): stream_fn(params, frames (T, H, W, 3)) ->
    detection stream dict of (T, D, ...) tensors on the device."""
    dev = resolve_device(device)
    init_fn, detect_fn = make_yolo_detector(
        variant=variant,
        max_det=cfg.detector.max_detections,
        score_threshold=score_threshold,
        iou_threshold=iou_threshold,
        img_size=img_size,
        device=dev,
    )

    def stream_fn(params, frames) -> Dict[str, torch.Tensor]:
        return _detect_chunks(detect_fn, params, frames, batch, dev, False)[0]

    return init_fn, stream_fn


def make_yolo_sequence_runner(
    cfg: PipelineConfig,
    variant: str = "n",
    batch: int = 64,
    score_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    compute_dtype=None,
    map_to_taxonomy: bool = True,
    img_size: int = 640,
    device="cuda",
    pre_topk: int = 256,
):
    """BASELINE config 3: camera frames in -> YOLO detection -> tracker ->
    ego estimation -> planner (-> tags with ``enable_tagging``) -> outputs.

    Returns (init_fn, run) where
      run(params, state, frames (T, H, W, 3), ego (T, 4)) -> (state', outs),
    ``outs`` with the keys of `make_sequence_runner`.  With
    ``keep_candidates=True``, ``outs`` also holds the detection tables
    ("detections", (T, D, ...)) and the NMS candidates ("candidates",
    (T, N, ...)) of the run, for checking the NMS stage.

    ``compute_dtype`` defaults to bfloat16 (the conv tower); the decode /
    NMS tail and the pipeline run in float32.  ``pre_topk`` is the NMS
    candidate pool (`make_yolo_detector`'s, which the JAX package's runner
    leaves at its default of 256); 8,400 takes every anchor at 640.  With ``cfg.use_frames`` the
    frames also go into the pipeline: lanes, scene features and
    frames-mode tags.
    """
    dev = resolve_device(device)
    init_fn, detect_fn = make_yolo_detector(
        variant=variant,
        max_det=cfg.detector.max_detections,
        score_threshold=score_threshold,
        iou_threshold=iou_threshold,
        map_to_taxonomy=map_to_taxonomy,
        img_size=img_size,
        compute_dtype=torch.bfloat16 if compute_dtype is None else compute_dtype,
        pre_topk=pre_topk,
        device=dev,
    )
    run_frames = make_sequence_runner(cfg, device=dev)

    def run_segment(params, state, frames, ego, keep_candidates: bool):
        stream, candidates = _detect_chunks(detect_fn, params, frames, batch, dev, keep_candidates)
        inputs = dict(stream, ego_measurement=torch.as_tensor(ego, dtype=torch.float32))
        if cfg.use_frames:
            inputs["frame"] = frames
        final, outs = run_frames(state, inputs)
        if keep_candidates:
            outs["detections"], outs["candidates"] = stream, candidates
        return final, outs

    def run(params, state, frames, ego, keep_candidates: bool = False):
        rec = SPANS.active()
        if rec is None:
            return run_segment(params, state, frames, ego, keep_candidates)
        t = len(frames)
        with rec.span("segment", frames=t, chunks=-(-t // batch)) as sp:
            before = _kernel_launches()
            result = run_segment(params, state, frames, ego, keep_candidates)
            sp.counts.update({k: v - before[k] for k, v in _kernel_launches().items()})
        return result

    return init_fn, run


class ObjectDetector:
    """Host-facing detector with the reference's constructor/API surface
    (detector.py:29-226), on the card unless built with ``device="cpu"``.

    ``detect(frame)`` returns a list of HostDetection; ``detect_stream``
    returns the (T, D, ...) detection tables the pipeline consumes, on the
    detector's device.  YOLO mode runs the conv tower and NMS with kernel
    K5 once a chunk (`make_yolo_frontend`).
    """

    # Reference class attributes (detector.py:39-60).
    CLASSES = {i: n for i, n in enumerate(CLASS_NAMES)}
    CLASS_COLORS = dict(CLASS_COLORS)

    def __init__(
        self,
        mode: str = "simulated",
        model_path: Optional[str] = None,
        cfg: Optional[PipelineConfig] = None,
        rng_seed: int = 0,
        img_size: int = 640,
        allow_random_init: bool = False,
        device="cuda",
    ):
        self.cfg = cfg or DEFAULT_CONFIG
        self.device = resolve_device(device)
        self.mode = mode
        self.frame_count = 0
        self.variables = None
        self.variant = None
        self._img_size = img_size
        self._stream_fn = None
        self._frame_fn = None

        if mode == "yolo":
            loaded, variant = (None, "n")
            if model_path:
                loaded, variant = self._try_load_weights(model_path)
            if loaded is None and not allow_random_init:
                # Reference contract (detector.py:77-84 and PARITY.md's
                # "weightless YOLO -> simulated"): without usable weights the
                # detector degrades to the seeded simulator; it must never
                # emit a random-init network's boxes as detections.
                print(f"Could not load YOLO weights ({model_path!r}); falling back to simulated mode.")
                self.mode = "simulated"
                return
            self.variant = variant
            init_fn, self._stream_fn = make_yolo_frontend(
                self.cfg, variant=variant, img_size=img_size, device=self.device
            )
            self.variables = (
                {k: v.to(self.device) for k, v in loaded.items()}
                if loaded is not None
                else init_fn(torch.Generator().manual_seed(rng_seed))
            )

    def _try_load_weights(self, model_path: str):
        """Accepts a portable ``.npz`` archive (tools/export_weights.py) or
        a torch state_dict checkpoint of ultralytics keys.  Returns
        (state dict or None, variant); the variant comes from the archive's
        metadata when present, else from the tensor shapes, so that an
        un-hinted yolov8s/m export never builds the wrong architecture."""
        try:
            if model_path.endswith(".npz"):
                from ..utils.weights import load_npz_state_dict

                sd, meta = load_npz_state_dict(model_path)
            else:
                sd = torch.load(model_path, map_location="cpu", weights_only=True)
                if isinstance(sd, dict) and "state_dict" in sd:
                    sd = sd["state_dict"]
                meta = {}
            variant = meta.get("variant") or infer_variant_from_state_dict(sd)
            return load_torch_state_dict(sd, variant=variant), variant
        except Exception as e:  # surfaced: a silent fallback hid shape bugs
            print(f"YOLO weight load failed ({model_path}): {e!r}")
            return None, "n"

    # -- per-frame host API (reference detector.py:86-101) -----------------
    def detect(self, frame: np.ndarray):
        self.frame_count += 1
        if self.mode == "yolo" and self.variables is not None:
            if self._frame_fn is None:
                # A batch of one for the per-frame API: the streaming
                # frontend pads to its batch (8), which would run 8 frames
                # of conv work a single-frame call.
                _, self._frame_fn = make_yolo_frontend(
                    self.cfg, variant=self.variant, img_size=self._img_size, batch=1, device=self.device
                )
            out = self._frame_fn(self.variables, torch.as_tensor(np.asarray(frame))[None])
            out = {k: to_numpy(v[0]) for k, v in out.items()}
        else:
            boxes, cls, confs = simulated_detections_for_frame(self.frame_count, frame.shape[0], frame.shape[1])
            d = self.cfg.detector.max_detections
            out = {
                "bbox": np.zeros((d, 4), np.float32),
                "class_id": np.zeros((d,), np.int32),
                "confidence": np.zeros((d,), np.float32),
                "valid": np.zeros((d,), bool),
            }
            n = min(len(boxes), d)
            out["bbox"][:n] = boxes[:n]
            out["class_id"][:n] = cls[:n]
            out["confidence"][:n] = confs[:n]
            out["valid"][:n] = True
        return [
            HostDetection(
                bbox=tuple(out["bbox"][j].tolist()),
                class_id=int(out["class_id"][j]),
                class_name=CLASS_NAMES[int(out["class_id"][j])],
                confidence=float(out["confidence"][j]),
            )
            for j in np.flatnonzero(out["valid"])
        ]

    # -- batch device API ---------------------------------------------------
    def detect_stream(self, frames) -> Dict[str, torch.Tensor]:
        """(T, H, W, 3) frames -> (T, D, ...) detection tables on the
        detector's device."""
        if self.mode == "yolo" and self.variables is not None:
            out = self._stream_fn(self.variables, frames)
            self.frame_count += int(frames.shape[0])
            return out
        t = int(frames.shape[0])
        stream = simulated_detection_stream(
            t,
            height=self.cfg.frame_height,
            width=self.cfg.frame_width,
            capacity=self.cfg.detector.max_detections,
            start_frame_count=self.frame_count + 1,
        )
        self.frame_count += t
        return {k: torch.from_numpy(v).to(self.device) for k, v in stream.items()}

    def draw_detections(
        self,
        frame: np.ndarray,
        detections,
        show_labels: bool = True,
        show_confidence: bool = True,
    ) -> np.ndarray:
        """Reference detector.py:171-222."""
        return draw_detections(frame, detections, show_labels, show_confidence)

    def reset(self) -> None:
        self.frame_count = 0
