"""Learned models of the port: the YOLOv8 detector and the BLIP captioner
(`blip.init_params`, `blip.preprocess_bgr` and `blip.load_torch_state_dict`
share their names with YOLO's, so they stay in their module)."""

from .blip import BlipConfig, BlipForCaptioning, make_beam_caption_fn, make_caption_fn
from .yolov8 import YOLOv8, YOLOV8_VARIANTS, decode_predictions, make_yolo_detector

__all__ = [
    "YOLOv8",
    "YOLOV8_VARIANTS",
    "decode_predictions",
    "make_yolo_detector",
    "BlipConfig",
    "BlipForCaptioning",
    "make_caption_fn",
    "make_beam_caption_fn",
]
