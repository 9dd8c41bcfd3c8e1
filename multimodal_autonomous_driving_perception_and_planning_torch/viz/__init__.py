"""Host renderers over the port's records: the bird's-eye view, the HUD
overlays and the per-module draw helpers (cv2, imported when they draw)."""

from .bev import BEVRenderer
from .overlays import OverlayRenderer
from .draw import draw_detections, draw_lanes, draw_tracks

__all__ = [
    "BEVRenderer",
    "OverlayRenderer",
    "draw_detections",
    "draw_lanes",
    "draw_tracks",
]
