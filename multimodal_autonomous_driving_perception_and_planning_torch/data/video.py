"""Video ingestion.

API-compatible with the reference's VideoDataLoader
(data/loaders/video_loader.py:21-259) — same constructor, properties,
read_frame/read_frame_at/generate_video_stream/generate_ego_motion — with
one deliberate performance fix: the reference seeks the container for
*every* frame (video_loader.py:121, O(frames) seeks, flagged pathological in
SURVEY.md section 3.1).  Here sequential reads are the fast path and
`load_frames` decodes a whole clip into one (T, H, W, 3) batch for the
device run, only seeking when random access actually goes backwards.

A copy of the JAX package's data/video.py.  cv2 is imported when a loader
is built, so that the port imports on a machine without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Generator, Optional, Tuple

import numpy as np


class VideoDataLoader:
    def __init__(self, video_path: str, target_size: Optional[Tuple[int, int]] = None):
        self.cap = None  # first, before any raise, so __del__ is safe
        try:
            import cv2
        except ImportError as e:
            raise ImportError("OpenCV (cv2) is required for video decoding") from e
        self._cv2 = cv2
        self.video_path = Path(video_path)
        self.target_size = target_size
        self.frame_count = 0
        if not self.video_path.exists():
            raise FileNotFoundError(f"Video file not found: {video_path}")
        self.cap = self._cv2.VideoCapture(str(self.video_path))
        if not self.cap.isOpened():
            raise ValueError(f"Could not open video file: {self.video_path}")
        self._total_frames = int(self.cap.get(self._cv2.CAP_PROP_FRAME_COUNT))
        self._fps = self.cap.get(self._cv2.CAP_PROP_FPS)
        self._width = int(self.cap.get(self._cv2.CAP_PROP_FRAME_WIDTH))
        self._height = int(self.cap.get(self._cv2.CAP_PROP_FRAME_HEIGHT))
        self._duration = self._total_frames / self._fps if self._fps > 0 else 0
        self._next_decode_idx = 0

    # -- properties (video_loader.py:56-84) --------------------------------
    @property
    def total_frames(self) -> int:
        return self._total_frames

    @property
    def fps(self) -> float:
        return self._fps

    @property
    def width(self) -> int:
        return self.target_size[0] if self.target_size else self._width

    @property
    def height(self) -> int:
        return self.target_size[1] if self.target_size else self._height

    @property
    def duration(self) -> float:
        return self._duration

    @property
    def dt(self) -> float:
        return 1.0 / self._fps if self._fps > 0 else 0.033

    # -- reads -------------------------------------------------------------
    def _postprocess(self, frame: np.ndarray) -> np.ndarray:
        if self.target_size is not None:
            frame = self._cv2.resize(frame, self.target_size)
        return frame

    def read_frame(self) -> Optional[np.ndarray]:
        if self.cap is None:
            return None
        ok, frame = self.cap.read()
        if not ok:
            return None
        self._next_decode_idx += 1
        self.frame_count += 1
        return self._postprocess(frame)

    def read_frame_at(self, frame_idx: int) -> Optional[np.ndarray]:
        if self.cap is None or frame_idx < 0 or frame_idx >= self._total_frames:
            return None
        if frame_idx != self._next_decode_idx:
            # Only seek when the request is non-sequential.
            self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, frame_idx)
            self._next_decode_idx = frame_idx
        ok, frame = self.cap.read()
        if not ok:
            return None
        self._next_decode_idx = frame_idx + 1
        self.frame_count = frame_idx + 1
        return self._postprocess(frame)

    def load_frames(self, num_frames: Optional[int] = None, start: int = 0) -> np.ndarray:
        """Decode a clip into one (T, H, W, 3) uint8 batch (device feed)."""
        if self.cap is None:  # released — mirror read_frame's graceful path
            return np.zeros((0, self.height, self.width, 3), np.uint8)
        n = self._total_frames - start if num_frames is None else num_frames
        n = max(0, min(n, self._total_frames - start))
        if start != self._next_decode_idx:
            self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, start)
            self._next_decode_idx = start
        frames = []
        for _ in range(n):
            f = self.read_frame()
            if f is None:
                break
            frames.append(f)
        if not frames:
            return np.zeros((0, self.height, self.width, 3), np.uint8)
        return np.stack(frames)

    # -- SyntheticDataGenerator-compat shims (video_loader.py:133-164) -----
    def generate_frame_with_vehicles(self) -> Optional[np.ndarray]:
        return self.read_frame()

    def generate_video_stream(
        self, num_frames: Optional[int] = None
    ) -> Generator[np.ndarray, None, None]:
        self.reset()
        limit = num_frames if num_frames else self._total_frames
        for _ in range(limit):
            frame = self.read_frame()
            if frame is None:
                break
            yield frame

    def generate_ego_motion(self, num_steps: Optional[int] = None) -> list:
        """Synthetic ego measurements (video_loader.py:166-205 semantics)."""
        from .synthetic import ego_motion_stream

        n = num_steps if num_steps is not None else self._total_frames
        return [tuple(row) for row in ego_motion_stream(n, dt=self.dt, seed=None)]

    # -- lifecycle ----------------------------------------------------------
    def reset(self) -> None:
        if self.cap is not None:
            self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, 0)
        self._next_decode_idx = 0
        self.frame_count = 0

    def release(self) -> None:
        if self.cap is not None:
            self.cap.release()
            self.cap = None

    def __del__(self):
        self.release()

    def __len__(self) -> int:
        return self._total_frames

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> np.ndarray:
        frame = self.read_frame()
        if frame is None:
            raise StopIteration
        return frame

    def get_info(self) -> dict:
        return {
            "path": str(self.video_path),
            "total_frames": self._total_frames,
            "fps": self._fps,
            "width": self._width,
            "height": self._height,
            "duration": self._duration,
            "target_size": self.target_size,
        }

    def __repr__(self) -> str:
        return (
            f"VideoDataLoader(path='{self.video_path.name}', "
            f"frames={self._total_frames}, fps={self._fps:.1f}, "
            f"size={self._width}x{self._height})"
        )
