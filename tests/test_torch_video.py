"""The port's `VideoDataLoader` against the JAX package's, on a clip this
test writes with cv2 (mp4v): frames, metadata, sequential and random
reads, iteration and the lifecycle equal, frames byte for byte."""

import numpy as np
import pytest

from multimodal_autonomous_driving_perception_and_planning_torch.data.video import VideoDataLoader as LoaderT
from multimodal_autonomous_driving_perception_and_planning_tpu.data.frames import SyntheticRoadGenerator as RoadJ
from multimodal_autonomous_driving_perception_and_planning_tpu.data.video import VideoDataLoader as LoaderJ


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    import cv2

    path = str(tmp_path_factory.mktemp("video") / "road.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (320, 240))
    for f in RoadJ(320, 240).generate_frames(14):
        writer.write(f)
    writer.release()
    return path


@pytest.mark.parametrize("target_size", [None, (160, 120)])
def test_frames_and_metadata_equal_jax(clip, target_size):
    t, j = LoaderT(clip, target_size=target_size), LoaderJ(clip, target_size=target_size)
    try:
        assert t.get_info() == j.get_info()
        assert (t.total_frames, t.fps, t.width, t.height, t.duration, t.dt, len(t)) == (
            j.total_frames, j.fps, j.width, j.height, j.duration, j.dt, len(j))
        assert t.total_frames == 14 and t.dt == pytest.approx(1 / 25)
        assert repr(t) == repr(j)
        a, b = t.load_frames(10, start=2), j.load_frames(10, start=2)
        assert a.shape == b.shape == (10, t.height, t.width, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        for idx in (0, 13, 5, 6, 14, -1):  # backwards, forwards, out of range
            fa, fb = t.read_frame_at(idx), j.read_frame_at(idx)
            assert (fa is None) == (fb is None), idx
            if fa is not None:
                np.testing.assert_array_equal(fa, fb)
        assert t.frame_count == j.frame_count
        np.testing.assert_array_equal(np.stack(list(t)), np.stack(list(j)))
        np.testing.assert_array_equal(np.stack(list(t.generate_video_stream(4))),
                                      np.stack(list(j.generate_video_stream(4))))
        assert len(t.generate_ego_motion(6)) == 6 and len(t.generate_ego_motion(6)[0]) == 4
        t.reset()
        np.testing.assert_array_equal(t.read_frame(), j.read_frame_at(0))
    finally:
        t.release()
        j.release()
    assert t.read_frame() is None and t.load_frames(3).shape == (0, t.height, t.width, 3)


def test_missing_and_unreadable_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        LoaderT(str(tmp_path / "none.mp4"))
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    with pytest.raises(ValueError):
        LoaderT(str(bad))
