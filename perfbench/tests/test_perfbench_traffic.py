"""The traffic generator: determined by the seed, and drawing what the
program's own synthetic road generator draws."""

from __future__ import annotations

import numpy as np

from perfbench.traffic import road


def test_one_seed_gives_the_same_pool_twice():
    a = road.road_frames(2**31 + 17, 12, 96, 128)
    b = road.road_frames(2**31 + 17, 12, 96, 128)
    assert a.dtype == np.uint8 and a.shape == (12, 96, 128, 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, road.road_frames(18, 12, 96, 128))
    e = road.ego_measurements(-5, 64, 30.0)
    assert e.dtype == np.float32 and np.array_equal(e, road.ego_measurements(-5, 64, 30.0))


def test_frames_are_the_programs_synthetic_road_frames():
    """Drawn once a pool and copied, the background and vehicles equal the
    port's `SyntheticRoadGenerator` frame for frame from the same index."""
    from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import SyntheticRoadGenerator

    seed, n = 321, 5
    start = int(road.rng(seed, 0).integers(0, 100_000))
    gen = SyntheticRoadGenerator(width=160, height=120)
    gen.frame_count = start
    want = gen.generate_frames(n)
    assert np.array_equal(road.road_frames(seed, n, 120, 160), want)
