"""Kernels K1 and K2 against their plain versions on a CUDA card.

The kernels are CUDA C++ for sm_90a and have no CPU mode, so every test
here needs the card: on a machine without one they skip.  Run them on the
card with ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
This file imports no JAX: the card's machine has none.
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_tracker_kernel_matches_plain(device):
    """Every output exact at every step: churn at (64, 16) and (128, 64), a
    saturated table, and the 300-frame synthetic stream."""
    cases = chip_smoke.check_tracker_kernel(device, steps=20)
    assert [c["case"] for c in cases] == [
        "churn_64x16", "churn_128x64", "saturated_64x16", "synthetic_64x16"
    ]
    torch.cuda.synchronize()


def test_kalman_kernel_matches_plain(device):
    result = chip_smoke.check_kalman_kernel(device, frames=100)
    assert result["unmeasured"] > 0
    torch.cuda.synchronize()


def test_main_path_on_card_matches_cpu(device):
    result = chip_smoke.check_main_path(device, chip_smoke.synthetic_inputs())
    assert result["launches"] == {"tracker_step": 300, "kalman_step": 300}


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    from multimodal_autonomous_driving_perception_and_planning_torch import TrackerConfig
    from multimodal_autonomous_driving_perception_and_planning_torch.ops import tracker_kernel
    from multimodal_autonomous_driving_perception_and_planning_torch.types import TrackTable

    import numpy as np

    dets = chip_smoke.random_dets(np.random.default_rng(0), 65, device)
    table = TrackTable.empty(16, 4, device)
    with pytest.raises(ValueError, match="1..64 detections"):
        tracker_kernel.tracker_step(table, dets, TrackerConfig(), 3)
