"""The host side of kernels K1, K2 and K3 on the CPU: the output buffers
the wrappers carve (ops/launch.py `carve`, `tracker_kernel.output_fields`,
`kalman_kernel.output_fields`, `tagging_kernel.output_fields`) and the
one-pass input checks.

The kernels carve the same buffers by the same rule (tracker_step.cu and
tagging_step.cu and kalman_step.cu `carve`): fields in order, each starting at a multiple
of 4 elements, so that each ring starts 16-byte aligned and the kernels can
store it with 16-byte vector stores.  These tests hold the Python side to
that rule with an independent offset count; the card's runs in
chip_smoke.py compare every field with the plain version.
"""

import math

import numpy as np
import pytest
import torch

from multimodal_autonomous_driving_perception_and_planning_torch.ops import (
    kalman_kernel,
    launch,
    tagging_kernel,
    tracker_kernel,
)


def _offsets(shapes):
    """Element offsets of each field: the kernels' rule, counted anew."""
    offsets, at = [], 0
    for shape in shapes:
        offsets.append(at)
        at += -(-math.prod(shape) // 4) * 4
    return offsets


def _check_fields(buf, names, shapes, fields, dtype):
    assert buf.dtype == dtype and buf.is_contiguous()
    base = buf.data_ptr()
    spans = []
    for name, shape, off in zip(names, shapes, _offsets(shapes)):
        t = fields[name]
        assert t.dtype == dtype, name
        assert tuple(t.shape) == tuple(shape), name
        assert t.is_contiguous(), name
        assert t.data_ptr() - base == off * buf.element_size(), name
        assert (t.data_ptr() - base) % 16 == 0, name
        spans.append((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()))
    spans.sort()
    assert all(a_end <= b_start for (_, a_end), (b_start, _) in zip(spans, spans[1:])), "fields overlap"
    assert spans[-1][1] <= base + buf.numel() * buf.element_size()


@pytest.mark.parametrize("T,L", [(64, 50), (128, 50), (7, 3), (1, 1)])
def test_tracker_output_fields(T, L):
    """Every field of K1's new table, match, order and count: its shape and
    dtype, contiguous, 16-byte aligned, no two overlapping; the trajectory
    ring first.  T L odd gives a ring that is not a multiple of 16 bytes."""
    fbuf, ibuf, out = tracker_kernel.output_fields(T, L, "cpu")
    f_shapes, i_shapes = tracker_kernel.output_shapes(T, L)
    _check_fields(fbuf, tracker_kernel.FLOAT_FIELDS, f_shapes, out, torch.float32)
    _check_fields(ibuf, tracker_kernel.INT_FIELDS, i_shapes, out, torch.int32)
    assert out["trajectory"].data_ptr() == fbuf.data_ptr()
    assert out["trajectory"].shape == (T, 2 * L) and out["next_id"].shape == ()


@pytest.mark.parametrize("T,W,H,HI", [(64, 5, 30, 30), (128, 5, 30, 30), (3, 1, 1, 1), (5, 7, 11, 3)])
def test_tagging_output_fields(T, W, H, HI):
    """K3's new state and packed rows: shapes, dtypes, contiguity, 16-byte
    alignment, no overlap; the center ring first."""
    fbuf, ibuf, out = tagging_kernel.output_fields(T, W, H, HI, "cpu")
    f_shapes, i_shapes = tagging_kernel.output_shapes(T, W, H, HI)
    _check_fields(fbuf, tagging_kernel.FLOAT_FIELDS, f_shapes, out, torch.float32)
    _check_fields(ibuf, tagging_kernel.INT_FIELDS, i_shapes, out, torch.int32)
    assert out["int_centers"].data_ptr() == fbuf.data_ptr()
    assert out["tag_f"].numel() == tagging_kernel.row_width(tagging_kernel.FLOAT_TAGS, T)
    assert out["tag_i"].numel() == tagging_kernel.row_width(tagging_kernel.INT_TAGS, T)


def test_kalman_output_fields():
    """K2's one float32 buffer: x (6,), P (6, 6), the vehicle row (11,) and
    the next step's time, heading and speed at the offsets the kernel
    writes (0, 8, 44, 56, 60 and 64 floats), each 16-byte aligned and
    contiguous, none overlapping."""
    buf, fields = kalman_kernel.output_fields("cpu")
    names = ("x", "P", "vs", "time", "heading", "speed")
    _check_fields(buf, names, kalman_kernel.OUTPUT_SHAPES, dict(zip(names, fields)), torch.float32)
    assert [(t.data_ptr() - buf.data_ptr()) // 4 for t in fields] == [0, 8, 44, 56, 60, 64]
    assert buf.numel() == 68


def test_carved_fields_are_independent():
    """Writing one carved field leaves every other field as it was."""
    fbuf, ibuf, out = tracker_kernel.output_fields(16, 5, "cpu")
    fbuf.zero_()
    ibuf.zero_()
    out["bbox"].fill_(1.0)
    out["match"].fill_(-1)
    for name, t in out.items():
        if name not in ("bbox", "match"):
            assert not t.any(), name


def test_check_inputs_refuses_each_mismatch():
    """One pass of checks, and each mismatch raises with the field's name."""
    good = torch.zeros((4, 2), dtype=torch.float32)
    cpu = torch.device("cpu")
    launch.check_inputs("k", cpu, [("x", good, torch.float32, (4, 2))])
    with pytest.raises(TypeError, match="x has dtype torch.float64"):
        launch.check_inputs("k", cpu, [("x", good.double(), torch.float32, (4, 2))])
    with pytest.raises(ValueError, match=r"x has shape \(2, 4\)"):
        launch.check_inputs("k", cpu, [("x", good.reshape(2, 4), torch.float32, (4, 2))])
    with pytest.raises(ValueError, match="x is not contiguous"):
        launch.check_inputs("k", cpu, [("x", good.t().contiguous().t(), torch.float32, (4, 2))])
    with pytest.raises(ValueError, match="x is on cpu, expected meta"):
        launch.check_inputs("k", torch.device("meta"), [("x", good, torch.float32, (4, 2))])
    scalar = torch.tensor(np.int32(3))
    launch.check_inputs("k", cpu, [("n", scalar, torch.int32, ())])
