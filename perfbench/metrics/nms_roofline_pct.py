"""K5, the greedy-NMS keep mask (both instances): its bound on the run's
pools over its device time in the stretch."""

from perfbench.metrics import _roofline


def read(ctx):
    return _roofline.share(ctx, "nms", "nms_")
