"""K2, the ego Kalman step: its bound over its device time in the stretch."""

from perfbench.metrics import _roofline


def read(ctx):
    return _roofline.share(ctx, "kalman", "kalman_step")
