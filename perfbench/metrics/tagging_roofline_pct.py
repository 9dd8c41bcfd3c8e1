"""K3, the tagging step (every instance): its bound on the frame's data
over its device time in the stretch."""

from perfbench.metrics import _roofline


def read(ctx):
    return _roofline.share(ctx, "tagging", "tagging_step")
