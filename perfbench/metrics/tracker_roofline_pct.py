"""K1, the tracker step (every instance): its bound with the rounds these
inputs need over its device time in the stretch."""

from perfbench.metrics import _roofline


def read(ctx):
    return _roofline.share(ctx, "tracker", "tracker_")
