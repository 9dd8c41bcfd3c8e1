"""The whole step's share of the card's dense bf16 peak over the traced
stretch: the detector's FLOPs a frame (counted from the published layer
shapes) times the frames, plus the hand-written kernels' counted
operations, over the stretch's seconds and 989 TFLOP/s."""

from perfbench import counts


def read(ctx):
    if not ctx.frames or not ctx.window_s or not ctx.tower_ranges:
        return None
    flops = counts.tower_flops(ctx.config) * ctx.frames
    flops += sum(w["ops"] for w in ctx.work.values())
    return 100.0 * flops / ctx.window_s / counts.PEAK_BF16_PER_S
