"""Device milliseconds a frame of the stretch's records launched inside
the program's ``plan`` spans; nothing where the spans and the trace
disagree on the clock (`perfbench.spans`)."""

from perfbench import spans


def read(ctx):
    return spans.read_device(ctx, lambda j: j.device_ms_per_frame("plan"))
