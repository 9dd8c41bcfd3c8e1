"""Host milliseconds a frame inside the program's ``plan`` spans (the
planner and the choice of its best plan), over the traced stretch's
segments."""

from perfbench import spans


def read(ctx):
    return spans.read_host(ctx, lambda j: j.host_ms_per_frame("plan"))
