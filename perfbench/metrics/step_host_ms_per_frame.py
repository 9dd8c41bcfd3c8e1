"""Host milliseconds a frame inside the program's ``step`` spans (the
frame loop's step: tracking, estimation, planning, tagging and the
outputs' writes), over the traced stretch's segments."""

from perfbench import spans


def read(ctx):
    return spans.read_host(ctx, lambda j: j.host_ms_per_frame("step"))
