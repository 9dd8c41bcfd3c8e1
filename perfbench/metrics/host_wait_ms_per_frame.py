"""Host milliseconds a frame inside blocking runtime calls (the names of
`perfbench.spans.BLOCKING`: stream, device and event synchronizes and
synchronous copies) that start inside a program span; the harness's own
synchronize after each segment lies outside every span and is not
counted.  Nothing where the spans and the trace disagree on the clock."""

from perfbench import spans


def read(ctx):
    return spans.read_device(ctx, lambda j: sum(j.waits().values()))
