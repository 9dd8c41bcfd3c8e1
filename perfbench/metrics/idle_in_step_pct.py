"""Share of the stretch's device-idle time (between the merged busy
intervals `device_idle_pct` reads) during which the host was inside the
program's ``step`` spans; nothing where the spans and the trace disagree
on the clock."""

from perfbench import spans


def read(ctx):
    return spans.read_device(ctx, lambda j: j.idle_within_pct("step"))
