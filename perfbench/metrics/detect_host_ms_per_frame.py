"""Host milliseconds a frame inside the program's ``detect`` spans (a
segment's chunks: the upload, the tower, the decode and NMS), over the
traced stretch's segments."""

from perfbench import spans


def read(ctx):
    return spans.read_host(ctx, lambda j: j.host_ms_per_frame("detect"))
