"""A hand-written kernel's share of its roofline over the traced stretch:
the sum of its launches' bounds (`perfbench.counts`) over the device time
of the kernels whose names carry its name.  Nothing is read where the
stretch launched none of it."""


def share(ctx, work: str, kernel: str):
    seconds = ctx.device_seconds(kernel)
    if not seconds or not ctx.launches.get(work):
        return None
    return 100.0 * ctx.work[work]["bound_s"] / seconds
