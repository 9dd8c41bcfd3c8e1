"""Device records (kernels, copies and fills) a frame over the traced
stretch: how many separate pieces of device work the runner issues."""


def read(ctx):
    if not ctx.frames or not ctx.device_records():
        return None
    return ctx.device_records() / ctx.frames
