"""Device milliseconds a frame of the records launched inside the
detector's forward pass (the ``perfbench.tower`` ranges the harness opens
around the program's YOLOv8 module)."""


def read(ctx):
    if not ctx.frames or not ctx.tower_ranges or not ctx.tower_s:
        return None
    return 1e3 * ctx.tower_s / ctx.frames
