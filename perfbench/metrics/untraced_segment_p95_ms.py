"""The 95th percentile (numpy's linear interpolation) of the segments'
times from hand-over to outputs on the host, over the ``--trace 1`` run's
segments served before the traced stretch opened (the window's first
third; the profiler slows the host for the rest of the run): the
end-to-end ``segment_p95_ms``'s statistic, for the cells whose runs
spread too widely for it to carry a bound."""

import numpy as np


def read(ctx):
    if not ctx.segment_s:
        return None
    return 1e3 * float(np.percentile(np.asarray(ctx.segment_s), 95))
