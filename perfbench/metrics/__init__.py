"""One reader a per-layer metric, each named as the metric: ``read(ctx)`` returns
the value from the traced stretch (`perfbench.trace.Context`), or None
where the stretch has nothing to read."""
