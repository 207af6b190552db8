"""One reader a metric: ``read(ctx)`` returns the metric in its unit, or
None where the run has nothing to read it from."""
