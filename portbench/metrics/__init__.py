"""One reader per per-layer metric, `<metric name>.py`, each with
`read(ctx) -> float | None` (`tracing.Context`); `_layer.py` holds what they
share. A reader that finds nothing to read returns None."""
