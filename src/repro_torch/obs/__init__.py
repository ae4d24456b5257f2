"""Observability: request-lifecycle tracing, the metrics registry and the
time-series sampler's headroom helper."""
