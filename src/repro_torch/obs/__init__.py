"""Observability of the port (counterpart of ``repro.obs``): the
counters/gauges/histograms metrics bus (``obs.metrics``).  Span tracing
(``obs.trace`` in the JAX package) is not yet ported."""
from repro_torch.obs.metrics import JsonlSink, MetricsBus

__all__ = ["JsonlSink", "MetricsBus"]
