"""Observability of the port (counterpart of ``repro.obs``, DESIGN.md
§11): span tracing with Perfetto export (``obs.trace``) and the
counters/gauges/histograms metrics bus (``obs.metrics``).  Nothing runs
when unused: with no tracer installed no stamp is enqueued anywhere."""
from repro_torch.obs.metrics import JsonlSink, MetricsBus
from repro_torch.obs.trace import Tracer, get_tracer, set_tracer, span

__all__ = ["JsonlSink", "MetricsBus", "Tracer", "get_tracer", "set_tracer",
           "span"]
