"""Unified telemetry of the port (``veles_tpu/telemetry``): the
process-wide metrics registry and span tracer shared by training and
the serving engine, with the JAX package's metric, label, span and
route names.

>>> from veles_tpu_torch import telemetry
>>> reqs = telemetry.get_registry().counter(
...     "myapp_requests_total", "requests", labels=("route",))
>>> reqs.labels(route="/api").inc()
>>> with telemetry.span("work", phase="demo"):
...     pass  # no-op unless telemetry.tracing.enable() ran

:mod:`.timeseries`, :mod:`.profiler`, :mod:`.flight` and :mod:`.alerts`
are imported by their consumers.
"""

from veles_tpu_torch.telemetry import registry, tracing  # noqa: F401
from veles_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, Reservoir, get_registry,
    percentile)
from veles_tpu_torch.telemetry.tracing import (  # noqa: F401
    TraceBuffer, add_complete, get_buffer, request_span, span,
    trace_context)
