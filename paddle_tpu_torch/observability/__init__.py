"""Telemetry of the port (counterpart of ``paddle_tpu/observability``): the
metrics registry (``metrics``), span tracing (``tracing``), request-scoped
traces (``request_trace``), goodput accounting (``goodput``), SLO burn
rates (``slo``), the compile and device-memory ledgers with OOM forensics
(``compilemem``), the device-time plane (``devprof``), the serving fleet
rollup (``fleet``) and the training-dynamics monitor (``dynamics``).

Metric publication is always on; span tracing and goodput timers cost a
shared no-op context manager while disabled (``PADDLE_TELEMETRY`` or
``enable()`` turns them on). The status server, the hang watchdog, the
flight recorder and the fleet's training side come with the operator
plane (ROADMAP.md, slice 16).
"""
from . import (  # noqa: F401
    compilemem, devprof, dynamics, fleet, goodput, request_trace, slo,
    tracing,
)
from .compilemem import CompileLedger, MemoryLedger, record_compile
from .devprof import DevProfPlane
from .dynamics import DynamicsMonitor
from .goodput import GoodputAccountant
from .metrics import (
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry, registry,
)
from .slo import SLOMonitor, SLOObjective
from .tracing import (
    JsonlSpanSink, add_jsonl_sink, disable, enable, enabled, last_spans,
    span,
)

__all__ = [
    "compilemem", "devprof", "dynamics", "fleet", "goodput",
    "request_trace", "slo", "tracing",
    "CompileLedger", "MemoryLedger", "record_compile", "DevProfPlane",
    "DynamicsMonitor", "GoodputAccountant", "DEFAULT_BUCKETS", "Counter",
    "Gauge", "Histogram", "MetricsRegistry", "registry", "SLOMonitor",
    "SLOObjective", "JsonlSpanSink", "add_jsonl_sink", "disable", "enable",
    "enabled", "last_spans", "span",
]
