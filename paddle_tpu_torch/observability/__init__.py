"""Telemetry of the port (counterpart of ``paddle_tpu/observability``): the
metrics registry (``metrics``), span tracing (``tracing``), request-scoped
traces (``request_trace``), goodput accounting (``goodput``), SLO burn
rates (``slo``), the compile and device-memory ledgers with OOM forensics
and the in-flight build breadcrumb (``compilemem``), the device-time plane
(``devprof``), the fleet snapshots, aggregator and serving rollup
(``fleet``), the training-dynamics monitor (``dynamics``), the hang
watchdog and heartbeats (``watchdog``), the anomaly flight recorder and
its ``torch.profiler`` capture registry (``flightrec``) and the
``/statusz`` introspection server (``statusz``).

Metric publication is always on; span tracing and goodput timers cost a
shared no-op context manager while disabled (``PADDLE_TELEMETRY`` or
``enable()`` turns them on). Heartbeats, fleet snapshots and flight
records go to ``PADDLE_TELEMETRY_DIR`` when it is set.
"""
from . import (  # noqa: F401
    compilemem, devprof, dynamics, fleet, flightrec, goodput,
    request_trace, slo, statusz, tracing, watchdog,
)
from .compilemem import CompileLedger, MemoryLedger, record_compile
from .devprof import DevProfPlane
from .dynamics import DynamicsMonitor
from .fleet import FleetAggregator, SnapshotPublisher
from .flightrec import FlightRecorder
from .goodput import GoodputAccountant
from .metrics import (
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry, registry,
)
from .slo import SLOMonitor, SLOObjective
from .statusz import StatusServer
from .tracing import (
    JsonlSpanSink, add_jsonl_sink, disable, enable, enabled, last_spans,
    span,
)
from .watchdog import HangWatchdog, Heartbeat, maybe_beat

__all__ = [
    "compilemem", "devprof", "dynamics", "fleet", "flightrec", "goodput",
    "request_trace", "slo", "statusz", "tracing", "watchdog",
    "CompileLedger", "MemoryLedger", "record_compile", "DevProfPlane",
    "DynamicsMonitor", "FleetAggregator", "SnapshotPublisher",
    "FlightRecorder", "GoodputAccountant", "DEFAULT_BUCKETS", "Counter",
    "Gauge", "Histogram", "MetricsRegistry", "registry", "SLOMonitor",
    "SLOObjective", "StatusServer", "JsonlSpanSink", "add_jsonl_sink",
    "disable", "enable", "enabled", "last_spans", "span", "HangWatchdog",
    "Heartbeat", "maybe_beat",
]
