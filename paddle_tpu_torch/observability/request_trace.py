"""Request-scoped tracing for the serving stack (the port's own copy of
``paddle_tpu/observability/request_trace.py``).

Thread spans (``tracing.span``) answer "what is this thread doing"; they
cannot answer "where did request X spend its 900 ms", because one request
crosses threads (the submit thread, a dispatcher, another dispatcher after
a reroute). :func:`start` mints a **trace context** (a process-unique
``trace_id`` and a root span) at ``ServingFrontend.submit()``, and every
layer the request flows through (queueing, placement, the engine's admit,
prefill chunks, decode blocks and emits, reroutes) attaches child spans to
it by handle, so the whole lifecycle reconstructs as one rooted tree.

Records are JSON per line, emitted through the same sinks thread spans use
(``tracing.add_jsonl_sink`` or the ``PADDLE_TELEMETRY_DIR`` sink) and the
same ring::

    {"trace": "<trace_id>", "span": "<trace_id>/3", "parent": "<id>|null",
     "name": "prefill_chunk", "rid": 7, "t0": <wall start>, "dur_s": 0.012,
     "time": <wall end>, "pid": ..., "status": "ok", "attrs": {...}}

In the engine each dispatch a traced request takes part in runs under
``torch.profiler.record_function("rtrace:<id>")`` while a torch profiler
records: the join between these host records and the device trace.

Cost: disabled, ``start()`` is one enabled-flag check returning None, and
every call site guards on that None. Per-trace records are bounded
(``MAX_SPANS_PER_TRACE``), the overflow counted in ``rtrace.dropped_spans``.
"""
import os
import threading
import time
from collections import deque

from . import tracing
from .metrics import registry as _registry

__all__ = ["TraceContext", "Span", "start", "recent", "slowest", "errored",
           "clear", "MAX_SPANS_PER_TRACE"]

#: per-trace record bound: a runaway request (huge max_new_tokens) must not
#: hold an unbounded record list; overflow increments rtrace.dropped_spans
MAX_SPANS_PER_TRACE = 512

#: completed traces kept for /tracez (slow + errored views)
RECENT_TRACES = 128

_M_TRACES = _registry.counter(
    "rtrace.traces", help="request traces started")
_M_DROPPED = _registry.counter(
    "rtrace.dropped_spans",
    help="request-trace spans dropped by the per-trace bound")
_M_OPEN = _registry.gauge(
    "rtrace.open", help="request traces currently open")

_recent = deque(maxlen=RECENT_TRACES)
_recent_lock = threading.Lock()


def _emit(rec):
    """Fan one completed record out where thread spans land: the ring and
    every JSONL sink."""
    tracing.emit_record(rec)


class Span:
    """One open request-scoped span. Unlike ``tracing.span`` this is an
    explicit handle: it can be opened on one thread and closed on another
    (submit opens ``queue``, a dispatcher closes it), and children hang off
    it by id, not off a thread-local stack. ``end()`` is idempotent — the
    context's finish() sweep may race a late closer benignly."""

    __slots__ = ("ctx", "span_id", "parent_id", "name", "attrs",
                 "_t0_wall", "_t0_perf", "_closed")

    def __init__(self, ctx, span_id, parent_id, name, attrs,
                 t0_wall=None, dur_s=None):
        self.ctx = ctx
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self._t0_wall = time.time() if t0_wall is None else t0_wall
        self._t0_perf = time.perf_counter() if dur_s is None else None
        self._closed = False
        if dur_s is not None:  # pre-timed span (emitted at readback points)
            self._finish(dur_s, "ok")

    def child(self, name, **attrs):
        """Open a child span (cross-thread safe)."""
        return self.ctx.begin(name, parent=self, **attrs)

    def event(self, name, **attrs):
        """Zero-duration child record — placement decisions, reroute edges."""
        return self.ctx.begin(name, parent=self, _dur_s=0.0, **attrs)

    def span_at(self, name, started_before_s, dur_s, **attrs):
        """Child span with explicit timing — for work whose start/end were
        stamped elsewhere with monotonic deltas (a decode block's
        dispatch→readback window). ``started_before_s`` is how long before
        NOW the work began; the wall-clock conversion happens here so hot
        paths never touch time.time() themselves."""
        return self.ctx.begin(name, parent=self,
                              _t0_wall=time.time() - started_before_s,
                              _dur_s=dur_s, **attrs)

    def end(self, status="ok", **attrs):
        if self._closed:
            return self
        dur = (time.perf_counter() - self._t0_perf
               if self._t0_perf is not None else 0.0)
        if attrs:
            self.attrs = {**(self.attrs or {}), **attrs}
        self._finish(dur, status)
        return self

    def _finish(self, dur_s, status):
        self._closed = True
        rec = {
            "trace": self.ctx.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "rid": self.ctx.rid,
            "t0": self._t0_wall,
            "dur_s": dur_s,
            "time": self._t0_wall + dur_s,
            "pid": os.getpid(),
            "status": status,
        }
        if self.attrs:
            rec["attrs"] = self.attrs
        self.ctx._record(self, rec)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end("error" if exc_type is not None else "ok",
                 **({"error": f"{exc_type.__name__}: {exc}"}
                    if exc_type is not None else {}))
        return False


class _SuppressedSpan:
    """Inert span handle returned once a trace hits its span bound: every
    operation is a no-op that returns self, so over-budget call sites keep
    working while only the NEW span is dropped. Suppression happens at
    CREATION, not at record time — spans opened under budget (the root,
    the current attempt) still emit their close records, so a truncated
    trace stays a well-formed tree instead of orphaning already-emitted
    children under never-written parents."""

    __slots__ = ("ctx",)

    span_id = None
    parent_id = None

    def __init__(self, ctx):
        self.ctx = ctx

    def child(self, name, **attrs):
        return self.ctx.begin(name, parent=self)

    def event(self, name, **attrs):
        return self.ctx.begin(name, parent=self)

    def span_at(self, name, started_before_s, dur_s, **attrs):
        return self.ctx.begin(name, parent=self)

    def end(self, status="ok", **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class TraceContext:
    """One request's trace: the id, the root span, the (bounded) record
    buffer, and the set of still-open spans. Thread-safe — spans open and
    close from the submit thread, N dispatcher threads, and the monitor."""

    __slots__ = ("trace_id", "rid", "root", "records", "dropped",
                 "_seq", "_lock", "_open", "_finished")

    def __init__(self, trace_id, rid, **attrs):
        self.trace_id = trace_id
        self.rid = rid
        self.records = []
        self.dropped = 0
        self._seq = 0
        self._lock = threading.Lock()
        self._open = {}
        self._finished = False
        self.root = self.begin("request", parent=None, **attrs)

    def begin(self, name, parent=None, _t0_wall=None, _dur_s=None, **attrs):
        with self._lock:
            # the bound applies at CREATION: every span created here WILL
            # emit its close record, so a truncated trace never orphans
            # (parents always outlive — hence out-record — their children)
            if self._seq >= MAX_SPANS_PER_TRACE \
                    or isinstance(parent, _SuppressedSpan):
                self.dropped += 1
                _M_DROPPED.inc()
                return _SuppressedSpan(self)
            self._seq += 1
            span_id = f"{self.trace_id}/{self._seq}"
        parent_id = (parent.span_id if isinstance(parent, Span)
                     else parent)
        sp = Span(self, span_id, parent_id, name, attrs or None,
                  t0_wall=_t0_wall, dur_s=_dur_s)
        if not sp._closed:
            with self._lock:
                self._open[span_id] = sp
        return sp

    def _record(self, span, rec):
        with self._lock:
            self._open.pop(span.span_id, None)
            self.records.append(rec)
        _emit(rec)

    def finish(self, status="ok", **attrs):
        """Close the trace: every still-open non-root span is swept closed
        with the terminal status (structurally, a finished trace can have
        no orphan open spans), then the root closes and the trace joins the
        recent ring for /tracez. Idempotent — exactly one terminal
        transition wins, however many failure paths race."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
            stragglers = [s for s in self._open.values()
                          if s is not self.root]
        for s in stragglers:
            s.end(status)
        self.root.end(status, **attrs)
        _M_OPEN.dec()
        dur = self.records[-1]["dur_s"] if self.records else 0.0
        root_rec = next((r for r in self.records
                         if r["span"] == self.root.span_id), None)
        summary = {
            "trace": self.trace_id,
            "rid": self.rid,
            "status": status,
            "dur_s": root_rec["dur_s"] if root_rec else dur,
            "t0": root_rec["t0"] if root_rec else None,
            "n_spans": len(self.records),
            "dropped": self.dropped,
            "records": list(self.records),
        }
        with _recent_lock:
            _recent.append(summary)


def start(rid, **attrs):
    """Mint a trace for one request, or None when telemetry is disabled
    (the zero-overhead contract: one flag check, no allocation)."""
    if not tracing.enabled():
        return None
    trace_id = os.urandom(8).hex()
    _M_TRACES.inc()
    _M_OPEN.inc()
    return TraceContext(trace_id, rid, **attrs)


def recent(n=RECENT_TRACES):
    """Most recently finished traces (oldest first), with full records."""
    with _recent_lock:
        return list(_recent)[-n:]


def slowest(n=10):
    """The n slowest recent traces, slowest first — /tracez's main view."""
    return sorted(recent(), key=lambda t: -(t["dur_s"] or 0.0))[:n]


def errored(n=10):
    """Recent traces that finished non-ok, newest first."""
    out = [t for t in recent() if t["status"] != "ok"]
    return out[::-1][:n]


def clear():
    """Test hook: drop the recent-trace ring."""
    with _recent_lock:
        _recent.clear()
