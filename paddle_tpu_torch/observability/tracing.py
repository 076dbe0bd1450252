"""Span tracing: ``with span("name"):`` through the seams that matter (the
port's own copy of ``paddle_tpu/observability/tracing.py``).

A span is a host-side timed region with parent/child nesting (a stack per
thread). Completed spans fan out to:

- a process-wide ring buffer (``last_spans``);
- any registered JSONL sinks (one json object per line, each record
  flushed as written);
- a per-span-name duration histogram in the metrics registry
  (``span.<name>_s``).

While a ``torch.profiler`` is recording, a span also opens a
``torch.profiler.record_function`` of its name, so host spans land in the
same trace as the kernels they enqueue. Request-scoped trace records
(``observability/request_trace.py``) ride the same ring and sinks through
:func:`emit_record`, so one ``spans.<rank>.jsonl`` carries both streams.

Cost: disabled, an attr-less span is one module-global load and a
None/False check returning a shared no-op context manager. Spans called
with ``**attrs`` pay the kwargs dict before the check, so per-dispatch hot
paths use attr-less spans. Enable with ``enable()`` or
``PADDLE_TELEMETRY=1``.
"""
import atexit
import collections
import json
import os
import threading
import time

import torch

from ..utils.envs import env_bool, env_str

__all__ = ["span", "enable", "disable", "enabled", "last_spans",
           "add_jsonl_sink", "clear_sinks", "JsonlSpanSink", "emit_record"]

_ENABLED = None           # tri-state: None = resolve from env on first use
_RING_DEFAULT = 512
_ring = collections.deque(maxlen=_RING_DEFAULT)
_sinks = []
_local = threading.local()
_tids = {}
_tids_lock = threading.Lock()


def _small_tid():
    """Small, stable per-thread id (chrome-trace tid / span record tid).
    Unlike ``get_ident() % 100000``, cannot collide: ids are assigned
    sequentially per distinct live thread identity."""
    ident = threading.get_ident()
    tid = _tids.get(ident)
    if tid is None:
        with _tids_lock:
            tid = _tids.setdefault(ident, len(_tids) + 1)
    return tid


def _resolve_enabled():
    global _ENABLED
    _ENABLED = env_bool("PADDLE_TELEMETRY")
    if _ENABLED:
        _autoconfigure_sinks()
    return _ENABLED


def enabled():
    """True when span tracing is on (env PADDLE_TELEMETRY or enable())."""
    e = _ENABLED
    return e if e is not None else _resolve_enabled()


def enable(jsonl_path=None, ring=None):
    """Turn span tracing on programmatically; optionally attach a JSONL sink
    and resize the ring buffer. Env-configured sinks (PADDLE_TELEMETRY_DIR)
    attach here too — a launcher-spawned worker that calls obs.enable()
    itself still streams spans where the hang watchdog looks."""
    global _ENABLED, _ring
    _ENABLED = True
    if ring is not None and ring != _ring.maxlen:
        _ring = collections.deque(_ring, maxlen=int(ring))
    if jsonl_path is not None and not any(
            getattr(s, "path", None) == jsonl_path for s in _sinks):
        add_jsonl_sink(jsonl_path)  # idempotent: re-enable ≠ duplicate sink
    _autoconfigure_sinks()


def disable():
    """Turn tracing off. The ring buffer and sinks are kept (post-mortem
    inspection of what was captured while enabled)."""
    global _ENABLED
    _ENABLED = False


_autosink_path = None


def _autoconfigure_sinks():
    """Env-armed processes (launcher-spawned trainers) stream spans to
    <PADDLE_TELEMETRY_DIR>/spans.<rank>.jsonl — the file the hang watchdog
    tails for its per-rank last-N-spans report. Idempotent: repeated
    enable() calls attach the sink once."""
    global _autosink_path
    d = env_str("PADDLE_TELEMETRY_DIR")
    if not d:
        return
    rank = env_str("PADDLE_TRAINER_ID", env_str("RANK", "0"))
    path = os.path.join(d, f"spans.{rank}.jsonl")
    if path == _autosink_path and any(
            getattr(s, "path", None) == path for s in _sinks):
        return
    try:
        add_jsonl_sink(path)
        _autosink_path = path
    except OSError:
        pass


class JsonlSpanSink:
    """Crash-safe JSONL span sink: every record is written + flushed
    immediately, the file handle closes idempotently at exit (atexit) or via
    the context-manager protocol — a crash loses at most the record being
    formatted, never the flushed tail."""

    def __init__(self, path):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self._f = open(path, "a")
        atexit.register(self.close)

    def __call__(self, record):
        f = self._f
        if f is None:
            return
        try:
            f.write(json.dumps(record) + "\n")
            f.flush()
        except ValueError:  # closed underneath us at interpreter teardown
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        f, self._f = self._f, None
        if f is not None:
            try:
                f.close()
            except ValueError:
                pass
        try:
            atexit.unregister(self.close)
        except Exception:
            pass


def add_jsonl_sink(path):
    sink = JsonlSpanSink(path)
    _sinks.append(sink)
    return sink


def clear_sinks():
    while _sinks:
        s = _sinks.pop()
        close = getattr(s, "close", None)
        if close is not None:
            close()


def last_spans(n=64):
    """Most recent completed span records (oldest first) — the watchdog's
    'what was this rank doing' payload."""
    buf = list(_ring)
    return buf[-n:]


def clear():
    """Test hook: drop captured spans (sinks untouched)."""
    _ring.clear()


class _NullSpan:
    """Shared no-op context manager — the entire disabled cost of span()."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def _profiler_recording():
    """True while a torch profiler records on this process."""
    return torch.autograd.profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "attrs", "_t0", "_parent", "_rf")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._parent = stack[-1].name if stack else None
        stack.append(self)
        self._rf = None
        if _profiler_recording():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        dur_us = (t1 - self._t0) / 1000.0
        rec = {
            "name": self.name,
            "ts_us": self._t0 / 1000.0,   # perf_counter epoch (chrome-trace)
            "dur_us": dur_us,
            "time": time.time(),          # wall clock (cross-rank alignment)
            "pid": os.getpid(),
            "tid": _small_tid(),
            "parent": self._parent,
            "depth": len(stack),
        }
        if self.attrs:
            rec["attrs"] = self.attrs
        _emit(rec, dur_us)
        return False


def _emit(rec, dur_us):
    _ring.append(rec)
    from .metrics import registry

    try:
        registry.histogram(f"span.{rec['name']}_s").observe(dur_us / 1e6)
    except ValueError:
        pass  # name collision with a non-histogram metric: skip, don't kill
    for sink in _sinks:
        try:
            sink(rec)
        except Exception:
            pass


def emit_record(rec):
    """Route an externally built record through the fan-out completed spans
    get (the ring buffer and every JSONL sink): request-scoped trace records
    land in the same ``spans.<rank>.jsonl`` files as thread spans. The
    span-duration histograms are not fed; they are keyed by the thread-span
    names."""
    _ring.append(rec)
    for sink in _sinks:
        try:
            sink(rec)
        except Exception:
            pass


def span(name, **attrs):
    """``with span("train.step.dispatch", step=i):`` — free when disabled."""
    e = _ENABLED
    if not (e if e is not None else _resolve_enabled()):
        return _NULL
    return _Span(name, attrs)
