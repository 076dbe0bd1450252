"""Compile and device-memory observability of the port (its own copy of
the part of ``paddle_tpu/observability/compilemem.py`` that serving
reaches): the compile ledger, the device-memory ledger and OOM forensics.

- :class:`CompileLedger`: the event log and churn detector. In the port a
  "compile" is one of two things: ``ops/_build.py``'s first ``nvcc`` build
  of a kernel library (key ``build.<name>``), and an engine program
  family's first dispatch (the reference's keys: ``serve.prefill[b..,s..]``,
  ``serve.decode_block[k..,s..]``, ``serve.ragged[k..,s..]``, ...), both
  bracketed by :func:`record_compile`. Eager PyTorch traces nothing, so a
  first dispatch is the wall of a warm-up run, not of a trace.
- :class:`MemoryLedger`: the device-memory budget. Components (the KV page
  pools, ...) register as weakly bound byte providers and sum against the
  card's capacity (``torch.cuda.mem_get_info``), beside the allocator's
  live and peak bytes (``torch.cuda.memory_stats``). It also holds each
  program's cost row (FLOPs and bytes), which ``observability.devprof``
  joins with its sampled device time; the engine registers an analytic
  cost for its serve programs (:meth:`MemoryLedger.note_cost`).
- OOM forensics: :func:`maybe_oom_report` recognizes
  ``torch.cuda.OutOfMemoryError`` (and the ``obs.oom`` chaos site's
  synthetic fault) at the dispatch seams and writes
  ``<PADDLE_TELEMETRY_DIR or telemetry>/oom_report.json`` (the ledger, the
  budget, the registered contexts: the engine's active slots and pages)
  before the exception re-raises.

The jit-only parts of the reference (``ledgered_jit``,
``analyze_function``, the ``compiling.<rank>.json`` breadcrumb the hang
watchdog reads) wait for the operator plane (ROADMAP.md, slice 16).
"""
import itertools
import json
import os
import threading
import time
import warnings
import weakref
from collections import OrderedDict, deque
from contextlib import contextmanager

import torch

from ..utils.envs import env_int, env_str
from .metrics import registry as _registry

__all__ = [
    "CompileLedger", "MemoryLedger", "ledger", "memory", "record_compile",
    "is_oom", "maybe_oom_report", "write_oom_report",
    "register_oom_context", "oom_report_path", "OOM_REPORT_NAME",
]

OOM_REPORT_NAME = "oom_report.json"

# ---- compile.* metrics (always-on, the EventCounters cost model) ----------
_M_EVENTS = _registry.counter(
    "compile.events", help="compiles recorded by the compile ledger")
_M_RECOMPILES = _registry.counter(
    "compile.recompiles",
    help="compiles of a program key that had already compiled before")
_M_CHURN = _registry.counter(
    "compile.churn_alerts",
    help="same logical program recompiled under shape/dtype drift past "
         "the churn threshold")
_M_WALL = _registry.histogram(
    "compile.wall_s",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0, 60.0, 120.0, 300.0),
    help="per-compile wall time (an nvcc build, or a program family's "
         "first dispatch)")
_M_ACTIVE = _registry.gauge(
    "compile.active", help="compiles currently in flight")
_M_CACHE_WARN = _registry.counter(
    "compile.cache_warnings",
    help="program-cache size warnings past the configured bound")
_M_OOM = _registry.counter(
    "device.oom_reports", help="OOM forensics reports written")


def _rank():
    return env_str("PADDLE_TRAINER_ID", env_str("RANK", "0")) or "0"


class CompileLedger:
    """Process-wide compile event log + recompile-churn detector.

    ``begin(key)`` / ``end(token, ...)`` bracket one compile (a kernel
    build, a program family's first dispatch): a compile in flight is
    visible in ``active()``. Nested begins on one thread (a kernel build
    inside a first dispatch) are suppressed: the inner work is part of the
    outer compile.
    """

    def __init__(self, max_events=512, churn_threshold=None,
                 cache_warn_bound=None):
        self._lock = threading.Lock()
        self._events = deque(maxlen=int(max_events))
        self._by_key = {}
        self._caches = {}
        self._cache_warned = set()
        self._active = {}
        self._counter = itertools.count(1)
        self._local = threading.local()
        self.churn_threshold = (int(churn_threshold)
                                if churn_threshold is not None
                                else env_int("PADDLE_COMPILE_CHURN_THRESHOLD", 3))
        self.cache_warn_bound = (int(cache_warn_bound)
                                 if cache_warn_bound is not None
                                 else env_int("PADDLE_COMPILE_CACHE_WARN", 64))

    # ---- trigger / suppression scopes ------------------------------------
    @contextmanager
    def trigger(self, label):
        """Label every compile recorded inside the scope (``warmup``)."""
        prev = getattr(self._local, "trigger", None)
        self._local.trigger = label
        try:
            yield
        finally:
            self._local.trigger = prev

    # ---- the begin/end protocol ------------------------------------------
    def begin(self, key):
        """Mark a compile of ``key`` started. Returns a token for end(),
        or None when this trace is nested (or suppressed) — end(None) is
        a no-op, so callers never need to branch."""
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        if depth:
            return None
        tok = next(self._counter)
        with self._lock:
            self._active[tok] = {"key": str(key), "started_at": time.time(),
                                 "tid": threading.get_ident()}
            _M_ACTIVE.set(len(self._active))
        return tok

    def exit_trace(self):
        """The bracketed work ended (the active entry stays until
        end())."""
        self._local.depth = max(0, getattr(self._local, "depth", 1) - 1)

    def end(self, token, key, wall_s=0.0, signature=None, trigger=None,
            error=None):
        """Close the compile ``begin()`` opened; records one event. A
        ``None`` token (nested/suppressed begin) is a no-op."""
        if token is None:
            return None
        with self._lock:
            self._active.pop(token, None)
            _M_ACTIVE.set(len(self._active))
        return _ledger_record(self, key, wall_s, signature, trigger, error)

    def record(self, key, wall_s=0.0, trigger=None, error=None):
        """Record one compile of ``key`` that was timed elsewhere (the
        engine's program families that one device section ran for the
        first time). Not bracketed, so a compile recorded inside it (a
        kernel build in that section) is recorded too."""
        return _ledger_record(self, key, wall_s, None, trigger, error)

    # ---- cache-size accounting -------------------------------------------
    def note_cache_size(self, name, size):
        """Export a program cache's size (gauge ``compile.cache_size``,
        labeled per cache) and warn once past the configured bound."""
        size = int(size)
        with self._lock:
            self._caches[str(name)] = size
        _registry.gauge("compile.cache_size",
                        help="compiled-program cache sizes, per cache",
                        labels={"cache": str(name)}).set(size)
        if size > self.cache_warn_bound and name not in self._cache_warned:
            with self._lock:
                if name in self._cache_warned:
                    return
                self._cache_warned.add(name)
            _M_CACHE_WARN.inc()
            warnings.warn(
                f"program cache {name!r} holds {size} compiled programs "
                f"(bound {self.cache_warn_bound}; PADDLE_COMPILE_CACHE_WARN"
                f") — unbounded growth usually means an unstable program "
                f"key (shape/dtype drift)", RuntimeWarning, stacklevel=3)

    # ---- introspection ----------------------------------------------------
    def active(self):
        """[{key, started_at, elapsed_s, tid}] — compiles in flight."""
        now = time.time()
        with self._lock:
            return [dict(v, elapsed_s=round(now - v["started_at"], 3))
                    for v in self._active.values()]

    def counts(self):
        """Cheap scalar snapshot (bench deltas): events / wall / churn."""
        with self._lock:
            return {
                "events": sum(e["count"] for e in self._by_key.values()),
                "total_wall_s": round(sum(e["wall_s"]
                                          for e in self._by_key.values()), 4),
                "recompiles": int(_M_RECOMPILES.value),
                "churn_alerts": int(_M_CHURN.value),
            }

    def events(self, n=32):
        """The last ``n`` compile events, oldest first."""
        with self._lock:
            buf = list(self._events)
        return buf[-int(n):]

    def report(self, recent=32):
        """The /compilez payload: per-key rollup, churned keys, recent
        events, in-flight compiles, cache sizes."""
        with self._lock:
            by_key = {
                k: {"count": e["count"], "wall_s": round(e["wall_s"], 4),
                    "signatures": len(e["signatures"]),
                    "triggers": dict(e["triggers"]),
                    "churn_alerts": e["churn_alerts"],
                    "last_signature": e["last_signature"]}
                for k, e in sorted(self._by_key.items())
            }
            caches = dict(self._caches)
        churned = {k: v for k, v in by_key.items() if v["churn_alerts"]}
        counts = self.counts()
        return {
            "events": counts["events"],
            "total_wall_s": counts["total_wall_s"],
            "recompiles": counts["recompiles"],
            "churn_alerts": counts["churn_alerts"],
            "by_key": by_key,
            "churned": churned,
            "recent": self.events(recent),
            "active": self.active(),
            "caches": caches,
            "churn_threshold": self.churn_threshold,
        }

    def reset(self):
        """Test hook: forget events/keys/caches (metric objects keep their
        values — reset those via registry.reset("compile."))."""
        with self._lock:
            self._events.clear()
            self._by_key.clear()
            self._caches.clear()
            self._cache_warned.clear()
            self._active.clear()

def _ledger_record(led, key, wall_s, signature, trigger, error):
    """The event append and the churn/trigger classification."""
    key = str(key)
    sig = "?" if signature is None else str(signature)
    err = None if error is None else f"{type(error).__name__}: {error}"
    with led._lock:
        entry = led._by_key.get(key)
        first = entry is None
        if first:
            entry = led._by_key[key] = {
                "count": 0, "wall_s": 0.0, "signatures": OrderedDict(),
                "triggers": {}, "churn_alerts": 0, "last_signature": None,
                "warned": False,
            }
        resolved = (getattr(led._local, "trigger", None)
                    or trigger
                    or ("cold" if first else "recompile"))
        entry["count"] += 1
        entry["wall_s"] += float(wall_s)
        entry["triggers"][resolved] = entry["triggers"].get(resolved, 0) + 1
        new_sig = sig not in entry["signatures"]
        entry["signatures"][sig] = entry["signatures"].get(sig, 0) + 1
        while len(entry["signatures"]) > 64:  # bound per-key memory
            entry["signatures"].popitem(last=False)
        entry["last_signature"] = sig
        churned = (new_sig and err is None
                   and len(entry["signatures"]) > led.churn_threshold)
        if churned:
            entry["churn_alerts"] += 1
        rec = {"key": key, "signature": sig, "wall_s": round(float(wall_s), 4),
               "trigger": resolved, "time": time.time()}
        if err:
            rec["error"] = err
        led._events.append(rec)
    _M_EVENTS.inc()
    _M_WALL.observe(wall_s)
    if not first and err is None:
        _M_RECOMPILES.inc()
    if churned:
        _M_CHURN.inc()
        if not entry["warned"]:
            entry["warned"] = True
            warnings.warn(
                f"compile churn: program {key!r} has compiled "
                f"{entry['count']} times under {len(entry['signatures'])} "
                f"distinct input signatures (threshold "
                f"{led.churn_threshold}) — shape/dtype drift is defeating "
                f"the program cache; bucket the inputs or split the key",
                RuntimeWarning, stacklevel=4)
    return rec


#: the process-wide singleton every compile site records into
ledger = CompileLedger()


#: the process-wide singleton every compile site records into
ledger = CompileLedger()


@contextmanager
def record_compile(key, trigger=None, signature=None):
    """Compile bracket: times the body (a kernel build, a program family's
    first dispatch), records one ledger event, and routes exceptions
    through OOM forensics before re-raising."""
    tok = ledger.begin(key)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as e:  # incl. interrupts: never leak the token
        ledger.exit_trace()
        ledger.end(tok, key, wall_s=time.perf_counter() - t0,
                   signature=signature, trigger=trigger, error=e)
        if isinstance(e, Exception):
            maybe_oom_report(e, program=key)
        raise
    ledger.exit_trace()
    ledger.end(tok, key, wall_s=time.perf_counter() - t0,
               signature=signature, trigger=trigger)


# ---------------------------------------------------------------------------
# memory ledger
# ---------------------------------------------------------------------------
class MemoryLedger:
    """The device-memory budget and the programs' cost rows.

    Components (the KV page pools, ...) are registered as weakly bound
    byte providers, so N live engines sum and a dead one drops out. A
    program's cost row ({flops, bytes} of one dispatch) is what
    ``observability.devprof`` divides by the sampled device time."""

    def __init__(self, max_programs=160):
        self._lock = threading.Lock()
        self._programs = OrderedDict()
        self._max_programs = int(max_programs)
        self._providers = {}

    # ---- device-memory budget components ---------------------------------
    def register_component_provider(self, name, obj, method_name):
        """Register ``obj.method_name() -> bytes`` weakly under component
        ``name``; multiple live objects per name sum, dead ones vanish."""
        ref = weakref.ref(obj)
        with self._lock:
            self._providers.setdefault(str(name), []).append(
                (ref, str(method_name)))

    def components(self):
        """{component: bytes}: the live providers' sums (0 once a
        component's providers are gone)."""
        with self._lock:
            providers = {k: list(v) for k, v in self._providers.items()}
            # prune dead refs in place under the lock (a write-back of the
            # snapshot would clobber providers registered concurrently)
            for refs in self._providers.values():
                refs[:] = [(r, m) for r, m in refs if r() is not None]
        out = {}
        for name, refs in providers.items():
            total = 0
            for ref, meth in refs:
                obj = ref()
                if obj is None:
                    continue
                try:
                    total += int(getattr(obj, meth)())
                except Exception:
                    continue
            out[name] = total
        return out

    @staticmethod
    def _card():
        """The current CUDA device when a card has been initialized here,
        else None (a CPU run reads no card)."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch.cuda.current_device()
        return None

    def capacity_bytes(self):
        """Device memory capacity: ``PADDLE_HBM_CAPACITY_BYTES`` first,
        else the card's total (``torch.cuda.mem_get_info``); None on a
        CPU run."""
        env = env_str("PADDLE_HBM_CAPACITY_BYTES")
        if env:
            try:
                return int(float(env))
            except ValueError:
                pass
        dev = self._card()
        if dev is None:
            return None
        return int(torch.cuda.mem_get_info(dev)[1])

    def allocator_bytes(self):
        """(live, peak) bytes of the caching allocator
        (``torch.cuda.memory_stats``), or (None, None) on a CPU run."""
        dev = self._card()
        if dev is None:
            return None, None
        stats = torch.cuda.memory_stats(dev)
        return (int(stats.get("allocated_bytes.all.current", 0)),
                int(stats.get("allocated_bytes.all.peak", 0)))

    # ---- program cost rows -----------------------------------------------
    def note_cost(self, key, flops=None, nbytes=None):
        """Set program ``key``'s cost row: the FLOPs and the bytes one
        dispatch of it needs. Bounded LRU."""
        cost = {}
        if flops:
            cost["flops"] = float(flops)
        if nbytes:
            cost["bytes"] = float(nbytes)
        with self._lock:
            self._programs[str(key)] = cost
            self._programs.move_to_end(str(key))
            while len(self._programs) > self._max_programs:
                self._programs.popitem(last=False)

    def programs(self):
        """{key: cost row}."""
        with self._lock:
            return {k: dict(v) for k, v in self._programs.items()}

    def program_cost(self, key):
        """The devprof join hook: one program's cost row ({flops, bytes}),
        None until one was noted."""
        with self._lock:
            v = self._programs.get(str(key))
            return dict(v) if v else None

    # ---- the budget report ------------------------------------------------
    def refresh_gauges(self):
        """Publish the ``device.hbm_*`` gauges from the current ledger."""
        comps = self.components()
        used = sum(comps.values())
        cap = self.capacity_bytes()
        live, peak = self.allocator_bytes()
        for name, v in comps.items():
            _registry.gauge("device.hbm_component_bytes",
                            help="device-memory budget components (KV "
                                 "page pools, ...)",
                            labels={"component": name}).set(v)
        _registry.gauge("device.hbm_used_bytes",
                        help="sum of registered components").set(used)
        if live is not None:
            _registry.gauge("device.hbm_live_bytes",
                            help="caching allocator's live bytes").set(live)
        if cap:
            _registry.gauge("device.hbm_capacity_bytes",
                            help="device memory capacity").set(cap)
            _registry.gauge(
                "device.hbm_headroom_bytes",
                help="capacity - max(components, allocator live)").set(
                max(0, cap - max(used, live or 0)))
        return {"components": comps, "used_bytes": used,
                "capacity_bytes": cap, "live_bytes": live,
                "peak_bytes": peak}

    def report(self):
        """The budget: components, their sum, the allocator's live and
        peak bytes, the capacity, the headroom and the share of the
        capacity in use, and the programs' cost rows."""
        budget = self.refresh_gauges()
        cap = budget["capacity_bytes"]
        used = max(budget["used_bytes"], budget["live_bytes"] or 0)
        return {
            **budget,
            "headroom_bytes": (max(0, cap - used) if cap else None),
            "budget_fraction": (round(used / cap, 6) if cap else None),
            "programs": self.programs(),
        }

    def reset(self):
        with self._lock:
            self._programs.clear()
            self._providers.clear()


memory = MemoryLedger()


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------
_OOM_MARKERS = ("CUDA out of memory", "Out of memory", "out of memory",
                "RESOURCE_EXHAUSTED", "OOM")
_oom_contexts = []
_oom_lock = threading.Lock()
# (id of last reported exc, report path, monotonic stamp): the double-seam
# dedup. Two seams (the dispatch section and the readback) can fire within
# one raise propagation, so the id match is time-bounded: a later distinct
# OOM whose exception object reuses the freed address still gets its own
# report.
_last_oom = [None, None, 0.0]
_OOM_DEDUP_WINDOW_S = 5.0


def is_oom(exc):
    """Is this exception a device-memory exhaustion? A
    ``torch.cuda.OutOfMemoryError``, the out-of-memory family by message
    or type name, or the ``obs.oom`` chaos site's synthetic injection."""
    if exc is None:
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    try:
        from ..testing.chaos import FaultInjected

        if isinstance(exc, FaultInjected) and exc.site == "obs.oom":
            return True
    except Exception:
        pass
    text = f"{type(exc).__name__}: {exc}"
    return any(m in text for m in _OOM_MARKERS)


def register_oom_context(name, obj, method_name):
    """Register ``obj.method_name() -> dict`` (weakly bound) to be
    snapshotted into the OOM report — the serving engine registers its
    active slots / page-pool occupancy here."""
    with _oom_lock:
        _oom_contexts.append((str(name), weakref.ref(obj),
                              str(method_name)))


def _collect_oom_contexts():
    out = {}
    with _oom_lock:
        items = list(_oom_contexts)
    live = []
    for name, ref, meth in items:
        obj = ref()
        if obj is None:
            continue
        live.append((name, ref, meth))
        try:
            out.setdefault(name, []).append(getattr(obj, meth)())
        except Exception as e:
            out.setdefault(name, []).append(
                {"error": f"{type(e).__name__}: {e}"})
    with _oom_lock:
        _oom_contexts[:] = live
    return out


def oom_report_path():
    d = env_str("PADDLE_TELEMETRY_DIR") or "telemetry"
    return os.path.join(d, OOM_REPORT_NAME)


def write_oom_report(exc, program=None, path=None):
    """Commit ``telemetry/oom_report.json``: the error, the compile
    ledger snapshot (with the last compile events), the device-memory
    budget, and every registered context (the engines' active slots and
    pages). Atomic tmp+rename; never raises: forensics must not mask the
    original exception."""
    try:
        report = {
            "time": time.time(),
            "pid": os.getpid(),
            "rank": _rank(),
            "error": f"{type(exc).__name__}: {exc}",
            "program": program,
            "compile": ledger.report(recent=32),
            "memory": memory.report(),
            "contexts": _collect_oom_contexts(),
        }
        path = path or oom_report_path()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1, default=str)
        os.replace(tmp, path)
        _M_OOM.inc()
        return path
    except Exception:
        return None


def maybe_oom_report(exc, program=None):
    """The dispatch-seam hook: no-op for non-OOM exceptions (one string
    scan, only on the error path); for an out-of-memory error writes the
    forensics report once per exception object."""
    if not is_oom(exc):
        return None
    if (_last_oom[0] == id(exc)
            and time.monotonic() - _last_oom[2] < _OOM_DEDUP_WINDOW_S):
        return _last_oom[1]
    path = write_oom_report(exc, program=program)
    _last_oom[0] = id(exc)
    _last_oom[1] = path
    _last_oom[2] = time.monotonic()
    return path
