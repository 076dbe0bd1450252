"""Anomaly flight recorder (the port's own copy of
``paddle_tpu/observability/flightrec.py``): commit the evidence while it
exists.

When an anomaly fires (a loss spike past the z threshold, a non-finite
skip, a persistent straggler, an SLO page, a hang diagnosis) the forensics
that explain it (the dynamics window, the recent span ring, the compile
ledger's tail) are volatile process state, gone by the time a person
looks. Any trigger calls :func:`record`, which commits one bounded,
deduplicated, rate-limited atomic bundle
``<telemetry>/flight/<trigger>_<step>.json`` (tmp + rename: a reader never
sees a torn file, and committing never raises into the caller).

Bundle contents: the trigger and its payload, the dynamics window
(:func:`dynamics.flight_block`), the last host spans, the compile ledger's
tail, the goodput split, the ``train.*``/``fault.*`` metrics and the
capture registry's state.

Bounds (each with a variable):

- **rate limit**: per trigger, a second bundle within
  ``PADDLE_FLIGHTREC_MIN_INTERVAL_S`` is suppressed (counted, not
  written), so a non-finite storm gives one bundle per window;
- **dedup**: an exact ``(trigger, step)`` repeat never writes twice;
- **cap**: at most ``PADDLE_FLIGHTREC_MAX`` bundles per recorder; past it
  everything is suppressed (the first evidence is the valuable evidence).

**The capture registry.** The recorder also owns the process's one
on-demand ``torch.profiler`` capture: :func:`arm_capture` schedules a
trace of the next K train steps (``/profilez?steps=K``, or on every
committed bundle when ``PADDLE_FLIGHTREC_CAPTURE_STEPS`` > 0), the train
step's epilogue hook :func:`maybe_capture_step` starts, advances and stops
it, and every capture is ledgered in a bounded history.
:func:`_start_backend` and :func:`_stop_backend` are the only place that
opens a profiler (``torch.profiler.profile`` over the CPU and CUDA
activities; its Chrome trace lands in the capture's ``log_dir``). Kineto
runs one profiler at a time: a capture that would start while another
profiler is active is refused through the registry (ledgered with the
error), never nested. ``torch.profiler`` is imported only when a capture
starts.

Cost: with nothing armed, :func:`maybe_capture_step` is one module-global
None check; :func:`record` is only ever called from anomaly paths.
"""
import json
import os
import threading
import time

from ..utils.envs import env_float, env_int, env_str
from .metrics import registry as _registry

__all__ = ["FlightRecorder", "record", "recorder", "report",
           "arm_capture", "disarm_capture", "maybe_capture_step",
           "start_capture", "stop_capture", "capture_status",
           "FLIGHT_DIR", "MAX_ENV", "MIN_INTERVAL_ENV", "CAPTURE_STEPS_ENV"]

#: subdirectory of the telemetry dir holding the bundles
FLIGHT_DIR = "flight"
#: bundle cap per recorder — past it, suppressed (first evidence wins)
MAX_ENV = "PADDLE_FLIGHTREC_MAX"
#: per-trigger rate limit between committed bundles, seconds
MIN_INTERVAL_ENV = "PADDLE_FLIGHTREC_MIN_INTERVAL_S"
#: >0 arms a K-step profiler capture automatically on every committed bundle
CAPTURE_STEPS_ENV = "PADDLE_FLIGHTREC_CAPTURE_STEPS"

_SAFE = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-"


def _sanitize(s):
    return "".join(c if c in _SAFE else "-" for c in str(s)) or "trigger"


def _rank():
    return env_str("PADDLE_TRAINER_ID", env_str("RANK", "0")) or "0"


class FlightRecorder:
    """One directory's bundle writer with its dedup/rate-limit/cap state."""

    def __init__(self, directory=None, max_bundles=None, min_interval_s=None,
                 capture_steps=None):
        # same fallback as the OOM report: a recorder is ALWAYS available
        self.dir = os.path.join(
            directory or env_str("PADDLE_TELEMETRY_DIR") or "telemetry",
            FLIGHT_DIR)
        self.max_bundles = (int(max_bundles) if max_bundles is not None
                            else env_int(MAX_ENV, 16))
        self.min_interval_s = (float(min_interval_s)
                               if min_interval_s is not None
                               else env_float(MIN_INTERVAL_ENV, 30.0))
        self.capture_steps = (int(capture_steps) if capture_steps is not None
                              else env_int(CAPTURE_STEPS_ENV, 0))
        self._lock = threading.Lock()
        self._last_t = {}      # trigger -> monotonic time of last commit
        self._committed = []   # [(trigger, step, path)]
        self._seen = set()     # {(trigger, step)} — step-keyed dedup only
        self._seq = 0          # per-recorder sequence for stepless names
        self.suppressed = 0

    # ---- bundle building ---------------------------------------------------
    def _build(self, trigger, step, payload):
        """The evidence bundle. Each block is best-effort: a dying
        subsystem must not cost the others their last words."""
        bundle = {
            "kind": "flight_record",
            "trigger": trigger,
            "step": step,
            "time": time.time(),
            "rank": _rank(),
            "pid": os.getpid(),
            "payload": payload or {},
        }
        try:
            from . import dynamics as _dynamics

            bundle["dynamics"] = _dynamics.flight_block()
        except Exception as e:
            bundle["dynamics"] = {"error": f"{type(e).__name__}: {e}"}
        try:
            from . import tracing as _tracing

            bundle["spans"] = _tracing.last_spans(64)
        except Exception as e:
            bundle["spans"] = {"error": f"{type(e).__name__}: {e}"}
        try:
            from . import compilemem as _compilemem

            bundle["compile"] = _compilemem.ledger.report(recent=16)
        except Exception as e:
            bundle["compile"] = {"error": f"{type(e).__name__}: {e}"}
        try:
            from . import goodput as _goodput

            bundle["goodput"] = _goodput.report()
        except Exception as e:
            bundle["goodput"] = {"error": f"{type(e).__name__}: {e}"}
        try:
            bundle["metrics"] = {
                **_registry.snapshot(prefix="train."),
                **_registry.snapshot(prefix="fault."),
            }
        except Exception as e:
            bundle["metrics"] = {"error": f"{type(e).__name__}: {e}"}
        try:
            bundle["capture"] = capture_status()
        except Exception as e:
            bundle["capture"] = {"error": f"{type(e).__name__}: {e}"}
        return bundle

    def record(self, trigger, step=None, payload=None, force=False):
        """Commit one bundle; returns its path, or None when suppressed
        (dedup / rate limit / cap) or the write failed. Never raises."""
        trigger = _sanitize(trigger)
        now = time.monotonic()
        with self._lock:
            if not force:
                # exact-repeat dedup is STEP-KEYED only: a stepless
                # trigger (hang, slo_page, straggler) must stay eligible
                # after the rate window — (trigger, None) in the seen set
                # would suppress every later occurrence forever
                if step is not None and (trigger, step) in self._seen:
                    self.suppressed += 1
                    self._count_suppressed()
                    return None
                last = self._last_t.get(trigger)
                if last is not None and now - last < self.min_interval_s:
                    self.suppressed += 1
                    self._count_suppressed()
                    return None
                if len(self._committed) >= self.max_bundles:
                    self.suppressed += 1
                    self._count_suppressed()
                    return None
            # reserve the slot under the lock; build/write outside it
            self._last_t[trigger] = now
            if step is not None:
                self._seen.add((trigger, step))
            self._seq += 1
            seq = self._seq
        # stepless bundles get a per-recorder sequence suffix: a second
        # hang an hour later must not overwrite the first one's evidence
        name = (f"{trigger}_{step}.json" if step is not None
                else f"{trigger}_n{seq}.json")
        path = os.path.join(self.dir, name)
        try:
            bundle = self._build(trigger, step, payload)
            os.makedirs(self.dir, exist_ok=True)
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(bundle, f, indent=1, default=str)
            os.replace(tmp, path)
        except Exception:
            # a full disk must not take the train loop down — and a
            # FAILED write must not consume the dedup/rate-limit slot:
            # no evidence landed, so the trigger stays eligible
            with self._lock:
                self._seen.discard((trigger, step))
                if self._last_t.get(trigger) == now:
                    del self._last_t[trigger]
            return None
        with self._lock:
            self._committed.append((trigger, step, path))
        _registry.counter(
            "flightrec.bundles",
            help="flight-record bundles committed by this process").inc()
        if self.capture_steps > 0:
            # evidence escalation: the NEXT K steps get a profiler capture
            arm_capture(self.capture_steps, trigger=trigger)
        return path

    def _count_suppressed(self):
        _registry.counter(
            "flightrec.suppressed",
            help="flight-record triggers suppressed by dedup, the "
                 "per-trigger rate limit, or the bundle cap").inc()

    def status(self):
        with self._lock:
            return {
                "dir": self.dir,
                "max_bundles": self.max_bundles,
                "min_interval_s": self.min_interval_s,
                "auto_capture_steps": self.capture_steps,
                "committed": [
                    {"trigger": t, "step": s, "path": p}
                    for t, s, p in self._committed],
                "suppressed": self.suppressed,
            }


#: recorder per directory (the watchdog records into ITS telemetry dir,
#: which may differ from this process's env) — dedup state is per dir
_recorders = {}
_recorders_lock = threading.Lock()


def recorder(directory=None):
    key = directory or env_str("PADDLE_TELEMETRY_DIR") or "telemetry"
    with _recorders_lock:
        rec = _recorders.get(key)
        if rec is None:
            rec = _recorders[key] = FlightRecorder(directory=key)
        return rec


def record(trigger, step=None, payload=None, directory=None, force=False):
    """Module-level convenience: commit a bundle via the (cached) recorder
    for ``directory`` (default: this process's telemetry dir). A process
    with NO telemetry dir configured records nothing — the trigger seams
    (nf sentinel, SLO monitor, fleet aggregator) fire unconditionally,
    and un-armed processes must not sprinkle ``telemetry/`` dirs over
    whatever their cwd happens to be."""
    d = directory or env_str("PADDLE_TELEMETRY_DIR")
    if not d:
        return None
    return recorder(d).record(trigger, step=step, payload=payload,
                              force=force)


def report():
    """The /dynamicsz ``flight`` block: every live recorder's status."""
    with _recorders_lock:
        recs = list(_recorders.values())
    return [r.status() for r in recs]


def _reset():
    """Test hook: drop recorder caches, any armed capture, and the
    completed-capture history."""
    global _capture
    with _recorders_lock:
        _recorders.clear()
    with _cap_lock:
        _capture = None
        del _cap_history[:]
    _registry.gauge("flightrec.capture_active",
                    help=_CAP_ACTIVE_HELP).set(0)


# ---------------------------------------------------------------------------
# the profiler capture registry
# ---------------------------------------------------------------------------
_cap_lock = threading.Lock()
_capture = None        # the one armed/active capture, or None
_cap_history = []      # bounded completed-capture ledger
_CAP_HISTORY_MAX = 16
_CAP_ACTIVE_HELP = ("a profiler capture is armed or in flight "
                    "(the flight recorder's capture registry)")


def _default_log_dir(trigger):
    base = env_str("PADDLE_TELEMETRY_DIR") or "telemetry"
    return os.path.join(base, "profile",
                        f"{_sanitize(trigger)}_{int(time.time())}")


#: the live capture's profiler and its log_dir (set by _start_backend)
_backend = None
_BUSY = "another torch.profiler session is active in this process"


def _profiler_active():
    """Whether a profiler session (ours or another's) is running here."""
    import torch

    return bool(torch._C._autograd._profiler_enabled())


def _start_backend(log_dir):
    """The raw capture site: the one place that opens a profiler. Refuses
    (raises) while another profiler is active in this process: Kineto
    runs one at a time, and a nested start would break the outer one."""
    global _backend
    import torch

    if _profiler_active():
        raise RuntimeError(_BUSY)
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _backend = (prof, log_dir)


def _stop_backend():
    """Stop the live capture and write its Chrome trace into its
    ``log_dir`` (``trace.json``)."""
    global _backend
    live, _backend = _backend, None
    if live is None:
        raise RuntimeError("no profiler capture is running")
    prof, log_dir = live
    prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def arm_capture(steps, log_dir=None, trigger="manual"):
    """Schedule a profiler capture of the next ``steps`` train steps (the
    /profilez?steps=K handler, and the auto-escalation on flight
    triggers). One capture at a time — arming while one is armed/active
    returns its status instead of stacking."""
    global _capture
    try:
        steps = int(steps)
    except (TypeError, ValueError):
        return {"error": f"steps must be an int, got {steps!r}"}
    if steps <= 0:
        return {"error": f"steps must be > 0, got {steps}"}
    if _capture is None and _profiler_active():
        return {"error": _BUSY}
    with _cap_lock:
        if _capture is not None:
            return {"error": "a capture is already armed or active",
                    "capture": _public(_capture)}
        _capture = {
            "trigger": _sanitize(trigger),
            "steps": steps,
            "steps_left": steps,
            "log_dir": log_dir or _default_log_dir(trigger),
            "manual": False,
            "started": False,
            "armed_at": time.time(),
        }
        _registry.gauge("flightrec.capture_active",
                        help=_CAP_ACTIVE_HELP).set(1)
        return {"armed": True, "capture": _public(_capture)}


def disarm_capture():
    """Cancel an armed-but-not-started capture; stop a started one (the
    backend stop runs OUTSIDE the lock — see :func:`_stop_and_ledger`)."""
    with _cap_lock:
        cap = _capture
        if cap is None:
            return {"disarmed": False}
        if not cap["started"]:
            _clear_locked()
            return {"disarmed": True}
    _stop_and_ledger(cap, aborted=True)
    return {"disarmed": True}


def maybe_capture_step(step=None, n=1):
    """The train-step epilogue hook: one module-global None check when
    nothing is armed. First armed call starts the trace; each later call
    burns ``n`` steps (a run_steps call covers n optimizer steps — the
    K-step contract counts TRAIN steps, not dispatches); the Kth stops
    and ledgers it."""
    if _capture is None:
        return
    _capture_tick(step, n)


def _capture_tick(step, n=1):
    # backend start/stop can flush a large trace to disk — NEVER under
    # _cap_lock, or every /profilez scrape and flight-bundle build (via
    # capture_status) blocks behind the profiler I/O
    to_start = to_stop = None
    with _cap_lock:
        cap = _capture
        if cap is None or cap["manual"]:
            return
        if not cap["started"]:
            cap["started"] = True
            cap["first_step"] = step
            cap["t0"] = time.time()
            to_start = cap
        else:
            cap["steps_left"] -= max(1, int(n))
            if cap["steps_left"] <= 0:
                cap["last_step"] = step
                to_stop = cap
    if to_start is not None:
        try:
            _start_backend(to_start["log_dir"])
        except Exception as e:  # a broken profiler must not kill steps
            with _cap_lock:
                if _capture is to_start:
                    _finish_locked(error=f"{type(e).__name__}: {e}")
        return
    if to_stop is not None:
        _stop_and_ledger(to_stop)


def _stop_and_ledger(cap, aborted=False):
    """Stop the backend (outside the lock — trace flushing can take
    seconds) and ledger ``cap`` if it is still the live capture. A lost
    race (someone else already finished it) stops at most twice; the
    second stop raises and is swallowed, and the ledger entry is
    written exactly once."""
    error = None
    try:
        _stop_backend()
    except Exception as e:
        error = f"{type(e).__name__}: {e}"
    with _cap_lock:
        if _capture is cap:
            _finish_locked(error=error, aborted=aborted)


def start_capture(log_dir, trigger="profiler_api"):
    """Manual open-ended capture. Ledgered like step captures, stopped by
    :func:`stop_capture`. Raises RuntimeError if one is already live
    (the profiler's own one-session contract). The slot is reserved under
    the lock; the backend start runs outside it."""
    global _capture
    with _cap_lock:
        if _capture is not None:
            raise RuntimeError(
                "a profiler capture is already armed or active: "
                f"{_public(_capture)}")
        cap = _capture = {
            "trigger": _sanitize(trigger),
            "steps": None,
            "steps_left": None,
            "log_dir": log_dir,
            "manual": True,
            "started": True,
            "armed_at": time.time(),
            "t0": time.time(),
        }
        _registry.gauge("flightrec.capture_active",
                        help=_CAP_ACTIVE_HELP).set(1)
    try:
        _start_backend(log_dir)
    except BaseException:
        with _cap_lock:
            if _capture is cap:
                _clear_locked()
        raise


def stop_capture():
    """Stop the manual capture started by :func:`start_capture`."""
    with _cap_lock:
        cap = _capture
        if cap is None or not cap["manual"]:
            raise RuntimeError("no manual profiler capture is active")
    _stop_and_ledger(cap)


def _finish_locked(error, aborted=False):
    """Ledger the capture and clear the slot. Caller holds ``_cap_lock``
    and has already stopped the backend (outside the lock)."""
    global _capture
    cap = _capture
    if cap is None:
        return
    rec = _public(cap)
    rec["ended_at"] = time.time()
    if cap.get("t0"):
        rec["duration_s"] = round(rec["ended_at"] - cap["t0"], 3)
    if error:
        rec["error"] = error
    if aborted:
        rec["aborted"] = True
    _cap_history.append(rec)
    del _cap_history[:-_CAP_HISTORY_MAX]
    if cap["started"] and not error and not aborted:
        _registry.counter(
            "flightrec.captures",
            help="profiler captures completed through the capture "
                 "registry").inc()
    _clear_locked()


def _clear_locked():
    global _capture
    _capture = None
    _registry.gauge("flightrec.capture_active",
                    help=_CAP_ACTIVE_HELP).set(0)


def _public(cap):
    return {k: cap.get(k) for k in
            ("trigger", "steps", "steps_left", "log_dir", "manual",
             "started", "armed_at", "first_step")}


def capture_status():
    """The /profilez payload: the armed/active capture (if any) and the
    bounded completed-capture history."""
    with _cap_lock:
        return {
            "active": _public(_capture) if _capture is not None else None,
            "completed": list(_cap_history),
        }
