"""Per-replica circuit breaking (the port's own copy of
``paddle_tpu/serving/breaker.py``).

Without it the health ladder is binary above DRAINING: a replica was
LIVE (full traffic) or DEAD (everything reroutes). A replica that is
*sick* — spewing request errors from a corrupted KV pool, or running 5x
slower than its peers (the fleet's straggler verdict, applied per
replica) — kept receiving its full placement share
until it either died or burned the SLO budget. The breaker adds the
intermediate verdict:

    LIVE --(error rate / slow strikes over a sliding window)--> PROBATION
    PROBATION: only rate-limited *probe* requests are routed there
               (half-open); its pending queue is re-routed to healthy
               replicas the moment it trips
    PROBATION --(probe_successes consecutive probe OKs)--> LIVE  (close)
    PROBATION --(probation_failures probe errors)--> DEAD  (fail hard —
               the normal replica-death relocation machinery takes over)

Probes are real requests (that is what half-open means), but they are not
sacrificed: a probe that fails on a PROBATION replica is transparently
re-routed by the frontend (stream-unconsumed requests re-run bit-identically
elsewhere), so the probing traffic observes the failure without the caller
eating it.

Scoring feeds (all event-driven, no threads here):

- ``record(name, ok)`` — per-request outcomes from the frontend's finish
  path (the same per-request ``req.error`` plumbing ``request_errors``
  rides).
- ``note_slow(name)`` / ``note_on_pace(name)`` — the frontend monitor's
  per-tick latency verdict: a replica whose dispatch EWMA exceeds
  ``slow_ratio`` x the cross-replica median for ``slow_strikes``
  consecutive ticks trips exactly like an error storm (the compute-straggler
  classification, applied to serving dispatch).

The breaker only renders verdicts ("trip" / "close" / "fail_hard" /
None); the frontend owns the actual state transitions so every replica
state write stays under the one frontend lock.
"""
import threading
import time
from collections import deque

from ..observability.metrics import registry as _registry

__all__ = ["BreakerPolicy", "CircuitBreaker"]

_M_TRIPS = _registry.counter(
    "breaker.trips", help="LIVE -> PROBATION circuit-breaker trips")
_M_PROBES = _registry.counter(
    "breaker.probes", help="probe requests routed to PROBATION replicas")
_M_RECOVERIES = _registry.counter(
    "breaker.recoveries", help="PROBATION -> LIVE half-open closes")
_M_FAILED_HARD = _registry.counter(
    "breaker.failed_hard",
    help="PROBATION -> DEAD transitions after failed probes")

#: breaker.state gauge values per replica
_ST_CLOSED, _ST_PROBATION, _ST_OPEN = 0, 1, 2


class BreakerPolicy:
    """Trip/recovery thresholds (all overridable; clock injectable so the
    probe rate limit is unit-testable without sleeping)."""

    __slots__ = ("window", "error_threshold", "min_samples", "slow_ratio",
                 "slow_strikes", "probe_interval_s", "probe_successes",
                 "probation_failures")

    def __init__(self, window=20, error_threshold=0.5, min_samples=4,
                 slow_ratio=4.0, slow_strikes=3, probe_interval_s=0.25,
                 probe_successes=3, probation_failures=3):
        self.window = int(window)
        self.error_threshold = float(error_threshold)
        self.min_samples = int(min_samples)
        self.slow_ratio = float(slow_ratio)
        self.slow_strikes = int(slow_strikes)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_successes = int(probe_successes)
        self.probation_failures = int(probation_failures)


class _ReplicaScore:
    __slots__ = ("outcomes", "slow_strikes", "probing", "last_probe_t",
                 "probe_ok", "probe_bad", "tripped_reason")

    def __init__(self, window):
        self.outcomes = deque(maxlen=window)  # True = error
        self.slow_strikes = 0
        self.probing = False
        self.last_probe_t = None
        self.probe_ok = 0
        self.probe_bad = 0
        self.tripped_reason = None


class CircuitBreaker:
    """Sliding-window scorer + half-open probe budget per replica name.
    Thread-safe; every method is a few dict/deque ops under one lock."""

    def __init__(self, policy=None, clock=time.monotonic):
        self.policy = policy or BreakerPolicy()
        self._clock = clock
        self._lock = threading.Lock()
        self._scores = {}

    def _score(self, name):
        s = self._scores.get(name)
        if s is None:
            s = self._scores[name] = _ReplicaScore(self.policy.window)
        return s

    def _gauge(self, name):
        return _registry.gauge(
            "breaker.state", labels={"replica": str(name)},
            help="circuit state per replica: 0 closed (LIVE), "
                 "1 probation (half-open), 2 open (failed hard)")

    # ---- scoring feeds ----------------------------------------------------
    def record(self, name, ok):
        """One request outcome on a LIVE replica. Returns "trip" when the
        windowed error rate crosses the threshold, else None."""
        p = self.policy
        with self._lock:
            s = self._score(name)
            if s.probing:
                return None  # probation outcomes go through probe_result
            s.outcomes.append(not ok)
            n = len(s.outcomes)
            if n < p.min_samples:
                return None
            if sum(s.outcomes) / n >= p.error_threshold:
                return self._trip_locked(
                    name, s,
                    f"error rate {sum(s.outcomes)}/{n} over the last "
                    f"{n} requests")
        return None

    def note_slow(self, name):
        """One monitor-tick slow verdict (dispatch EWMA vs the fleet
        median). Trips after ``slow_strikes`` consecutive verdicts."""
        p = self.policy
        with self._lock:
            s = self._score(name)
            if s.probing:
                return None
            s.slow_strikes += 1
            if s.slow_strikes >= p.slow_strikes:
                return self._trip_locked(
                    name, s,
                    f"dispatch latency > {p.slow_ratio}x the replica "
                    f"median for {s.slow_strikes} consecutive checks")
        return None

    def note_on_pace(self, name):
        with self._lock:
            s = self._scores.get(name)
            if s is not None and not s.probing:
                s.slow_strikes = 0

    def _trip_locked(self, name, s, reason):
        s.probing = True
        s.tripped_reason = reason
        s.last_probe_t = None
        s.probe_ok = s.probe_bad = 0
        s.outcomes.clear()
        s.slow_strikes = 0
        _M_TRIPS.inc()
        self._gauge(name).set(_ST_PROBATION)
        return "trip"

    # ---- half-open probes --------------------------------------------------
    def allow_probe(self, name):
        """Rate-limited probe admission for a PROBATION replica: at most
        one probe per ``probe_interval_s``."""
        now = self._clock()
        with self._lock:
            s = self._scores.get(name)
            if s is None or not s.probing:
                return False
            if s.last_probe_t is not None \
                    and now - s.last_probe_t < self.policy.probe_interval_s:
                return False
            s.last_probe_t = now
        _M_PROBES.inc()
        return True

    def probe_result(self, name, ok):
        """One probe outcome: "close" after ``probe_successes``
        consecutive OKs, "fail_hard" after ``probation_failures`` errors,
        else None (keep probing)."""
        p = self.policy
        with self._lock:
            s = self._scores.get(name)
            if s is None or not s.probing:
                return None
            if ok:
                s.probe_ok += 1
                s.probe_bad = 0
                if s.probe_ok >= p.probe_successes:
                    s.probing = False
                    s.tripped_reason = None
                    s.outcomes.clear()
                    _M_RECOVERIES.inc()
                    self._gauge(name).set(_ST_CLOSED)
                    return "close"
                return None
            s.probe_ok = 0
            s.probe_bad += 1
            if s.probe_bad >= p.probation_failures:
                s.probing = False
                _M_FAILED_HARD.inc()
                self._gauge(name).set(_ST_OPEN)
                return "fail_hard"
        return None

    # ---- lifecycle ---------------------------------------------------------
    def forget(self, name):
        """Replica left the pool (death/retirement): drop its score and
        retire its state gauge so removed names stop exporting."""
        with self._lock:
            self._scores.pop(name, None)
        _registry.remove("breaker.state", labels={"replica": str(name)})

    def tripped_reason(self, name):
        with self._lock:
            s = self._scores.get(name)
            return s.tripped_reason if s is not None else None

    def report(self):
        with self._lock:
            return {
                name: {
                    "probing": s.probing,
                    "reason": s.tripped_reason,
                    "window_errors": sum(s.outcomes),
                    "window_n": len(s.outcomes),
                    "slow_strikes": s.slow_strikes,
                    "probe_ok": s.probe_ok,
                    "probe_bad": s.probe_bad,
                }
                for name, s in sorted(self._scores.items())
            }
