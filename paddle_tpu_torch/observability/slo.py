"""SLO burn-rate accounting for the serving stack (the port's own copy of
``paddle_tpu/observability/slo.py``).

Latency histograms say what the tail WAS; an operator paging decision needs
"is the error budget burning down NOW, and is it a blip or a trend". This
module implements the standard multi-window burn-rate method (Google
SRE-workbook alerting): each :class:`SLOObjective` declares a target —
"99% of interactive requests see TTFT <= 1s" — and every observation is
classified good/bad into time-bucketed windows. The **burn rate** over a
window is ``bad_fraction / error_budget`` (1.0 = burning exactly the
budget; 14.4 over 5 minutes = the monthly budget gone in two days). An
alert fires only when BOTH the fast and the slow window exceed the
threshold: the fast window makes the alert responsive, the slow window
keeps a 30-second blip from paging.

Objectives come in three kinds:

- ``ttft``          — seconds from submit to first token (threshold_s)
- ``tpot``          — steady-state seconds per output token (threshold_s)
- ``deadline_miss`` — boolean: the request's user deadline expired

The serving frontend feeds a :class:`SLOMonitor` from its observation
points (``_observe_admission``/``_observe_completion``/expiry) and
surfaces ``monitor.report()`` in ``serving_report()``. Stdlib-only,
always-on (an observe is a few dict lookups and adds under one lock); the
clock is injectable so burn-rate math is unit-testable without sleeping.
"""
import threading
import time
from collections import deque

from .metrics import registry as _registry

__all__ = ["SLOObjective", "SLOMonitor", "default_objectives"]


class SLOObjective:
    """One promise: ``objective`` fraction of ``slo_class`` requests keep
    ``metric`` within ``threshold_s`` (threshold ignored for the boolean
    ``deadline_miss`` kind). ``error_budget = 1 - objective``."""

    __slots__ = ("name", "slo_class", "metric", "threshold_s", "objective")

    KINDS = ("ttft", "tpot", "deadline_miss")

    def __init__(self, slo_class, metric, threshold_s=None, objective=0.99,
                 name=None):
        if metric not in self.KINDS:
            raise ValueError(f"unknown SLO metric {metric!r}; "
                             f"have {self.KINDS}")
        if metric != "deadline_miss" and threshold_s is None:
            raise ValueError(f"{metric} objective needs threshold_s")
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective {objective} outside (0, 1)")
        self.slo_class = str(slo_class)
        self.metric = metric
        self.threshold_s = (float(threshold_s)
                            if threshold_s is not None else None)
        self.objective = float(objective)
        self.name = name or (
            f"{self.slo_class}.{metric}" +
            (f"<{self.threshold_s}s" if self.threshold_s is not None else ""))

    @property
    def error_budget(self):
        return 1.0 - self.objective

    def is_bad(self, value=None, bad=None):
        if self.metric == "deadline_miss":
            return bool(bad)
        return float(value) > self.threshold_s

    def __repr__(self):
        return (f"SLOObjective({self.slo_class!r}, {self.metric!r}, "
                f"threshold_s={self.threshold_s}, "
                f"objective={self.objective})")


def default_objectives(classes):
    """Build the default objective set from SLO classes (scheduler.SLOClass
    objects carrying ``ttft_slo_s``/``tpot_slo_s``/``slo_objective``, or
    anything duck-typed the same): one ttft + one tpot objective per class
    that declares a threshold, plus a shared per-class deadline_miss
    objective — the three kinds the serving comparison papers report."""
    out = []
    for c in classes:
        objective = float(getattr(c, "slo_objective", 0.99) or 0.99)
        ttft = getattr(c, "ttft_slo_s", None)
        if ttft:
            out.append(SLOObjective(c.name, "ttft", threshold_s=ttft,
                                    objective=objective))
        tpot = getattr(c, "tpot_slo_s", None)
        if tpot:
            out.append(SLOObjective(c.name, "tpot", threshold_s=tpot,
                                    objective=objective))
        out.append(SLOObjective(c.name, "deadline_miss", objective=0.999))
    return out


class _Window:
    """Time-bucketed good/bad counts over a bounded horizon. Buckets are
    coarse (horizon/60 by default) — burn-rate alerting needs minutes-scale
    resolution, not per-event timestamps — so memory is O(60) per window
    regardless of traffic."""

    __slots__ = ("bucket_s", "horizon_s", "_buckets", "_lock")

    def __init__(self, horizon_s, bucket_s=None):
        self.horizon_s = float(horizon_s)
        self.bucket_s = float(bucket_s) if bucket_s else max(
            1.0, self.horizon_s / 60.0)
        self._buckets = deque()  # [bucket_start, good, bad]
        self._lock = threading.Lock()

    def add(self, now, good, bad):
        start = now - (now % self.bucket_s)
        with self._lock:
            if self._buckets and self._buckets[-1][0] == start:
                self._buckets[-1][1] += good
                self._buckets[-1][2] += bad
            else:
                self._buckets.append([start, good, bad])
            self._prune(now)

    def _prune(self, now):
        limit = now - self.horizon_s - self.bucket_s
        while self._buckets and self._buckets[0][0] < limit:
            self._buckets.popleft()

    def totals(self, now):
        with self._lock:
            self._prune(now)
            good = sum(b[1] for b in self._buckets)
            bad = sum(b[2] for b in self._buckets)
        return good, bad


class SLOMonitor:
    """Burn-rate accounting over a set of objectives, two windows each.

    ``alert_burn_rate`` is the page threshold applied to BOTH windows
    (default 14.4 — the SRE-workbook 5m/1h pairing: sustaining it exhausts
    a 30-day budget in ~2 days). ``observe``/``observe_event`` are the feed
    points; ``report()`` is the /statusz + serving_report() payload and
    refreshes the ``slo.burn_rate`` gauges.

    ``gauge_labels`` namespaces this monitor's gauge series —
    the per-tenant monitors the frontend keeps would otherwise all write
    the same ``slo.burn_rate{objective=,window=}`` series and clobber the
    fleet monitor's."""

    def __init__(self, objectives=None, classes=None, fast_window_s=300.0,
                 slow_window_s=3600.0, alert_burn_rate=14.4,
                 clock=time.monotonic, gauge_labels=None):
        if objectives is None:
            objectives = default_objectives(classes or ())
        self.objectives = list(objectives)
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.alert_burn_rate = float(alert_burn_rate)
        self.gauge_labels = dict(gauge_labels) if gauge_labels else {}
        self._clock = clock
        self._windows = {
            o.name: (_Window(self.fast_window_s), _Window(self.slow_window_s))
            for o in self.objectives}
        self._by_key = {}
        for o in self.objectives:
            self._by_key.setdefault((o.slo_class, o.metric), []).append(o)
        self._alerts_fired = _registry.counter(
            "slo.alerts_fired",
            help="multi-window SLO burn-rate alert transitions (off->on)")
        self._alerting = set()

    # ---- feed -------------------------------------------------------------
    def observe(self, slo_class, metric, value):
        """One latency sample (seconds) for every matching objective."""
        self._add(slo_class, metric, value=value)

    def observe_event(self, slo_class, metric, bad):
        """One boolean sample (deadline_miss kind)."""
        self._add(slo_class, metric, bad=bad)

    def _add(self, slo_class, metric, value=None, bad=None):
        objs = self._by_key.get((slo_class, metric))
        if not objs:
            return
        now = self._clock()
        for o in objs:
            is_bad = o.is_bad(value=value, bad=bad)
            fast, slow = self._windows[o.name]
            fast.add(now, 0 if is_bad else 1, 1 if is_bad else 0)
            slow.add(now, 0 if is_bad else 1, 1 if is_bad else 0)

    # ---- read -------------------------------------------------------------
    def _burn(self, o, window, now):
        good, bad = window.totals(now)
        total = good + bad
        if not total:
            return 0.0, 0
        return (bad / total) / o.error_budget, total

    def burn_rates(self):
        """{objective name: {fast, slow, fast_n, slow_n, budget}}"""
        now = self._clock()
        out = {}
        for o in self.objectives:
            fast_w, slow_w = self._windows[o.name]
            fast, fast_n = self._burn(o, fast_w, now)
            slow, slow_n = self._burn(o, slow_w, now)
            out[o.name] = {"fast": fast, "slow": slow,
                           "fast_n": fast_n, "slow_n": slow_n,
                           "budget": o.error_budget}
        return out

    def alerts(self, rates=None):
        """Objectives burning past the threshold in BOTH windows right now
        (the multi-window AND is what separates a page from a blip).
        ``rates`` lets report() reuse one burn_rates() pass."""
        out = []
        all_rates = rates if rates is not None else self.burn_rates()
        for o in self.objectives:
            r = all_rates[o.name]
            if (r["fast_n"] and r["slow_n"]
                    and r["fast"] >= self.alert_burn_rate
                    and r["slow"] >= self.alert_burn_rate):
                out.append({
                    "objective": o.name,
                    "slo_class": o.slo_class,
                    "metric": o.metric,
                    "threshold_s": o.threshold_s,
                    "burn_fast": round(r["fast"], 3),
                    "burn_slow": round(r["slow"], 3),
                    "alert_burn_rate": self.alert_burn_rate,
                })
        # transition counting: a NEW alerting objective bumps the counter
        # and flight-records the page: the bundle freezes the span ring and
        # the goodput split at the moment the burn crossed, the evidence a
        # later SLO review needs
        names = {a["objective"] for a in out}
        newly = names - self._alerting
        for name in newly:
            self._alerts_fired.inc()
        if newly:
            from . import flightrec

            flightrec.record(
                "slo_page",
                payload={"alerting": sorted(names),
                         "new": sorted(newly),
                         "alerts": [a for a in out
                                    if a["objective"] in newly]})
        self._alerting = names
        return out

    def report(self):
        """Structured snapshot for serving_report()//statusz; refreshes the
        ``slo.burn_rate`` gauge family as a side effect (scrape-visible)."""
        rates = self.burn_rates()
        for name, r in rates.items():
            for win in ("fast", "slow"):
                _registry.gauge("slo.burn_rate",
                                labels={"objective": name, "window": win,
                                        **self.gauge_labels},
                                help="SLO error-budget burn rate per window"
                                ).set(r[win])
        alerts = self.alerts(rates=rates)
        alerting = {a["objective"] for a in alerts}
        return {
            "windows_s": {"fast": self.fast_window_s,
                          "slow": self.slow_window_s},
            "alert_burn_rate": self.alert_burn_rate,
            "objectives": {
                name: {**{k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in r.items()},
                       "alerting": name in alerting}
                for name, r in rates.items()},
            "alerts": alerts,
        }
