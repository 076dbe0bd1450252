"""Goodput accounting: where did the wall clock actually go? (The port's own
copy of ``paddle_tpu/observability/goodput.py``.)

Attributes elapsed time to a small fixed taxonomy —

- ``init``       first-dispatch compile + state placement (pays once, or
                 again after every elastic restart: restart badput)
- ``step``       productive optimizer steps — THE goodput
- ``data_wait``  input pipeline starvation (host blocked on the loader)
- ``checkpoint`` save/serialize stalls on the training thread
- ``recovery``   resume loads, restart rendezvous, watchdog-diagnosed stalls
- ``telemetry``  cadence-gated host reads of device-resident telemetry
                 (the non-finite sentinel counters, the dynamics carry
                 spill) — each read synchronizes on the step, and that
                 wall must be attributed, not silently folded into step
                 time

so the chaos layer's preemptions and the launcher's restarts show up as
measured badput fractions, not vibes. ``report()`` divides by true wall
clock since process start (or ``reset()``), so untracked time is visible
too instead of silently inflating goodput.

Gating: ``account(cat)`` is a no-op context manager unless span tracing is
enabled (same switch: PADDLE_TELEMETRY / tracing.enable()) — hot loops carry
it for free, and ALL categories share the gate so a report never shows
badput-only fractions from a telemetry-off run. ``always=True`` exists for
callers that need unconditional attribution.
"""
import threading
import time

from . import tracing

__all__ = ["GoodputAccountant", "accountant", "account", "note", "report",
           "reset", "CATEGORIES", "SERVING_CATEGORIES", "serving",
           "serving_note", "serving_report"]

CATEGORIES = ("init", "step", "data_wait", "checkpoint", "recovery",
              "telemetry")

#: serving-path taxonomy: engine wall clock classified
#: into device-productive work (prefill, decode) vs host/emit, dispatcher
#: idle, and compile stalls — the serving analogue of the training split
SERVING_CATEGORIES = ("prefill", "decode", "host_emit", "idle", "compile")


class _Timer:
    __slots__ = ("_acct", "_cat", "_t0")

    def __init__(self, acct, cat):
        self._acct = acct
        self._cat = cat

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._acct.note(self._cat, time.perf_counter() - self._t0)
        return False


class GoodputAccountant:
    def __init__(self, goodput_categories=("step",)):
        #: the categories that COUNT as goodput in report() — ("step",) for
        #: the training accountant, ("prefill", "decode") for serving
        self.goodput_categories = tuple(goodput_categories)
        self._lock = threading.Lock()
        self._totals = {}
        self._t0 = time.perf_counter()

    def account(self, category, always=False):
        """Context manager attributing the enclosed wall time to
        ``category``. Free (shared no-op) when telemetry is disabled unless
        ``always=True``."""
        if not always and not tracing.enabled():
            return tracing._NULL
        return _Timer(self, category)

    def note(self, category, seconds):
        with self._lock:
            self._totals[category] = self._totals.get(category, 0.0) + seconds

    def totals(self):
        with self._lock:
            return dict(self._totals)

    def report(self):
        """{wall_s, tracked_s, untracked_s, categories, fractions,
        goodput_fraction, badput}: fractions are of WALL clock, so they sum
        (with untracked) to 1."""
        wall = time.perf_counter() - self._t0
        totals = self.totals()
        tracked = sum(totals.values())
        frac = {k: (v / wall if wall > 0 else 0.0) for k, v in totals.items()}
        good = self.goodput_categories
        return {
            "wall_s": wall,
            "tracked_s": tracked,
            "untracked_s": max(0.0, wall - tracked),
            "categories": totals,
            "fractions": frac,
            "goodput_fraction": sum(frac.get(c, 0.0) for c in good),
            "badput": {k: v for k, v in frac.items() if k not in good},
        }

    def reset(self):
        with self._lock:
            self._totals = {}
            self._t0 = time.perf_counter()


#: process singleton + module-level conveniences
accountant = GoodputAccountant()
account = accountant.account
note = accountant.note
totals = accountant.totals
report = accountant.report
reset = accountant.reset

#: the serving-path accountant: device work (prefill + decode) is the
#: goodput; host_emit / idle / compile are the badput the data-plane
#: pipelining exists to hide. Fed by the engine's dispatch
#: epilogues and the frontend's idle waits — gated on the same telemetry
#: switch as every other timer (call sites check tracing.enabled()).
#: Attribution caveat: N dispatcher threads each contribute their own
#: time against ONE wall clock (reset at frontend start), so with N
#: replicas an idle cell reports idle ≈ N×wall and fractions can exceed
#: 1 — read the split as "where thread-seconds went", not a partition.
serving = GoodputAccountant(goodput_categories=("prefill", "decode"))
serving_note = serving.note
serving_report = serving.report

