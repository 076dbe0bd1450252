"""Per-program device-time profiling plane (the port's own copy of
``paddle_tpu/observability/devprof.py``).

Host telemetry (spans, compile events, the memory budget) cannot say how
many device-seconds a program consumes, or whether it is compute- or
memory-bound. This module joins two sources, keyed by the compile
ledger's program key (``serve.decode_block[k8,s...]``, ...):

- **cost**: the program's FLOPs and bytes for one dispatch, noted in the
  memory ledger (``compilemem.memory.note_cost``). The serving engine
  notes an analytic row for its serve programs: 2 x parameters x tokens
  plus the attention pairs' products, and the parameter and KV bytes the
  dispatch reads;
- **measured device time**: the dispatch site records a CUDA event before
  the dispatch and one after it and calls :meth:`DevProfPlane.tick`. On
  the sampling cadence (``PADDLE_DEVPROF_SAMPLE_EVERY``) the tick
  synchronizes the second event, here and nowhere else, and banks the
  elapsed time between the two as the program's device time; off cadence
  it is one counter increment and the dispatch stays asynchronous. On the
  CPU (no events) the tick banks the host wall since the dispatch began.

From the join the plane derives, per program: achieved FLOP/s, achieved
memory bandwidth, arithmetic intensity, MFU, and a **roofline verdict**:
``compute-bound`` above the card's knee (peak FLOP/s over peak bytes/s),
``memory-bound`` below it, ``host-bound`` when the measured time dwarfs
what the roofline says the work should cost. The peaks come from the
card's name (an H100: 989e12 bf16 FLOP/s and 3.35e12 B/s), with
``PADDLE_DEVPROF_PEAK_FLOPS`` / ``PADDLE_DEVPROF_PEAK_BW`` overrides; a
CPU run gets nominal peaks so its rows stay well defined (and obviously
nominal). The serving split rolls the decode programs up into
device-seconds per emitted token.

Cost: disabled (``PADDLE_DEVPROF`` unset) the hot paths pay one
module-attribute-is-None check; enabled, between samples, one counter
increment. Surfaces: ``serving_report()["devprof"]`` and the
``devprof.*`` metrics.
"""
import math
import threading
import time

import torch

from ..utils.envs import env_bool, env_float, env_int
from .metrics import registry as _registry

__all__ = ["DevProfPlane", "arm_from_env", "enable", "disable", "enabled",
           "plane", "report", "serving_block", "fleet_block", "ENABLE_ENV",
           "EVERY_ENV", "PEAK_FLOPS_ENV", "PEAK_BW_ENV"]

#: master switch — unset/false = every hot path is one None check
ENABLE_ENV = "PADDLE_DEVPROF"
#: sampling cadence in dispatches per call-site context: at most one
#: timed (blocking) dispatch per window, the rest stay async
EVERY_ENV = "PADDLE_DEVPROF_SAMPLE_EVERY"
#: hardware peak FLOP/s override for the roofline/MFU denominators
PEAK_FLOPS_ENV = "PADDLE_DEVPROF_PEAK_FLOPS"
#: hardware peak HBM bytes/s override for the roofline knee
PEAK_BW_ENV = "PADDLE_DEVPROF_PEAK_BW"

#: dense bf16 peak FLOP/s and HBM bytes/s by card-name substring (NVIDIA's
#: data sheet, SXM part), first match wins
_PEAKS = (
    ("h100", 989e12, 3.35e12),
)
#: nominal knees for CPU smoke runs — the roofline still needs a finite
#: denominator so MFU/verdicts are well-defined (and obviously nominal)
_CPU_PEAKS = (1e12, 100e9)

#: measured device time past this multiple of the roofline-predicted
#: time means the chip is idle most of the window: host-bound
_HOST_BOUND_RATIO = 10.0

#: the live plane — None means disabled and every hot path is the single
#: ``_PLANE is not None`` check (the watchdog/dynamics one-check pattern)
_PLANE = None
_plane_lock = threading.Lock()


def _device_peaks(peak_flops=None, peak_bw=None):
    """(kind, peak FLOP/s, peak bytes/s): env overrides first, else the
    card-name table, else CPU nominals."""
    kind = "cpu"
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        kind = torch.cuda.get_device_name().lower()
    flops, bw = _CPU_PEAKS
    for sub, f, b in _PEAKS:
        if sub in kind:
            flops, bw = f, b
            break
    flops = float(peak_flops if peak_flops is not None
                  else env_float(PEAK_FLOPS_ENV, flops))
    bw = float(peak_bw if peak_bw is not None
               else env_float(PEAK_BW_ENV, bw))
    return kind, max(flops, 1.0), max(bw, 1.0)


class DevProfPlane:
    """The process-wide sampler: per-context cadence counters, the
    per-program sample table, and the cost join that turns samples into
    roofline rows."""

    def __init__(self, sample_every=None, peak_flops=None, peak_bw=None):
        self.sample_every = max(1, int(sample_every) if sample_every
                                is not None else env_int(EVERY_ENV, 16))
        self.device_kind, self.peak_flops, self.peak_bw = _device_peaks(
            peak_flops, peak_bw)
        self._lock = threading.Lock()
        #: dispatches since the last timed sample, per call-site context
        #: ("train", "serve.decode", ...) — cadence is per SITE so a busy
        #: decode loop cannot starve the train step of samples
        self._since = {}
        #: program key -> accumulated sample stats
        self._programs = {}
        self.started = time.time()

    # ---- the sampling seam -------------------------------------------------
    def tick(self, key, t0, events=None, tokens=0, context=None):
        """One dispatch of ``key``: ``t0`` is its pre-dispatch
        ``time.monotonic()`` stamp, ``events`` the (start, end) CUDA
        events recorded around it on its stream (None on the CPU, where
        the dispatch has finished when it returns). Off cadence: one
        counter increment. On cadence: the timed sync, the end event's,
        and the events' elapsed time banked as device time (on the CPU,
        the host wall since ``t0``). Returns True when this tick
        sampled."""
        ctx = context or key
        with self._lock:
            n = self._since.get(ctx, 0) + 1
            if n < self.sample_every:
                self._since[ctx] = n
                return False
            self._since[ctx] = 0
        if events is None:
            dev_s = time.monotonic() - t0
        else:
            start, end = events
            end.synchronize()
            dev_s = start.elapsed_time(end) / 1e3
        if dev_s < 0:  # a bad caller clock must not poison the table
            return False
        self._record(key, dev_s, tokens)
        return True

    def _record(self, key, dev_s, tokens):
        key = str(key)
        with self._lock:
            rec = self._programs.get(key)
            if rec is None:
                rec = self._programs[key] = {
                    "samples": 0, "device_s": 0.0, "last_s": 0.0,
                    "min_s": math.inf, "max_s": 0.0, "tokens": 0}
            rec["samples"] += 1
            rec["device_s"] += dev_s
            rec["last_s"] = dev_s
            rec["min_s"] = min(rec["min_s"], dev_s)
            rec["max_s"] = max(rec["max_s"], dev_s)
            rec["tokens"] += int(tokens)
        _registry.counter(
            "devprof.samples",
            help="timed (blocking) devprof dispatch samples taken").inc()
        _registry.histogram(
            "devprof.sample_s",
            help="sampled dispatch-to-ready device wall per timed "
                 "dispatch").observe(dev_s)
        labels = {"program": key}
        _registry.gauge(
            "devprof.device_s", labels=labels,
            help="last sampled device-seconds per dispatch of this "
                 "program").set(round(dev_s, 9))
        if tokens:
            _registry.gauge(
                "devprof.device_s_per_token", labels=labels,
                help="last sampled device-seconds per emitted token for "
                     "this decode program").set(round(dev_s / tokens, 9))
        cost = self._cost(key)
        flops = (cost or {}).get("flops")
        if flops:
            _registry.gauge(
                "devprof.mfu", labels=labels,
                help="achieved FLOP/s over device peak at the last "
                     "sample of this program").set(
                round(flops / dev_s / self.peak_flops, 6))

    # ---- the cost join -----------------------------------------------------
    @staticmethod
    def _cost(key):
        """The memory ledger's cost row for ``key`` (None until one was
        noted)."""
        from . import compilemem

        return compilemem.memory.program_cost(key)

    def _row(self, key, rec):
        n = rec["samples"]
        mean_s = rec["device_s"] / n if n else 0.0
        row = {
            "samples": n,
            "device_s_total": round(rec["device_s"], 6),
            "device_s_mean": round(mean_s, 9),
            "device_s_last": round(rec["last_s"], 9),
            "device_s_min": round(rec["min_s"], 9),
            "device_s_max": round(rec["max_s"], 9),
        }
        if rec["tokens"]:
            row["tokens"] = rec["tokens"]
            row["device_s_per_token"] = round(
                rec["device_s"] / rec["tokens"], 9)
        cost = self._cost(key) or {}
        flops = cost.get("flops") or 0.0
        nbytes = cost.get("bytes") or 0.0
        if flops:
            row["flops"] = flops
        if nbytes:
            row["bytes"] = nbytes
        if mean_s <= 0:
            row["verdict"] = "unknown"
            return row
        if flops:
            row["achieved_flops_s"] = round(flops / mean_s, 3)
            row["mfu"] = round(flops / mean_s / self.peak_flops, 6)
        if nbytes:
            row["achieved_bw_bytes_s"] = round(nbytes / mean_s, 3)
            row["hbm_util"] = round(nbytes / mean_s / self.peak_bw, 6)
        if flops and nbytes:
            row["arith_intensity"] = round(flops / nbytes, 4)
        # roofline: what SHOULD this program cost on this chip?
        t_compute = flops / self.peak_flops
        t_mem = nbytes / self.peak_bw
        bound = max(t_compute, t_mem)
        if bound <= 0:
            row["verdict"] = "unknown"
        elif mean_s > _HOST_BOUND_RATIO * bound:
            row["verdict"] = "host-bound"
        elif t_compute >= t_mem:
            row["verdict"] = "compute-bound"
        else:
            row["verdict"] = "memory-bound"
        return row

    # ---- surfaces ----------------------------------------------------------
    def _table(self):
        with self._lock:
            return {k: dict(v) for k, v in self._programs.items()}

    def report(self, program=None):
        """The per-program roofline rows plus the serving decode-token
        budget; ``program`` filters rows by key prefix."""
        rows = {}
        for key, rec in sorted(self._table().items()):
            if program and not key.startswith(program):
                continue
            rows[key] = self._row(key, rec)
        out = {
            "enabled": True,
            "sample_every": self.sample_every,
            "device": {
                "kind": self.device_kind,
                "peak_flops_s": self.peak_flops,
                "peak_bw_bytes_s": self.peak_bw,
                "roofline_knee": round(self.peak_flops / self.peak_bw, 3),
            },
            "programs": rows,
        }
        serving = self._serving_split(rows)
        if serving:
            out["serving"] = serving
        return out

    @staticmethod
    def _serving_split(rows):
        """The decode device-time budget: device-seconds per emitted
        token, overall and per decode program signature."""
        decode = {k: r for k, r in rows.items()
                  if k.startswith("serve.decode") and r.get("tokens")}
        if not decode:
            return None
        dev_s = sum(r["device_s_total"] for r in decode.values())
        tokens = sum(r["tokens"] for r in decode.values())
        return {
            "decode_device_s": round(dev_s, 6),
            "decode_tokens": tokens,
            "device_s_per_token": round(dev_s / tokens, 9) if tokens else None,
            "per_program": {k: {
                "device_s_per_token": r.get("device_s_per_token"),
                "mfu": r.get("mfu"),
                "verdict": r.get("verdict"),
            } for k, r in decode.items()},
        }


    def fleet_block(self):
        """The bounded per-rank snapshot block the fleet aggregator medians
        across ranks: mean device-seconds per dispatch for the costliest
        programs. None until something has been sampled."""
        table = self._table()
        if not table:
            return None
        ranked = sorted(table.items(), key=lambda kv: kv[1]["device_s"],
                        reverse=True)[:16]
        return {
            "sample_every": self.sample_every,
            "programs": {k: round(v["device_s"] / v["samples"], 9)
                         for k, v in ranked if v["samples"]},
        }


# ---- module-level switches (the watchdog arm/disarm idiom) -----------------
def arm_from_env():
    """Install the plane when ``PADDLE_DEVPROF`` is truthy (idempotent:
    every serving engine constructor calls this). Returns the live plane
    or None."""
    global _PLANE
    if _PLANE is None and env_bool(ENABLE_ENV):
        with _plane_lock:
            if _PLANE is None:
                _PLANE = DevProfPlane()
    return _PLANE


def enable(sample_every=None, peak_flops=None, peak_bw=None):
    """Install a plane unconditionally (a measurement arms profiling after
    its timed comparison phases this way). Replaces any live plane."""
    global _PLANE
    with _plane_lock:
        _PLANE = DevProfPlane(sample_every=sample_every,
                              peak_flops=peak_flops, peak_bw=peak_bw)
    return _PLANE


def disable():
    """Back to the disabled one-check state; sampled data is dropped."""
    global _PLANE
    with _plane_lock:
        _PLANE = None


def enabled():
    return _PLANE is not None


def plane():
    """The live plane or None."""
    return _PLANE


def report(program=None):
    """The plane's report ({"enabled": False} while disarmed)."""
    p = _PLANE
    if p is None:
        return {"enabled": False}
    return p.report(program=program)


def serving_block():
    """The serving_report()["devprof"] block."""
    return report()


def fleet_block():
    """The per-rank fleet-snapshot block (None while disarmed or before
    the first sample)."""
    p = _PLANE
    if p is None:
        return None
    return p.fleet_block()
