"""Step-metrics bus (the port's counterpart of
``paddle_tpu/utils/metrics_bus.py``): tokens/s, MFU and the window loss of
training steps, and the event counters every layer bumps.

The hot path stays asynchronous: ``on_step`` stamps the host clock and
keeps the step's loss tensor, still on the device. Every ``log_every``
steps the bus reads the window's losses back once, computes throughput,
MFU and peak device memory, and hands the record to its subscribers
(``stdout_logger``, ``JsonlWriter``, user callbacks).
"""
import logging
import time

import torch

from ..observability.metrics import Counter
from ..observability.metrics import registry as _registry
from ..observability.tracing import JsonlSpanSink

logger = logging.getLogger("paddle_tpu_torch.metrics")


class EventCounters:
    """Event counters over the metrics registry, as the reference keeps
    them: ``bump`` is one lock and an add; ``snapshot(prefix)`` returns only
    counters that fired (zero values are omitted, so
    ``if counters.snapshot("fault."):`` means "something failed");
    ``reset(prefix)`` zeroes them."""

    def __init__(self, registry=None):
        self._registry = registry if registry is not None else _registry

    def bump(self, name, n=1):
        self._registry.counter(name).inc(n)

    def get(self, name):
        m = self._registry.get(name)
        return m.value if isinstance(m, Counter) else 0

    def snapshot(self, prefix=""):
        # registry.snapshot renders Counters as bare numbers (zeros already
        # omitted); gauges/histograms render as dicts and are filtered out
        snap = self._registry.snapshot(prefix)
        return {k: v for k, v in snap.items() if isinstance(v, (int, float))}

    def reset(self, prefix=""):
        for name in self._registry.names(prefix):
            m = self._registry.get(name)
            if isinstance(m, Counter):
                m.reset()


#: module singleton: `from paddle_tpu_torch.utils.metrics_bus import counters`
counters = EventCounters()


def device_peak_memory():
    """Peak bytes allocated on the current CUDA device since its last
    reset; 0 without a card."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.max_memory_allocated())


class StepMetricsBus:
    """Publish/subscribe bus for per-step training metrics.

    tokens_per_step: tokens processed per optimizer step (batch*seq), enables
        tokens/sec. flops_per_token + peak_flops enable MFU.
    """

    def __init__(self, tokens_per_step=None, flops_per_token=None, peak_flops=None,
                 log_every=10, skip_first=1):
        self.tokens_per_step = tokens_per_step
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops
        self.log_every = max(1, log_every)
        self.skip_first = skip_first  # first step(s) include compile time
        self._subs = []
        self._step = 0
        self._last_emit_t = None
        self._last_emit_step = 0
        self._pending_losses = []  # EVERY step since the last emission
        self._intervals = []  # (steps, seconds) since previous emission
        self._t0 = None

    def subscribe(self, fn):
        """fn(record: dict) — called at each emission."""
        self._subs.append(fn)
        return fn

    def on_step(self, loss=None, tokens=None):
        """Cheap host-side hook; call once per optimizer step. ``loss`` may be a
        tensor on the device: it is read back only at emission time."""
        now = time.perf_counter()
        self._step += 1
        if tokens is not None:
            self.tokens_per_step = tokens
        if self._step <= self.skip_first:
            # warmup/compile steps: restart the timing window after them and
            # keep their losses out of the first window's mean
            self._pending_losses.clear()
            self._last_emit_t = now
            self._last_emit_step = self._step
            return
        # buffer (not overwrite): the emission reports the WINDOW mean, not
        # whichever loss happened to be last — sync still deferred to _emit
        if loss is not None:
            self._pending_losses.append(loss)
        if self._t0 is None:
            self._t0 = now
        if self._last_emit_t is None:
            self._last_emit_t = now
            self._last_emit_step = self._step
            return
        if (self._step - self._last_emit_step) >= self.log_every:
            self._emit(now)

    def _window_loss(self):
        """Mean of the buffered window losses. The device→host reads happen
        here, once per emission window — by now the async dispatches have
        long completed, so this is a copy, not a pipeline sync (same cost
        profile as the old single-loss read)."""
        vals = []
        for loss in self._pending_losses:
            try:
                vals.append(float(loss))
            except (TypeError, ValueError, RuntimeError):
                pass
        self._pending_losses.clear()
        return sum(vals) / len(vals) if vals else None

    def _emit(self, now):
        steps = self._step - self._last_emit_step
        dt = now - self._last_emit_t
        if steps <= 0 or dt <= 0:
            return
        step_time = dt / steps
        record = {"step": self._step, "step_time_s": round(step_time, 6)}
        loss = self._window_loss()
        if loss is not None:
            record["loss"] = loss
        if self.tokens_per_step:
            tps = self.tokens_per_step / step_time
            record["tokens_per_sec"] = round(tps, 2)
            if self.flops_per_token and self.peak_flops:
                record["mfu"] = round(self.flops_per_token * tps / self.peak_flops, 4)
        mem = device_peak_memory()
        if mem:
            record["peak_memory_bytes"] = mem
        faults = counters.snapshot("fault.")
        if faults:  # only present when something actually failed/retried
            record["faults"] = faults
        self._intervals.append((steps, dt))
        self._last_emit_t = now
        self._last_emit_step = self._step
        for fn in self._subs:
            try:
                fn(record)
            except Exception:  # a broken sink must not kill training
                logger.exception("metrics subscriber failed")

    def summary(self):
        """Aggregate over all post-warmup emissions: steps/sec, tokens/sec, MFU."""
        total_steps = sum(s for s, _ in self._intervals)
        total_dt = sum(d for _, d in self._intervals)
        if not total_steps or not total_dt:
            return {}
        step_time = total_dt / total_steps
        out = {"steps": total_steps, "step_time_s": step_time}
        if self.tokens_per_step:
            out["tokens_per_sec"] = self.tokens_per_step / step_time
            if self.flops_per_token and self.peak_flops:
                out["mfu"] = self.flops_per_token * out["tokens_per_sec"] / self.peak_flops
        return out


def stdout_logger(prefix="step"):
    """A subscriber that logs each record as ``<prefix> k=v ...`` through
    the ``paddle_tpu_torch.metrics`` logger."""
    def fn(record):
        parts = " ".join(f"{k}={v}" for k, v in record.items())
        logger.info("%s %s", prefix, parts)

    return fn


class JsonlWriter(JsonlSpanSink):
    """Structured per-rank metrics log: one JSON record a line, the span
    sink's implementation (every record flushed, an idempotent close at
    exit or through the context-manager protocol, writes after the close
    dropped)."""
