"""Training-dynamics telemetry (counterpart of
``paddle_tpu/observability/dynamics.py``).

A small fixed-shape carry of torch tensors on the device, updated every
step and spilled to the host on a cadence, so a diverging run is visible,
and attributable to a layer group, before the loss chart goes bad:

- per-layer-group gradient norms (squared, f32): the gradient-norm kernel's
  group sums (``ops.grad_norm``), over the unscaled, unclipped gradients;
- per-group parameter and update norms: the AdamW kernel's epilogue sums
  p_old^2 and (p_new - p_old)^2 over the stored parameter
  (``ops.adamw.UpdateNorms``; on a skipped step the gradient-norm kernel
  over the parameters, and no update);
- loss EWMA, variance EWMA and spike z-score;
- non-finite provenance: which groups' gradients were NaN/Inf this step,
  and the latched first occurrence.

Groups come from :func:`group_of` (``llama.layers.3.self_attn.q_proj
.weight`` -> ``layers.3``), at most ``PADDLE_DYNAMICS_MAX_GROUPS`` (the
rest collapse into ``other``). The carry's update semantics are the
reference's (:219-297). Disabled (``PADDLE_DYNAMICS`` unset),
``DynamicsMonitor.from_env`` returns None and the step pays one None
check. Enabled, between spills the host side is one counter increment;
a spill (every ``PADDLE_DYNAMICS_EVERY_STEPS`` steps) reads the carry back
once and publishes the ``train.*`` gauges; a spike past the threshold
commits a ``loss_spike`` flight-record bundle. Live monitors are listed
for ``/dynamicsz`` (:func:`reports`), the flight recorder's bundles
(:func:`flight_block`) and the fleet snapshot (:func:`fleet_block`).
"""
import collections
import math
import re
import threading
import time
import weakref

import torch

from ..device import resolve
from ..utils.envs import env_bool, env_float, env_int
from .metrics import registry as _registry

__all__ = ["DynamicsMonitor", "group_of", "monitors", "reports",
           "flight_block", "fleet_block", "ENABLE_ENV", "EVERY_ENV",
           "SPIKE_Z_ENV", "EWMA_ENV", "MAX_GROUPS_ENV", "WINDOW_ENV"]

#: master switch: unset or false, the whole layer is one None check
ENABLE_ENV = "PADDLE_DYNAMICS"
#: host spill cadence in steps: at most one device read per window
EVERY_ENV = "PADDLE_DYNAMICS_EVERY_STEPS"
#: EWMA decay for the loss mean/variance trackers
EWMA_ENV = "PADDLE_DYNAMICS_EWMA"
#: |z| past this counts a loss spike (<= 0 disables)
SPIKE_Z_ENV = "PADDLE_DYNAMICS_SPIKE_Z"
#: layer-group cap: overflow groups collapse into 'other'
MAX_GROUPS_ENV = "PADDLE_DYNAMICS_MAX_GROUPS"
#: host-side summary ring length
WINDOW_ENV = "PADDLE_DYNAMICS_WINDOW"

#: repeated-block param names: the numbered block IS the layer group
_LAYER_RE = re.compile(
    r"(?:^|\.)((?:layers|layer|blocks|h|stages|encoder_layers|"
    r"decoder_layers)\.\d+)(?=\.|$)")

#: live monitors, for /dynamicsz and the fleet snapshot block: weak, so a
#: dropped TrainStep takes its monitor out of the listing
_monitors = weakref.WeakValueDictionary()
_monitors_lock = threading.Lock()
_monitor_seq = 0


def group_of(name):
    """Layer group for a parameter name: the numbered transformer block
    (``layers.3``) when one appears in the dotted path, else the first
    dotted component (``embed_tokens``, ``lm_head``), else ``root``."""
    m = _LAYER_RE.search(name)
    if m:
        return m.group(1)
    head = name.split(".", 1)[0]
    return head or "root"


def monitors():
    """Live monitors, oldest first (usually exactly one per process)."""
    with _monitors_lock:
        return [m for _, m in sorted(_monitors.items())]


def reports():
    """The /dynamicsz monitor payloads."""
    return [m.report() for m in monitors()]


def flight_block():
    """The flight-record payload: per-monitor group list, last summary and
    the recent spill window."""
    out = []
    for m in monitors():
        out.append({
            "groups": list(m.group_names),
            "every": m.every,
            "last": m.last,
            "window": m.window_list(),
        })
    return out


def fleet_block():
    """The per-rank fleet-snapshot block (bounded: the newest monitor's
    last spilled summary only), what the aggregator reads to flag
    cross-rank grad-norm skew. None when nothing has spilled."""
    ms = monitors()
    for m in reversed(ms):
        if m.last is not None:
            return dict(m.last)
    return None


class DynamicsMonitor:
    """One TrainStep's dynamics instrumentation: the static group mapping,
    the carry's update on the device, and the cadence-gated host spill."""

    def __init__(self, named_params, every=None, ewma=None, spike_z=None,
                 max_groups=None, window=None):
        max_groups = (int(max_groups) if max_groups is not None
                      else env_int(MAX_GROUPS_ENV, 64))
        groups = {}
        for name in named_params:
            groups.setdefault(group_of(name), []).append(name)
        names = sorted(groups)
        if len(names) > max_groups:
            kept, spill = names[:max_groups - 1], names[max_groups - 1:]
            other = []
            for g in spill:
                other.extend(groups.pop(g))
            groups["other"] = other
            names = kept + ["other"]
        #: group names, index-aligned with every f32[G] carry vector
        self.group_names = tuple(names)
        self._group_members = tuple(tuple(groups[g]) for g in names)
        index = {n: i for i, members in enumerate(self._group_members)
                 for n in members}
        #: group index of each parameter, in ``named_params`` order
        self.group_index = [index[n] for n in named_params]
        self.every = max(1, every if every is not None
                         else env_int(EVERY_ENV, 32))
        self.ewma = float(ewma if ewma is not None
                          else env_float(EWMA_ENV, 0.1))
        self.spike_z = float(spike_z if spike_z is not None
                             else env_float(SPIKE_Z_ENV, 6.0))
        window = (int(window) if window is not None
                  else env_int(WINDOW_ENV, 32))
        #: recent spill summaries; all access goes through _win_lock
        self.window = collections.deque(maxlen=max(1, window))
        self._win_lock = threading.Lock()
        #: the newest spilled summary (None until the first spill)
        self.last = None
        global _monitor_seq
        with _monitors_lock:
            _monitor_seq += 1
            _monitors[_monitor_seq] = self

    @classmethod
    def from_env(cls, named_params):
        """The TrainStep hook: a monitor when ``PADDLE_DYNAMICS`` is
        truthy, else None, and None means the step carries nothing."""
        if not env_bool(ENABLE_ENV):
            return None
        return cls(named_params)

    # ---- device side -------------------------------------------------------
    def init_state(self, device="cuda"):
        """The carry: fixed-shape f32/int32 tensors on ``device`` (default
        the card; raises without CUDA unless given ``device="cpu"``)."""
        device = resolve(device)
        g = len(self.group_names)

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=device)

        f32, i32 = torch.float32, torch.int32
        return {
            "count": full((), 0, i32),
            "loss_ewma": full((), 0.0, f32),
            "loss_var": full((), 0.0, f32),
            "loss_z": full((), 0.0, f32),
            # max-z latch since the last spill window reset
            "z_max": full((), -math.inf, f32),
            "z_max_at": full((), -1, i32),
            "last_loss": full((), 0.0, f32),
            "grad_sq": full((g,), 0.0, f32),
            "param_sq": full((g,), 0.0, f32),
            "upd_sq": full((g,), 0.0, f32),
            "nf_mask": full((g,), 0, i32),
            "nf_first_mask": full((g,), 0, i32),
            "nf_first_step": full((), -1, i32),
            "nf_steps": full((), 0, i32),
        }

    def update(self, st, loss, grad_sq, grad_nonfinite, param_sq, upd_sq):
        """The next carry (reference :219-297) from this step's loss and
        the per-group sums: ``grad_sq`` and ``grad_nonfinite`` (int) over
        the unscaled, unclipped gradients; ``param_sq`` and ``upd_sq`` over
        the stored parameters before the update and the update's change
        (zero on a skipped step)."""
        f32, i32 = torch.float32, torch.int32
        loss32 = loss.detach().to(f32).reshape(())
        loss_ok = torch.isfinite(loss32)
        nf_mask = (grad_nonfinite != 0).to(i32)
        nf_any = (~loss_ok) | (nf_mask != 0).any()
        newly = (st["nf_first_step"] < 0) & nf_any
        count = st["count"]
        # a fill on the device: a copy from the host would wait for the
        # stream
        a = torch.full((), self.ewma, dtype=f32, device=loss32.device)
        prev_mean, prev_var = st["loss_ewma"], st["loss_var"]
        delta = loss32 - prev_mean
        zero = torch.zeros((), dtype=f32, device=loss32.device)
        # z of this step's loss against the pre-update trackers; 0 until
        # the variance tracker has something to divide by, and for a
        # non-finite loss
        z = torch.where((count > 0) & (prev_var > 0) & loss_ok,
                        delta / torch.sqrt(prev_var + 1e-12), zero)
        # non-finite losses never enter the trackers
        new_mean = torch.where(
            loss_ok, torch.where(count == 0, loss32, prev_mean + a * delta),
            prev_mean)
        new_var = torch.where(loss_ok & (count > 0),
                              (1 - a) * (prev_var + a * delta * delta),
                              prev_var)
        z_hit = z > st["z_max"]
        return {
            "count": count + 1,
            "loss_ewma": new_mean,
            "loss_var": new_var,
            "loss_z": z,
            "z_max": torch.maximum(z, st["z_max"]),
            "z_max_at": torch.where(z_hit, count, st["z_max_at"]).to(i32),
            "last_loss": loss32,
            "grad_sq": grad_sq.to(f32),
            "param_sq": param_sq.to(f32),
            "upd_sq": upd_sq.to(f32),
            "nf_mask": nf_mask,
            "nf_first_mask": torch.where(newly, nf_mask,
                                         st["nf_first_mask"]),
            "nf_first_step": torch.where(newly, count,
                                         st["nf_first_step"]).to(i32),
            "nf_steps": st["nf_steps"] + nf_any.to(i32),
        }

    # ---- host side ---------------------------------------------------------
    @staticmethod
    def _get(state):
        return {k: v.cpu() for k, v in state.items()}

    def summarize(self, state, step=None):
        """One host read of the carry distilled into a plain dict. Does
        not publish: :meth:`spill` does."""
        if state is None:
            return None
        st = self._get(state)
        grad_sq = [float(v) for v in st["grad_sq"]]
        param_sq = [float(v) for v in st["param_sq"]]
        upd_sq = [float(v) for v in st["upd_sq"]]
        eps = 1e-20
        groups = {}
        for i, name in enumerate(self.group_names):
            groups[name] = {
                "grad_norm": round(math.sqrt(max(grad_sq[i], 0.0)), 8),
                "param_norm": round(math.sqrt(max(param_sq[i], 0.0)), 8),
                "update_ratio": round(
                    math.sqrt(max(upd_sq[i], 0.0)
                              / max(param_sq[i], eps)), 10),
            }
        nf_first_step = int(st["nf_first_step"])
        z_max = float(st["z_max"])
        return {
            "step": int(step) if step is not None else int(st["count"]),
            "updates": int(st["count"]),
            "time": time.time(),
            "loss": float(st["last_loss"]),
            "loss_ewma": float(st["loss_ewma"]),
            "loss_z": float(st["loss_z"]),
            "loss_z_max": z_max if math.isfinite(z_max) else None,
            "loss_z_max_at": int(st["z_max_at"]),
            "grad_norm": round(math.sqrt(max(sum(grad_sq), 0.0)), 8),
            "groups": groups,
            "grad_sq": grad_sq,
            "param_sq": param_sq,
            "upd_sq": upd_sq,
            "nonfinite_steps": int(st["nf_steps"]),
            "nonfinite_groups": [self.group_names[i]
                                 for i, v in enumerate(st["nf_mask"]) if v],
            "nonfinite_first": None if nf_first_step < 0 else {
                "update": nf_first_step,
                "groups": [self.group_names[i]
                           for i, v in enumerate(st["nf_first_mask"]) if v],
            },
        }

    def provenance(self, state):
        """The latched first-non-finite record (None while everything has
        stayed finite): which group(s) went NaN/Inf first, at which update,
        and the current mask."""
        if state is None:
            return None
        st = self._get({k: state[k] for k in
                        ("nf_first_mask", "nf_first_step", "nf_mask",
                         "nf_steps")})
        if int(st["nf_first_step"]) < 0:
            return None
        return {
            "first_update": int(st["nf_first_step"]),
            "first_groups": [self.group_names[i]
                             for i, v in enumerate(st["nf_first_mask"])
                             if v],
            "current_groups": [self.group_names[i]
                               for i, v in enumerate(st["nf_mask"]) if v],
            "nonfinite_steps": int(st["nf_steps"]),
        }

    def spill(self, state, step=None):
        """The cadence hook: read the carry once, publish the gauges,
        append to the window ring, and count a loss spike when the
        window's largest z crosses the threshold. Returns the summary."""
        t0 = time.perf_counter()
        summary = self.summarize(state, step=step)
        if summary is None:
            return None
        _registry.gauge(
            "train.grad_norm",
            help="global gradient norm at the last dynamics spill"
        ).set(summary["grad_norm"])
        _registry.gauge(
            "train.loss_spike_z",
            help="loss z-score vs the EWMA trackers"
        ).set(round(summary["loss_z"], 6))
        for name, g in summary["groups"].items():
            labels = {"group": name}
            _registry.gauge(
                "train.grad_norm", labels=labels,
                help="per-layer-group gradient norm at the last "
                     "dynamics spill"
            ).set(g["grad_norm"])
            _registry.gauge(
                "train.param_norm", labels=labels,
                help="per-layer-group parameter norm"
            ).set(g["param_norm"])
            _registry.gauge(
                "train.update_ratio", labels=labels,
                help="per-layer-group ||delta_w|| / ||w|| at the last spill"
            ).set(g["update_ratio"])
        with self._win_lock:
            self.window.append(summary)
        self.last = summary
        # one-sided: a spike is the loss jumping up, read from the
        # window's max-z latch (reset_window re-arms it)
        z_trip = summary["loss_z_max"]
        if (self.spike_z > 0 and z_trip is not None
                and z_trip >= self.spike_z):
            _registry.counter(
                "train.loss_spikes",
                help="dynamics spills whose loss z-score crossed the "
                     "spike threshold").inc()
            from . import flightrec

            flightrec.record(
                "loss_spike", step=summary["step"],
                payload={"loss": summary["loss"],
                         "loss_ewma": summary["loss_ewma"],
                         "loss_z": summary["loss_z"],
                         "loss_z_max": z_trip,
                         "loss_z_max_at": summary["loss_z_max_at"],
                         "threshold": self.spike_z})
        _registry.histogram(
            "dynamics.spill_s",
            help="wall cost of one dynamics host spill (device read + "
                 "gauge publish)").observe(time.perf_counter() - t0)
        return summary

    def reset_window(self, state):
        """Re-arm the per-window max-z latch after a spill."""
        if state is None:
            return None
        st = dict(state)
        dev = st["z_max"].device
        st["z_max"] = torch.full((), -math.inf, dtype=torch.float32,
                                 device=dev)
        st["z_max_at"] = torch.full((), -1, dtype=torch.int32, device=dev)
        return st

    def window_list(self):
        """Snapshot of the spill window, safe from any thread."""
        with self._win_lock:
            return list(self.window)

    def report(self):
        """This monitor's state for a status page."""
        return {
            "enabled": True,
            "every": self.every,
            "ewma": self.ewma,
            "spike_z": self.spike_z,
            "groups": list(self.group_names),
            "group_sizes": [len(m) for m in self._group_members],
            "last": self.last,
            "window": self.window_list(),
        }
