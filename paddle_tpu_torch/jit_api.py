"""One training step (counterpart of ``paddle_tpu/jit_api.py::TrainStep``
:158).

The reference traces forward, backward and the optimizer into one XLA
program; the port runs them eagerly on the card: forward and ``loss_fn``
through the model (the flash kernels inside), ``loss.backward()``, one
launch of the gradient-norm kernel over every gradient
(``ops.grad_norm``: the finite check, the loss scaler's unscale, the
global-norm clip's factor and the dynamics' group sums, in one buffer),
one host read of the skip flag, then the optimizer's update one parameter
at a time (the AdamW kernel takes the scale and the clip factor from the
device and applies them in registers). The reference's rounding points
(:328-366) are kept: ``g / scale`` in f32, the finite check on those
gradients, the clip on them, the cast to the updated weight's dtype.
The operator plane's hooks are the reference's (:241-245, :499-509,
:542-548, :651-654): construction registers with the hang watchdog
(``watchdog.arm_from_env``), every call beats (``watchdog.maybe_beat``,
which also publishes the fleet snapshot on its cadence) and ticks the
flight recorder's profiler capture (``flightrec.maybe_capture_step``,
counting the n steps of ``run_steps``), and the guard's check commits a
``nonfinite`` flight-record bundle, with the dynamics' provenance, when it
finds new skips. Device profiling, the compile ledger and ``run_steps`` as
one captured program come in a later slice of the port (ROADMAP.md).
Under ``FLAGS_check_nan_inf`` a step runs unchecked, as the reference's
compiled program does (``framework.nan_inf``).
"""
import math

import numpy as np
import torch

from .device import resolve
from .framework.nan_inf import suspended as _unchecked
from .utils.envs import env_int
from .nn.clip import ClipGradByGlobalNorm
from .observability import flightrec as _flightrec
from .observability import watchdog as _watchdog
from .observability.dynamics import DynamicsMonitor
from .observability.metrics import registry as _registry
from .ops.adamw import UpdateNorms, transform_grad
from .ops.grad_norm import grad_sumsq

#: consecutive non-finite (NaN/Inf loss or grads) steps tolerated before the
#: guard raises NonFiniteLossError; <= 0 turns the guard off (reference
#: jit_api.py:28-30)
NONFINITE_TOLERANCE_ENV = "PADDLE_NONFINITE_TOLERANCE"
#: the host checks the guard's counters every this many dispatches;
#: default max(tolerance, 16) (reference :31-33)
NONFINITE_CHECK_ENV = "PADDLE_NONFINITE_CHECK_EVERY"


class NonFiniteLossError(FloatingPointError):
    """The loss or the gradients were NaN/Inf for ``tolerance`` consecutive
    steps; every one of those updates was skipped, so the weights hold the
    last finite step's values."""


class TrainStep:
    """``TrainStep(model, loss_fn, optimizer)(*batch)`` runs one step and
    returns the loss tensor on the device.

    - ``batch`` is the model's inputs followed by ``n_labels`` labels
      (numpy arrays or tensors); ``loss_fn(*model_outputs, *labels)``;
    - ``accumulate_steps=k`` splits every batch array whose leading dim is
      the batch's (and divisible by k) into k micro-batches, runs forward
      and backward on each, sums the gradients in f32 and averages them,
      and makes one update (reference :286-327); the loss is the mean of
      the micro-batches' losses in f32;
    - ``scaler`` (``amp.GradScaler``): the backward is seeded with the
      loss scale, the gradients are divided by it, a non-finite gradient
      skips the update, and the scale moves by the scaler's state machine
      on the device (reference :328-352);
    - the optimizer's ``grad_clip`` runs on the unscaled gradients
      (:360-363); the lr is ``optimizer.get_lr()`` before the update, and
      a scheduler steps after every call, skipped or not (:645-647);
    - the non-finite guard (default on without a scaler, off with one, as
      the reference's; off with ``PADDLE_NONFINITE_TOLERANCE`` <= 0): a
      NaN or Inf in the loss or in any gradient skips the whole update
      (weights, optimizer slots and its step count hold) and counts it in
      ``nonfinite`` {"consec", "total"}. As in the reference (:512-566),
      the counters are checked every ``PADDLE_NONFINITE_CHECK_EVERY``
      dispatches (default max(tolerance, 16); after ``run_steps``
      always): the check adds the new skips to ``train.nonfinite_skips``
      and raises NonFiniteLossError once ``consec`` has reached
      ``PADDLE_NONFINITE_TOLERANCE`` (default 3). The update's skip itself
      is read every step (the optimizer counts its steps on the host);
    - ``metrics_bus`` (``utils.metrics_bus.StepMetricsBus``) gets
      ``on_step(loss=...)`` after every call (:655-660);
    - ``PADDLE_DYNAMICS=1`` attaches a ``DynamicsMonitor`` (:232): its
      carry moves every step and spills on its cadence (:576-596);
    - with ``PADDLE_TELEMETRY_DIR`` set, the step beats
      ``heartbeat.<rank>.json`` there (phase "init" at construction, then
      the step count) and commits flight-record bundles under
      ``flight/``; an armed ``flightrec.arm_capture(k)`` traces the next k
      steps with ``torch.profiler``.

    ``device`` (default "cuda") is where the batch goes and where the
    model's parameters must already be; without CUDA it raises unless
    ``device="cpu"``."""

    def __init__(self, model, loss_fn, optimizer, n_labels=1, scaler=None,
                 metrics_bus=None, accumulate_steps=1, nonfinite_guard=None,
                 device="cuda"):
        self.device = resolve(device)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.n_labels = n_labels
        self.scaler = scaler
        self.metrics_bus = metrics_bus
        self.accumulate_steps = int(accumulate_steps)
        if self.accumulate_steps < 1:
            raise ValueError(
                f"accumulate_steps must be >= 1, got {accumulate_steps}")
        self._trainable = {k: p for k, p in model.named_parameters()
                           if p.requires_grad}
        for name, p in self._trainable.items():
            if p.device.type != self.device.type:
                raise ValueError(
                    f"TrainStep on {self.device}: parameter {name} is on "
                    f"{p.device}")
        optimizer.init_state(self._trainable)
        self._scaler_state = (scaler.init_state(self.device)
                              if scaler is not None else None)
        self._nf_tolerance = env_int(NONFINITE_TOLERANCE_ENV, 3)
        on = (scaler is None if nonfinite_guard is None
              else bool(nonfinite_guard))
        self.nonfinite = ({"consec": 0, "total": 0}
                          if on and self._nf_tolerance > 0 else None)
        self._nf_check_every = max(1, env_int(
            NONFINITE_CHECK_ENV, max(self._nf_tolerance, 16)))
        self._nf_reported = 0     # skips already added to the registry
        self._nf_since_check = 0  # dispatches since the last check
        self._dynamics = dyn = DynamicsMonitor.from_env(self._trainable)
        self._dyn_state = dyn.init_state(self.device) if dyn else None
        self._group = (dict(zip(self._trainable, dyn.group_index))
                       if dyn else None)
        self._dyn_since_check = 0
        self._norms = None
        self._calls = 0
        #: the last step's gradient-norm kernel output (None when the step
        #: needed none) and whether it skipped the update
        self.last_stats = None
        self.last_skipped = False
        # register with the hang watchdog before the first step: a rank
        # that wedges in its first kernel build or step must still be
        # diagnosable (the init beat gets the longer startup deadline)
        _watchdog.arm_from_env()

    def _tensor(self, b):
        t = torch.from_numpy(np.asarray(b)) if not isinstance(
            b, torch.Tensor) else b
        return t.to(self.device)

    def _forward_backward(self, batch, scale):
        n = self.n_labels
        inputs = batch[:-n] if n else batch
        labels = batch[-n:] if n else ()
        out = self.model(*inputs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        loss = self.loss_fn(*outs, *labels)
        if scale is None:
            loss.backward()
        else:
            # seed the cotangent with the loss scale (reference :272-274)
            loss.backward((torch.ones_like(loss) * scale).to(loss.dtype))
        return loss.detach()

    def _grads(self):
        grads = {k: p.grad for k, p in self._trainable.items()}
        for p in self._trainable.values():
            p.grad = None
        return grads

    def _accumulated(self, batch, scale):
        k = self.accumulate_steps
        bdim = batch[0].shape[0] if batch and batch[0].dim() else 0
        split = [b.dim() >= 1 and b.shape[0] == bdim and bdim % k == 0
                 for b in batch]
        if not any(split):
            raise ValueError(f"accumulate_steps={k}: no batch array with "
                             f"leading dim divisible by {k}")
        gsum, loss_sum = {}, torch.zeros((), device=self.device)
        for i in range(k):
            micro = tuple(b.chunk(k)[i] if s else b
                          for b, s in zip(batch, split))
            loss_sum += self._forward_backward(micro, scale).float()
            for name, g in self._grads().items():
                if g is None:
                    continue
                if name in gsum:
                    gsum[name] += g.float()
                else:
                    gsum[name] = g.float()
        return loss_sum / k, {n: g / k for n, g in gsum.items()}

    # -- the gradient checks: one kernel launch, one host read --------------
    def _global_clip(self):
        clip = self.optimizer._grad_clip
        return clip if isinstance(clip, ClipGradByGlobalNorm) else None

    def _stats(self, grads, scale):
        """The gradient-norm kernel over every gradient, or None when the
        step needs none of its outputs."""
        clip = self._global_clip()
        if (self.nonfinite is None and self.scaler is None and clip is None
                and self._dynamics is None):
            return None
        names = [k for k, g in grads.items() if g is not None]
        dyn = self._dynamics
        return grad_sumsq(
            [grads[k] for k in names], scale=scale,
            clip_norm=clip.clip_norm if clip is not None else None,
            groups=[self._group[k] for k in names] if dyn else None,
            n_groups=len(dyn.group_names) if dyn else 0)

    def _skip(self, loss, stats):
        """Decide the skip (one host read) and move the scaler's state and
        the guard's counters (reference :331-354)."""
        if stats is None:
            return False
        finite = stats.any_nonfinite == 0
        flags = []
        if self.scaler is not None:
            self._scaler_state = self.scaler.update_state(self._scaler_state,
                                                          finite)
            flags.append(~finite)
        if self.nonfinite is not None:
            flags.append(~(finite & torch.isfinite(loss.float()).all()))
        if not flags:
            return False
        read = torch.stack(flags).tolist()
        if self.nonfinite is not None:
            nf_skip = read[-1]
            nf = self.nonfinite
            nf["consec"] = nf["consec"] + 1 if nf_skip else 0
            nf["total"] += int(nf_skip)
        return any(read)

    def _update_norms(self):
        if self._norms is None:
            self._norms = UpdateNorms(self._trainable.values(),
                                      self._dynamics.group_index,
                                      len(self._dynamics.group_names))
        return self._norms

    def _step(self, batch, lr=None):
        """Forward, backward, checks and update; returns the loss."""
        batch = tuple(self._tensor(b) for b in batch)
        self.model.train()
        for p in self._trainable.values():
            p.grad = None
        scale = (self._scaler_state["scale"] if self.scaler is not None
                 else None)
        if self.accumulate_steps == 1:
            loss = self._forward_backward(batch, scale)
            grads = self._grads()
        else:
            loss, grads = self._accumulated(batch, scale)
        stats = self._stats(grads, scale)
        skip = self._skip(loss, stats)
        clip, factor = self.optimizer._grad_clip, None
        if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
            # a per-tensor clip runs on the unscaled gradients in plain
            # PyTorch; the update then takes them as they are
            pairs = clip([(p, None if grads.get(k) is None
                           else transform_grad(grads[k], scale))
                          for k, p in self._trainable.items()])
            scale = None
        else:
            pairs = [(p, grads.get(k)) for k, p in self._trainable.items()]
            if clip is not None:
                factor = stats.factor
        dyn = self._dynamics
        norms = self._update_norms() if dyn is not None and not skip \
            else None
        if norms is not None:
            norms.begin()
        self.optimizer.apply_gradients(pairs, skip_update=skip, scale=scale,
                                       factor=factor, norms=norms, lr=lr)
        del grads, pairs
        if dyn is not None:
            self._dynamics_update(loss, stats, norms)
        self.last_stats, self.last_skipped = stats, skip
        return loss

    def _dynamics_update(self, loss, stats, norms):
        """Move the dynamics carry: the gradients' group sums from this
        step's kernel output; the parameters' and the update's from the
        update kernels' epilogue, or on a skipped step from one
        gradient-norm launch over the parameters (no update)."""
        dyn = self._dynamics
        n, g = len(self._trainable), len(dyn.group_names)
        if norms is not None:
            out = norms.reduce()
            psq, usq = out[0, n:n + g], out[1, n:n + g]
        else:
            psq = grad_sumsq(list(self._trainable.values()),
                             groups=dyn.group_index, n_groups=g).group_sums
            usq = torch.zeros_like(psq)
        self._dyn_state = dyn.update(self._dyn_state, loss, stats.group_sums,
                                     stats.group_nonfinite, psq, usq)

    def _after(self, loss, batch, ticks=1):
        """The host epilogue of ``ticks`` steps (reference :642-660): the
        scheduler, the guard's tolerance, the dynamics spill and, after a
        single step (``batch`` given), the bus."""
        sched = self.optimizer._learning_rate_scheduler
        for _ in range(ticks):
            if sched is not None:
                sched.step()
        _watchdog.maybe_beat(self._calls)
        # one dispatch covered the n steps of run_steps: always checked
        self._nf_check(force=batch is None)
        self._dyn_check(n=ticks)
        # the capture counts train steps: run_steps' call burns n
        _flightrec.maybe_capture_step(self._calls, n=ticks)
        bus = self.metrics_bus
        if bus is not None and batch is not None:
            if bus.tokens_per_step is None and batch:
                bus.tokens_per_step = int(math.prod(np.shape(batch[0])))
            bus.on_step(loss=loss)

    def _nf_check(self, force=False):
        """The guard's host check, once per ``_nf_check_every`` dispatches
        (reference :512-566): the new skips go to ``train.nonfinite_skips``,
        and ``consec`` at the tolerance raises NonFiniteLossError."""
        nf = self.nonfinite
        if nf is None:
            return
        self._nf_since_check += 1
        if not force and self._nf_since_check < self._nf_check_every:
            return
        self._nf_since_check = 0
        consec, total = self._nf_read()
        prov = None
        if total > self._nf_reported:
            _registry.counter("train.nonfinite_skips").inc(
                total - self._nf_reported)
            self._nf_reported = total
            # the dynamics carry knows which layer group went NaN/Inf
            # first: the bundle carries it (rate-limited, so a skip storm
            # commits one bundle a window)
            prov = self._nf_provenance()
            _flightrec.record(
                "nonfinite", step=self._calls,
                payload={"skips_total": total, "consecutive": consec,
                         "tolerance": self._nf_tolerance,
                         "provenance": prov})
        if consec < self._nf_tolerance:
            return
        if prov is None:
            prov = self._nf_provenance()
        where = ""
        if prov:
            where = (f"; first non-finite gradients in layer group(s) "
                     f"{', '.join(prov['first_groups']) or '<loss>'} "
                     f"at update {prov['first_update']}")
        raise NonFiniteLossError(
            f"loss/grads non-finite for {consec} consecutive steps "
            f"(tolerance {self._nf_tolerance}, {total} skipped updates in "
            f"all){where}; every skipped update left the weights untouched: "
            f"lower the learning rate, check the data, or raise "
            f"{NONFINITE_TOLERANCE_ENV}")

    def _nf_provenance(self):
        """The dynamics' first-non-finite record (None without dynamics or
        while everything stayed finite)."""
        if self._dynamics is None:
            return None
        return self._dynamics.provenance(self._dyn_state)

    def _nf_read(self):
        """The guard's counters (consec, total) as the check reads them."""
        return self.nonfinite["consec"], self.nonfinite["total"]

    def _dyn_check(self, force=False, n=1):
        """Spill the dynamics carry once per ``every`` steps (the read
        synchronises on the step, so it is cadence-gated)."""
        if self._dynamics is None:
            return
        self._dyn_since_check += n
        if not force and self._dyn_since_check < self._dynamics.every:
            return
        self._dyn_since_check = 0
        self._dynamics.spill(self._dyn_state, step=self._calls)
        self._dyn_state = self._dynamics.reset_window(self._dyn_state)

    @_unchecked()
    def __call__(self, *batch):
        loss = self._step(batch)
        self._calls += 1
        self._after(loss, batch)
        return loss

    @_unchecked()
    def run_steps(self, *batch, n, stacked=False):
        """n steps; with ``stacked`` each batch array carries a leading [n]
        dim, one batch per step, else the same batch every step. As the
        reference's one dispatch does (:483-510), the n steps share the lr
        read before the first, and a scheduler then steps n times. Returns
        the [n] losses on the device. The metrics bus is not told, as the
        reference's ``run_steps`` does not tell it."""
        if stacked:
            for b in batch:
                if np.shape(b)[0] != n:
                    raise ValueError(f"stacked run_steps: leading dim "
                                     f"{np.shape(b)[0]} != n={n}")
        lr = self.optimizer.get_lr()
        losses = []
        for i in range(n):
            step_batch = tuple(b[i] for b in batch) if stacked else batch
            losses.append(self._step(step_batch, lr=lr))
            self._calls += 1
        self._after(losses[-1], None, ticks=n)
        return torch.stack(losses)
