"""One training step (counterpart of ``paddle_tpu/jit_api.py::TrainStep``
:158).

The reference traces forward, backward and the optimizer into one XLA
program; the port runs them eagerly on the card: forward and ``loss_fn``
through the model (the flash kernels inside), ``loss.backward()``, then the
optimizer's update one parameter at a time. Grad clipping, the AMP loss
scaler, dynamics telemetry, the watchdog, device profiling, the compile
ledger and ``run_steps`` as one captured program come in a later slice of
the port (see ROADMAP.md).
"""
import numpy as np
import torch

from .device import resolve


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
    - the non-finite guard (on unless ``nonfinite_guard=False``): a NaN or
      Inf in the loss or in any gradient skips the whole update (weights,
      optimizer slots and its step count hold) and counts it in
      ``nonfinite`` {"consec", "total"}; after ``nonfinite_tolerance``
      consecutive skips the step raises NonFiniteLossError. The check reads
      one flag back from the card per step.

    ``device`` (default "cuda") is where the batch goes and where the
    model's parameters must already be; without CUDA it raises unless
    ``device="cpu"``."""

    def __init__(self, model, loss_fn, optimizer, n_labels=1,
                 accumulate_steps=1, nonfinite_guard=None,
                 nonfinite_tolerance=3, device="cuda"):
        self.device = resolve(device)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.n_labels = n_labels
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
        on = nonfinite_guard is None or bool(nonfinite_guard)
        self._nf_tolerance = int(nonfinite_tolerance)
        self.nonfinite = ({"consec": 0, "total": 0}
                          if on and self._nf_tolerance > 0 else None)

    def _tensor(self, b):
        t = torch.from_numpy(np.asarray(b)) if not isinstance(
            b, torch.Tensor) else b
        return t.to(self.device)

    def _forward_backward(self, batch):
        n = self.n_labels
        inputs = batch[:-n] if n else batch
        labels = batch[-n:] if n else ()
        out = self.model(*inputs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        loss = self.loss_fn(*outs, *labels)
        loss.backward()
        return loss.detach()

    def _grads(self):
        grads = {k: p.grad for k, p in self._trainable.items()}
        for p in self._trainable.values():
            p.grad = None
        return grads

    def _accumulated(self, batch):
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
            loss_sum += self._forward_backward(micro).float()
            for name, g in self._grads().items():
                if g is None:
                    continue
                if name in gsum:
                    gsum[name] += g.float()
                else:
                    gsum[name] = g.float()
        return loss_sum / k, {n: g / k for n, g in gsum.items()}

    def _skip(self, loss, grads):
        """The non-finite guard: True when this update must be skipped."""
        if self.nonfinite is None:
            return False
        flags = [torch.isfinite(loss).all()] + [
            torch.isfinite(g).all() for g in grads.values() if g is not None]
        skip = not bool(torch.stack(flags).all())
        nf = self.nonfinite
        nf["consec"] = nf["consec"] + 1 if skip else 0
        nf["total"] += int(skip)
        return skip

    def __call__(self, *batch):
        batch = tuple(self._tensor(b) for b in batch)
        self.model.train()
        for p in self._trainable.values():
            p.grad = None
        if self.accumulate_steps == 1:
            loss = self._forward_backward(batch)
            grads = self._grads()
        else:
            loss, grads = self._accumulated(batch)
        skip = self._skip(loss, grads)
        self.optimizer.apply_gradients(
            [(p, grads.get(k)) for k, p in self._trainable.items()],
            skip_update=skip)
        del grads
        nf = self.nonfinite
        if nf is not None and nf["consec"] >= self._nf_tolerance:
            raise NonFiniteLossError(
                f"loss/grads non-finite for {nf['consec']} consecutive steps "
                f"(tolerance {self._nf_tolerance}, {nf['total']} skipped "
                "updates in all); every skipped update left the weights "
                "untouched: lower the learning rate or check the data")
        return loss

    def run_steps(self, *batch, n, stacked=False):
        """n steps; with ``stacked`` each batch array carries a leading [n]
        dim, one batch per step, else the same batch every step. Returns
        the [n] losses on the device."""
        if stacked:
            for b in batch:
                if np.shape(b)[0] != n:
                    raise ValueError(f"stacked run_steps: leading dim "
                                     f"{np.shape(b)[0]} != n={n}")
        losses = [self(*(tuple(b[i] for b in batch) if stacked else batch))
                  for i in range(n)]
        return torch.stack(losses)
