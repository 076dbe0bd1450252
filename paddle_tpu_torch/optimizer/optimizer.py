"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

The update semantics are the reference's ``Optimizer.apply_gradients``
(:161-198): the step count advances by one; each gradient is cast to its
parameter's dtype; the rule runs; the new parameter lands back in the
parameter's dtype, whatever the rule's arithmetic promoted to; and
``skip_update`` leaves parameters, slots and the step count untouched.

The port updates parameters and slots IN PLACE (the reference returns new
arrays), one parameter at a time, so the f32 temporaries of a rule never
exceed one parameter's size. Gradient clipping, L1 decay, learning-rate
schedulers and multi-precision master weights come in a later slice of the
port (see ROADMAP.md) and raise when asked for.
"""
import numbers

import torch

_LATER = "comes in a later slice of the port (see ROADMAP.md)"


class L2Decay:
    """Coupled L2 decay: ``coeff * p`` is added to the gradient."""

    def __init__(self, coeff=0.0):
        self.coeff = coeff


class Optimizer:
    """``parameters`` is an iterable of tensors or of (name, tensor) pairs
    (``model.named_parameters()``); names feed AdamW's
    ``apply_decay_param_fun``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                f"Optimizer: learning-rate schedulers {_LATER}")
        if grad_clip is not None:
            raise NotImplementedError(f"Optimizer: grad_clip {_LATER}")
        if multi_precision:
            raise NotImplementedError(
                f"Optimizer: multi_precision master weights {_LATER}")
        self._learning_rate = float(learning_rate)
        self._names = {}
        self._parameter_list = None
        if parameters is not None:
            self._parameter_list = []
            for item in parameters:
                if isinstance(item, tuple):
                    name_, p = item
                    self._names[id(p)] = name_
                else:
                    p = item
                self._parameter_list.append(p)
        if isinstance(weight_decay, numbers.Real):
            self.regularization = L2Decay(float(weight_decay))
        elif weight_decay is None or isinstance(weight_decay, L2Decay):
            self.regularization = weight_decay
        else:
            raise NotImplementedError(
                f"Optimizer: weight_decay {weight_decay!r} {_LATER}")
        self._accumulators = {}   # id(param) -> {slot name: tensor}
        self._global_step = 0

    # -- lr ------------------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # -- state ---------------------------------------------------------------
    def parameters(self):
        return list(self._parameter_list or [])

    def _slots_for(self, p):
        key = id(p)
        if key not in self._accumulators:
            self._accumulators[key] = self._create_slots(p)
        return self._accumulators[key]

    def _create_slots(self, p):
        return {}

    def init_state(self, named_params):
        """Create every parameter's slots up front, with its name (the
        counterpart of the reference's ``init_state``, used by
        ``TrainStep``)."""
        for name, p in named_params.items():
            self._names.setdefault(id(p), name)
            self._slots_for(p)

    def state_dict(self):
        """The step count and every slot, as ``param_{i}.{slot}`` in the
        order of the parameter list (``{name}.{slot}`` for parameters the
        optimizer was not constructed with)."""
        sd = {"global_step": self._global_step}
        order = {id(p): f"param_{i}"
                 for i, p in enumerate(self._parameter_list or [])}
        for pid, slots in self._accumulators.items():
            key = order.get(pid, self._names.get(pid, str(pid)))
            for k, v in slots.items():
                sd[f"{key}.{k}"] = v
        return sd

    # -- the update ----------------------------------------------------------
    def _rule(self, p, g, slots, lr, step):
        """Update ``p`` and ``slots`` in place from gradient ``g`` (already
        in p's dtype)."""
        raise NotImplementedError

    def _apply_regularization(self, p, g):
        reg = self.regularization
        if isinstance(reg, L2Decay) and reg.coeff:
            return g + reg.coeff * p
        return g

    @torch.no_grad()
    def apply_gradients(self, params_grads, skip_update=False):
        """One update over ``[(param, grad), ...]`` (grads None are
        skipped). With ``skip_update`` nothing changes, the step count
        included."""
        if skip_update:
            return
        self._global_step += 1
        lr = self.get_lr()
        for p, g in params_grads:
            if g is None:
                continue
            slots = self._slots_for(p)
            gd = self._apply_regularization(p, g.to(p.dtype))
            self._rule(p, gd, slots, lr, self._global_step)

    def step(self):
        """Eager update from each parameter's ``.grad``."""
        if self._parameter_list is None:
            raise RuntimeError("optimizer constructed without parameters")
        self.apply_gradients([(p, p.grad) for p in self._parameter_list
                              if p.grad is not None])

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or []:
            if p.grad is not None and set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None
