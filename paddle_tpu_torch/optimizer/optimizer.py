"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

The update semantics are the reference's ``Optimizer.apply_gradients``
(:161-198): the step count advances by one; each gradient is cast to the
dtype of the weight it updates (the f32 master weight of a bf16 parameter
under ``multi_precision``, else the parameter); the regularization
(``L2Decay`` or ``L1Decay``, :88-94) is added on that weight; the rule
runs; the new parameter lands back in the parameter's dtype, whatever the
rule's arithmetic promoted to; and ``skip_update`` leaves parameters, slots
and the step count untouched. Before the cast, ``apply_gradients`` can
apply the training step's gradient transform (the loss scaler's unscale
``g / scale`` and the global-norm clip's ``factor``, jit_api.py:328-363):
the AdamW kernel does both in registers, the other rules in plain PyTorch.

``learning_rate`` is a number or an ``lr.LRScheduler`` (read at every
update; ``set_lr`` raises under one, as the reference's). ``parameters``
is an iterable of tensors, of (name, tensor) pairs
(``model.named_parameters()``; names feed AdamW's
``apply_decay_param_fun``) or of param-group dicts ``{"params": [...]}``,
flattened in order as the reference flattens them (:34-42).

The port updates parameters and slots IN PLACE (the reference returns new
arrays), one parameter at a time, so the f32 temporaries of a rule never
exceed one parameter's size.
"""
import numbers

import torch

from ..ops.adamw import regularize, transform_grad
from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler


def _flatten(parameters):
    """(tensors, {id: name}) of a parameter list, (name, tensor) pairs or
    param-group dicts (their params in order)."""
    items = list(parameters)
    if items and isinstance(items[0], dict):
        items = [p for g in items for p in g["params"]]
    tensors, names = [], {}
    for item in items:
        if isinstance(item, tuple):
            name, p = item
            names[id(p)] = name
        else:
            p = item
        tensors.append(p)
    return tensors, names


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise TypeError(f"learning_rate must be a number or an "
                            f"LRScheduler, got {learning_rate!r}")
        self._learning_rate = learning_rate
        self._names = {}
        self._parameter_list = None
        if parameters is not None:
            self._parameter_list, self._names = _flatten(parameters)
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        if isinstance(weight_decay, numbers.Real):
            self.regularization = L2Decay(float(weight_decay))
        elif weight_decay is None or isinstance(weight_decay,
                                                (L1Decay, L2Decay)):
            self.regularization = weight_decay
        else:
            raise TypeError(f"weight_decay must be a number, L1Decay or "
                            f"L2Decay, got {weight_decay!r}")
        self._accumulators = {}   # id(param) -> {slot name: tensor}
        self._global_step = 0

    # -- lr ------------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = value

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    @property
    def _learning_rate_scheduler(self):
        lr = self._learning_rate
        return lr if isinstance(lr, LRScheduler) else None

    # -- state ---------------------------------------------------------------
    def parameters(self):
        return list(self._parameter_list or [])

    def _slots_for(self, p):
        key = id(p)
        if key not in self._accumulators:
            self._accumulators[key] = self._create_slots(p)
        return self._accumulators[key]

    def _use_master_weights(self, p):
        return self._multi_precision and p.dtype in (torch.float16,
                                                     torch.bfloat16)

    def _create_slots(self, p):
        """The f32 master weight of a bf16/fp16 parameter under
        ``multi_precision``; subclasses add their slots shaped and typed
        like ``_base(p, slots)``."""
        if self._use_master_weights(p):
            return {"master_weight": p.detach().to(torch.float32, copy=True)}
        return {}

    @staticmethod
    def _base(p, slots):
        """The weight the rule updates: the master where there is one."""
        return slots.get("master_weight", p)

    def init_state(self, named_params):
        """Create every parameter's slots up front, with its name (the
        counterpart of the reference's ``init_state``, used by
        ``TrainStep``)."""
        for name, p in named_params.items():
            self._names.setdefault(id(p), name)
            self._slots_for(p)

    def state_dict(self):
        """The step count, every slot as ``param_{i}.{slot}`` in the order
        of the parameter list (``{name}.{slot}`` for parameters the
        optimizer was not constructed with), and the scheduler's state as
        ``LR_Scheduler`` (reference :199-209)."""
        sd = {"global_step": self._global_step}
        order = {id(p): f"param_{i}"
                 for i, p in enumerate(self._parameter_list or [])}
        for pid, slots in self._accumulators.items():
            key = order.get(pid, self._names.get(pid, str(pid)))
            for k, v in slots.items():
                sd[f"{key}.{k}"] = v
        if self._learning_rate_scheduler is not None:
            sd["LR_Scheduler"] = self._learning_rate_scheduler.state_dict()
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Load ``state_dict()``'s output (reference :211-223): the step
        count, the scheduler's state, and each ``param_{i}.{slot}`` into
        that parameter's slot (a tensor is copied onto the parameter's
        device)."""
        self._global_step = int(state_dict.get("global_step", 0))
        sched = self._learning_rate_scheduler
        if sched is not None and "LR_Scheduler" in state_dict:
            sched.set_state_dict(dict(state_dict["LR_Scheduler"]))
        names = {f"param_{i}": p
                 for i, p in enumerate(self._parameter_list or [])}
        for key, v in state_dict.items():
            if key in ("global_step", "LR_Scheduler"):
                continue
            pname, _, slot = key.rpartition(".")
            p = names.get(pname)
            if p is None:
                continue
            slots = self._slots_for(p)
            if isinstance(v, torch.Tensor) or hasattr(v, "__array__"):
                v = torch.as_tensor(v)
                old = slots.get(slot)
                slots[slot] = v.to(device=p.device, dtype=old.dtype).clone() \
                    if isinstance(old, torch.Tensor) else v.to(p.device)
            else:
                slots[slot] = v

    # -- the update ----------------------------------------------------------
    def _rule(self, p, g, slots, lr, step):
        """The reference's pure rule: returns (new p, {slot: new value})
        from ``p`` (the updated weight) and ``g`` (in its dtype)."""
        raise NotImplementedError

    def _update(self, p, g, slots, lr, step, scale, factor, norms):
        """One parameter's update in place: the gradient transform, the
        cast to the updated weight's dtype, the regularization, the rule,
        then p from the master (``UpdateNorms`` records the update)."""
        master = slots.get("master_weight")
        base = master if master is not None else p
        old = p.clone() if norms is not None else None
        gd = regularize(base, transform_grad(g, scale, factor).to(
            base.dtype), self.regularization)
        new_p, new_slots = self._rule(base, gd, slots, lr, step)
        base.copy_(new_p)
        for k, v in new_slots.items():
            if isinstance(slots.get(k), torch.Tensor) and v is not slots[k]:
                slots[k].copy_(v)
        if master is not None:
            p.copy_(master)
        if norms is not None:
            norms.record(p, old)

    @torch.no_grad()
    def apply_gradients(self, params_grads, skip_update=False, scale=None,
                        factor=None, norms=None, lr=None):
        """One update over ``[(param, grad), ...]`` (grads None are
        skipped). ``scale`` and ``factor`` (one f32 each, on the
        parameters' device, or None): each gradient is divided by the scale
        and multiplied by the factor first, at the reference step's
        rounding points. ``norms``: an ``ops.adamw.UpdateNorms`` that
        records each update for the dynamics telemetry. ``lr``: this
        update's learning rate (default ``get_lr()``). With
        ``skip_update`` nothing changes, the step count included."""
        if skip_update:
            return
        self._global_step += 1
        lr = self.get_lr() if lr is None else lr
        for p, g in params_grads:
            if g is None:
                continue
            self._update(p, g, self._slots_for(p), lr, self._global_step,
                         scale, factor, norms)

    def step(self):
        """Eager update from each parameter's ``.grad``, through
        ``grad_clip`` first (reference :103-130)."""
        if self._parameter_list is None:
            raise RuntimeError("optimizer constructed without parameters")
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self.apply_gradients(params_grads)

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or []:
            if p.grad is not None and set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()``, ``step()``, ``clear_grad()`` (reference
        :144-148)."""
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None
