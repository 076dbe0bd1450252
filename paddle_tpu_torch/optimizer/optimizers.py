"""Adam and AdamW (counterpart of ``paddle_tpu/optimizer/optimizers.py``
:40-110).

The arithmetic follows the reference's dtype promotion step for step:
with ``multi_precision=False`` the moments live in the parameter's dtype
(bf16 stays bf16), the moment updates run in that dtype, and the bias
correction divides by f32 step powers, so ``mhat``, ``vhat`` and the new
parameter are computed in f32 and cast back to the parameter's dtype
(``ops.adamw`` has the rounding points). The port updates one parameter at
a time, never all at once: on the card one fused kernel pass each, on the
CPU the plain version, whose f32 temporaries never exceed one parameter.
"""
import numpy as np
import torch

from ..ops.adamw import adamw_update
from .optimizer import Optimizer


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_slots(self, p):
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p)}

    def _rule(self, p, g, slots, lr, step, factor=1.0):
        """One Adam update of ``p``, first scaled by ``factor`` (AdamW's
        decoupled decay), in place."""
        adamw_update(p, g, slots["moment1"], slots["moment2"], lr,
                     self._beta1, self._beta2, self._epsilon, step, factor)


class AdamW(Adam):
    """Decoupled weight decay: ``p * (1 - lr * coeff * decay)`` before the
    Adam rule (reference :86-89), with ``decay`` 0 for the parameters that
    ``apply_decay_param_fun(name)`` refuses or that carry
    ``no_weight_decay = True``, else 1."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         name=name)
        if isinstance(weight_decay, (int, float)):
            self._coeff = float(weight_decay)
        else:
            self._coeff = float(getattr(weight_decay, "coeff", 0.01))
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, p):
        if getattr(p, "no_weight_decay", False):
            return False
        fn = self._apply_decay_param_fun
        return fn is None or bool(fn(self._names.get(id(p), "")))

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        slots["_decay"] = 1.0 if self._decays(p) else 0.0
        return slots

    def _rule(self, p, g, slots, lr, step):
        # the factor is an f32 scalar (lr, coeff and the mask are traced
        # f32 scalars in the reference's step program)
        factor = np.float32(1) - np.float32(lr) * np.float32(
            self._coeff) * np.float32(slots["_decay"])
        super()._rule(p, g, slots, lr, step, factor=float(factor))
