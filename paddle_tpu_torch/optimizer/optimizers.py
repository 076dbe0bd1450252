"""The optimizer zoo (counterpart of ``paddle_tpu/optimizer/optimizers.py``).

Adam and AdamW run ``ops.adamw.adamw_update``: one fused pass per
parameter, the CUDA kernel on the card and its plain version on the CPU,
with the training step's gradient transform, the regularization and the
master weight inside that pass. Their arithmetic follows the reference's
dtype promotion step for step: without master weights the moments live in
the parameter's dtype (bf16 stays bf16) and the bias correction divides by
f32 step powers (``ops.adamw`` has the rounding points); with
``multi_precision`` a bf16 parameter's f32 master weight and f32 moments
carry the rule in f32 throughout.

The other eleven rules (SGD, Momentum, Adagrad, RMSProp, Adadelta, Adamax,
Lamb, NAdam, RAdam, Rprop, ASGD) are the reference's pure rules in plain
PyTorch on the parameter's device: the reference leaves them to XLA's
fusion, with no Pallas kernel. ``LBFGS`` comes in a later slice
(ROADMAP.md).
"""
import numpy as np
import torch

from ..ops.adamw import adamw_update
from .optimizer import Optimizer


def _f32(x, like):
    """``x`` as an f32 scalar on ``like``'s device, by a fill (a copy from
    the host would wait for the stream)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _rule(self, p, g, slots, lr, step):
        return p - lr * g, {}


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        slots["velocity"] = torch.zeros_like(self._base(p, slots))
        return slots

    def _rule(self, p, g, slots, lr, step):
        v = slots["velocity"] * self._momentum + g
        if self._use_nesterov:
            new_p = p - lr * (g + self._momentum * v)
        else:
            new_p = p - lr * v
        return new_p, {"velocity": v}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        base = self._base(p, slots)
        slots["moment1"] = torch.zeros_like(base)
        slots["moment2"] = torch.zeros_like(base)
        return slots

    def _decay_factor(self, lr, slots):
        """The factor the updated weight is scaled by first (AdamW's
        decoupled decay); 1 for Adam."""
        return 1.0

    def _update(self, p, g, slots, lr, step, scale, factor, norms):
        adamw_update(p, g, slots["moment1"], slots["moment2"], lr,
                     self._beta1, self._beta2, self._epsilon, step,
                     self._decay_factor(lr, slots),
                     master=slots.get("master_weight"), scale=scale,
                     grad_factor=factor, regularization=self.regularization,
                     norms=norms)


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

    def _decay_factor(self, lr, slots):
        # an f32 scalar (lr, coeff and the mask are traced f32 scalars in
        # the reference's step program)
        return float(np.float32(1) - np.float32(lr) * np.float32(
            self._coeff) * np.float32(slots["_decay"]))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        slots["moment"] = torch.full_like(self._base(p, slots),
                                          self._init_acc)
        return slots

    def _rule(self, p, g, slots, lr, step):
        acc = slots["moment"] + g.square()
        new_p = p - lr * g / (acc.sqrt() + self._epsilon)
        return new_p, {"moment": acc}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        base = self._base(p, slots)
        slots["mean_square"] = torch.zeros_like(base)
        slots["momentum_acc"] = torch.zeros_like(base)
        if self._centered:
            slots["mean_grad"] = torch.zeros_like(base)
        return slots

    def _rule(self, p, g, slots, lr, step):
        ms = self._rho * slots["mean_square"] + (1 - self._rho) * g.square()
        out = {"mean_square": ms}
        if self._centered:
            mg = self._rho * slots["mean_grad"] + (1 - self._rho) * g
            denom = (ms - mg.square() + self._epsilon).sqrt()
            out["mean_grad"] = mg
        else:
            denom = (ms + self._epsilon).sqrt()
        mom = self._momentum * slots["momentum_acc"] + lr * g / denom
        out["momentum_acc"] = mom
        return p - mom, out


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon, self._rho = epsilon, rho

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        base = self._base(p, slots)
        slots["avg_squared_grad"] = torch.zeros_like(base)
        slots["avg_squared_update"] = torch.zeros_like(base)
        return slots

    def _rule(self, p, g, slots, lr, step):
        asg = (self._rho * slots["avg_squared_grad"]
               + (1 - self._rho) * g.square())
        update = -(slots["avg_squared_update"] + self._epsilon).sqrt() / (
            asg + self._epsilon).sqrt() * g
        asu = (self._rho * slots["avg_squared_update"]
               + (1 - self._rho) * update.square())
        return p + lr * update, {"avg_squared_grad": asg,
                                 "avg_squared_update": asu}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        base = self._base(p, slots)
        slots["moment"] = torch.zeros_like(base)
        slots["inf_norm"] = torch.zeros_like(base)
        return slots

    def _rule(self, p, g, slots, lr, step):
        m = self._beta1 * slots["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * slots["inf_norm"], g.abs())
        step_f = _f32(step, p)
        new_p = p - lr / (1 - self._beta1 ** step_f) * m / (u + self._epsilon)
        return new_p, {"moment": m, "inf_norm": u}


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        base = self._base(p, slots)
        slots["moment1"] = torch.zeros_like(base)
        slots["moment2"] = torch.zeros_like(base)
        no_decay = (self._exclude_fn is not None and self._exclude_fn(p)) \
            or getattr(p, "no_weight_decay", False)
        slots["_decay"] = 0.0 if no_decay else 1.0
        return slots

    def _rule(self, p, g, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g.square()
        step_f = _f32(step, p)
        mhat = m / (1 - b1 ** step_f)
        vhat = v / (1 - b2 ** step_f)
        r = mhat / (vhat.sqrt() + self._epsilon) + (
            self._lamb_wd * slots["_decay"]) * p
        w_norm = torch.linalg.vector_norm(p)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            _f32(1.0, p))
        return p - lr * trust * r, {"moment1": m, "moment2": v}


class NAdam(Adam):
    """Adam with Nesterov momentum, the mu-product bias correction
    (reference :251-278); the plain rule, not the AdamW kernel."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, False, multi_precision,
                         name=name)
        self._psi = momentum_decay

    _update = Optimizer._update

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        slots["mu_product"] = torch.ones((), dtype=torch.float32,
                                         device=p.device)
        return slots

    def _rule(self, p, g, slots, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        t = _f32(step, p)
        mu_t = b1 * (1.0 - 0.5 * 0.96 ** (t * self._psi))
        mu_t1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1.0) * self._psi))
        mu_prod = slots["mu_product"] * mu_t
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g.square()
        mhat = mu_t1 * m / (1 - mu_prod * mu_t1) + (1 - mu_t) * g / (
            1 - mu_prod)
        vhat = v / (1 - b2 ** t)
        new_p = p - lr * mhat / (vhat.sqrt() + eps)
        return new_p, {"moment1": m, "moment2": v, "mu_product": mu_prod}


class RAdam(Adam):
    """Rectified Adam (reference :281-301): SGD with momentum while the
    variance estimate is untrustworthy; the plain rule."""

    _update = Optimizer._update

    def _rule(self, p, g, slots, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        t = _f32(step, p)
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g.square()
        mhat = m / (1 - b1 ** t)
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        rho_t = rho_inf - 2.0 * t * b2 ** t / (1 - b2 ** t)
        r = (torch.clamp_min((rho_t - 4) * (rho_t - 2) * rho_inf, 0.0)
             / torch.clamp_min((rho_inf - 4) * (rho_inf - 2) * rho_t,
                               1e-30)).sqrt()
        vhat = (v / (1 - b2 ** t)).sqrt() + eps
        adam_step = lr * r * mhat / vhat
        sgd_step = lr * mhat
        new_p = p - torch.where(rho_t > 5.0, adam_step, sgd_step)
        return new_p, {"moment1": m, "moment2": v}


class Rprop(Optimizer):
    """Resilient backprop (reference :304-336): per-element step sizes
    grow on a steady gradient sign and shrink on a flip."""

    def __init__(self, learning_rate=0.01, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._eta_minus, self._eta_plus = etas
        self._lr_min, self._lr_max = learning_rate_range
        self._init_lr = learning_rate

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        base = self._base(p, slots)
        slots["prev_grad"] = torch.zeros_like(base)
        slots["step_size"] = torch.full_like(base, self._init_lr)
        return slots

    def _rule(self, p, g, slots, lr, step):
        sign = torch.sign(g * slots["prev_grad"])
        size = slots["step_size"]
        size = torch.clamp(
            torch.where(sign > 0, size * self._eta_plus,
                        torch.where(sign < 0, size * self._eta_minus, size)),
            self._lr_min, self._lr_max)
        # on a sign flip, skip the update and zero the remembered gradient
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        new_p = p - torch.sign(g_eff) * size
        return new_p, {"prev_grad": g_eff, "step_size": size}


class ASGD(Optimizer):
    """Averaged SGD (reference :339-359): SGD steps plus the running
    average of the iterates in an f32 slot."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        slots["averaged_param"] = self._base(p, slots).detach().to(
            torch.float32, copy=True)
        return slots

    def _rule(self, p, g, slots, lr, step):
        new_p = p - lr * g
        avg = slots["averaged_param"]
        avg = avg + (new_p.float() - avg) / _f32(step, p)
        return new_p, {"averaged_param": avg}
