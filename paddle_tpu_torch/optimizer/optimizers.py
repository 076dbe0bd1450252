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
fusion, with no Pallas kernel. They keep its dtype promotion step for
step, so a bf16 parameter without master weights updates to the same
bits: a Python scalar (and the lr, a weakly typed scalar in the
reference's step) is rounded to the tensor's dtype before it meets a
tensor (``_w``; PyTorch would multiply a bf16 tensor by the unrounded
scalar), and a bf16 tensor that meets an f32 step-count scalar widens to
f32 first, as JAX promotes it (PyTorch would keep bf16). Where the
reference widens the result of a bf16 operation, XLA computes that last
operation in f32 unrounded (``_widened_sum``, ``_norm``), and so do the
rules. ``LBFGS`` comes in a later slice (ROADMAP.md).
"""
import numpy as np
import torch

from ..ops.adamw import adamw_update
from .optimizer import Optimizer


def _f32(x, like):
    """``x`` as an f32 scalar on ``like``'s device, by a fill (a copy from
    the host would wait for the stream)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _w(x, like):
    """A Python scalar as JAX's weak typing gives it to ``like``: rounded
    to ``like``'s dtype first (a 0-dim tensor of it, by a fill)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _widened_sum(a, b):
    """``(a + b)`` of two tensors in a low dtype as XLA computes it where
    the sum is widened to f32 next: the sum itself in f32, unrounded (XLA
    drops the rounding of the last operation before a widening cast)."""
    return a.float() + b.float()


def _moments(opt, p, g, slots):
    """Adam's moments in the updated weight's dtype, b1 m + (1 - b1) g and
    b2 v + (1 - b2) g^2, each scalar rounded to that dtype first: (m, v)
    as stored and (m, v) widened to f32 (``_widened_sum``), as the rules
    read them."""
    b1, b2 = opt._beta1, opt._beta2
    m1, m2 = _w(b1, p) * slots["moment1"], _w(1 - b1, p) * g
    v1, v2 = _w(b2, p) * slots["moment2"], _w(1 - b2, p) * g.square()
    return (m1 + m2, v1 + v2), (_widened_sum(m1, m2), _widened_sum(v1, v2))


def _norm(x):
    """``jnp.linalg.norm(x)`` widened to f32, as XLA computes it: the
    squares and their sum in f32, the sum rounded to x's dtype, its square
    root in f32."""
    xf = x.float()
    return (xf * xf).sum().to(x.dtype).float().sqrt()


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _rule(self, p, g, slots, lr, step):
        return p - _w(lr, p) * g, {}


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
        mom = _w(self._momentum, p)
        v = slots["velocity"] * mom + g
        if self._use_nesterov:
            new_p = p - _w(lr, p) * (g + mom * v)
        else:
            new_p = p - _w(lr, p) * v
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
        new_p = p - _w(lr, p) * g / (acc.sqrt() + _w(self._epsilon, p))
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
        rho, rest, eps = (_w(x, p) for x in (self._rho, 1 - self._rho,
                                             self._epsilon))
        ms = rho * slots["mean_square"] + rest * g.square()
        out = {"mean_square": ms}
        if self._centered:
            mg = rho * slots["mean_grad"] + rest * g
            denom = (ms - mg.square() + eps).sqrt()
            out["mean_grad"] = mg
        else:
            denom = (ms + eps).sqrt()
        mom = (_w(self._momentum, p) * slots["momentum_acc"]
               + _w(lr, p) * g / denom)
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
        rho, rest, eps = (_w(x, p) for x in (self._rho, 1 - self._rho,
                                             self._epsilon))
        asg = rho * slots["avg_squared_grad"] + rest * g.square()
        update = -(slots["avg_squared_update"] + eps).sqrt() / (
            asg + eps).sqrt() * g
        asu = rho * slots["avg_squared_update"] + rest * update.square()
        return p + _w(lr, p) * update, {"avg_squared_grad": asg,
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
        b1 = self._beta1
        m1, m2 = _w(b1, p) * slots["moment"], _w(1 - b1, p) * g
        m = m1 + m2
        u = torch.maximum(_w(self._beta2, p) * slots["inf_norm"], g.abs())
        step_f = _f32(step, p)
        # lr / (1 - b1^t) is f32, so the rest of the update is too
        c = _f32(lr, p) / (1 - _f32(b1, p) ** step_f)
        new_p = p.float() - c * _widened_sum(m1, m2) / _widened_sum(
            u, _w(self._epsilon, p))
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
        (m, v), (mf, vf) = _moments(self, p, g, slots)
        step_f = _f32(step, p)
        mhat = mf / (1 - _f32(b1, p) ** step_f)
        vhat = vf / (1 - _f32(b2, p) ** step_f)
        # (lamb_wd * decay) * p, widened: the product in f32
        r = mhat / (vhat.sqrt() + self._epsilon) + (
            _w(self._lamb_wd * slots["_decay"], p).float() * p.float())
        w_norm, r_norm = _norm(p), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            _f32(1.0, p))
        return p.float() - lr * trust * r, {"moment1": m, "moment2": v}


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
        decay = _f32(0.96, p)
        mu_t = b1 * (1.0 - 0.5 * decay ** (t * self._psi))
        mu_t1 = b1 * (1.0 - 0.5 * decay ** ((t + 1.0) * self._psi))
        mu_prod = slots["mu_product"] * mu_t
        (m, v), (mf, vf) = _moments(self, p, g, slots)
        mhat = mu_t1 * mf / (1 - mu_prod * mu_t1) + (
            1 - mu_t) * g.float() / (1 - mu_prod)
        vhat = vf / (1 - _f32(b2, p) ** t)
        new_p = p.float() - lr * mhat / (vhat.sqrt() + eps)
        return new_p, {"moment1": m, "moment2": v, "mu_product": mu_prod}


class RAdam(Adam):
    """Rectified Adam (reference :281-301): SGD with momentum while the
    variance estimate is untrustworthy; the plain rule."""

    _update = Optimizer._update

    def _rule(self, p, g, slots, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        t = _f32(step, p)
        (m, v), (mf, vf) = _moments(self, p, g, slots)
        b2_t = _f32(b2, p) ** t
        mhat = mf / (1 - _f32(b1, p) ** t)
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        rho_t = rho_inf - 2.0 * t * b2_t / (1 - b2_t)
        r = (torch.clamp_min((rho_t - 4) * (rho_t - 2) * rho_inf, 0.0)
             / torch.clamp_min((rho_inf - 4) * (rho_inf - 2) * rho_t,
                               1e-30)).sqrt()
        vhat = (vf / (1 - b2_t)).sqrt() + eps
        adam_step = lr * r * mhat / vhat
        sgd_step = lr * mhat
        new_p = p.float() - torch.where(rho_t > 5.0, adam_step, sgd_step)
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
        size = torch.minimum(torch.maximum(
            torch.where(sign > 0, size * _w(self._eta_plus, p),
                        torch.where(sign < 0, size * _w(self._eta_minus, p),
                                    size)),
            _w(self._lr_min, p)), _w(self._lr_max, p))
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
        step_ = _w(lr, p) * g
        new_p = p - step_
        avg = slots["averaged_param"]
        avg = avg + (_widened_sum(p, -step_) - avg) / _f32(step, p)
        return new_p, {"averaged_param": avg}
