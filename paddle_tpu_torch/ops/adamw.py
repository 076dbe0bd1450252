"""The Adam / AdamW update of one parameter, in place (the update rule of
``paddle_tpu/optimizer/optimizers.py``, Adam :51-62 with AdamW's decoupled
decay :86-89, as the reference's compiled TrainStep fuses it).

``adamw_update`` picks its tier from the parameter's device: a CUDA tensor
launches ``csrc/adamw.cu`` (one pass: read p, g, m, v, write p, m, v); a
CPU tensor runs the plain version ``_adamw_plain``, the same arithmetic as
separate PyTorch operations. There is no fallback between them.

The same kernel takes the training recipe's options beside p, g, m and v:
an f32 ``master`` weight of a bf16 or fp16 p (then m and v are f32 and the
rule runs on the master, whose rounding to p's dtype lands in p), the
gradient transform of the reference's step (``scale``, the loss scaler's
unscale, and ``grad_factor``, the global-norm clip's factor, both one f32
on the device; ``transform_grad``), the L1 or L2 ``regularization`` on the
updated weight, and ``norms``, an ``UpdateNorms`` that collects each
parameter's sum p_old^2 and sum (p_new - p_old)^2 for the dynamics
telemetry.

The rounding points are those of the reference's compiled step, checked
element for element against it in bf16 (in fp16 the moments part by an
ulp of their terms where the reference's CPU program rounds b1 m + (1 -
b1) g once and the two terms cancel): each product with a
Python scalar in the parameter's dtype (the scalar rounded to that dtype
first, so a beta2 of 0.999 is 1.0 for bf16 moments and 0.99902 for fp16
ones), the moment sums and everything after them in f32, rounded once
where m, v and p are stored. ``eps`` stays f32 in every dtype: the
reference adds it to sqrt(v / bc2), which the f32 bias correction makes
f32, so fp16's 1e-8 (below half its smallest subnormal) is not rounded to
0, and a zero gradient over zero moments updates by 0 / 1e-8 = 0.
"""
import ctypes
import inspect

import numpy as np
import torch

from ..regularizer import L1Decay, L2Decay
from ..framework.nan_inf import checked
from . import _build
from .grad_norm import finish_math

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
             + [ctypes.c_float] * 9
             + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_void_p])
_REDUCE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p]
_REG_KINDS = {L2Decay: 1, L1Decay: 2}   # csrc/adamw.cu: GradIn::reg
_THREADS, _MAX_PART = 256, 1024   # csrc/adamw.cu: kThreads; partial blocks


def _in(x, dtype):
    """A Python scalar rounded to ``dtype``."""
    return float(torch.tensor(x, dtype=dtype))


def _f32(x):
    return float(np.float32(x))


def _scalars(p, lr, beta1, beta2, eps, step, factor):
    """(b1, 1-b1, b2, 1-b2, factor) in p's dtype; lr, bc1, bc2, eps f32."""
    dt = p.dtype
    step_f = np.float32(step)
    bc1 = np.float32(1) - np.float32(beta1) ** step_f
    bc2 = np.float32(1) - np.float32(beta2) ** step_f
    return (_in(beta1, dt), _in(1 - beta1, dt), _in(beta2, dt),
            _in(1 - beta2, dt), _in(factor, dt), _f32(lr), float(bc1),
            float(bc2), _f32(eps))


def _adamw_math(p, g, m, v, scalars):
    """Plain version: the kernel's arithmetic as PyTorch operations."""
    b1, c1, b2, c2, factor, lr, bc1, bc2, eps = scalars
    # m = b1 m + (1 - b1) g ; v = b2 v + (1 - b2) g^2 ; the sums in f32
    mf = m.mul_(b1).float() + (g * c1).float()
    vf = v.mul_(b2).float() + g.square().mul_(c2).float()
    m.copy_(mf)
    v.copy_(vf)
    # p = p * factor - lr * mhat / (sqrt(vhat) + eps), in f32 (out of place
    # first: .float() of an f32 tensor is the tensor itself)
    den = vf.div_(bc2).sqrt_().add_(eps)
    upd = mf.div_(bc1).mul_(lr).div_(den)
    del den
    p.copy_(p.float() * factor - upd)


def transform_grad(g, scale=None, factor=None):
    """Plain version of the reference step's gradient transform
    (jit_api.py:328-363): ``g / scale`` in f32, then ``(x.f32 * factor)``
    cast back to x's dtype (bf16 for a bf16 gradient without a scale)."""
    x = g
    if scale is not None:
        x = g.float() / scale
    if factor is not None:
        x = (x.float() * factor).to(x.dtype)
    return x


def regularize(base, g, reg):
    """``g + reg(base)``: ``coeff * base`` (L2) or ``coeff * sign(base)``
    (L1), a product in base's dtype (reference optimizer.py:88-94)."""
    if reg is None or not reg.coeff:
        return g
    return g + reg(base)


def _adamw_plain(p, g, m, v, args, master, scale, grad_factor, reg, norms):
    """Plain version of every instance: the transform, the regularization
    and ``_adamw_math`` on the master (or p), then p from the master."""
    base = master if master is not None else p
    old = p.clone() if norms is not None else None
    gd = regularize(base, transform_grad(g, scale, grad_factor).to(
        base.dtype), reg)
    _adamw_math(base, gd, m, v, _scalars(base, *args))
    if master is not None:
        p.copy_(master)
    if norms is not None:
        norms.record(p, old)


def _check_operands(name, p, g, m, v, master):
    chk = _build.check
    base = master if master is not None else p
    chk(p.is_cuda, name, "p must be a CUDA tensor")
    for t in (g, m, v) + ((master,) if master is not None else ()):
        chk(t.device == p.device, name, "operands must share p's device")
        chk(t.shape == p.shape, name, "operands must have p's shape")
    chk(m.dtype == base.dtype and v.dtype == base.dtype, name,
        "m and v must have the updated weight's dtype")
    if master is not None:
        chk(master.dtype == torch.float32
            and p.dtype in (torch.bfloat16, torch.float16), name,
            "a master weight is f32 for a bf16 or fp16 parameter")
    for t in (p, g, m, v) + ((master,) if master is not None else ()):
        _build.check_dtype(name, t)
        chk(t.is_contiguous(), name, "operands must be contiguous")
        chk(t.data_ptr() % 16 == 0, name, "operands must be 16-byte aligned")
    g16 = torch.bfloat16 if p.dtype == torch.float32 else p.dtype
    chk(g.dtype in (torch.float32, g16), name,
        f"the gradient must be f32 or {g16} for a {p.dtype} parameter")
    chk(p.numel() > 0, name, "empty parameter")


def _adamw_cuda(p, g, m, v, args, master=None, scale=None, grad_factor=None,
                reg=None, norms=None):
    """Launch the kernel on the current stream; validates every operand.
    ``args`` are ``adamw_update``'s scalars."""
    name = "adamw_update"
    fn = _build.entry("adamw", "adamw_update_launch", _ARGTYPES)
    _check_operands(name, p, g, m, v, master)
    for t in (scale, grad_factor):
        _build.check(t is None or (t.device == p.device and t.dtype
                                   == torch.float32 and t.numel() == 1),
                     name, "scale and factor: one f32 on p's device")
    base = master if master is not None else p
    kind = _REG_KINDS[type(reg)] if reg is not None and reg.coeff else 0
    part, n_part, stride = norms.slot(p) if norms is not None else (
        None, 0, 0)
    rc = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            master.data_ptr() if master is not None else None, p.numel(),
            *_scalars(base, *args), _build.DTYPE_CODES[str(base.dtype)],
            _build.DTYPE_CODES[str(g.dtype)],
            _build.DTYPE_CODES[str(p.dtype)],
            scale.data_ptr() if scale is not None else None,
            grad_factor.data_ptr() if grad_factor is not None else None,
            kind, _in(reg.coeff, base.dtype) if kind else 0.0, part, n_part,
            stride, torch.cuda.current_stream(p.device).cuda_stream)
    _build.check_status(rc, name)
    _build.count_launch(adamw_update, like=p)


def _in_place(args, kwargs, result):
    """adamw_update's outputs: p, m and v, and the master where given."""
    a = inspect.signature(adamw_update).bind(*args, **kwargs).arguments
    return tuple(a[k] for k in ("p", "m", "v", "master")
                 if a.get(k) is not None)


@checked("adamw_update", _in_place)
@torch.no_grad()
def adamw_update(p, g, m, v, lr, beta1, beta2, eps, step, factor=1.0,
                 master=None, scale=None, grad_factor=None,
                 regularization=None, norms=None):
    """One Adam update of ``p`` from gradient ``g`` at update ``step``
    (1-based); the updated weight (``master`` where given, else p) is
    first scaled by ``factor`` (AdamW's ``1 - lr * coeff``); moments ``m``,
    ``v`` in its dtype. In place. The other arguments: the module
    docstring. A CUDA ``p`` launches the kernel (counted in
    ``adamw_update.launches``); a CPU ``p`` runs the plain version."""
    args = (lr, beta1, beta2, eps, step, factor)
    if p.device.type == "cpu":
        _adamw_plain(p, g, m, v, args, master, scale, grad_factor,
                     regularization, norms)
    else:
        _adamw_cuda(p, g, m, v, args, master, scale, grad_factor,
                    regularization, norms)


adamw_update.launches = adamw_update.launches_fp16 = 0


class UpdateNorms:
    """Per parameter of one optimizer update, sum p_old^2 and
    sum (p_new - p_old)^2 over the stored parameter, then per group (the
    dynamics' param_sq and upd_sq, paddle_tpu/observability/dynamics.py
    :239-242), with no copy of a parameter on the card.

    ``params`` in order, ``groups[i]`` the group index of params[i]. Call
    ``begin()`` before a step's updates and ``reduce()`` after them: on the
    card each update kernel writes its blocks' f64 partials into one buffer
    and ``reduce`` launches their fixed-order reduction (counted in
    ``UpdateNorms.reduces``); on the CPU each update records its sums
    (``record``) and ``reduce`` runs the same order in plain PyTorch.
    Returns f32 [2, n + n_groups + 3]: the sums of p_old^2 then of the
    update's squares, each per tensor, per group, total. A parameter the
    step leaves without a gradient adds 0 to both."""

    reduces = 0

    def __init__(self, params, groups, n_groups):
        self.params, self.groups = list(params), list(groups)
        self.n_groups = n_groups
        self._index = {id(p): i for i, p in enumerate(self.params)}
        dev = self.params[0].device
        self._dev = dev
        if dev.type == "cpu":
            self._sums = [None] * len(self.params)
            return
        self._blocks = [min(-(-p.numel() // (_THREADS * 8)), _MAX_PART) or 1
                        for p in self.params]
        self._starts = np.concatenate([[0], np.cumsum(self._blocks)])
        self._n_part = int(self._starts[-1])
        self._part = torch.zeros(2, self._n_part, dtype=torch.float64,
                                 device=dev)
        self._meta = torch.tensor(
            list(self._starts) + self.groups, dtype=torch.int64).to(dev)

    def begin(self):
        if self._dev.type == "cpu":
            self._sums = [None] * len(self.params)
        else:
            self._part.zero_()

    def slot(self, p):
        """(partials pointer, blocks, stride) of p's kernel launch."""
        i = self._index[id(p)]
        return (self._part.data_ptr() + 8 * int(self._starts[i]),
                self._blocks[i], self._n_part)

    def record(self, p, old):
        """The plain version of the kernel's epilogue for one update (an
        update without the kernel: a CPU parameter, or a rule in plain
        PyTorch on the card, which then fills p's first partial)."""
        i = self._index[id(p)]
        po = old.float()
        d = p.float() - po
        sums = (po.square().sum(dtype=torch.float64),
                d.square().sum(dtype=torch.float64))
        if self._dev.type == "cpu":
            self._sums[i] = tuple(x.float() for x in sums)
        else:
            self._part[:, int(self._starts[i])] = torch.stack(sums)

    def reduce(self):
        n, g = len(self.params), self.n_groups
        if self._dev.type == "cpu":
            zero = torch.zeros((), dtype=torch.float32)
            sums = [s or (zero, zero) for s in self._sums]
            return torch.stack([finish_math(
                [s[q] for s in sums], [], self.groups, g, None)[0]
                for q in range(2)])
        name = "adamw_dynamics_reduce"
        fn = _build.entry("adamw", "adamw_dynamics_reduce_launch",
                          _REDUCE_ARGTYPES)
        out = torch.empty(2, n + g + 3, dtype=torch.float32, device=self._dev)
        rc = fn(self._meta.data_ptr(), n, self._n_part, g,
                self._part.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(self._dev).cuda_stream)
        _build.check_status(rc, name)
        UpdateNorms.reduces += 1
        return out
