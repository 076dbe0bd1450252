"""The Adam / AdamW update of one parameter, in place (the update rule of
``paddle_tpu/optimizer/optimizers.py``, Adam :51-62 with AdamW's decoupled
decay :86-89, as the reference's compiled TrainStep fuses it).

``adamw_update`` picks its tier from the parameter's device: a CUDA tensor
launches ``csrc/adamw.cu`` (one pass: read p, g, m, v, write p, m, v); a
CPU tensor runs the plain version ``_adamw_math``, the same arithmetic as
separate PyTorch operations. There is no fallback between them.

The rounding points are those of the reference's compiled step, checked
element for element against it in bf16: each product with a Python scalar
in the parameter's dtype (the scalar rounded to that dtype first, so a
beta2 of 0.999 is 1.0 for bf16 moments), the moment sums and everything
after them in f32, rounded once where m, v and p are stored.
"""
import ctypes

import numpy as np
import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
             + [ctypes.c_float] * 9 + [ctypes.c_int, ctypes.c_void_p])


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


def _adamw_cuda(p, g, m, v, *args):
    """Launch the kernel on the current stream; validates every operand.
    ``args`` are ``adamw_update``'s scalars."""
    name = "adamw_update"
    fn = _build.entry("adamw", "adamw_update_launch", _ARGTYPES)
    chk = _build.check
    chk(p.is_cuda, name, "p must be a CUDA tensor")
    for t in (g, m, v):
        chk(t.device == p.device, name, "operands must share p's device")
        chk(t.dtype == p.dtype and t.shape == p.shape, name,
            "g, m and v must have p's dtype and shape")
    for t in (p, g, m, v):
        chk(t.is_contiguous(), name, "operands must be contiguous")
        chk(t.data_ptr() % 16 == 0, name, "operands must be 16-byte aligned")
    chk(str(p.dtype) in _build.DTYPE_CODES, name,
        f"dtype {p.dtype} not in {sorted(_build.DTYPE_CODES)}")
    chk(p.numel() > 0, name, "empty parameter")
    scalars = _scalars(p, *args)
    rc = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p.numel(), *scalars, _build.DTYPE_CODES[str(p.dtype)],
            torch.cuda.current_stream(p.device).cuda_stream)
    _build.check_status(rc, name)
    adamw_update.launches += 1


@torch.no_grad()
def adamw_update(p, g, m, v, lr, beta1, beta2, eps, step, factor=1.0):
    """One Adam update of ``p`` (moments ``m``, ``v`` in p's dtype) from
    gradient ``g`` (in p's dtype) at update ``step`` (1-based); ``p`` is
    first scaled by ``factor`` (AdamW's ``1 - lr * coeff``). In place. A
    CUDA ``p`` launches the kernel (counted in ``adamw_update.launches``);
    a CPU ``p`` runs the plain version."""
    args = (lr, beta1, beta2, eps, step, factor)
    if p.device.type == "cpu":
        _adamw_math(p, g, m, v, _scalars(p, *args))
    else:
        _adamw_cuda(p, g, m, v, *args)


adamw_update.launches = 0
