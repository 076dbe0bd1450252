"""``FLAGS_check_nan_inf``: the per-op NaN/Inf check (counterpart of
``paddle_tpu/framework/core.py::_nan_check``, :582-602; reference:
CheckVarHasNanOrInf, framework/details/nan_inf_utils_detail.cc).

With the flag on, every eager op's floating outputs are scanned. Level 0
(``FLAGS_check_nan_inf_level``) raises FloatingPointError at the first op
whose output holds a NaN or an Inf, level 1 and above warns; the message
names the op and the output: ``Operator <op> output <i> contains <n>
NaN/Inf values``. In PyTorch's idiom the ops are seen by a
``TorchDispatchMode`` (``NanInfCheckMode``), which setting the flag
installs on the calling thread and clearing it removes (dispatch modes are
per thread, so other threads, a serving replica's dispatcher among them,
are not checked). The port's kernels launch through ctypes, which no
dispatch mode sees, so each kernel wrapper is one op of its own
(``checked``): its outputs are checked where it returns, under its name,
and the operations inside it are not checked one by one.

The reference checks concrete arrays only, so its compiled programs
(``TrainStep``, the serving engine's programs) never check; their
counterparts here run under ``suspended()``.
"""
import contextlib
import functools
import threading
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import flags

_tls = threading.local()
#: ops whose outputs are uninitialised memory, not results
_UNINITIALISED = ("empty", "new_empty", "empty_like", "empty_strided",
                  "new_empty_strided", "empty_permuted")


def _state():
    if not hasattr(_tls, "mode"):
        _tls.mode, _tls.suspended = None, 0
    return _tls


def active():
    """The check runs on this thread: the flag installed the mode here and
    no ``suspended()`` block is open."""
    st = _state()
    return st.mode is not None and st.suspended == 0


@contextlib.contextmanager
def suspended():
    """No op is checked inside (the compiled programs' counterparts)."""
    st = _state()
    st.suspended += 1
    try:
        yield
    finally:
        st.suspended -= 1


def _tensors(outs):
    if isinstance(outs, torch.Tensor):
        return [outs]
    if isinstance(outs, (list, tuple)):
        return [t for o in outs for t in _tensors(o)]
    return []


def check(name, outs):
    """Scan ``outs`` (a tensor or nested tuples of them) as op ``name``'s
    outputs: raise FloatingPointError (level 0) or warn (level >= 1) at
    the first floating output holding a NaN or an Inf."""
    for i, o in enumerate(_tensors(outs)):
        if (not (o.is_floating_point() or o.is_complex())
                or o.device.type == "meta" or o.numel() == 0):
            continue
        bad = int((~torch.isfinite(o)).sum())
        if bad:
            msg = (f"Operator {name or 'unknown'} output {i} contains {bad} "
                   f"NaN/Inf values")
            if flags.flag("check_nan_inf_level", 0) >= 1:
                warnings.warn(msg, stacklevel=3)
            else:
                raise FloatingPointError(msg)


class NanInfCheckMode(TorchDispatchMode):
    """Checks the outputs of every aten op dispatched on its thread (the
    mode is off while its own handler runs, so the scan is not itself
    checked)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _state().suspended == 0 and (
                func.overloadpacket.__name__ not in _UNINITIALISED):
            check(str(func), out)
        return out


def sync_mode():
    """Install or remove the mode on this thread to follow the flag."""
    st = _state()
    on = bool(flags.flag("check_nan_inf"))
    if on and st.mode is None:
        st.mode = NanInfCheckMode()
        st.mode.__enter__()
    elif not on and st.mode is not None:
        mode, st.mode = st.mode, None
        mode.__exit__(None, None, None)


def checked(name, outputs=None):
    """Make a kernel wrapper one op of the check: with the check active on
    this thread its body runs unchecked and its outputs are checked under
    ``name`` as it returns (what it returns, or ``outputs(args, kwargs,
    result)`` for a wrapper that writes in place); otherwise it runs as it
    is."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not active():
                return fn(*args, **kwargs)
            with suspended():
                out = fn(*args, **kwargs)
                check(name, out if outputs is None
                      else outputs(args, kwargs, out))
            return out
        return run
    return wrap
