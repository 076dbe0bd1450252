"""Runtime flag registry (the port's own copy of
``paddle_tpu/framework/flags.py``; reference: paddle/utils/flags.h
PD_DEFINE_EXPORTED_* and the flags.cc registry). Python surface:
``set_flags`` / ``get_flags``, each name with or without its ``FLAGS_``
prefix; a flag's default is overridden by the environment variable
``FLAGS_<name>``, read once at import (through ``utils.envs``).

The registry carries the reference's flags. ``set_flags`` also accepts an
unknown name (stored, inert), so that scripts setting flags of other
backends keep running; ``get_flags`` raises ValueError on a name that was
never set.
"""
import threading

from ..utils.envs import env_str

_lock = threading.Lock()
_TRUE = ("1", "true", "yes", "on")


def _env_default(name, default, typ):
    raw = env_str(f"FLAGS_{name}")
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() in _TRUE
    try:
        return typ(raw)
    except ValueError:
        return default


# name -> (default, type, help)
_DEFS = {
    # debugging (reference: nan_inf_utils_detail, enforce)
    "check_nan_inf": (False, bool, "scan every eager op output for NaN/Inf"),
    "check_nan_inf_level": (0, int, "0 raise, 1 warn"),
    "call_stack_level": (2, int, "error message verbosity"),
    # determinism (reference: cudnn_deterministic)
    "cudnn_deterministic": (False, bool, "accepted for script compat"),
    "embedding_deterministic": (0, int, "script compat"),
    # allocator (reference: FLAGS_fraction_of_gpu_memory_to_use etc.)
    "fraction_of_gpu_memory_to_use": (0.92, float, "script compat"),
    "allocator_strategy": ("auto_growth", str, "script compat"),
    "gpu_memory_limit_mb": (0, int, "script compat"),
    # profiler / logging
    "enable_profiler": (False, bool, "v1 profiler toggle"),
    "v": (0, int, "glog-style verbosity (GLOG_v)"),
    # distributed
    "distributed_timeout_s": (900, int, "rendezvous / collective timeout"),
    "stop_check_timeout": (300, int, "launcher watchdog timeout"),
    # numerics
    "use_tf32": (True, bool, "script compat"),
    "matmul_use_bf16": (True, bool, "prefer bf16 matmul accumulation inputs"),
}

_values = {}
_types = {}
for _n, (_d, _t, _h) in _DEFS.items():
    _values[_n] = _env_default(_n, _d, _t)
    _types[_n] = _t


def _bare(name):
    return name[6:] if name.startswith("FLAGS_") else name


def set_flags(flags):
    """paddle.set_flags: {'FLAGS_name': value} or {'name': value}; a known
    flag's value is converted to its type (a bool from '1'/'true'/...).
    Setting ``check_nan_inf`` installs or removes the per-op check on the
    calling thread (``nan_inf``)."""
    with _lock:
        for k, v in flags.items():
            name = _bare(k)
            t = _types.get(name)
            if t is bool and isinstance(v, str):
                v = v.lower() in _TRUE
            elif t is not None and not isinstance(v, t):
                v = t(v)
            _values[name] = v
    if any(_bare(k) == "check_nan_inf" for k in flags):
        from . import nan_inf

        nan_inf.sync_mode()


def get_flags(flags):
    """paddle.get_flags: a name or a list of names -> {FLAGS_name: value}."""
    names = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    with _lock:
        for k in names:
            name = _bare(k)
            if name not in _values:
                raise ValueError(f"unknown flag {k}")
            out[f"FLAGS_{name}"] = _values[name]
    return out


def flag(name, default=None):
    """A flag's value without the lock (the per-op check reads it)."""
    return _values.get(name, default)
