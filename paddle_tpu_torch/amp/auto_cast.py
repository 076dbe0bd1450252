"""AMP autocast (counterpart of ``paddle_tpu/amp/auto_cast.py``).

O1: the ops on the white list (matmul, linear and their kind) run in the
low dtype and the black-list ops stay f32: a thread-local mode that the
compute functionals consult through ``amp_cast_inputs`` where the
reference consults it (the linear projections, ``nn.Linear``, and
``tensor.linalg.matmul``). O2: ``decorate`` casts the model's parameters
to the low dtype, and the optimizer keeps f32 master weights
(``multi_precision``).
"""
import contextlib
import threading

import torch

_state = threading.local()

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

# reference: python/paddle/amp/amp_lists.py white/black lists
white_list = {"matmul", "conv2d", "conv1d", "conv3d", "linear", "einsum",
              "bmm", "mm", "attention"}
black_list = {"exp", "log", "softmax", "log_softmax", "cross_entropy",
              "mean", "sum", "norm", "cumsum"}


def _dtype(d):
    return d if isinstance(d, torch.dtype) else _DTYPES[str(d)]


def _tls():
    if not hasattr(_state, "enabled"):
        _state.enabled = False
        _state.dtype = torch.bfloat16
        _state.level = "O1"
        _state.custom_white = set()
        _state.custom_black = set()
    return _state


def is_autocast_enabled():
    return _tls().enabled


def _is_low(d):
    return d in (torch.float16, torch.bfloat16)


def amp_cast_inputs(op_name, tensors):
    """The inputs of ``op_name`` cast as the autocast mode says: a
    black-list op's low-precision inputs to f32, a white-list op's float
    inputs to the autocast dtype, others as they are."""
    t = _tls()
    if not t.enabled:
        return tensors
    if op_name in t.custom_black or (op_name in black_list
                                     and op_name not in t.custom_white):
        return [a.float() if _is_low(a.dtype) else a for a in tensors]
    if op_name in white_list or op_name in t.custom_white:
        return [a.to(t.dtype) if a.is_floating_point() else a
                for a in tensors]
    return tensors


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    t = _tls()
    prev = (t.enabled, t.dtype, t.level, t.custom_white, t.custom_black)
    t.enabled = enable
    t.dtype = _dtype(dtype)
    t.level = level
    t.custom_white = set(custom_white_list or ())
    t.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        t.enabled, t.dtype, t.level, t.custom_white, t.custom_black = prev


autocast = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast each model's floating parameters to ``dtype``; each
    optimizer keeps f32 master weights (``master_weight`` None or True)."""
    dt = _dtype(dtype)
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dt)
    if optimizers is None:
        return models if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    for o in opt_list:
        o._multi_precision = True if master_weight is None else master_weight
    return ((models if single_model else model_list),
            (optimizers if single_opt else opt_list))
