"""paddle.amp.debugging (counterpart of ``paddle_tpu/amp/debugging.py``;
reference: python/paddle/amp/debugging.py): ``check_numerics`` on one
tensor, and the per-op NaN/Inf scan behind ``FLAGS_check_nan_inf``
(``framework.nan_inf``) switched on and off."""
import contextlib

import torch

from ..framework import flags as F


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


def check_numerics(tensor, op_type="", var_name="",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """Count the NaN, Inf and zero elements of one tensor (in f32, as the
    reference reads them) and return them as three int64 tensors on the
    tensor's device; under CHECK_NAN_INF_AND_ABORT a NaN or an Inf raises
    FloatingPointError naming ``op_type`` and ``var_name``."""
    d = torch.as_tensor(tensor).float()
    counts = torch.stack([torch.isnan(d).sum(), torch.isinf(d).sum(),
                          (d == 0).sum()])
    n_nan, n_inf, _ = counts.tolist()
    if (n_nan or n_inf) and debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
        raise FloatingPointError(
            f"[check_numerics] op={op_type} var={var_name}: {n_nan} NaN, "
            f"{n_inf} Inf")
    return tuple(counts.unbind())


def enable_operator_stats_collection():
    """Turn on the per-op NaN/Inf scan (FLAGS_check_nan_inf), warning."""
    F.set_flags({"check_nan_inf": True, "check_nan_inf_level": 1})


def disable_operator_stats_collection():
    F.set_flags({"check_nan_inf": False, "check_nan_inf_level": 0})


@contextlib.contextmanager
def collect_operator_numerical_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()
