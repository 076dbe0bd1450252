"""AMP of the port (counterpart of ``paddle_tpu/amp``): ``auto_cast`` and
``decorate`` (bf16 or fp16; O2 keeps f32 master weights), the dynamic
loss scaler, and ``debugging`` (``check_numerics`` and the per-op
NaN/Inf scan behind ``FLAGS_check_nan_inf``)."""
import torch

from . import debugging
from .auto_cast import (
    auto_cast, autocast, decorate, is_autocast_enabled, white_list,
)
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "autocast", "decorate", "GradScaler", "AmpScaler",
           "debugging",
           "is_autocast_enabled", "white_list", "is_bfloat16_supported",
           "is_float16_supported"]


def is_bfloat16_supported(place=None):
    """The H100 computes bf16 on its tensor cores; the CPU emulates it."""
    return True


def is_float16_supported(place=None):
    """fp16 is a card's type: True with CUDA. The training and serving
    kernels have fp16 instances (the flash kernels, AdamW, the gradient
    norm, the paged kernels); the weight-only product and the MoE kernels
    take f32 and bf16 only (ROADMAP.md section 1 item 3)."""
    return torch.cuda.is_available()
