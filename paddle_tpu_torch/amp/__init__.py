"""AMP of the port (counterpart of ``paddle_tpu/amp``): ``auto_cast`` and
``decorate``, and the dynamic loss scaler. ``amp.debugging`` comes in a
later slice (ROADMAP.md)."""
import torch

from .auto_cast import (
    auto_cast, autocast, decorate, is_autocast_enabled, white_list,
)
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "autocast", "decorate", "GradScaler", "AmpScaler",
           "is_autocast_enabled", "white_list", "is_bfloat16_supported",
           "is_float16_supported"]


def is_bfloat16_supported(place=None):
    """The H100 computes bf16 on its tensor cores; the CPU emulates it."""
    return True


def is_float16_supported(place=None):
    """fp16 is a card's type: True with CUDA. The port's kernels take f32
    and bf16 only; fp16 instances come later (ROADMAP.md)."""
    return torch.cuda.is_available()
