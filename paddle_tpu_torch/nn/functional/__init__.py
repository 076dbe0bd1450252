"""RMSNorm as a plain PyTorch function, and the functionals the model
reaches through this module.

``rms_norm`` is the counterpart of ``paddle_tpu/nn/functional/norm.py``;
the reference lowers it to XLA fused math, not to a Pallas kernel, and the
arithmetic (f32 inside, cast back to the input dtype) is kept step for
step. ``rope_rotate``, ``fused_rotary_position_embedding``, ``swiglu`` and
``rope_tables`` live in ``paddle_tpu_torch.incubate.nn.functional``, where
the reference defines them, and are re-exported here; the attention
functionals live in ``flash_attention.py`` and are re-exported here, as
the reference's ``nn.functional`` does.
"""
import torch

from ...incubate.nn.functional import (  # noqa: F401  (re-exported)
    fused_rotary_position_embedding, rope_rotate, rope_tables, swiglu,
)
from .flash_attention import (  # noqa: F401  (re-exported)
    flash_attention, scaled_dot_product_attention, sdp_kernel,
)


def rms_norm(x, weight=None, epsilon=1e-6):
    """x * rsqrt(mean(x^2) + eps) in f32, cast back to x's dtype, then
    scaled by ``weight`` in that dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out * weight if weight is not None else out
