"""RMSNorm, rotary embedding and SwiGLU as plain PyTorch functions.

Counterparts: ``rms_norm`` of ``paddle_tpu/nn/functional/norm.py``, and
``rope_rotate``, ``fused_rotary_position_embedding`` and ``swiglu`` of
``paddle_tpu/incubate/nn/functional.py``. The reference lowers them to XLA
fused math, not to Pallas kernels; the arithmetic (f32 inside, cast back to
the input dtype) is kept step for step. The attention functionals live in
``flash_attention.py`` and are re-exported here, as the reference's
``nn.functional`` does.
"""
import torch
import torch.nn.functional as F

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


def rope_tables(n_positions, head_dim, base=10000.0, device=None):
    """(cos, sin) tables [n_positions, head_dim] in f32, rotate-half form."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    freqs = torch.outer(torch.arange(n_positions, dtype=torch.float32,
                                     device=device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def rope_rotate(x, cos, sin):
    """Rotate-half rope on [B, S, H, D]."""
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    rotary_emb_base=10000.0):
    """Rope on [batch, seq, heads, head_dim] tensors. cos/sin tables
    ([S_tab, D]) are built from ``rotary_emb_base`` when not given;
    ``position_ids`` [B, S] gathers their rows. Math in f32, results in
    each input's dtype."""
    B, S, H, D = q.shape
    if sin is None or cos is None:
        cos, sin = rope_tables(S, D, rotary_emb_base, device=q.device)
    if position_ids is not None:
        pid = position_ids.long()
        cos_a, sin_a = cos[pid][:, :, None, :], sin[pid][:, :, None, :]
    else:
        cos_a, sin_a = cos[None, :, None, :], sin[None, :, None, :]
    return tuple(None if t is None
                 else rope_rotate(t.float(), cos_a, sin_a).to(t.dtype)
                 for t in (q, k, v))


def swiglu(x, y=None):
    """LLaMA MLP gate: silu(x) * y; with y None, x is split in halves."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y
