"""Flash / SDP attention in the paddle layout (counterpart of
``paddle_tpu/nn/functional/flash_attention.py``).

q/k/v are [batch, seqlen, num_heads, head_dim]. With no mask, no dropout
and flash enabled (the reference's gate, :160), a call goes to
``ops.flash_attention.flash_attention_fwd``: the flash kernels on a CUDA
tensor, their plain version on a CPU tensor. A mask or dropout takes
``_math_attention`` in plain PyTorch, which the reference also computes
outside any Pallas kernel.
"""
import contextlib

import torch
import torch.nn.functional as F

from ...ops.flash_attention import flash_attention_fwd

_sdp_config = {"enable_flash": True}


@contextlib.contextmanager
def sdp_kernel(enable_flash=True, enable_math=True, enable_mem_efficient=True):
    """Select the attention tier for the calls inside the block:
    ``enable_flash=False`` forces ``_math_attention``. The other two
    arguments keep the reference's signature and select nothing: the math
    tier is always there, and there is no memory-efficient tier."""
    prev = _sdp_config["enable_flash"]
    _sdp_config["enable_flash"] = enable_flash
    try:
        yield
    finally:
        _sdp_config["enable_flash"] = prev


def _math_attention(q, k, v, mask, causal, dropout, scale):
    """Masked / dropout attention in plain PyTorch ([B, S, H, D] in and
    out): f32 scores, KV heads expanded, bottom-right causal mask and a bool
    or additive ``mask`` as -inf / addend, probabilities in q's dtype."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    hq, hk = qt.shape[1], kt.shape[1]
    if hq != hk:
        kt = kt.repeat_interleave(hq // hk, dim=1)
        vt = vt.repeat_interleave(hq // hk, dim=1)
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(sq, sk, dtype=torch.bool,
                        device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~cm, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout > 0.0:
        probs = F.dropout(probs, p=dropout)
    out = torch.matmul(probs, vt)
    return out.transpose(1, 2)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """paddle.nn.functional.flash_attention.flash_attention parity: returns
    (out, None)."""
    scale = 1.0 / (query.shape[-1] ** 0.5)
    drop = dropout if training else 0.0
    if drop == 0.0 and _sdp_config["enable_flash"]:
        return flash_attention_fwd(query, key, value, causal=causal,
                                   scale=scale), None
    return _math_attention(query, key, value, None, causal, drop,
                           scale), None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """paddle.nn.functional.scaled_dot_product_attention parity, layout
    [batch, seqlen, heads, head_dim]."""
    scale = 1.0 / (query.shape[-1] ** 0.5)
    drop = dropout_p if training else 0.0
    if attn_mask is None and drop == 0.0 and _sdp_config["enable_flash"]:
        return flash_attention_fwd(query, key, value, causal=is_causal,
                                   scale=scale)
    return _math_attention(query, key, value, attn_mask, is_causal, drop,
                           scale)
