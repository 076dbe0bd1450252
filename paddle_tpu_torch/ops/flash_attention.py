"""Flash attention, forward and backward (counterpart of
``paddle_tpu/ops/flash_attention.py``: K1, the MHA Pallas kernel reached
through ``_get_pallas_impl``, and K2, the GQA splash kernel of
``_splash_impl``).

Layout: q [B, Sq, Hq, D], k and v [B, Sk, Hkv, D] (the paddle layout), with
Hq a multiple of Hkv; the output is [B, Sq, Hq, D]. A causal mask is
bottom-right aligned, ``tril(k=Sk-Sq)``, as the reference's (:382).

``flash_attention_fwd`` picks its tier from the tensor's device: a CPU
tensor runs the plain version ``_attention_math`` through autograd; a CUDA
tensor goes through ``FlashAttention``, whose forward launches the forward
kernel (``csrc/flash_attention_fwd.cu``, which also saves the row log-sum-
exp) and whose backward launches the three backward kernels
(``csrc/flash_attention_bwd.cu``). GQA needs no second kernel: query head h
reads kv head h // group inside the kernels. There is no fallback between
the tiers: a kernel that cannot build or launch raises.
"""
import ctypes

import torch

from . import _build

HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)


def _attention_math(q, k, v, causal, scale):
    """Plain version (the reference's ``_xla_attention`` :377), in the
    paddle layout: f32 scores and softmax, the KV heads expanded to Hq, the
    bottom-right causal mask filled with the f32 minimum, probabilities
    rounded to q's dtype before the product with V, as the reference does.
    Differentiable by autograd."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    hq, hk = qt.shape[1], kt.shape[1]
    if hq != hk:
        kt = kt.repeat_interleave(hq // hk, dim=1)
        vt = vt.repeat_interleave(hq // hk, dim=1)
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs.float(), vt.float()).to(q.dtype)
    return out.transpose(1, 2)


def _attention_bwd_math(q, k, v, out, dout, causal, scale):
    """Plain version of the three backward entries on their own inputs:
    (dq, dk, dv) from q, k, v, the forward's output ``out`` as stored and
    ``dout``, paddle layout. ``delta = rowsum(dout * out)`` in f32 from
    ``out`` as stored, as the kernels and the reference's TPU kernel take
    it (autograd of ``_attention_math`` takes it from the f32 softmax
    instead); P recomputed in f32 with the bottom-right causal mask; dS =
    P * (dP - delta); dq = scale dS K, dk = scale dS^T Q summed over each
    kv head's group, dv = P^T dO; all in f32, each rounded once to q's
    dtype."""
    qt, kt, vt, ot, dot = (x.transpose(1, 2).float()
                           for x in (q, k, v, out, dout))
    hkv, group = kt.shape[1], qt.shape[1] // kt.shape[1]
    if group > 1:
        kt = kt.repeat_interleave(group, dim=1)
        vt = vt.repeat_interleave(group, dim=1)
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    mask = None
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.softmax(logits, dim=-1)
    delta = (dot * ot).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dot, vt.transpose(-1, -2)) - delta)
    if mask is not None:
        # a masked score is a constant, so it passes no gradient back (the
        # rows of a causal Sq > Sk that see no key, where P is uniform)
        ds = ds.masked_fill(~mask, 0.0)
    dq = torch.matmul(ds, kt) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qt) * scale
    dv = torch.matmul(p.transpose(-1, -2), dot)
    if group > 1:
        dk = dk.unflatten(1, (hkv, group)).sum(2)
        dv = dv.unflatten(1, (hkv, group)).sum(2)
    return tuple(x.transpose(1, 2).to(q.dtype).contiguous()
                 for x in (dq, dk, dv))


_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DELTA_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]
_DKDV_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DQ_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check_paddle_layout(name, q, k, v, causal, extra=()):
    """Validate the operands every flash kernel takes."""
    chk = _build.check
    chk(q.is_cuda, name, "q must be a CUDA tensor")
    for t in (k, v, *extra):
        chk(t.device == q.device, name, "operands must share q's device")
    for t in (q, k, v, *extra):
        chk(t.is_contiguous(), name, "operands must be contiguous")
        chk(t.data_ptr() % 16 == 0, name, "operands must be 16-byte aligned")
    chk(str(q.dtype) in _build.DTYPE_CODES, name,
        f"dtype {q.dtype} not in {sorted(_build.DTYPE_CODES)}")
    chk(k.dtype == q.dtype and v.dtype == q.dtype, name,
        "k and v must have q's dtype")
    chk(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape, name,
        "q must be [B, Sq, Hq, D], k and v [B, Sk, Hkv, D]")
    B, sq, hq, D = q.shape
    _, sk, hkv, dk = k.shape
    chk(k.shape[0] == B and dk == D, name, "k and v must match q's B and D")
    chk(D in HEAD_DIMS, name, f"head_dim {D} not in {HEAD_DIMS}")
    chk(hq % hkv == 0 and hq // hkv in GROUPS, name,
        f"Hq/Hkv = {hq}/{hkv} not a group in {GROUPS}")
    chk(B > 0 and sq > 0 and sk > 0, name, "empty batch or sequence")
    chk(not causal or sq <= sk, name,
        "causal attention needs Sq <= Sk (every query row sees a key)")
    return B, sq, sk, hq, hkv, D


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, causal, scale):
    """Launch the forward kernel: returns (out [B, Sq, Hq, D] in q's dtype,
    lse [B, Hq, Sq] f32). Counted in ``flash_fwd.launches``."""
    name = "flash_attention_fwd"
    fn = _build.entry("flash_attention_fwd", "flash_attention_fwd_launch",
                      _FWD_ARGTYPES)
    B, sq, sk, hq, hkv, D = _check_paddle_layout(name, q, k, v, causal)
    out = torch.empty_like(q)
    lse = torch.empty((B, hq, sq), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, sq, sk, hq, hkv, D, int(causal), float(scale),
            _build.DTYPE_CODES[str(q.dtype)], _stream(q))
    _build.check_status(rc, name)
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_delta(out, dout):
    """Launch the delta pass: rowsum(dout * out) in f32, [B, Hq, Sq].
    Counted in ``flash_bwd_delta.launches``."""
    name = "flash_attention_bwd_delta"
    fn = _build.entry("flash_attention_bwd",
                      "flash_attention_bwd_delta_launch", _DELTA_ARGTYPES)
    chk = _build.check
    chk(out.is_cuda and dout.device == out.device, name,
        "out and dout must be CUDA tensors on one device")
    for t in (out, dout):
        chk(t.is_contiguous(), name, "operands must be contiguous")
        chk(t.data_ptr() % 16 == 0, name, "operands must be 16-byte aligned")
    chk(str(out.dtype) in _build.DTYPE_CODES and dout.dtype == out.dtype,
        name, f"dtype {out.dtype}/{dout.dtype} not one of "
        f"{sorted(_build.DTYPE_CODES)}")
    chk(out.dim() == 4 and dout.shape == out.shape, name,
        "out and dout must be [B, Sq, Hq, D]")
    B, sq, hq, D = out.shape
    chk(D in HEAD_DIMS, name, f"head_dim {D} not in {HEAD_DIMS}")
    chk(B > 0 and sq > 0 and hq > 0, name, "empty batch or sequence")
    delta = torch.empty((B, hq, sq), dtype=torch.float32, device=out.device)
    rc = fn(out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B, sq, hq, D,
            _build.DTYPE_CODES[str(out.dtype)], _stream(out))
    _build.check_status(rc, name)
    flash_bwd_delta.launches += 1
    return delta


def _launch_grad(name, fn, q, k, v, dout, lse, delta, causal, scale, outs):
    """Validate the operands of a gradient kernel and launch it, writing
    ``outs`` (the gradient tensors, allocated by the caller)."""
    B, sq, sk, hq, hkv, D = _check_paddle_layout(
        name, q, k, v, causal, extra=(dout, lse, delta))
    _build.check(dout.shape == q.shape and dout.dtype == q.dtype, name,
                 "dout must match q")
    for t in (lse, delta):
        _build.check(t.dtype == torch.float32 and t.shape == (B, hq, sq),
                     name, "lse and delta must be f32 [B, Hq, Sq]")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            B, sq, sk, hq, hkv, D, int(causal), float(scale),
            _build.DTYPE_CODES[str(q.dtype)], _stream(q))
    _build.check_status(rc, name)


def flash_bwd_dkdv(q, k, v, dout, lse, delta, causal, scale):
    """Launch the dK/dV kernel: returns (dk, dv) shaped and typed as k.
    Counted in ``flash_bwd_dkdv.launches``."""
    fn = _build.entry("flash_attention_bwd", "flash_attention_bwd_dkdv_launch",
                      _DKDV_ARGTYPES)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_grad("flash_attention_bwd_dkdv", fn, q, k, v, dout, lse, delta,
                 causal, scale, (dk, dv))
    flash_bwd_dkdv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale):
    """Launch the dQ kernel: returns dq shaped and typed as q. Counted in
    ``flash_bwd_dq.launches``."""
    fn = _build.entry("flash_attention_bwd", "flash_attention_bwd_dq_launch",
                      _DQ_ARGTYPES)
    dq = torch.empty_like(q)
    _launch_grad("flash_attention_bwd_dq", fn, q, k, v, dout, lse, delta,
                 causal, scale, (dq,))
    flash_bwd_dq.launches += 1
    return dq


KERNELS = (flash_fwd, flash_bwd_delta, flash_bwd_dkdv, flash_bwd_dq)
for _k in KERNELS:
    _k.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention with the flash kernels' forward and backward.

    On a CUDA tensor the forward launches the forward kernel and keeps its
    lse; the backward launches delta, dK/dV and dQ. On a CPU tensor both
    directions run the plain version (the backward through autograd on a
    recomputed forward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.causal, ctx.scale = causal, scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return _attention_math(q, k, v, causal, scale)
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, scale = ctx.causal, ctx.scale
        if dout.device.type == "cpu":
            q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
            with torch.enable_grad():
                out = _attention_math(q, k, v, causal, scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
            return dq, dk, dv, None, None
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_bwd_delta(out, dout)
        dk, dv = flash_bwd_dkdv(q, k, v, dout, lse, delta, causal, scale)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
        return dq, dk, dv, None, None


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (paddle layout) -> [B, Sq, Hq,
    D]. A CPU tensor runs the plain version through autograd; a CUDA tensor
    runs the flash kernels (forward now, backward under autograd)."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return _attention_math(q, k, v, causal, scale)
    return FlashAttention.apply(q, k, v, causal, scale)
