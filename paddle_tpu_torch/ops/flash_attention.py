"""Flash attention, forward and backward (counterpart of
``paddle_tpu/ops/flash_attention.py``: K1, the MHA Pallas kernel reached
through ``_get_pallas_impl``; K2, the GQA splash kernel of
``_splash_impl``; K3, the splash kernel with segment ids of
``flash_attention_packed`` and ``_splash_varlen``; and K6, one visit of
``ops/ring_attention.py::_ring_kernel_fwd_impl``: ``ring_flash_fwd``, the
forward kernel with an epilogue that merges into the ring's running
output, whose ring and backward live in ``ring_attention.py``).

Layout: q [B, Sq, Hq, D], k and v [B, Sk, Hkv, D] (the paddle layout), with
Hq a multiple of Hkv; the output is [B, Sq, Hq, D]. K1/K2: a causal mask is
bottom-right aligned, ``tril(k=Sk-Sq)``, as the reference's (:382). K3: a
query sees the keys of its own segment and, when causal, only those at or
before its position in the segment (``Segments``); the packed form takes
[B, S] segment ids, the varlen form the [total, H, D] layout with
cumulative offsets.

``flash_attention_fwd`` (and K3's ``flash_attention_packed`` and
``flash_attention_varlen_fwd``) pick their tier from the tensor's device: a
CPU tensor runs the plain version (``_attention_math``, ``_segment_math``)
through autograd; a CUDA tensor goes through ``FlashAttention`` (or
``SegmentFlashAttention``), whose forward launches the forward kernel
(``csrc/flash_attention_fwd.cu``, which also saves the row log-sum-exp:
for bf16 and fp16 a persistent Hopper kernel of TMA loads and wgmma
products, one instance each, for f32 a CUDA-core tile loop) and
whose backward launches the three backward kernels
(``csrc/flash_attention_bwd.cu``: delta, then for bf16 and fp16 persistent
Hopper kernels for dK/dV and dQ, for f32 CUDA-core tile loops; the 16-bit
ones can add into f32 sums instead of writing, for K6's ring). An fp16
instance rounds where the bf16 one does (P before P.V, P and dS before
their products, the outputs once) and launches on fp16 tensors as they
are: nothing is cast around a kernel. GQA needs no second
kernel: query head h
reads kv head h // group inside the kernels. K3's kernels are K1's with the
segment mask and a tile-range table (``_tile_ranges``) that lets each block
visit only the tiles its segments can see. There is no fallback between
the tiers: a kernel that cannot build or launch raises. Each wrapper
counts its launches in ``.launches`` and, of those, the fp16 instance's
in ``.launches_fp16``.
"""
import ctypes
from typing import NamedTuple

import torch

from ..framework.nan_inf import checked
from . import _build

HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)
#: the dtypes of the Hopper (TMA + wgmma) instances
HOPPER_DTYPES = (torch.bfloat16, torch.float16)


def _causal_mask(q, k, causal):
    """K1's bottom-right causal mask [Sq, Sk] (None when not causal)."""
    if not causal:
        return None
    sq, sk = q.shape[1], k.shape[1]
    return torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)


def _masked_attention(q, k, v, mask, scale, zero_empty=False):
    """Attention in the paddle layout under ``mask`` (None, or broadcast
    to [B, Hq, Sq, Sk]; True = visible): f32 scores and softmax, the KV
    heads expanded to Hq, masked scores filled with the f32 minimum,
    probabilities rounded to q's dtype before the product with V, as the
    reference does. A row that sees no key spreads over every key (the
    reference's ``_xla_attention``), or with ``zero_empty`` comes out 0
    (its ``_dense_varlen``). Differentiable by autograd."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    hq, hk = qt.shape[1], kt.shape[1]
    if hq != hk:
        kt = kt.repeat_interleave(hq // hk, dim=1)
        vt = vt.repeat_interleave(hq // hk, dim=1)
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    if zero_empty:
        probs = probs * mask.any(-1, keepdim=True)
    out = torch.matmul(probs.to(q.dtype).float(), vt.float()).to(q.dtype)
    return out.transpose(1, 2)


def _attention_math(q, k, v, causal, scale):
    """Plain version of K1/K2 (the reference's ``_xla_attention`` :377):
    ``_masked_attention`` under the bottom-right causal mask."""
    return _masked_attention(q, k, v, _causal_mask(q, k, causal), scale)


def _attention_bwd_math(q, k, v, out, dout, causal, scale):
    """Plain version of K1/K2's backward entries: ``_masked_bwd`` under the
    bottom-right causal mask."""
    return _masked_bwd(q, k, v, out, dout, _causal_mask(q, k, causal), scale)


def _masked_bwd(q, k, v, out, dout, mask, scale, zero_empty=False):
    """Plain version of the three backward entries on their own inputs:
    (dq, dk, dv) from q, k, v, the forward's output ``out`` as stored and
    ``dout``, paddle layout, under ``_masked_attention``'s mask and
    ``zero_empty``. ``delta = rowsum(dout * out)`` in f32 from ``out`` as
    stored, as the kernels and the reference's TPU kernel take it
    (autograd of the forward takes it from the f32 softmax instead); P
    recomputed in f32; dS = P * (dP - delta); dq = scale dS K, dk = scale
    dS^T Q summed over each kv head's group, dv = P^T dO; all in f32, each
    rounded once to q's dtype."""
    qt, kt, vt, ot, dot = (x.transpose(1, 2).float()
                           for x in (q, k, v, out, dout))
    hkv, group = kt.shape[1], qt.shape[1] // kt.shape[1]
    if group > 1:
        kt = kt.repeat_interleave(group, dim=1)
        vt = vt.repeat_interleave(group, dim=1)
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.softmax(logits, dim=-1)
    if zero_empty:
        p = p * mask.any(-1, keepdim=True)
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
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p])
_DQ_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])


def _check_paddle_layout(name, q, k, v, causal, extra=()):
    """Validate the operands every flash kernel takes."""
    chk = _build.check
    chk(q.is_cuda, name, "q must be a CUDA tensor")
    for t in (k, v, *extra):
        chk(t.device == q.device, name, "operands must share q's device")
    for t in (q, k, v, *extra):
        chk(t.is_contiguous(), name, "operands must be contiguous")
        # (the bf16 forward's TMA tensor maps need 16-byte aligned bases,
        # which a ring shard of a stacked tensor may not have)
        chk(t.data_ptr() % 16 == 0, name, "operands must be 16-byte aligned")
    _build.check_dtype(name, q)
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


def _out_only(args, kwargs, result):
    """A forward's checked output (``FLAGS_check_nan_inf``): out, not its
    lse, a residual that is -inf where a row sees no key."""
    return result[0]


def _no_outputs(args, kwargs, result):
    """The delta pass's: none, its rowsum is a residual of the backward."""
    return ()


@checked("flash_attention_fwd", _out_only)
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
    _build.count_launch(flash_fwd, like=q)
    return out, lse


@checked("flash_attention_bwd_delta", _no_outputs)
def flash_bwd_delta(out, dout):
    """Launch the delta pass: rowsum(dout * out) in f32, [B, Hq, Sq].
    Counted in ``flash_bwd_delta.launches``."""
    delta = _delta(out, dout, "flash_attention_bwd_delta")
    _build.count_launch(flash_bwd_delta, like=out)
    return delta


def _delta(out, dout, name):
    """Validate and launch the delta kernel (errors name ``name``)."""
    fn = _build.entry("flash_attention_bwd",
                      "flash_attention_bwd_delta_launch", _DELTA_ARGTYPES)
    chk = _build.check
    chk(out.is_cuda and dout.device == out.device, name,
        "out and dout must be CUDA tensors on one device")
    for t in (out, dout):
        chk(t.is_contiguous(), name, "operands must be contiguous")
        chk(t.data_ptr() % 16 == 0, name, "operands must be 16-byte aligned")
    _build.check_dtype(name, out)
    chk(dout.dtype == out.dtype, name, "dout must have out's dtype")
    chk(out.dim() == 4 and dout.shape == out.shape, name,
        "out and dout must be [B, Sq, Hq, D]")
    B, sq, hq, D = out.shape
    chk(D in HEAD_DIMS, name, f"head_dim {D} not in {HEAD_DIMS}")
    chk(B > 0 and sq > 0 and hq > 0, name, "empty batch or sequence")
    delta = torch.empty((B, hq, sq), dtype=torch.float32, device=out.device)
    rc = fn(out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B, sq, hq, D,
            _build.DTYPE_CODES[str(out.dtype)], _stream(out))
    _build.check_status(rc, name)
    return delta


def _launch_grad(name, fn, q, k, v, dout, lse, delta, causal, scale, outs,
                 accumulate=False):
    """Validate the operands of a gradient kernel and launch it, writing
    ``outs`` (the gradient tensors, allocated by the caller) or, with
    ``accumulate``, adding into them (f32 sums of the gradients' shapes; the
    bf16 and fp16 kernels only)."""
    B, sq, sk, hq, hkv, D = _check_paddle_layout(
        name, q, k, v, causal, extra=(dout, lse, delta, *outs))
    _check_grad_inputs(name, q, dout, lse, delta)
    if accumulate:
        for t, like in zip(outs, (k, v) if len(outs) == 2 else (q,)):
            _build.check(t.dtype == torch.float32 and t.shape == like.shape,
                         name, "the sums must be f32 of the gradients' shapes")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            B, sq, sk, hq, hkv, D, int(causal), float(scale),
            _build.DTYPE_CODES[str(q.dtype)], int(accumulate), _stream(q))
    _build.check_status(rc, name)


def _into(acc, grads):
    """Add the gradients of an f32 launch into the caller's sums."""
    for a, g in zip(acc, grads):
        a += g


def _check_grad_inputs(name, q, dout, lse, delta):
    """Validate a gradient kernel's dout, lse and delta against q."""
    B, sq, hq = q.shape[0], q.shape[1], q.shape[2]
    _build.check(dout.shape == q.shape and dout.dtype == q.dtype, name,
                 "dout must match q")
    for t in (lse, delta):
        _build.check(t.dtype == torch.float32 and t.shape == (B, hq, sq),
                     name, "lse and delta must be f32 [B, Hq, Sq]")


@checked("flash_attention_bwd_dkdv")
def flash_bwd_dkdv(q, k, v, dout, lse, delta, causal, scale, acc=None):
    """Launch the dK/dV kernel: returns (dk, dv) shaped and typed as k.
    ``acc``: f32 sums (dk, dv) of k's shape that the gradients are added to
    and that are returned instead (K6's ring visits): bf16 and fp16 add
    them in the kernel's epilogue, so they never exist in 16 bits; f32
    launches into a fresh pair and adds it. Counted in
    ``flash_bwd_dkdv.launches``."""
    fn = _build.entry("flash_attention_bwd", "flash_attention_bwd_dkdv_launch",
                      _DKDV_ARGTYPES)
    in_kernel = acc is not None and q.dtype in HOPPER_DTYPES
    outs = acc if in_kernel else (torch.empty_like(k), torch.empty_like(v))
    _launch_grad("flash_attention_bwd_dkdv", fn, q, k, v, dout, lse, delta,
                 causal, scale, tuple(outs), accumulate=in_kernel)
    _build.count_launch(flash_bwd_dkdv, like=q)
    if acc is None or in_kernel:
        return tuple(outs)
    _into(acc, outs)
    return tuple(acc)


@checked("flash_attention_bwd_dq")
def flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale, acc=None):
    """Launch the dQ kernel: returns dq shaped and typed as q. ``acc``: an
    f32 sum of q's shape that dq is added to and that is returned instead,
    as ``flash_bwd_dkdv``'s. Counted in ``flash_bwd_dq.launches``."""
    fn = _build.entry("flash_attention_bwd", "flash_attention_bwd_dq_launch",
                      _DQ_ARGTYPES)
    in_kernel = acc is not None and q.dtype in HOPPER_DTYPES
    dq = acc if in_kernel else torch.empty_like(q)
    _launch_grad("flash_attention_bwd_dq", fn, q, k, v, dout, lse, delta,
                 causal, scale, (dq,), accumulate=in_kernel)
    _build.count_launch(flash_bwd_dq, like=q)
    if acc is None or in_kernel:
        return dq
    _into((acc,), (dq,))
    return acc


KERNELS = (flash_fwd, flash_bwd_delta, flash_bwd_dkdv, flash_bwd_dq)
for _k in KERNELS:
    _k.launches = _k.launches_fp16 = 0


# -- K6: one ring visit, merged into the ring's running state ----------------

def _visit_math(q, k, v, causal, scale):
    """Plain version of one ring visit's attention: (o, lse), o [B, Sq, Hq,
    D] f32 normalized and unrounded (the kernel keeps the visit's output in
    f32 registers), lse [B, Hq, Sq] f32 (-inf where a row sees no key),
    probabilities rounded to q's dtype before the product with V as in
    ``_masked_attention``."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    hq, hk = qt.shape[1], kt.shape[1]
    if hq != hk:
        kt = kt.repeat_interleave(hq // hk, dim=1)
        vt = vt.repeat_interleave(hq // hk, dim=1)
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    mask = _causal_mask(q, k, causal)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse.masked_fill(lse == float("-inf"), 0)[
        ..., None])
    out = torch.matmul(probs.to(q.dtype).float(), vt.float())
    return out.transpose(1, 2), lse


def _ring_merge_math(o_acc, lse_acc, o_visit, lse_visit):
    """Plain version of K6's epilogue, the counterpart of the reference's
    ``_online_merge`` (ring_attention.py:50) on normalized outputs and
    log-sum-exps: lse' = logaddexp(lse_acc, lse_v), o' = o_acc
    exp(lse_acc - lse') + o_v exp(lse_v - lse'); o [B, S, H, D], lse [B, H,
    S], f32. A side at -inf weighs 0, and a row at -inf on both stays 0."""
    merged = torch.logaddexp(lse_acc, lse_visit)
    empty = merged == float("-inf")

    def weight(lse):
        w = torch.exp(lse - merged.masked_fill(empty, 0))
        return w.masked_fill(empty, 0).transpose(1, 2)[..., None]

    return o_acc * weight(lse_acc) + o_visit * weight(lse_visit), merged


_RING_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


@checked("flash_attention_ring_fwd", _out_only)
def ring_flash_fwd(q, k, v, o_acc, lse_acc, causal, scale, first=False,
                   out=None):
    """K6, one ring visit: attention of q [B, Sq, Hq, D] over the visiting
    k, v [B, Sk, Hkv, D] (``causal``: the diagonal visit, Sq == Sk), merged
    IN PLACE into the ring's running state, ``o_acc`` (f32, q's shape) and
    ``lse_acc`` (f32 [B, Hq, Sq]). ``first``: the state is empty and is not
    read. ``out`` (q's shape and dtype): the ring's last visit writes the
    merged output there instead of into ``o_acc`` (which may then be None
    on a visit that is also first). Returns (merged output, lse_acc). A CPU
    tensor runs the plain version (``_visit_math``, ``_ring_merge_math``);
    a CUDA tensor launches ``flash_attention_ring_fwd_launch``, counted in
    ``ring_flash_fwd.launches``."""
    target = out if out is not None else o_acc
    if q.device.type == "cpu":
        o_v, lse_v = _visit_math(q, k, v, causal, scale)
        if not first:
            o_v, lse_v = _ring_merge_math(o_acc, lse_acc, o_v, lse_v)
        lse_acc.copy_(lse_v)
        target.copy_(o_v)
        return target, lse_acc
    name = "flash_attention_ring_fwd"
    fn = _build.entry("flash_attention_fwd", "flash_attention_ring_fwd_launch",
                      _RING_FWD_ARGTYPES)
    chk = _build.check
    state = [t for t in (o_acc, lse_acc, out) if t is not None]
    B, sq, sk, hq, hkv, D = _check_paddle_layout(name, q, k, v, False,
                                                 extra=state)
    chk(not causal or sq == sk, name,
        "a causal (diagonal) visit needs Sq == Sk")
    chk(target is not None, name, "o_acc or out is needed")
    chk(o_acc is not None or first, name,
        "a visit after the first needs o_acc")
    chk(o_acc is None or (o_acc.dtype == torch.float32
                          and o_acc.shape == q.shape), name,
        "o_acc must be f32 [B, Sq, Hq, D]")
    chk(lse_acc.dtype == torch.float32 and lse_acc.shape == (B, hq, sq), name,
        "lse_acc must be f32 [B, Hq, Sq]")
    chk(out is None or (out.dtype == q.dtype and out.shape == q.shape), name,
        "out must match q")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if o_acc is None else o_acc.data_ptr(), lse_acc.data_ptr(),
            0 if out is None else out.data_ptr(), int(first), B, sq, sk, hq,
            hkv, D, int(causal), float(scale),
            _build.DTYPE_CODES[str(q.dtype)], _stream(q))
    _build.check_status(rc, name)
    _build.count_launch(ring_flash_fwd, like=q)
    return target, lse_acc


ring_flash_fwd.launches = ring_flash_fwd.launches_fp16 = 0


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


# -- K3: segment-masked attention (packed rows and varlen) -------------------

class Segments(NamedTuple):
    """K3's view of a call: int32 segment ids and positions of the queries
    ([B, Sq]) and of the keys ([B, Sk]). Key j is visible to query i when
    ``seg_q[i] == seg_k[j]`` and, under a causal mask, ``pos_q[i] >=
    pos_k[j]``. Within a segment the positions rise by one per token."""

    seg_q: torch.Tensor
    pos_q: torch.Tensor
    seg_k: torch.Tensor
    pos_k: torch.Tensor

    def mask(self, causal):
        """[B, Sq, Sk] bool, True = visible."""
        mask = self.seg_q[:, :, None] == self.seg_k[:, None, :]
        if causal:
            mask = mask & (self.pos_q[:, :, None] >= self.pos_k[:, None, :])
        return mask


def varlen_segment_ids(cu_seqlens, total):
    """Token -> sequence index from cumulative offsets (reference :172):
    cu [0, 3, 5], total 6 -> [0, 0, 0, 1, 1, 2]; tokens past cu[-1] get the
    next id, the padding segment. int32 [total]."""
    cu = torch.as_tensor(cu_seqlens).long()
    tokens = torch.arange(total, device=cu.device)
    return torch.searchsorted(cu[1:], tokens, right=True, out_int32=True)


def packed_position_ids(segment_ids):
    """[B, S] within-segment positions for rope (reference :324): each
    token's index minus its segment's start, for ids contiguous and
    ascending along a row (the packing contract). int32."""
    seg = torch.as_tensor(segment_ids).to(torch.int32).contiguous()
    start = torch.searchsorted(seg, seg, side="left", out_int32=True)
    return torch.arange(seg.shape[-1], dtype=torch.int32,
                        device=seg.device) - start


def _packed_segments(segment_ids):
    """Segments of packed rows: the ids on both sides and each token's
    index in the row as its position, so causal is the reference's global
    ``tril`` ∧ same segment for any ids (for contiguous segments, the same
    as within-segment causal)."""
    seg = torch.as_tensor(segment_ids).to(torch.int32).contiguous()
    pos = torch.arange(seg.shape[-1], dtype=torch.int32,
                       device=seg.device).expand(seg.shape).contiguous()
    return Segments(seg, pos, seg, pos)


def _varlen_segments(cu_q, cu_k, total_q, total_k, device):
    """Segments of the varlen layout (batch 1): ids from ``cu_*`` and the
    position within each sequence, ``index - cu[seg]``, as the reference's
    ``_dense_varlen`` (:257): causal is top-left aligned within each
    sequence, whatever its query and key lengths."""
    out = []
    for cu, total in ((cu_q, total_q), (cu_k, total_k)):
        cu = torch.as_tensor(cu, device=device).long()
        seg = varlen_segment_ids(cu, total)
        pos = torch.arange(total, device=device) - cu[seg.long()]
        out += [seg[None], pos.to(torch.int32)[None]]
    return Segments(*out)


def _segment_math(q, k, v, segs, causal, scale):
    """Plain version of K3 (the reference's dense branches of
    ``flash_attention_packed`` :309-321 and ``_dense_varlen`` :257):
    ``_masked_attention`` under the segment mask, a row that sees no key
    coming out 0. A packed query always sees itself, so there the f32
    minimum and the varlen branch's -inf give the same bits."""
    return _masked_attention(q, k, v, segs.mask(causal)[:, None], scale,
                             zero_empty=True)


def _segment_bwd_math(q, k, v, out, dout, segs, causal, scale):
    """Plain version of K3's backward entries (``_masked_bwd`` under the
    segment mask)."""
    return _masked_bwd(q, k, v, out, dout, segs.mask(causal)[:, None], scale,
                       zero_empty=True)


def _tile_spans(lo, hi, tile, other_tile):
    """Per-token spans [lo, hi) of the other side ([B, n]) -> per ``tile``
    of tokens, the tiles of ``other_tile`` tokens that cover every span
    ([B, n_tiles, 2] int32); (0, 0) for a tile whose tokens see nothing."""
    B, n = lo.shape
    n_tiles = -(-n // tile)
    empty = lo >= hi
    # rows past n and rows that see nothing: an empty span (big, 0)
    big = torch.iinfo(torch.int64).max
    lo_rows = lo.new_full((B, n_tiles * tile), big)
    hi_rows = hi.new_zeros((B, n_tiles * tile))
    lo_rows[:, :n] = lo.masked_fill(empty, big)
    hi_rows[:, :n] = hi.masked_fill(empty, 0)
    lo = lo_rows.view(B, n_tiles, tile).amin(-1)
    hi = hi_rows.view(B, n_tiles, tile).amax(-1)
    seen = lo < hi
    return torch.stack([torch.where(seen, lo // other_tile, 0),
                        torch.where(seen, -(-hi // other_tile), 0)],
                       -1).to(torch.int32)


def _tile_ranges(segs, causal, tile=64):
    """K3's tile-range tables, built on the ids' device without a host
    sync: (key_ranges [B, ceil(Sq / tile), 2], query_ranges [B, ceil(Sk /
    tile), 2]), for each query tile the key tiles [lo, hi) that can hold a
    key it sees (the forward and dQ walk these), for each key tile the query
    tiles that can see it (dK/dV). With ids ascending along a row (the
    packing contract, always true of varlen ids) each query's keys are the
    span of its segment in k, cut at its own position when causal (and each
    key's queries likewise), so the tables are tight. A row whose ids do not
    ascend gets every tile: the tables only skip work, the kernels' in-tile
    mask decides what is visible."""
    seg_q, pos_q, seg_k, pos_k = segs
    sq, sk = seg_q.shape[1], seg_k.shape[1]
    k_lo = torch.searchsorted(seg_k, seg_q, side="left")
    k_hi = torch.searchsorted(seg_k, seg_q, side="right")
    q_lo = torch.searchsorted(seg_q, seg_k, side="left")
    q_hi = torch.searchsorted(seg_q, seg_k, side="right")
    if causal:
        # a query sees its segment's keys up to its own position; a key is
        # seen by its segment's queries from its own position on
        first_k = pos_k.gather(1, k_lo.clamp(max=sk - 1))
        k_hi = torch.minimum(k_hi, k_lo + (pos_q - first_k) + 1)
        first_q = pos_q.gather(1, q_lo.clamp(max=sq - 1))
        q_lo = torch.maximum(q_lo, q_lo + (pos_k - first_q))
    key_ranges = _tile_spans(k_lo, k_hi, tile, tile)
    query_ranges = _tile_spans(q_lo, q_hi, tile, tile)
    ascending = ((seg_q[:, 1:] >= seg_q[:, :-1]).all(1)
                 & (seg_k[:, 1:] >= seg_k[:, :-1]).all(1))[:, None, None]
    # every tile, filled on the device (a host tensor's copy would
    # synchronize the stream)
    every_k, every_q = (torch.zeros_like(t) for t in (key_ranges,
                                                      query_ranges))
    every_k[..., 1] = -(-sk // tile)
    every_q[..., 1] = -(-sq // tile)
    return (torch.where(ascending, key_ranges, every_k),
            torch.where(ascending, query_ranges, every_q))


def _pair_union(ranges):
    """Per pair of 64-unit tiles (2t, 2t + 1) of a K3 range table [B, n, 2],
    the union of their non-empty ranges: (lo, hi, seen) [B, ceil(n / 2)]
    int64, seen False where neither tile sees anything."""
    B, n, _ = ranges.shape
    r = ranges.long()
    if n % 2:
        r = torch.cat([r, r.new_zeros(B, 1, 2)], 1)
    lo, hi = r[..., 0].view(B, -1, 2), r[..., 1].view(B, -1, 2)
    some = lo < hi
    lo = lo.masked_fill(~some, torch.iinfo(torch.int64).max).amin(-1)
    hi = hi.masked_fill(~some, 0).amax(-1)
    return lo, hi, lo < hi


def _fwd_key_ranges(key_ranges):
    """The key-tile table the bf16 forward and dQ kernels walk, from K3's
    64-unit ``key_ranges`` [B, ceil(Sq / 64), 2]: per 128-row query tile,
    the union of its two 64-row tiles' non-empty ranges, in 128-key tiles
    (``lo // 2``, ``ceil(hi / 2)``); (0, 0) where neither sees a key.
    [B, ceil(Sq / 128), 2] int32. The kernels do this arithmetic themselves
    (``seg_key_tiles`` in csrc/flash_common.cuh), so the backward kernels
    and they share one table; this is its statement for the tests and
    ``chip_smoke.py``."""
    lo, hi, seen = _pair_union(key_ranges)
    return torch.stack([torch.where(seen, lo // 2, 0),
                        torch.where(seen, (hi + 1) // 2, 0)],
                       -1).to(torch.int32)


def _dkdv_query_ranges(query_ranges):
    """The query-tile table the bf16 dK/dV kernel walks, from K3's 64-unit
    ``query_ranges`` [B, ceil(Sk / 64), 2]: per 128-key tile, the union of
    its two 64-key tiles' non-empty ranges, still in 64-row query tiles (its
    stages are 64 rows); (0, 0) where no query sees either. [B, ceil(Sk /
    128), 2] int32. The kernel does this itself (``tile_pair_range`` in
    csrc/flash_common.cuh); this is its statement for the tests and
    ``chip_smoke.py``."""
    lo, hi, seen = _pair_union(query_ranges)
    return torch.stack([torch.where(seen, lo, 0), torch.where(seen, hi, 0)],
                       -1).to(torch.int32)


_SEG_FWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_SEG_DKDV_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_SEG_DQ_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _segment_pointers(name, q, k, segs, ranges, tiles):
    """Validate K3's ids and range table for q [B, Sq, ...] and k [B, Sk,
    ...] and return their pointers in the C entries' order: seg_q, pos_q,
    seg_k, pos_k, ranges (``tiles``: the row count the table's tiles split,
    Sq for the forward and dQ, Sk for dK/dV)."""
    chk = _build.check
    B, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    for t, n in zip(segs, (sq, sq, sk, sk)):
        chk(t.dtype == torch.int32 and tuple(t.shape) == (B, n), name,
            "segment ids and positions must be int32 [B, Sq] and [B, Sk]")
    chk(ranges.dtype == torch.int32
        and tuple(ranges.shape) == (B, -(-tiles // 64), 2), name,
        "the tile-range table must be int32 [B, n_tiles, 2]")
    for t in (*segs, ranges):
        chk(t.device == q.device, name, "operands must share q's device")
        chk(t.is_contiguous(), name, "operands must be contiguous")
        # (the bf16 forward reads the key ids through TMA tensor maps)
        chk(t.data_ptr() % 16 == 0, name, "operands must be 16-byte aligned")
    return [t.data_ptr() for t in (*segs, ranges)]


@checked("flash_attention_seg_fwd", _out_only)
def seg_flash_fwd(q, k, v, segs, key_ranges, causal, scale):
    """Launch K3's forward kernel: returns (out [B, Sq, Hq, D] in q's
    dtype, lse [B, Hq, Sq] f32, -inf where a row sees no key). Counted in
    ``seg_flash_fwd.launches``."""
    name = "flash_attention_seg_fwd"
    fn = _build.entry("flash_attention_fwd", "flash_attention_seg_fwd_launch",
                      _SEG_FWD_ARGTYPES)
    # K3's causal rule is per segment: any Sq and Sk
    B, sq, sk, hq, hkv, D = _check_paddle_layout(name, q, k, v, False)
    ids = _segment_pointers(name, q, k, segs, key_ranges, sq)
    out = torch.empty_like(q)
    lse = torch.empty((B, hq, sq), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *ids, B, sq, sk, hq, hkv, D, int(causal),
            float(scale), _build.DTYPE_CODES[str(q.dtype)], _stream(q))
    _build.check_status(rc, name)
    _build.count_launch(seg_flash_fwd, like=q)
    return out, lse


@checked("flash_attention_seg_bwd_delta", _no_outputs)
def seg_flash_bwd_delta(out, dout):
    """Launch K3's delta pass: K1's kernel, rowsum(dout * out) in f32, [B,
    Hq, Sq], counted apart in ``seg_flash_bwd_delta.launches``."""
    delta = _delta(out, dout, "flash_attention_seg_bwd_delta")
    _build.count_launch(seg_flash_bwd_delta, like=out)
    return delta


def _launch_seg_grad(name, fn, q, k, v, dout, lse, delta, segs, ranges,
                     tiles, causal, scale, outs):
    """Validate the operands of a K3 gradient kernel and launch it, writing
    ``outs`` (allocated by the caller)."""
    B, sq, sk, hq, hkv, D = _check_paddle_layout(
        name, q, k, v, False, extra=(dout, lse, delta))
    _check_grad_inputs(name, q, dout, lse, delta)
    ids = _segment_pointers(name, q, k, segs, ranges, tiles)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            *ids, B, sq, sk, hq, hkv, D, int(causal), float(scale),
            _build.DTYPE_CODES[str(q.dtype)], _stream(q))
    _build.check_status(rc, name)


@checked("flash_attention_seg_bwd_dkdv")
def seg_flash_bwd_dkdv(q, k, v, dout, lse, delta, segs, query_ranges,
                       causal, scale):
    """Launch K3's dK/dV kernel over each key tile's query-tile range:
    returns (dk, dv) shaped and typed as k. Counted in
    ``seg_flash_bwd_dkdv.launches``."""
    fn = _build.entry("flash_attention_bwd",
                      "flash_attention_seg_bwd_dkdv_launch",
                      _SEG_DKDV_ARGTYPES)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_seg_grad("flash_attention_seg_bwd_dkdv", fn, q, k, v, dout, lse,
                     delta, segs, query_ranges, k.shape[1], causal, scale,
                     (dk, dv))
    _build.count_launch(seg_flash_bwd_dkdv, like=q)
    return dk, dv


@checked("flash_attention_seg_bwd_dq")
def seg_flash_bwd_dq(q, k, v, dout, lse, delta, segs, key_ranges, causal,
                     scale):
    """Launch K3's dQ kernel over each query tile's key-tile range: returns
    dq shaped and typed as q. Counted in ``seg_flash_bwd_dq.launches``."""
    fn = _build.entry("flash_attention_bwd",
                      "flash_attention_seg_bwd_dq_launch", _SEG_DQ_ARGTYPES)
    dq = torch.empty_like(q)
    _launch_seg_grad("flash_attention_seg_bwd_dq", fn, q, k, v, dout, lse,
                     delta, segs, key_ranges, q.shape[1], causal, scale,
                     (dq,))
    _build.count_launch(seg_flash_bwd_dq, like=q)
    return dq


SEG_KERNELS = (seg_flash_fwd, seg_flash_bwd_delta, seg_flash_bwd_dkdv,
               seg_flash_bwd_dq)
for _k in SEG_KERNELS:
    _k.launches = _k.launches_fp16 = 0


class SegmentFlashAttention(torch.autograd.Function):
    """K3 attention: ``apply(q, k, v, seg_q, pos_q, seg_k, pos_k,
    key_ranges, query_ranges, causal, scale)`` in the paddle layout with
    ``Segments``' ids and positions and ``_tile_ranges``' tables for them.

    On a CUDA tensor the forward launches K3's forward kernel, keeping its
    lse; the backward launches K3's delta, dK/dV and dQ. On a CPU tensor
    both directions run the plain version (the backward through autograd on
    a recomputed forward), and the tables go unread."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, pos_q, seg_k, pos_k, key_ranges,
                query_ranges, causal, scale):
        ctx.causal, ctx.scale = causal, scale
        segs = Segments(seg_q, pos_q, seg_k, pos_k)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, *segs)
            return _segment_math(q, k, v, segs, causal, scale)
        out, lse = seg_flash_fwd(q, k, v, segs, key_ranges, causal, scale)
        ctx.save_for_backward(q, k, v, *segs, out, lse, key_ranges,
                              query_ranges)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, scale = ctx.causal, ctx.scale
        q, k, v, *rest = ctx.saved_tensors
        segs = Segments(*rest[:4])
        if dout.device.type == "cpu":
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            with torch.enable_grad():
                out = _segment_math(q, k, v, segs, causal, scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        else:
            out, lse, key_ranges, query_ranges = rest[4:]
            dout = dout.contiguous()
            delta = seg_flash_bwd_delta(out, dout)
            dk, dv = seg_flash_bwd_dkdv(q, k, v, dout, lse, delta, segs,
                                        query_ranges, causal, scale)
            dq = seg_flash_bwd_dq(q, k, v, dout, lse, delta, segs,
                                  key_ranges, causal, scale)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def _segment_attention(q, k, v, segs, causal, scale, ranges=None):
    """K3 on the tensor's device: the plain version through autograd on the
    CPU, ``SegmentFlashAttention`` (the kernels) on the card, over
    ``ranges`` (key_ranges, query_ranges; built here when None)."""
    if q.device.type == "cpu":
        return _segment_math(q, k, v, segs, causal, scale)
    if ranges is None:
        ranges = _tile_ranges(segs, causal)
    return SegmentFlashAttention.apply(q, k, v, *segs, *ranges, causal,
                                       scale)


class PackedSegments(NamedTuple):
    """Packed rows prepared once (``pack_segments``) for the causal
    attention of every layer of a forward: K3's ``Segments``, its
    tile-range tables and the rows' rope positions, so that no layer
    rebuilds them (some 60 small launches each)."""

    segs: Segments
    key_ranges: torch.Tensor
    query_ranges: torch.Tensor
    position_ids: torch.Tensor


def pack_segments(segment_ids):
    """[B, S] segment ids -> ``PackedSegments`` (returned as it is when it
    already is one)."""
    if isinstance(segment_ids, PackedSegments):
        return segment_ids
    segs = _packed_segments(segment_ids)
    return PackedSegments(segs, *_tile_ranges(segs, True),
                          packed_position_ids(segs.seg_q))


def flash_attention_packed(q, k, v, segment_ids, causal=True, scale=None):
    """Packed-sequence attention (reference :277): q [B, S, Hq, D], k/v [B,
    S, Hkv, D], ``segment_ids`` [B, S] (int, on q's device) or their
    ``PackedSegments``. A token sees only its own segment, causally: same
    segment ∧ key index <= query index. A CPU tensor runs the plain
    version; a CUDA tensor, K3's kernels."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if causal:
        packed = pack_segments(segment_ids)
        return _segment_attention(q, k, v, packed.segs, True, scale,
                                  packed[1:3])
    segs = (segment_ids.segs if isinstance(segment_ids, PackedSegments)
            else _packed_segments(segment_ids))
    return _segment_attention(q, k, v, segs, False, scale)


def _varlen_math(q, k, v, cu_q, cu_k, causal, scale):
    """Plain version of the varlen form: ``_segment_math`` on [total, H,
    D] as a batch of one."""
    segs = _varlen_segments(cu_q, cu_k, q.shape[0], k.shape[0], q.device)
    return _segment_math(q[None], k[None], v[None], segs, causal, scale)[0]


def flash_attention_varlen_fwd(q, k, v, cu_q, cu_k, causal=True, scale=None,
                               same_offsets=None):
    """Varlen attention on the packed layout (reference :181): q [Tq, Hq,
    D], k/v [Tk, Hkv, D], sequence b at ``cu_q[b]:cu_q[b + 1]`` of q and
    ``cu_k[b]:cu_k[b + 1]`` of k; causal is top-left aligned within each
    sequence; a query whose key sequence is empty comes out 0. A CPU tensor
    runs the plain version; a CUDA tensor, K3's kernels, for self- and
    cross-offset attention alike (the per-sequence positions cover both),
    so ``same_offsets``, the reference's choice between its kernel and its
    dense path, selects nothing."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return _varlen_math(q, k, v, cu_q, cu_k, causal, scale)
    segs = _varlen_segments(cu_q, cu_k, q.shape[0], k.shape[0], q.device)
    return _segment_attention(q[None], k[None], v[None], segs, causal,
                              scale)[0]
