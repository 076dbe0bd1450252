"""Ragged paged attention — one dispatch for mixed prefill+decode rows
(counterpart of ``paddle_tpu/ops/ragged_paged_attention.py``).

A batch step is a packed token stream ``q: [T, Hq, D]`` where row b owns the
contiguous query span ``cu_q_lens[b] : cu_q_lens[b+1]``; every row attends
over the shared page pool through its own page-table row. Query i of row b
(``q_len = cu[b+1] - cu[b]``) sees kv positions
``< kv_lens[b] - q_len + i + 1``: ``kv_lens`` counts tokens AFTER this
step's writes.

The pool is float (q's dtype) or int8: a ``QuantizedTensor(weight,
scales)`` pair of int8 codes and one f32 scale per row
(``ops/quantization.py``).

``ragged_paged_attention`` picks its tier from the tensor's device: a CUDA
tensor launches the hand-written kernel K4
(``csrc/ragged_paged_attention.cu``: its tile kernel, with the decode rows
taken by K5's split kernel and merge, one instance per pool type), a CPU
tensor runs the plain version ``_ragged_math``. There is no fallback
between them.
"""
import ctypes
import dataclasses

import torch

from ..framework.nan_inf import checked
from . import _build
from .paged_attention import (
    check_geometry,
    kv_split_plan,
    num_sms,
    split_scratch,
)
from .quantization import from_int8, is_quantized, quantize_to_int8


@dataclasses.dataclass
class RaggedLayerCache:
    """One layer's ragged paged cache view.

    k_pages/v_pages: [num_kv_heads, num_pages, page_size, head_dim], or
                     a QuantizedTensor of that weight shape (int8 pool)
    page_indices:    [S, pages_per_seq] int32 rows into the pool
    kv_lens:         [S] int32 — valid tokens per row AFTER this step's
                     writes land (post-write totals; self-attention incl.)
    cu_q_lens:       [S+1] int32 — packed query span boundaries
    row_of:          [T] int32 — owning row per packed token (pad -> any)
    token_pos:       [T] int32 — absolute kv position per packed token
    valid:           [T] bool — False for pad tokens (writes -> scratch)
    """

    k_pages: object
    v_pages: object
    page_indices: torch.Tensor
    kv_lens: torch.Tensor
    cu_q_lens: torch.Tensor
    row_of: torch.Tensor
    token_pos: torch.Tensor
    valid: torch.Tensor

    @property
    def page_size(self):
        k = self.k_pages
        return (k.weight if is_quantized(k) else k).shape[2]


def write_ragged_kv(pages, page_indices, row_of, token_pos, valid, new):
    """Scatter a packed token stream's K or V rows into the pool, IN PLACE
    (the reference returns a new pool; the port updates the one it is given
    and returns it).

    new: [T, Hkv, D]. Token t lands at absolute position token_pos[t] of
    row row_of[t] -> page page_indices[row_of[t], token_pos[t] // bs],
    offset token_pos[t] % bs. Invalid (pad) tokens go to scratch page 0,
    offset 0; their duplicate writes collide only with each other there.
    An int8 pool takes the f32 upcast quantized per (token, head): codes
    and scale written in place. At the scratch row the codes and the scale
    may then come from different pad tokens; that is harmless, since the
    scratch page is never read."""
    quant = is_quantized(pages)
    bs = (pages.weight if quant else pages).shape[2]
    row_of, token_pos = row_of.long(), token_pos.long()
    page_of = torch.where(valid, page_indices.long()[row_of, token_pos // bs],
                          0)
    off = torch.where(valid, token_pos % bs, 0)
    new_ht = new.transpose(0, 1)   # [Hkv, T, D]
    if quant:
        qt = quantize_to_int8(new_ht.float())
        pages.weight[:, page_of, off, :] = qt.weight
        pages.scales[:, page_of, off, :] = qt.scales.to(pages.scales.dtype)
        return pages
    pages[:, page_of, off, :] = new_ht.to(pages.dtype)
    return pages


def _ragged_meta(cu_q_lens, row_of, kv_lens):
    """Per-token attention limit from the packed-span boundaries:
    limit[t] = kv_lens[row] - q_len[row] + q_pos[t] + 1, and 0 for pad
    tokens (t >= cu_q_lens[-1])."""
    q_lens = cu_q_lens[1:] - cu_q_lens[:-1]
    t = torch.arange(row_of.shape[0], device=row_of.device)
    q_pos = t - cu_q_lens[row_of]
    valid = t < cu_q_lens[-1]
    return torch.where(valid, kv_lens[row_of] - q_lens[row_of] + q_pos + 1, 0)


def _ragged_math(q, k_pages, v_pages, kv_lens, page_indices, cu_q_lens,
                 scale):
    """Plain version of K4: online softmax over page columns, each step
    gathering ONE page per packed token ([T, Hkv, bs, D]; an int8 pool
    dequantizes the gathered page)."""
    T, Hq, D = q.shape
    quant = is_quantized(k_pages)
    Hkv, _, bs, _ = (k_pages.weight if quant else k_pages).shape
    npages = page_indices.shape[1]
    group = Hq // Hkv
    cu = cu_q_lens.long()
    row_of = (torch.searchsorted(cu, torch.arange(T, device=q.device),
                                 right=True) - 1).clamp(0, cu.shape[0] - 2)
    limit = _ragged_meta(cu, row_of, kv_lens.long())

    qs = (q * scale).float().reshape(T, Hkv, group, D)
    o = torch.zeros((T, Hkv, group, D), dtype=torch.float32, device=q.device)
    l = torch.zeros((T, Hkv, group), dtype=torch.float32, device=q.device)
    m = torch.full((T, Hkv, group), -1e30, dtype=torch.float32,
                   device=q.device)
    pt = page_indices.long()

    def gather(pages, pid):
        if quant:
            return from_int8(pages.weight[:, pid].transpose(0, 1),
                             pages.scales[:, pid].transpose(0, 1))
        return pages[:, pid].transpose(0, 1).float()

    # pages past every live row's KV extent are fully masked, so the loop
    # stops at the longest live row (as the reference's dynamic trip count)
    q_lens = cu[1:] - cu[:-1]
    n_live = int(torch.where(q_lens > 0, (kv_lens.long() + bs - 1) // bs,
                             0).max())
    for j in range(min(n_live, npages)):
        pid = pt[row_of, j]
        kb = gather(k_pages, pid)   # [T, Hkv, bs, D]
        vb = gather(v_pages, pid)
        s = torch.einsum("thgd,thkd->thgk", qs, kb)
        pos = j * bs + torch.arange(bs, device=q.device)
        s = torch.where(pos[None, None, None, :] < limit[:, None, None, None],
                        s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("thgk,thkd->thgd", p, vb)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(T, Hq, D).to(q.dtype)


# each entry takes the decode rows' split plan with its f32 scratch; the
# int8 entry takes each pool as two pointers (codes, scales)
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_ARGTYPES_INT8 = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _ragged_cuda(q, k_pages, v_pages, kv_lens, page_indices, cu_q_lens,
                 scale):
    """Launch K4 (its tile kernel, the split kernel over the decode rows
    and their merge; over an int8 pool K4-int8's) on the current stream;
    validates every operand first. An fp16 q over an int8 pool reads as the
    reference's kernel reads it (paddle_tpu/ops/ragged_paged_attention.py
    :232, :281): ``q * scale`` in fp16, read in f32, through the f32-q
    instance, its output cast back to fp16."""
    name = "ragged_paged_attention"
    quant = is_quantized(k_pages)
    fn = _build.entry("ragged_paged_attention",
                      "ragged_paged_attention_int8_launch" if quant
                      else "ragged_paged_attention_launch",
                      _ARGTYPES_INT8 if quant else _ARGTYPES)
    if quant and q.dtype == torch.float16:
        return _ragged_cuda((q * scale).float(), k_pages, v_pages, kv_lens,
                            page_indices, cu_q_lens, 1.0).to(q.dtype)
    T, Hq, D = q.shape
    pool_ptrs, (Hkv, P, bs, Dk) = _build.pool_operands(name, q, k_pages,
                                                       v_pages)
    S = page_indices.shape[0]
    chk = _build.check
    for t in (kv_lens, page_indices, cu_q_lens):
        chk(t.device == q.device, name, "operands must share q's device")
    for t in (q, kv_lens, page_indices, cu_q_lens):
        chk(t.is_contiguous(), name, "operands must be contiguous")
        chk(t.data_ptr() % 16 == 0, name, "operands must be 16-byte aligned")
    chk(Dk == D, name, "pools must be [Hkv, P, bs, D] with q's D")
    check_geometry(name, Hq, Hkv, bs, D)
    chk(kv_lens.dtype == torch.int32 and kv_lens.shape == (S,), name,
        "kv_lens must be int32 [S]")
    chk(page_indices.dtype == torch.int32 and page_indices.dim() == 2, name,
        "page_indices must be int32 [S, pages_per_seq]")
    chk(cu_q_lens.dtype == torch.int32 and cu_q_lens.shape == (S + 1,), name,
        "cu_q_lens must be int32 [S+1]")
    chk(T > 0, name, "empty token stream")
    pps = page_indices.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dtype = _build.DTYPE_CODES[str(q.dtype)]
    splits, per = kv_split_plan(pps, Hkv, num_sms(q.device))
    o_part, ml_part = split_scratch(S, Hq, splits, D, q.device)
    rc = fn(q.data_ptr(), *pool_ptrs, kv_lens.data_ptr(),
            page_indices.data_ptr(), cu_q_lens.data_ptr(), out.data_ptr(),
            o_part.data_ptr(), ml_part.data_ptr(), T, S, Hkv, Hq // Hkv, D,
            P, bs, pps, splits, per, float(scale), dtype, stream)
    _build.check_status(rc, name)
    _build.count_launch(ragged_paged_attention,
                        "launches_int8" if quant else "launches", like=q)
    return out


@checked("ragged_paged_attention")
def ragged_paged_attention(q, k_pages, v_pages, kv_lens, page_indices,
                           cu_q_lens, scale=None):
    """Mixed prefill+decode attention over the paged pool.

    q: [T, Hq, D] packed token stream (f32, bf16 or fp16); returns
    [T, Hq, D] in q's dtype.
    kv_lens must already include this step's tokens. Pad tokens (beyond
    cu_q_lens[-1]) return finite values that callers discard: zeros from
    the kernel, the reference's masked garbage from the plain version. The
    pools are q's dtype, or int8 ``QuantizedTensor``s. A CUDA q launches
    K4 (its two or three launches make one call, counted in
    ``ragged_paged_attention.launches``; over an int8 pool in
    ``.launches_int8``); a CPU q runs the plain version."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return _ragged_math(q, k_pages, v_pages, kv_lens, page_indices,
                            cu_q_lens, scale)
    return _ragged_cuda(q, k_pages, v_pages, kv_lens, page_indices,
                        cu_q_lens, scale)


ragged_paged_attention.launches = 0
ragged_paged_attention.launches_int8 = 0
ragged_paged_attention.launches_fp16 = 0
ragged_paged_attention.launches_by_thread = {}
