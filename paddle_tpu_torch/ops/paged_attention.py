"""Paged KV-cache decode attention (counterpart of
``paddle_tpu/ops/paged_attention.py``).

The KV cache is a pool of fixed-size pages shared by all sequences,
``[num_kv_heads, num_pages, page_size, head_dim]``, plus a per-sequence page
table ``page_indices [B, pages_per_seq]`` and ``lengths [B]``.

The pool is float (q's dtype) or int8: a ``QuantizedTensor(weight,
scales)`` pair of int8 codes and one f32 scale per row
(``ops/quantization.py``).

``paged_decode_attention`` picks its tier from the tensor's device: a CUDA
tensor launches the hand-written kernel K5 (``csrc/paged_attention.cu``:
the split-KV kernel of ``csrc/paged_common.cuh`` and its merge, one
instance per pool type), a CPU tensor runs the plain version
``_paged_math``. There is no fallback between them: a kernel that cannot
build or launch raises.
"""
import ctypes
import dataclasses
import functools

import torch

from ..framework.nan_inf import checked
from . import _build
from .quantization import from_int8, is_quantized, quantize_to_int8


@dataclasses.dataclass
class PagedLayerCache:
    """One layer's paged cache view.

    k_pages/v_pages: [num_kv_heads, num_pages, page_size, head_dim], or
                     a QuantizedTensor of that weight shape (int8 pool)
    page_indices:    [B, pages_per_seq] int32 rows into the pool
    lengths:         [B] int32 — valid tokens per sequence BEFORE this step
    """

    k_pages: object
    v_pages: object
    page_indices: torch.Tensor
    lengths: torch.Tensor

    @property
    def page_size(self):
        k = self.k_pages
        return (k.weight if is_quantized(k) else k).shape[2]


def write_token_kv(pages, page_indices, lengths, new):
    """Scatter one new token's K or V into the pool, IN PLACE (the
    reference returns a new pool; the port updates the one it is given and
    returns it).

    new: [B, Hkv, D]; the token lands at logical position ``lengths[b]`` →
    page ``page_indices[b, lengths[b] // bs]``, offset ``lengths[b] % bs``.
    An int8 pool takes the f32 upcast quantized per (row, head): codes and
    scale written in place."""
    quant = is_quantized(pages)
    bs = (pages.weight if quant else pages).shape[2]
    lengths = lengths.long()
    page_of = page_indices.long().gather(1, (lengths // bs)[:, None])[:, 0]
    off = lengths % bs
    new_hb = new.transpose(0, 1)   # [Hkv, B, D]
    if quant:
        qt = quantize_to_int8(new_hb.float())
        pages.weight[:, page_of, off, :] = qt.weight
        pages.scales[:, page_of, off, :] = qt.scales.to(pages.scales.dtype)
        return pages
    pages[:, page_of, off, :] = new_hb.to(pages.dtype)
    return pages


def _paged_math(q, k_pages, v_pages, lengths, page_indices, scale):
    """Plain version of K5: one gather of every row's pages and a masked
    dense softmax in f32 (an int8 pool dequantizes the gathered slab).
    q: [B, Hq, D] (one decode token per row)."""
    B, Hq, D = q.shape
    quant = is_quantized(k_pages)
    Hkv, _, bs, _ = (k_pages.weight if quant else k_pages).shape
    npages = page_indices.shape[1]
    group = Hq // Hkv
    M = npages * bs
    idx = page_indices.long()

    def gather(pages):
        if quant:
            full = from_int8(pages.weight[:, idx].transpose(0, 1),
                             pages.scales[:, idx].transpose(0, 1))
        else:
            full = pages[:, idx].transpose(0, 1).float()
        return full.reshape(B, Hkv, M, D)

    ks, vs = gather(k_pages), gather(v_pages)
    qs = (q * scale).float().reshape(B, Hkv, group, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qs, ks)
    pos = torch.arange(M, device=q.device)
    s = torch.where(pos[None, None, None, :] < lengths[:, None, None, None],
                    s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhgk,bhkd->bhgd", p, vs)
    out = out / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


# each entry takes the split plan with its f32 scratch; the int8 entry
# takes each pool as two pointers (codes, scales)
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_ARGTYPES_INT8 = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)
PAGE_MULTIPLE = 16        # page_size: a multiple of 16 (a 16-token block)
SPLIT_MIN_PAGES = 16      # four pages per consumer warp of a split block


def check_geometry(kernel, num_q_heads, num_kv_heads, page_size, head_dim):
    """Raise ValueError for a head layout or page size the paged kernels
    (K4, K5, every pool type) do not take: head_dim in HEAD_DIMS, the GQA
    group in GROUPS, page_size a multiple of PAGE_MULTIPLE."""
    _build.check(head_dim in HEAD_DIMS, kernel,
                 f"head_dim {head_dim} not in {HEAD_DIMS}")
    _build.check(num_q_heads % num_kv_heads == 0
                 and num_q_heads // num_kv_heads in GROUPS, kernel,
                 f"Hq/Hkv = {num_q_heads}/{num_kv_heads} not a group in "
                 f"{GROUPS}")
    _build.check(page_size % PAGE_MULTIPLE == 0, kernel,
                 f"page_size {page_size} is not a multiple of "
                 f"{PAGE_MULTIPLE}")


def kv_split_plan(pages_per_seq, num_kv_heads, num_sms):
    """Split-KV plan of the decode kernel: ``(num_splits,
    pages_per_split)``. A row's pages [0, n) are cut into splits of
    ``pages_per_split`` consecutive pages; the longest possible row
    (``pages_per_seq`` pages) is spread over about two waves of
    ``num_sms`` SMs across the kv heads, with at least SPLIT_MIN_PAGES
    pages a split. Needs no row length, so no device sync."""
    pages_per_seq = max(int(pages_per_seq), 1)
    want = max(1, -(-2 * int(num_sms) // int(num_kv_heads)))
    per = min(pages_per_seq, max(SPLIT_MIN_PAGES, -(-pages_per_seq // want)))
    return -(-pages_per_seq // per), per


@functools.lru_cache(maxsize=None)
def num_sms(device):
    """Streaming multiprocessors of CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_scratch(rows, num_q_heads, num_splits, head_dim, device):
    """The split kernel's f32 scratch: unnormalised partial outputs
    [rows, Hq, num_splits, D] and (max, sum) [rows, Hq, num_splits, 2]."""
    return (torch.empty((rows, num_q_heads, num_splits, head_dim),
                        dtype=torch.float32, device=device),
            torch.empty((rows, num_q_heads, num_splits, 2),
                        dtype=torch.float32, device=device))


def _paged_cuda(q, k_pages, v_pages, lengths, page_indices, scale):
    """Launch K5 (its split kernel and merge; over an int8 pool K5-int8's)
    on the current stream; validates every operand first. An fp16 q over
    an int8 pool reads as the reference's kernel reads it
    (paddle_tpu/ops/paged_attention.py:175): ``q * scale`` in fp16 cast to
    bf16, through the bf16-q instance, its output cast back to fp16."""
    name = "paged_decode_attention"
    quant = is_quantized(k_pages)
    fn = _build.entry("paged_attention",
                      "paged_decode_attention_int8_launch" if quant
                      else "paged_decode_attention_launch",
                      _ARGTYPES_INT8 if quant else _ARGTYPES)
    if quant and q.dtype == torch.float16:
        return _paged_cuda((q * scale).to(torch.bfloat16), k_pages, v_pages,
                           lengths, page_indices, 1.0).to(q.dtype)
    B, Hq, D = q.shape
    pool_ptrs, (Hkv, P, bs, Dk) = _build.pool_operands(name, q, k_pages,
                                                       v_pages)
    chk = _build.check
    for t in (lengths, page_indices):
        chk(t.device == q.device, name, "operands must share q's device")
    for t in (q, lengths, page_indices):
        chk(t.is_contiguous(), name, "operands must be contiguous")
        chk(t.data_ptr() % 16 == 0, name, "operands must be 16-byte aligned")
    chk(Dk == D, name, "pools must be [Hkv, P, bs, D] with q's D")
    check_geometry(name, Hq, Hkv, bs, D)
    chk(lengths.dtype == torch.int32 and lengths.shape == (B,), name,
        "lengths must be int32 [B]")
    chk(page_indices.dtype == torch.int32 and page_indices.dim() == 2
        and page_indices.shape[0] == B, name,
        "page_indices must be int32 [B, pages_per_seq]")
    chk(B > 0, name, "empty batch")
    pps = page_indices.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dtype = _build.DTYPE_CODES[str(q.dtype)]
    splits, per = kv_split_plan(pps, Hkv, num_sms(q.device))
    o_part, ml_part = split_scratch(B, Hq, splits, D, q.device)
    rc = fn(q.data_ptr(), *pool_ptrs, lengths.data_ptr(),
            page_indices.data_ptr(), out.data_ptr(), o_part.data_ptr(),
            ml_part.data_ptr(), B, Hkv, Hq // Hkv, D, P, bs, pps, splits,
            per, float(scale), dtype, stream)
    _build.check_status(rc, name)
    _build.count_launch(paged_decode_attention,
                        "launches_int8" if quant else "launches", like=q)
    return out


@checked("paged_decode_attention")
def paged_decode_attention(q, k_pages, v_pages, lengths, page_indices,
                           scale=None):
    """One-token decode attention over the paged pool.

    q: [B, Hq, D] (f32, bf16 or fp16); returns [B, Hq, D] in q's dtype.
    lengths must already INCLUDE the just-written token (the query attends
    to itself). The pools are q's dtype, or int8 ``QuantizedTensor``s. A
    CUDA q launches K5 (its split and merge launches one call, counted in
    ``paged_decode_attention.launches``; over an int8 pool in
    ``.launches_int8``); a CPU q runs the plain version."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return _paged_math(q, k_pages, v_pages, lengths, page_indices, scale)
    return _paged_cuda(q, k_pages, v_pages, lengths, page_indices, scale)


paged_decode_attention.launches = 0
paged_decode_attention.launches_int8 = 0
paged_decode_attention.launches_fp16 = 0
paged_decode_attention.launches_by_thread = {}
