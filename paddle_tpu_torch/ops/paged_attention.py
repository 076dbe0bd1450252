"""Paged KV-cache decode attention (counterpart of
``paddle_tpu/ops/paged_attention.py``).

The KV cache is a pool of fixed-size pages shared by all sequences,
``[num_kv_heads, num_pages, page_size, head_dim]``, plus a per-sequence page
table ``page_indices [B, pages_per_seq]`` and ``lengths [B]``.

``paged_decode_attention`` picks its tier from the tensor's device: a CUDA
tensor launches the hand-written kernel K5 (``csrc/paged_attention.cu``),
a CPU tensor runs the plain version ``_paged_math``. There is no fallback
between them: a kernel that cannot build or launch raises.
"""
import ctypes
import dataclasses

import torch

from . import _build


@dataclasses.dataclass
class PagedLayerCache:
    """One layer's paged cache view.

    k_pages/v_pages: [num_kv_heads, num_pages, page_size, head_dim]
    page_indices:    [B, pages_per_seq] int32 rows into the pool
    lengths:         [B] int32 — valid tokens per sequence BEFORE this step
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_indices: torch.Tensor
    lengths: torch.Tensor

    @property
    def page_size(self):
        return self.k_pages.shape[2]


def write_token_kv(pages, page_indices, lengths, new):
    """Scatter one new token's K or V into the pool, IN PLACE (the
    reference returns a new pool; the port updates the one it is given and
    returns it).

    new: [B, Hkv, D]; the token lands at logical position ``lengths[b]`` →
    page ``page_indices[b, lengths[b] // bs]``, offset ``lengths[b] % bs``."""
    bs = pages.shape[2]
    lengths = lengths.long()
    page_of = page_indices.long().gather(1, (lengths // bs)[:, None])[:, 0]
    pages[:, page_of, lengths % bs, :] = new.transpose(0, 1).to(pages.dtype)
    return pages


def _paged_math(q, k_pages, v_pages, lengths, page_indices, scale):
    """Plain version of K5: one gather of every row's pages and a masked
    dense softmax in f32. q: [B, Hq, D] (one decode token per row)."""
    B, Hq, D = q.shape
    Hkv, _, bs, _ = k_pages.shape
    npages = page_indices.shape[1]
    group = Hq // Hkv
    M = npages * bs
    idx = page_indices.long()

    def gather(pages):
        return pages[:, idx].transpose(0, 1).float().reshape(B, Hkv, M, D)

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


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)


def _paged_cuda(q, k_pages, v_pages, lengths, page_indices, scale):
    """Launch K5 on the current stream; validates every operand first."""
    name = "paged_decode_attention"
    fn = _build.entry("paged_attention", "paged_decode_attention_launch",
                      _ARGTYPES)
    B, Hq, D = q.shape
    Hkv, P, bs, Dk = k_pages.shape
    chk = _build.check
    chk(q.is_cuda, name, "q must be a CUDA tensor")
    for t in (k_pages, v_pages, lengths, page_indices):
        chk(t.device == q.device, name, "operands must share q's device")
    for t in (q, k_pages, v_pages, lengths, page_indices):
        chk(t.is_contiguous(), name, "operands must be contiguous")
        chk(t.data_ptr() % 16 == 0, name, "operands must be 16-byte aligned")
    chk(str(q.dtype) in _build.DTYPE_CODES, name,
        f"dtype {q.dtype} not in {sorted(_build.DTYPE_CODES)}")
    chk(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype, name,
        "pools must have q's dtype")
    chk(v_pages.shape == k_pages.shape and Dk == D, name,
        "pools must be [Hkv, P, bs, D] with q's D")
    chk(D in HEAD_DIMS, name, f"head_dim {D} not in {HEAD_DIMS}")
    chk(Hq % Hkv == 0 and Hq // Hkv in GROUPS, name,
        f"Hq/Hkv = {Hq}/{Hkv} not a group in {GROUPS}")
    chk(lengths.dtype == torch.int32 and lengths.shape == (B,), name,
        "lengths must be int32 [B]")
    chk(page_indices.dtype == torch.int32 and page_indices.dim() == 2
        and page_indices.shape[0] == B, name,
        "page_indices must be int32 [B, pages_per_seq]")
    chk(B > 0, name, "empty batch")
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
            B, Hkv, Hq // Hkv, D, P, bs, page_indices.shape[1], float(scale),
            _build.DTYPE_CODES[str(q.dtype)],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_status(rc, name)
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, lengths, page_indices,
                           scale=None):
    """One-token decode attention over the paged pool.

    q: [B, Hq, D]; returns [B, Hq, D] in q's dtype. lengths must already
    INCLUDE the just-written token (the query attends to itself). A CUDA q
    launches K5 (counted in ``paged_decode_attention.launches``); a CPU q
    runs the plain version."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return _paged_math(q, k_pages, v_pages, lengths, page_indices, scale)
    return _paged_cuda(q, k_pages, v_pages, lengths, page_indices, scale)


paged_decode_attention.launches = 0
