"""Ragged paged attention — one dispatch for mixed prefill+decode rows
(counterpart of ``paddle_tpu/ops/ragged_paged_attention.py``).

A batch step is a packed token stream ``q: [T, Hq, D]`` where row b owns the
contiguous query span ``cu_q_lens[b] : cu_q_lens[b+1]``; every row attends
over the shared page pool through its own page-table row. Query i of row b
(``q_len = cu[b+1] - cu[b]``) sees kv positions
``< kv_lens[b] - q_len + i + 1``: ``kv_lens`` counts tokens AFTER this
step's writes.

``ragged_paged_attention`` picks its tier from the tensor's device: a CUDA
tensor launches the hand-written kernel K4
(``csrc/ragged_paged_attention.cu``), a CPU tensor runs the plain version
``_ragged_math``. There is no fallback between them.
"""
import ctypes
import dataclasses

import torch

from . import _build


@dataclasses.dataclass
class RaggedLayerCache:
    """One layer's ragged paged cache view.

    k_pages/v_pages: [num_kv_heads, num_pages, page_size, head_dim]
    page_indices:    [S, pages_per_seq] int32 rows into the pool
    kv_lens:         [S] int32 — valid tokens per row AFTER this step's
                     writes land (post-write totals; self-attention incl.)
    cu_q_lens:       [S+1] int32 — packed query span boundaries
    row_of:          [T] int32 — owning row per packed token (pad -> any)
    token_pos:       [T] int32 — absolute kv position per packed token
    valid:           [T] bool — False for pad tokens (writes -> scratch)
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_indices: torch.Tensor
    kv_lens: torch.Tensor
    cu_q_lens: torch.Tensor
    row_of: torch.Tensor
    token_pos: torch.Tensor
    valid: torch.Tensor

    @property
    def page_size(self):
        return self.k_pages.shape[2]


def write_ragged_kv(pages, page_indices, row_of, token_pos, valid, new):
    """Scatter a packed token stream's K or V rows into the pool, IN PLACE
    (the reference returns a new pool; the port updates the one it is given
    and returns it).

    new: [T, Hkv, D]. Token t lands at absolute position token_pos[t] of
    row row_of[t] -> page page_indices[row_of[t], token_pos[t] // bs],
    offset token_pos[t] % bs. Invalid (pad) tokens go to scratch page 0,
    offset 0; their duplicate writes collide only with each other there."""
    bs = pages.shape[2]
    row_of, token_pos = row_of.long(), token_pos.long()
    page_of = torch.where(valid, page_indices.long()[row_of, token_pos // bs],
                          0)
    off = torch.where(valid, token_pos % bs, 0)
    pages[:, page_of, off, :] = new.transpose(0, 1).to(pages.dtype)
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
    gathering ONE page per packed token ([T, Hkv, bs, D])."""
    T, Hq, D = q.shape
    Hkv, _, bs, _ = k_pages.shape
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
    # pages past every live row's KV extent are fully masked, so the loop
    # stops at the longest live row (as the reference's dynamic trip count)
    q_lens = cu[1:] - cu[:-1]
    n_live = int(torch.where(q_lens > 0, (kv_lens.long() + bs - 1) // bs,
                             0).max())
    for j in range(min(n_live, npages)):
        pid = pt[row_of, j]
        kb = k_pages[:, pid].transpose(0, 1).float()   # [T, Hkv, bs, D]
        vb = v_pages[:, pid].transpose(0, 1).float()
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


_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
HEAD_DIMS = (64, 128)
TILE_PAIRS = 16   # (token, query head) pairs per block: group must divide it
SMEM_LIMIT = 48 * 1024


def _ragged_cuda(q, k_pages, v_pages, kv_lens, page_indices, cu_q_lens,
                 scale):
    """Launch K4 on the current stream; validates every operand first."""
    name = "ragged_paged_attention"
    fn = _build.entry("ragged_paged_attention",
                      "ragged_paged_attention_launch", _ARGTYPES)
    T, Hq, D = q.shape
    Hkv, P, bs, Dk = k_pages.shape
    S = page_indices.shape[0]
    chk = _build.check
    chk(q.is_cuda, name, "q must be a CUDA tensor")
    for t in (k_pages, v_pages, kv_lens, page_indices, cu_q_lens):
        chk(t.device == q.device, name, "operands must share q's device")
    for t in (q, k_pages, v_pages, kv_lens, page_indices, cu_q_lens):
        chk(t.is_contiguous(), name, "operands must be contiguous")
        chk(t.data_ptr() % 16 == 0, name, "operands must be 16-byte aligned")
    chk(str(q.dtype) in _build.DTYPE_CODES, name,
        f"dtype {q.dtype} not in {sorted(_build.DTYPE_CODES)}")
    chk(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype, name,
        "pools must have q's dtype")
    chk(v_pages.shape == k_pages.shape and Dk == D, name,
        "pools must be [Hkv, P, bs, D] with q's D")
    chk(D in HEAD_DIMS, name, f"head_dim {D} not in {HEAD_DIMS}")
    chk(Hq % Hkv == 0 and TILE_PAIRS % (Hq // Hkv) == 0, name,
        f"Hq/Hkv = {Hq}/{Hkv} must divide {TILE_PAIRS}")
    chk(2 * bs * D * q.element_size() <= SMEM_LIMIT, name,
        f"two pages of {bs}x{D} exceed {SMEM_LIMIT} bytes of shared memory")
    chk(kv_lens.dtype == torch.int32 and kv_lens.shape == (S,), name,
        "kv_lens must be int32 [S]")
    chk(page_indices.dtype == torch.int32 and page_indices.dim() == 2, name,
        "page_indices must be int32 [S, pages_per_seq]")
    chk(cu_q_lens.dtype == torch.int32 and cu_q_lens.shape == (S + 1,), name,
        "cu_q_lens must be int32 [S+1]")
    chk(T > 0, name, "empty token stream")
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            kv_lens.data_ptr(), page_indices.data_ptr(), cu_q_lens.data_ptr(),
            out.data_ptr(), T, S, Hkv, Hq // Hkv, D, P, bs,
            page_indices.shape[1], float(scale),
            _build.DTYPE_CODES[str(q.dtype)],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_status(rc, name)
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, kv_lens, page_indices,
                           cu_q_lens, scale=None):
    """Mixed prefill+decode attention over the paged pool.

    q: [T, Hq, D] packed token stream; returns [T, Hq, D] in q's dtype.
    kv_lens must already include this step's tokens. Pad tokens (beyond
    cu_q_lens[-1]) return finite values that callers discard: zeros from
    the kernel, the reference's masked garbage from the plain version. A
    CUDA q launches K4 (counted in ``ragged_paged_attention.launches``); a
    CPU q runs the plain version."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return _ragged_math(q, k_pages, v_pages, kv_lens, page_indices,
                            cu_q_lens, scale)
    return _ragged_cuda(q, k_pages, v_pages, kv_lens, page_indices,
                        cu_q_lens, scale)


ragged_paged_attention.launches = 0
