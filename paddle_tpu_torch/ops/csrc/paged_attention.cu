// K5: paged decode attention, hand-written for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/paged_attention.py::paged_decode_attention, which
// on a TPU calls jax's Pallas kernel
// jax.experimental.pallas.ops.tpu.paged_attention.paged_attention.
//
// Computes, for each row b and query head hq, one decode token's attention
// over the row's paged KV:
//   out[b, hq] = softmax(q[b, hq] * scale . K[b, :len]) V[b, :len]
// where K/V rows come from the pool [Hkv, num_pages, page_size, D] through
// page_indices[b, :], len = lengths[b] already counts the new token, and
// query head hq reads kv head hq / group (GQA). The pool is int8 (codes
// and one f32 scale per row, K5-int8) or q's type (bf16 or f32).
//
// What bounds it on the H100: bytes. Each K/V element is read once and
// used for 2 G operations (G <= 8 query heads a kv head), far below the
// ~295 operations a byte at which bf16 tensor cores would become the
// limit, so the floor is the live K/V rows over 3.35 TB/s: D + 4 bytes a
// row in int8, 2 D in bf16, 4 D in f32.
//
// Design for that bound, one kernel for every pool type
// (paged::paged_split_kernel<Pool, T, D, G> and its merge, in
// paged_common.cuh):
// - split-KV: the wrapper sizes the splits from pages_per_seq and the SM
//   count (kv_split_plan: the longest possible row over about two waves of
//   the SMs, at least 16 pages a split); lengths stay on the device. The
//   grid is (kv head, work item): each block finds its row and split among
//   the rows' splits that hold pages, numbered compactly, so the SMs take
//   them evenly and no block is launched for a split past its row's
//   length (an empty row's one split writes an empty partial, m = -inf,
//   l = 0). A second launch merges a row's live splits in a fixed order
//   (no atomics: two calls give the same bits);
// - a ring: one producer thread keeps a block's coming items in flight by
//   1-D bulk copies on mbarriers (8 stages of a page each in int8, 8 of 16
//   rows in bf16, 4 of 16 rows in f32: at most ~73 KB a block, three
//   blocks an SM), four consumer warps take whole items; an int8 pool's
//   scale rows are read once, at the start;
// - a 16-token block at a time: all its scores together, their partial
//   sums added over the D / 16 lanes of a token once, one max and one
//   correction per block and query head;
// - elements converted without a conversion call each: int8 codes by a
//   byte permute and a subtract, bf16 by a shift or mask into the high
//   half; int8 scales hoisted (q . codes * k_scale / 127.5; the weight
//   takes v_scale / 127.5 before the V sum), a float pool's key factor
//   log2(e) alone;
// - the products on CUDA cores as f32 FMAs. q * scale is rounded to q's
//   dtype first, as the plain version computes it. bf16 q reads an int8 or
//   a bf16 pool, f32 q an int8 or an f32 pool.
//
// Rows frozen at the scratch page (engine caps 0) arrive with lengths = 1
// and page-table row 0: they read page 0, offset 0, which is legal.

#include "paged_common.cuh"

namespace {

using namespace ptt;

// The split kernel and merge over `rows` decode rows.
int decode(const paged::PoolArgs& pool, bool quant, const void* q,
           const void* lengths, const void* page_indices, void* out,
           void* o_part, void* ml_part, int batch, int num_kv_heads,
           int group, int head_dim, int page_size, int pages_per_seq,
           int num_splits, int pages_per_split, float scale, int dtype,
           void* stream) {
  if (page_size % 16 != 0 || (head_dim != 64 && head_dim != 128))
    return cudaErrorInvalidValue;
  const paged::SplitArgs a{pool,
                           q,
                           static_cast<const int*>(lengths),
                           static_cast<const int*>(page_indices),
                           nullptr,
                           out,
                           static_cast<float*>(o_part),
                           static_cast<float*>(ml_part),
                           batch,
                           page_size,
                           pages_per_seq,
                           pages_per_split,
                           num_splits,
                           scale};
  return paged::decode_splits(a, quant, num_kv_heads, group, head_dim, dtype,
                              static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers of contiguous
// tensors, each 16-byte aligned: q/out [batch, num_kv_heads * group,
// head_dim] f32, bf16 or fp16 (dtype), pools [num_kv_heads, num_pages,
// page_size, head_dim] in q's dtype, lengths [batch] int32, page_indices
// [batch, pages_per_seq] int32; group 1, 2, 4 or 8; page_size a multiple
// of 16. The split kernel over num_splits splits of pages_per_split pages
// and, with more than one split, their merge, both on `stream`; o_part
// [batch, Hq, num_splits, head_dim] and ml_part [batch, Hq, num_splits, 2]
// are f32 scratch. Allocates nothing; returns cudaGetLastError().
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* page_indices, void* out, void* o_part,
    void* ml_part, int batch, int num_kv_heads, int group, int head_dim,
    int num_pages, int page_size, int pages_per_seq, int num_splits,
    int pages_per_split, float scale, int dtype, void* stream) {
  const ptt::paged::PoolArgs pool{k_pages, v_pages, nullptr, nullptr,
                                  num_pages};
  return decode(pool, false, q, lengths, page_indices, out, o_part, ml_part,
                batch, num_kv_heads, group, head_dim, page_size,
                pages_per_seq, num_splits, pages_per_split, scale, dtype,
                stream);
}

// K5-int8: the same operands, each pool given as int8 codes [num_kv_heads,
// num_pages, page_size, head_dim] and f32 scales [num_kv_heads, num_pages,
// page_size, 1]; q/out f32 or bf16 (dtype).
extern "C" int paged_decode_attention_int8_launch(
    const void* q, const void* k_codes, const void* k_scales,
    const void* v_codes, const void* v_scales, const void* lengths,
    const void* page_indices, void* out, void* o_part, void* ml_part,
    int batch, int num_kv_heads, int group, int head_dim, int num_pages,
    int page_size, int pages_per_seq, int num_splits, int pages_per_split,
    float scale, int dtype, void* stream) {
  const ptt::paged::PoolArgs pool{k_codes, v_codes,
                                  static_cast<const float*>(k_scales),
                                  static_cast<const float*>(v_scales),
                                  num_pages};
  return decode(pool, true, q, lengths, page_indices, out, o_part, ml_part,
                batch, num_kv_heads, group, head_dim, page_size,
                pages_per_seq, num_splits, pages_per_split, scale, dtype,
                stream);
}
