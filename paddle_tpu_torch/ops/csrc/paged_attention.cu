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
// query head hq reads kv head hq / group (GQA).
//
// What bounds it on the H100: bytes. Each K/V element is read once and used
// for `group` multiply-adds per head, far below the ~295 operations per
// byte at which bf16 tensor cores would become the limit, so the floor is
// the live K/V pages over 3.35 TB/s.
//
// Design for that bound, simple first:
// - one block per (row, kv head); its eight warps take the row's live pages
//   round-robin, so a long row keeps eight independent streams of loads in
//   flight;
// - a lane owns D/32 contiguous elements of a K/V row (one 8-byte load in
//   bf16 at D = 128), neighbouring lanes neighbouring addresses;
// - the `group` query heads of the kv head sit in registers, so each K/V
//   load serves all of them;
// - f32 online softmax per warp, merged across warps in shared memory.
// Split-KV across blocks, TMA and wgmma are later work.
//
// Rows frozen at the scratch page (engine caps 0) arrive with lengths = 1
// and page-table row 0: they read page 0, offset 0, which is legal.
//
// The int8 variant (paged_decode_attention_int8_launch, K5-int8) is its own
// design, int8p::paged_int8_split_kernel in int8_paged.cuh:
// - bound: bytes; a row costs D + 4 bytes (codes and a scale), (D + 4) / 2D
//   = 0.52 of the bf16 kernel's floor;
// - split-KV: the wrapper sizes the splits from pages_per_seq and the SM
//   count (kv_split_plan: the longest possible row over about two waves of
//   the SMs, at least 16 pages a split); lengths stay on the device. The
//   grid is (kv head, work item): each block finds its row and split among
//   the rows' splits that hold pages, numbered compactly, so the SMs take
//   them evenly and no block is launched for a split past its row's
//   length (an empty row's one split writes an empty partial, m = -inf,
//   l = 0). A second launch merges a row's live splits in a fixed order
//   (no atomics: two calls give the same bits);
// - a page ring: one producer thread keeps up to 8 pages per block in
//   flight by 1-D bulk copies on mbarriers, four consumer warps take whole
//   pages; the block's scale rows are read once, at the start;
// - a page's 16-token block at a time: all its scores together, their
//   partial sums added over the D / 16 lanes of a token once, one max and
//   one correction per block and query head;
// - hoisted scales (q . codes * k_scale / 127.5; the weight takes
//   v_scale / 127.5 before the V sum) and codes converted by a byte
//   permute and a subtract, not an I2F each;
// - the products on CUDA cores as f32 FMAs: 2 G operations per code byte
//   (G <= 8 query heads a kv head) is far below the ~295 per byte where
//   tensor cores would matter. bf16 and f32 q share the kernel; q * scale
//   is rounded to q's dtype first, as the plain version computes it.

#include "attention_common.cuh"
#include "int8_paged.cuh"

namespace {

using namespace ptt;

constexpr int kWarps = 8;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const T* __restrict__ q,
                        const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ lengths,
                        const int* __restrict__ page_indices,
                        T* __restrict__ out, int num_pages, int page_size,
                        int pages_per_seq, float scale) {
  constexpr int EPL = D / 32;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int num_kv_heads = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = max(lengths[b], 0);
  const int npages = min((len + page_size - 1) / page_size, pages_per_seq);

  float qr[G][EPL];
  float acc[G][EPL];
  float m[G];
  float l[G];
  const size_t head0 = (size_t)b * num_kv_heads * G + (size_t)h * G;
  const T* qb = q + head0 * D + lane * EPL;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<T, EPL>(qb + g * D, qr[g]);
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      qr[g][i] = round_to<T>(qr[g][i] * scale);
      acc[g][i] = 0.f;
    }
    m[g] = -1e30f;
    l[g] = 0.f;
  }

  const size_t page_elems = (size_t)page_size * D;
  const T* kh = k_pages + (size_t)h * num_pages * page_elems + lane * EPL;
  const T* vh = v_pages + (size_t)h * num_pages * page_elems + lane * EPL;
  const int* pt = page_indices + (size_t)b * pages_per_seq;
  for (int j = warp; j < npages; j += kWarps) {
    const size_t base = (size_t)pt[j] * page_size * D;
    const int ntok = min(page_size, len - j * page_size);
#pragma unroll 4
    for (int t = 0; t < ntok; ++t) {
      float kr[EPL];
      float vr[EPL];
      load_row<T, EPL>(kh + base + (size_t)t * D, kr);
      load_row<T, EPL>(vh + base + (size_t)t * D, vr);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) s += qr[g][i] * kr[i];
        s = warp_sum(s);
        online_update<EPL>(s, vr, m[g], l[g], acc[g]);
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) sm_acc[warp][g][lane * EPL + i] = acc[g][i];
  }
  __syncthreads();
  T* ob = out + head0 * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kWarps * 32) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = -1e30f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float sum = 0.f;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      sum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    ob[idx] = from_float<T>(a / fmaxf(sum, 1e-30f));
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* lengths, const void* page_indices, void* out,
                   int batch, int num_kv_heads, int num_pages, int page_size,
                   int pages_per_seq, float scale, cudaStream_t stream) {
  dim3 grid(batch, num_kv_heads);
  paged_decode_kernel<T, D, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(lengths),
      static_cast<const int*>(page_indices), static_cast<T*>(out), num_pages,
      page_size, pages_per_seq, scale);
  return cudaGetLastError();
}

// One dispatch over head_dim and group for a float q type.
template <typename T>
cudaError_t launch_any(int head_dim, int group, const void* q,
                       const void* k_pages, const void* v_pages,
                       const void* lengths, const void* page_indices,
                       void* out, int batch, int num_kv_heads, int num_pages,
                       int page_size, int pages_per_seq, float scale,
                       cudaStream_t stream) {
#define PTT_CASE(D_, G_)                                                    \
  if (head_dim == D_ && group == G_)                                        \
    return launch<T, D_, G_>(q, k_pages, v_pages, lengths, page_indices,    \
                             out, batch, num_kv_heads, num_pages, page_size, \
                             pages_per_seq, scale, stream);
  PTT_CASE(64, 1)
  PTT_CASE(64, 2)
  PTT_CASE(64, 4)
  PTT_CASE(64, 8)
  PTT_CASE(128, 1)
  PTT_CASE(128, 2)
  PTT_CASE(128, 4)
  PTT_CASE(128, 8)
#undef PTT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers of contiguous
// tensors: q/out [batch, num_kv_heads * group, head_dim], pools
// [num_kv_heads, num_pages, page_size, head_dim] (same dtype as q), lengths
// [batch] int32, page_indices [batch, pages_per_seq] int32. Launches on
// `stream`, allocates nothing, returns cudaGetLastError() of the launch.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* page_indices, void* out, int batch,
    int num_kv_heads, int group, int head_dim, int num_pages, int page_size,
    int pages_per_seq, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_any<float>(head_dim, group, q, k_pages, v_pages, lengths,
                             page_indices, out, batch, num_kv_heads,
                             num_pages, page_size, pages_per_seq, scale, s);
  if (dtype == ptt::kBFloat16)
    return launch_any<__nv_bfloat16>(head_dim, group, q, k_pages, v_pages,
                                     lengths, page_indices, out, batch,
                                     num_kv_heads, num_pages, page_size,
                                     pages_per_seq, scale, s);
  return cudaErrorInvalidValue;
}

// K5-int8: the same operands, each pool given as int8 codes [num_kv_heads,
// num_pages, page_size, head_dim] and f32 scales [num_kv_heads, num_pages,
// page_size, 1]; q/out f32 or bf16 (dtype); page_size a multiple of 16;
// every pointer 16-byte aligned. The split kernel over num_splits splits of
// pages_per_split pages and, with more than one split, their merge, both
// on `stream`; o_part [batch, Hq, num_splits, head_dim] and ml_part
// [batch, Hq, num_splits, 2] are f32 scratch. Allocates nothing.
extern "C" int paged_decode_attention_int8_launch(
    const void* q, const void* k_codes, const void* k_scales,
    const void* v_codes, const void* v_scales, const void* lengths,
    const void* page_indices, void* out, void* o_part, void* ml_part,
    int batch, int num_kv_heads, int group, int head_dim, int num_pages,
    int page_size, int pages_per_seq, int num_splits, int pages_per_split,
    float scale, int dtype, void* stream) {
  if (page_size % 16 != 0 || (head_dim != 64 && head_dim != 128))
    return cudaErrorInvalidValue;
  const ptt::int8p::SplitArgs a{
      {static_cast<const int8_t*>(k_codes), static_cast<const int8_t*>(v_codes),
       static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
       num_pages},
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
  return ptt::int8p::decode_int8(a, num_kv_heads, group, head_dim, dtype,
                                 static_cast<cudaStream_t>(stream));
}
