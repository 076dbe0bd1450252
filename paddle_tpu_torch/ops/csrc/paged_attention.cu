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
// The int8 variant (paged_decode_attention_int8_launch) reads an int8 pool:
// codes [Hkv, P, bs, D] plus one f32 scale per row. A lane's D/32 codes are
// one 4-byte load at D = 128, and a page's scales are one load per lane
// (lane t holds row t's; page_size <= 32), passed to the warp by a shuffle
// as each row is read. Each row costs D + 4 bytes instead of 2D in bf16:
// the byte floor falls to (D + 4) / 2D = 0.52 of the bf16 kernel's. The
// codes are dequantized in registers (code * scale / 127.5, in f32) and
// everything after the load is the float kernel's arithmetic; q and the
// output stay f32 or bf16.

#include "attention_common.cuh"

namespace {

using namespace ptt;

constexpr int kWarps = 8;

// KT: the pool's element type, T (float pool) or int8_t (int8 pool, with
// per-row scales k_scales / v_scales [Hkv, P, bs]; unread for a float pool)
template <typename T, typename KT, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const T* __restrict__ q,
                        const KT* __restrict__ k_pages,
                        const KT* __restrict__ v_pages,
                        const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales,
                        const int* __restrict__ lengths,
                        const int* __restrict__ page_indices,
                        T* __restrict__ out, int num_pages, int page_size,
                        int pages_per_seq, float scale) {
  constexpr int EPL = D / 32;
  constexpr bool kInt8 = std::is_same_v<KT, int8_t>;
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
  const KT* kh = k_pages + (size_t)h * num_pages * page_elems + lane * EPL;
  const KT* vh = v_pages + (size_t)h * num_pages * page_elems + lane * EPL;
  const size_t head_rows = (size_t)h * num_pages * page_size;  // scale rows
  const int* pt = page_indices + (size_t)b * pages_per_seq;
  for (int j = warp; j < npages; j += kWarps) {
    const size_t prow = (size_t)pt[j] * page_size;
    const size_t base = prow * D;
    const int ntok = min(page_size, len - j * page_size);
    float ksc = 0.f;  // int8 pool: lane t holds row t's scales
    float vsc = 0.f;
    if constexpr (kInt8) {
      if (lane < ntok) {
        ksc = k_scales[head_rows + prow + lane];
        vsc = v_scales[head_rows + prow + lane];
      }
    }
#pragma unroll 4
    for (int t = 0; t < ntok; ++t) {
      float kr[EPL];
      float vr[EPL];
      load_row<KT, EPL>(kh + base + (size_t)t * D, kr);
      load_row<KT, EPL>(vh + base + (size_t)t * D, vr);
      if constexpr (kInt8) {  // ntok is uniform over the warp
        dequantize<EPL>(kr, __shfl_sync(0xffffffffu, ksc, t));
        dequantize<EPL>(vr, __shfl_sync(0xffffffffu, vsc, t));
      }
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

template <typename T, typename KT, int D, int G>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales,
                   const void* lengths, const void* page_indices, void* out,
                   int batch, int num_kv_heads, int num_pages, int page_size,
                   int pages_per_seq, float scale, cudaStream_t stream) {
  dim3 grid(batch, num_kv_heads);
  paged_decode_kernel<T, KT, D, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(lengths),
      static_cast<const int*>(page_indices), static_cast<T*>(out), num_pages,
      page_size, pages_per_seq, scale);
  return cudaGetLastError();
}

// One dispatch over head_dim and group for a (q type, pool type) pair.
template <typename T, typename KT>
cudaError_t launch_any(int head_dim, int group, const void* q,
                       const void* k_pages, const void* v_pages,
                       const void* k_scales, const void* v_scales,
                       const void* lengths, const void* page_indices,
                       void* out, int batch, int num_kv_heads, int num_pages,
                       int page_size, int pages_per_seq, float scale,
                       cudaStream_t stream) {
#define PTT_CASE(D_, G_)                                                    \
  if (head_dim == D_ && group == G_)                                        \
    return launch<T, KT, D_, G_>(q, k_pages, v_pages, k_scales, v_scales,   \
                                 lengths, page_indices, out, batch,         \
                                 num_kv_heads, num_pages, page_size,        \
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
    return launch_any<float, float>(
        head_dim, group, q, k_pages, v_pages, nullptr, nullptr, lengths,
        page_indices, out, batch, num_kv_heads, num_pages, page_size,
        pages_per_seq, scale, s);
  if (dtype == ptt::kBFloat16)
    return launch_any<__nv_bfloat16, __nv_bfloat16>(
        head_dim, group, q, k_pages, v_pages, nullptr, nullptr, lengths,
        page_indices, out, batch, num_kv_heads, num_pages, page_size,
        pages_per_seq, scale, s);
  return cudaErrorInvalidValue;
}

// The int8 variant: the same operands, each pool given as int8 codes
// [num_kv_heads, num_pages, page_size, head_dim] and f32 scales
// [num_kv_heads, num_pages, page_size, 1]; q/out f32 or bf16 (dtype);
// page_size <= 32.
extern "C" int paged_decode_attention_int8_launch(
    const void* q, const void* k_codes, const void* k_scales,
    const void* v_codes, const void* v_scales, const void* lengths,
    const void* page_indices, void* out, int batch, int num_kv_heads,
    int group, int head_dim, int num_pages, int page_size, int pages_per_seq,
    float scale, int dtype, void* stream) {
  if (page_size > 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_any<float, int8_t>(
        head_dim, group, q, k_codes, v_codes, k_scales, v_scales, lengths,
        page_indices, out, batch, num_kv_heads, num_pages, page_size,
        pages_per_seq, scale, s);
  if (dtype == ptt::kBFloat16)
    return launch_any<__nv_bfloat16, int8_t>(
        head_dim, group, q, k_codes, v_codes, k_scales, v_scales, lengths,
        page_indices, out, batch, num_kv_heads, num_pages, page_size,
        pages_per_seq, scale, s);
  return cudaErrorInvalidValue;
}
