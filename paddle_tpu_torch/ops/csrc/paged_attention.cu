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

#include "attention_common.cuh"

namespace {

using namespace ptt;

constexpr int kWarps = 8;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
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
    const size_t base = (size_t)pt[j] * page_elems;
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

template <typename T, int D>
cudaError_t launch_group(int group, const void* q, const void* k_pages,
                         const void* v_pages, const void* lengths,
                         const void* page_indices, void* out, int batch,
                         int num_kv_heads, int num_pages, int page_size,
                         int pages_per_seq, float scale, cudaStream_t stream) {
#define PTT_CASE(G_)                                                        \
  case G_:                                                                  \
    return launch<T, D, G_>(q, k_pages, v_pages, lengths, page_indices, out, \
                            batch, num_kv_heads, num_pages, page_size,      \
                            pages_per_seq, scale, stream);
  switch (group) {
    PTT_CASE(1)
    PTT_CASE(2)
    PTT_CASE(4)
    PTT_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PTT_CASE
}

template <typename T>
cudaError_t launch_dim(int head_dim, int group, const void* q,
                       const void* k_pages, const void* v_pages,
                       const void* lengths, const void* page_indices,
                       void* out, int batch, int num_kv_heads, int num_pages,
                       int page_size, int pages_per_seq, float scale,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_group<T, 64>(group, q, k_pages, v_pages, lengths,
                                 page_indices, out, batch, num_kv_heads,
                                 num_pages, page_size, pages_per_seq, scale,
                                 stream);
    case 128:
      return launch_group<T, 128>(group, q, k_pages, v_pages, lengths,
                                  page_indices, out, batch, num_kv_heads,
                                  num_pages, page_size, pages_per_seq, scale,
                                  stream);
    default:
      return cudaErrorInvalidValue;
  }
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
    return launch_dim<float>(head_dim, group, q, k_pages, v_pages, lengths,
                             page_indices, out, batch, num_kv_heads, num_pages,
                             page_size, pages_per_seq, scale, s);
  if (dtype == ptt::kBFloat16)
    return launch_dim<__nv_bfloat16>(head_dim, group, q, k_pages, v_pages,
                                     lengths, page_indices, out, batch,
                                     num_kv_heads, num_pages, page_size,
                                     pages_per_seq, scale, s);
  return cudaErrorInvalidValue;
}
