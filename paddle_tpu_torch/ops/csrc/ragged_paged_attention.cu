// K4: ragged paged attention, hand-written for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/ragged_paged_attention.py::_ragged_pallas and its
// body _ragged_kernel, the Pallas TPU kernel of the mixed prefill+decode
// dispatch.
//
// Computes attention for a packed query stream q[T, Hq, D]: row b owns the
// tokens cu_q_lens[b] .. cu_q_lens[b+1] (q_len tokens), and its token at
// position q_pos sees the kv positions < kv_lens[b] - q_len + q_pos + 1 of
// the row, read from the pool [Hkv, num_pages, page_size, D] through
// page_indices[b, :]. kv_lens counts the tokens after this step's writes.
// Query head hq reads kv head hq / group (GQA). cu_q_lens[0] must be 0.
//
// The TPU kernel walks rows one after another through a sequential grid
// into one shared VMEM accumulator. Blocks on Hopper run in no order, so
// here every block owns its output outright:
// - one block per (row b, query tile of b, kv head): the tile is 16
//   (token, query head) pairs, i.e. 16 / group consecutive tokens with all
//   `group` query heads of the kv head; each block loads its own cu_q_lens,
//   kv_lens and page-table row;
// - it loops over the row's pages up to the causal extent of its last
//   token, staging each K and V page once in shared memory for all 16 pairs
//   (the GQA heads share every page load);
// - four warps, four pairs per warp; a lane owns D/32 contiguous elements;
//   f32 online softmax per pair, score by a warp-wide sum;
// - empty rows launch nothing useful (their tiles exit at once), and an
//   extra block row b = num_seqs writes zeros for the pad tokens past
//   cu_q_lens[num_seqs], so every output element is finite.
//
// What bounds it on the H100: bytes for the decode rows (one query token
// per K/V element read), and at a 256-token prefill chunk still the K/V
// bytes at this design's CUDA-core arithmetic. The floor is the live K/V
// pages over 3.35 TB/s or the products over the bf16 tensor-core peak,
// whichever is larger; wgmma tiles, TMA page loads and double buffering
// are later work.
//
// The int8 variant (ragged_paged_attention_int8_launch) reads an int8 pool:
// codes [Hkv, P, bs, D] plus one f32 scale per row. A block dequantizes
// each page once as it stages it (code * scale / 127.5, in f32; 16 codes
// per thread and load) into f32 shared memory, so the four warps that all
// read every staged row share one dequantization; everything after staging
// is the float kernel's arithmetic, and q and the output stay f32 or bf16.
// Each live row costs D + 4 bytes of device memory instead of 2D in bf16.

#include "attention_common.cuh"

namespace {

using namespace ptt;

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (token, head) pairs a block

// KT: the pool's element type, T (float pool) or int8_t (int8 pool, with
// per-row scales k_scales / v_scales [Hkv, P, bs]; unread for a float pool)
template <typename T, typename KT, int D>
__global__ void __launch_bounds__(kWarps * 32)
    ragged_paged_kernel(const T* __restrict__ q,
                        const KT* __restrict__ k_pages,
                        const KT* __restrict__ v_pages,
                        const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales,
                        const int* __restrict__ kv_lens,
                        const int* __restrict__ page_indices,
                        const int* __restrict__ cu_q_lens,
                        T* __restrict__ out, int num_tokens, int num_seqs,
                        int group, int num_pages, int page_size,
                        int pages_per_seq, float scale) {
  constexpr int EPL = D / 32;
  constexpr bool kInt8 = std::is_same_v<KT, int8_t>;
  using ST = std::conditional_t<kInt8, float, KT>;  // staged element type
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ST* ks = reinterpret_cast<ST*>(smem_raw);
  ST* vs = ks + (size_t)page_size * D;

  const int b = blockIdx.x;
  const int tile = blockIdx.y;
  const int h = blockIdx.z;
  const int num_q_heads = gridDim.z * group;
  const int tokens_per_tile = kRows / group;
  const bool pad_span = (b == num_seqs);
  const int start = cu_q_lens[b];
  const int end = pad_span ? num_tokens : cu_q_lens[b + 1];
  const int t0 = start + tile * tokens_per_tile;
  if (t0 >= end) return;  // uniform over the block
  const int t1 = min(t0 + tokens_per_tile, end);

  if (pad_span) {
    const int span = group * D;
    for (int idx = threadIdx.x; idx < (t1 - t0) * span; idx += blockDim.x) {
      const int tt = idx / span;
      out[((size_t)(t0 + tt) * num_q_heads + (size_t)h * group) * D +
          idx % span] = from_float<T>(0.f);
    }
    return;
  }

  const int q_len = end - start;
  // token t of this row sees kv positions < base_lim + t
  const int base_lim = kv_lens[b] - q_len - start + 1;
  const int block_lim =
      min(base_lim + t1 - 1, pages_per_seq * page_size);  // last token's
  const int npages = block_lim > 0 ? (block_lim + page_size - 1) / page_size
                                   : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float qr[kRowsPerWarp][EPL];
  float acc[kRowsPerWarp][EPL];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  int lim[kRowsPerWarp];  // 0 for pairs past the tile's last token
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int t = t0 + r / group;
    const int g = r % group;
    const bool active = t < t1;
    lim[i] = active ? base_lim + t : 0;
    if (active) {
      load_row<T, EPL>(
          q + ((size_t)t * num_q_heads + (size_t)h * group + g) * D +
              lane * EPL,
          qr[i]);
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[i][e] = active ? round_to<T>(qr[i][e] * scale) : 0.f;
      acc[i][e] = 0.f;
    }
    m[i] = -1e30f;
    l[i] = 0.f;
  }

  const int* pt = page_indices + (size_t)b * pages_per_seq;
  const size_t page_elems = (size_t)page_size * D;
  const KT* kh = k_pages + (size_t)h * num_pages * page_elems;
  const KT* vh = v_pages + (size_t)h * num_pages * page_elems;
  const size_t head_rows = (size_t)h * num_pages * page_size;  // scale rows
  const int vec_per_page = (int)(page_elems * sizeof(KT) / 16);
  for (int j = 0; j < npages; ++j) {
    __syncthreads();  // the previous page is consumed by every warp
    const size_t base = (size_t)pt[j] * page_elems;
    const uint4* ksrc = reinterpret_cast<const uint4*>(kh + base);
    const uint4* vsrc = reinterpret_cast<const uint4*>(vh + base);
    if constexpr (kInt8) {
      // 16 codes a load, all of one row (D is a multiple of 16)
      const size_t srow = head_rows + (size_t)pt[j] * page_size;
      for (int idx = threadIdx.x; idx < vec_per_page; idx += blockDim.x) {
        const int t = idx * 16 / D;
        dequantize16(ksrc[idx], k_scales[srow + t], ks + (size_t)idx * 16);
        dequantize16(vsrc[idx], v_scales[srow + t], vs + (size_t)idx * 16);
      }
    } else {
      for (int idx = threadIdx.x; idx < vec_per_page; idx += blockDim.x) {
        reinterpret_cast<uint4*>(ks)[idx] = ksrc[idx];
        reinterpret_cast<uint4*>(vs)[idx] = vsrc[idx];
      }
    }
    __syncthreads();
    const int p0 = j * page_size;
    int n[kRowsPerWarp];
    int nmax = 0;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      n[i] = min(page_size, lim[i] - p0);
      nmax = max(nmax, n[i]);
    }
    for (int t = 0; t < nmax; ++t) {
      float kr[EPL];
      float vr[EPL];
      load_row<ST, EPL>(ks + (size_t)t * D + lane * EPL, kr);
      load_row<ST, EPL>(vs + (size_t)t * D + lane * EPL, vr);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (t < n[i]) {  // uniform over the warp
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s += qr[i][e] * kr[e];
          s = warp_sum(s);
          online_update<EPL>(s, vr, m[i], l[i], acc[i]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int t = t0 + r / group;
    if (t >= t1) continue;
    const int g = r % group;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float o[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = acc[i][e] * inv;
    store_row<T, EPL>(
        out + ((size_t)t * num_q_heads + (size_t)h * group + g) * D +
            lane * EPL,
        o);
  }
}

template <typename T, typename KT, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales,
                   const void* kv_lens, const void* page_indices,
                   const void* cu_q_lens, void* out, int num_tokens,
                   int num_seqs, int num_kv_heads, int group, int num_pages,
                   int page_size, int pages_per_seq, float scale,
                   cudaStream_t stream) {
  const int tokens_per_tile = kRows / group;
  dim3 grid(num_seqs + 1, (num_tokens + tokens_per_tile - 1) / tokens_per_tile,
            num_kv_heads);
  // two staged pages: int8 codes are staged dequantized, as f32
  const size_t smem = 2 * (size_t)page_size * D *
                      (std::is_same_v<KT, int8_t> ? sizeof(float) : sizeof(KT));
  ragged_paged_kernel<T, KT, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(kv_lens),
      static_cast<const int*>(page_indices),
      static_cast<const int*>(cu_q_lens), static_cast<T*>(out), num_tokens,
      num_seqs, group, num_pages, page_size, pages_per_seq, scale);
  return cudaGetLastError();
}

// One dispatch over head_dim for a (q type, pool type) pair.
template <typename T, typename KT>
cudaError_t launch_any(int head_dim, const void* q, const void* k_pages,
                       const void* v_pages, const void* k_scales,
                       const void* v_scales, const void* kv_lens,
                       const void* page_indices, const void* cu_q_lens,
                       void* out, int num_tokens, int num_seqs,
                       int num_kv_heads, int group, int num_pages,
                       int page_size, int pages_per_seq, float scale,
                       cudaStream_t stream) {
  if (group < 1 || kRows % group != 0) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 64:
      return launch<T, KT, 64>(q, k_pages, v_pages, k_scales, v_scales,
                               kv_lens, page_indices, cu_q_lens, out,
                               num_tokens, num_seqs, num_kv_heads, group,
                               num_pages, page_size, pages_per_seq, scale,
                               stream);
    case 128:
      return launch<T, KT, 128>(q, k_pages, v_pages, k_scales, v_scales,
                                kv_lens, page_indices, cu_q_lens, out,
                                num_tokens, num_seqs, num_kv_heads, group,
                                num_pages, page_size, pages_per_seq, scale,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers of contiguous
// tensors: q/out [num_tokens, num_kv_heads * group, head_dim], pools
// [num_kv_heads, num_pages, page_size, head_dim] (same dtype as q), kv_lens
// [num_seqs] int32, page_indices [num_seqs, pages_per_seq] int32, cu_q_lens
// [num_seqs + 1] int32. group must divide 16, and the two staged pages
// (2 * page_size * head_dim elements) must fit 48 KB of shared memory.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* kv_lens, const void* page_indices, const void* cu_q_lens,
    void* out, int num_tokens, int num_seqs, int num_kv_heads, int group,
    int head_dim, int num_pages, int page_size, int pages_per_seq, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_any<float, float>(
        head_dim, q, k_pages, v_pages, nullptr, nullptr, kv_lens,
        page_indices, cu_q_lens, out, num_tokens, num_seqs, num_kv_heads,
        group, num_pages, page_size, pages_per_seq, scale, s);
  if (dtype == ptt::kBFloat16)
    return launch_any<__nv_bfloat16, __nv_bfloat16>(
        head_dim, q, k_pages, v_pages, nullptr, nullptr, kv_lens,
        page_indices, cu_q_lens, out, num_tokens, num_seqs, num_kv_heads,
        group, num_pages, page_size, pages_per_seq, scale, s);
  return cudaErrorInvalidValue;
}

// The int8 variant: the same operands, each pool given as int8 codes
// [num_kv_heads, num_pages, page_size, head_dim] and f32 scales
// [num_kv_heads, num_pages, page_size, 1]; q/out f32 or bf16 (dtype). The
// two staged pages (dequantized, f32) take 2 * page_size * head_dim * 4
// bytes, which must fit 48 KB.
extern "C" int ragged_paged_attention_int8_launch(
    const void* q, const void* k_codes, const void* k_scales,
    const void* v_codes, const void* v_scales, const void* kv_lens,
    const void* page_indices, const void* cu_q_lens, void* out,
    int num_tokens, int num_seqs, int num_kv_heads, int group, int head_dim,
    int num_pages, int page_size, int pages_per_seq, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_any<float, int8_t>(
        head_dim, q, k_codes, v_codes, k_scales, v_scales, kv_lens,
        page_indices, cu_q_lens, out, num_tokens, num_seqs, num_kv_heads,
        group, num_pages, page_size, pages_per_seq, scale, s);
  if (dtype == ptt::kBFloat16)
    return launch_any<__nv_bfloat16, int8_t>(
        head_dim, q, k_codes, v_codes, k_scales, v_scales, kv_lens,
        page_indices, cu_q_lens, out, num_tokens, num_seqs, num_kv_heads,
        group, num_pages, page_size, pages_per_seq, scale, s);
  return cudaErrorInvalidValue;
}
