// Kernels D and E: the token dispatch and combine of the MoE layer, forward
// and backward, on compact routing (one slot index and one weight per
// token and choice) instead of the dense one-hot tensors.
//
// Replaces no TPU kernel. The reference leaves MoE to XLA
// (paddle_tpu/incubate/distributed/models/moe/moe_layer.py): its gate
// builds dense combine and dispatch tensors [T, E, C] and the layer is
// three einsums, 'tec,tm->ecm' (:149), the expert bank, 'tec,ecm->tm'
// (:163). Each routing einsum is 2 T E C M operations, almost all of them
// products with zeros (344 GFLOP at Mixtral's T 4096, E 8, C 1280, M
// 4096), and each one-hot tensor is T E C elements. The same data
// movement as a gather moves a few hundred MB, so these kernels gather.
//
// - D (moe_gather_rows): out[s] = x[src[s]] * scale[s] for each output
//   row s, or a zero row where src[s] < 0. Without a scale it is a copy:
//   the dispatch, dispatched[e C + c] = tokens[token of the slot]. With
//   the per-slot weight as scale it is the combine's gradient to the
//   expert outputs, d expert_out[s] = w[t, j] d out[t] (one f32 product,
//   rounded once).
// - E (moe_combine_rows): out[t] = sum_j w[t, j] x[slot[t, j]], summed in
//   f32 in fixed j order and rounded once; a choice with slot < 0 adds
//   nothing, and a token with every choice dropped gets a zero row.
//   Without weights (unit weights) it is the dispatch's gradient to the
//   tokens, d tokens[t] = sum over the token's occupied slots.
// - E's weight gradient (moe_combine_dw): dw[t, j] = <d out[t],
//   x[slot[t, j]]>, an f32 row dot product, one warp a pair, reduced in a
//   fixed order; 0 where slot < 0.
// No atomics anywhere, so two launches give the same bits.
//
// What bounds them on the H100: bytes. Each moves rows of M elements with
// no arithmetic beyond one multiply-add an element; the bound is the bytes
// of the rows read once and written once over 3.35 TB/s. Design: one block
// a row (D, E) or a warp a pair (dw); a thread moves 16-byte vectors,
// neighbouring threads neighbouring vectors, and D writes its zero rows
// itself, so no memset precedes it. Rows are M * sizeof(T) bytes, a
// multiple of 16 (the wrapper refuses other widths).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 8;         // moe_dispatch.py: MAX_K
constexpr int kWarpsDw = 8;      // pairs a block of the dw kernel takes

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const uint4& u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 store(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const uint4& u, float (&v)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 store(const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))
              << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// D: one block an output row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const uint4* __restrict__ x, const int* __restrict__ src,
                       const float* __restrict__ scale, uint4* __restrict__ out,
                       int n_vec) {
  const int s = blockIdx.x;
  const int from = src[s];
  uint4* dst = out + (size_t)s * n_vec;
  if (from < 0) {
    for (int i = threadIdx.x; i < n_vec; i += kThreads)
      dst[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uint4* row = x + (size_t)from * n_vec;
  if (scale == nullptr) {
    for (int i = threadIdx.x; i < n_vec; i += kThreads) dst[i] = __ldg(row + i);
    return;
  }
  const float w = scale[s];
  constexpr int kN = Vec<T>::kN;
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    float v[kN];
    Vec<T>::load(__ldg(row + i), v);
#pragma unroll
    for (int e = 0; e < kN; ++e) v[e] = __fmul_rn(w, v[e]);
    dst[i] = Vec<T>::store(v);
  }
}

// E: one block a token.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    combine_rows_kernel(const uint4* __restrict__ x,
                        const int* __restrict__ slot,
                        const float* __restrict__ w, uint4* __restrict__ out,
                        int k, int n_vec) {
  const int t = blockIdx.x;
  int s[kMaxK];
  float wt[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    s[j] = j < k ? slot[(size_t)t * k + j] : -1;
    wt[j] = j < k && w != nullptr ? w[(size_t)t * k + j] : 1.f;
  }
  constexpr int kN = Vec<T>::kN;
  uint4* dst = out + (size_t)t * n_vec;
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    float acc[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (s[j] < 0) continue;
      float v[kN];
      Vec<T>::load(__ldg(x + (size_t)s[j] * n_vec + i), v);
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[e] = __fmaf_rn(wt[j], v[e], acc[e]);
    }
    dst[i] = Vec<T>::store(acc);
  }
}

// E's weight gradient: one warp a (token, choice) pair.
template <typename T>
__global__ void __launch_bounds__(kWarpsDw * 32)
    combine_dw_kernel(const uint4* __restrict__ dout,
                      const uint4* __restrict__ x, const int* __restrict__ slot,
                      float* __restrict__ dw, int n_pairs, int k, int n_vec) {
  const int pair = blockIdx.x * kWarpsDw + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= n_pairs) return;
  const int s = slot[pair];
  if (s < 0) {
    if (lane == 0) dw[pair] = 0.f;
    return;
  }
  const uint4* a = dout + (size_t)(pair / k) * n_vec;
  const uint4* b = x + (size_t)s * n_vec;
  constexpr int kN = Vec<T>::kN;
  float acc = 0.f;
  for (int i = lane; i < n_vec; i += 32) {
    float va[kN], vb[kN];
    Vec<T>::load(__ldg(a + i), va);
    Vec<T>::load(__ldg(b + i), vb);
#pragma unroll
    for (int e = 0; e < kN; ++e) acc = __fmaf_rn(va[e], vb[e], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dw[pair] = acc;
}

int vec_count(int M, int dtype) {
  const int bytes = M * (dtype == 0 ? 4 : 2);
  return bytes % 16 == 0 ? bytes / 16 : -1;
}

}  // namespace

// D. x [rows_in, M], src [rows_out] int32 (-1: zero row), scale [rows_out]
// f32 or null, out [rows_out, M]; dtype 0 f32, 1 bf16.
extern "C" int moe_gather_rows_launch(const void* x, const int* src,
                                      const float* scale, void* out,
                                      int rows_out, int M, int dtype,
                                      void* stream) {
  const int n_vec = vec_count(M, dtype);
  if (rows_out < 1 || M < 1 || n_vec < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* ov = static_cast<uint4*>(out);
  if (dtype == 0)
    gather_rows_kernel<float><<<rows_out, kThreads, 0, st>>>(xv, src, scale,
                                                             ov, n_vec);
  else
    gather_rows_kernel<__nv_bfloat16><<<rows_out, kThreads, 0, st>>>(
        xv, src, scale, ov, n_vec);
  return cudaGetLastError();
}

// E. x [rows_in, M], slot [T, k] int32, w [T, k] f32 or null (unit
// weights), out [T, M].
extern "C" int moe_combine_rows_launch(const void* x, const int* slot,
                                       const float* w, void* out, int T,
                                       int k, int M, int dtype, void* stream) {
  const int n_vec = vec_count(M, dtype);
  if (T < 1 || k < 1 || k > kMaxK || n_vec < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* ov = static_cast<uint4*>(out);
  if (dtype == 0)
    combine_rows_kernel<float><<<T, kThreads, 0, st>>>(xv, slot, w, ov, k,
                                                       n_vec);
  else
    combine_rows_kernel<__nv_bfloat16><<<T, kThreads, 0, st>>>(xv, slot, w, ov,
                                                               k, n_vec);
  return cudaGetLastError();
}

// E's weight gradient. dout [T, M], x [rows_in, M], slot [T, k] int32,
// dw [T, k] f32.
extern "C" int moe_combine_dw_launch(const void* dout, const void* x,
                                     const int* slot, float* dw, int T, int k,
                                     int M, int dtype, void* stream) {
  const int n_vec = vec_count(M, dtype);
  if (T < 1 || k < 1 || k > kMaxK || n_vec < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_pairs = T * k;
  const int blocks = (n_pairs + kWarpsDw - 1) / kWarpsDw;
  const uint4* dv = static_cast<const uint4*>(dout);
  const uint4* xv = static_cast<const uint4*>(x);
  if (dtype == 0)
    combine_dw_kernel<float><<<blocks, kWarpsDw * 32, 0, st>>>(
        dv, xv, slot, dw, n_pairs, k, n_vec);
  else
    combine_dw_kernel<__nv_bfloat16><<<blocks, kWarpsDw * 32, 0, st>>>(
        dv, xv, slot, dw, n_pairs, k, n_vec);
  return cudaGetLastError();
}
