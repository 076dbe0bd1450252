// Device helpers shared by the paged decode (K5) and ragged paged (K4)
// attention kernels: float <-> storage-type conversion, vectorised row
// loads into registers, and a warp-wide sum.
//
// Layout convention of both kernels: a "row" of D values is split over the
// 32 lanes of a warp, lane l owning the contiguous elements
// [l * D/32, (l+1) * D/32). Neighbouring lanes therefore read neighbouring
// addresses, and a lane's slice is one 8- or 16-byte load for D = 128.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round through the storage type: `q * scale` in the plain version is a
// product in q's dtype, so a bf16 q is rounded to bf16 after scaling.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Load N consecutive elements of type T into f32 registers. The caller
// guarantees p is aligned to N * sizeof(T) bytes (checked by the wrappers:
// contiguous tensors with 16-byte aligned base pointers).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int BYTES = N * int(sizeof(T));
  if constexpr (BYTES % 16 == 0) {
    constexpr int PER = 16 / int(sizeof(T));
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      uint4 u = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < PER; ++i) out[c * PER + i] = to_float(e[i]);
    }
  } else if constexpr (BYTES % 8 == 0) {
    constexpr int PER = 8 / int(sizeof(T));
#pragma unroll
    for (int c = 0; c < BYTES / 8; ++c) {
      uint2 u = reinterpret_cast<const uint2*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < PER; ++i) out[c * PER + i] = to_float(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(p[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_row(T* __restrict__ p,
                                          const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = from_float<T>(v[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One step of the f32 online softmax for a single score s against value
// slice v: the running max m, sum l and accumulator acc absorb it.
template <int N>
__device__ __forceinline__ void online_update(float s, const float (&v)[N],
                                              float& m, float& l,
                                              float (&acc)[N]) {
  const float m_new = fmaxf(m, s);
  const float corr = expf(m - m_new);
  const float p = expf(s - m_new);
  l = l * corr + p;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] * corr + p * v[i];
  m = m_new;
}

}  // namespace ptt
