// Fixed-order sums of squares shared by the gradient-norm kernel
// (grad_norm.cu) and the AdamW update's dynamics epilogue (adamw.cu).
//
// A first pass writes one f64 partial per block (and, for gradients, one
// non-finite flag); `sumsq_finish` reduces them in a fixed order, so two
// launches over the same data give the same bits (no atomics):
//   - tensor t's partials [starts[t], starts[t + 1]) are summed by one warp,
//     its lanes striding over them, then a shuffle tree; the f64 sum is
//     rounded once to f32;
//   - one thread then adds the tensors' f32 sums in order, into the total
//     and into each tensor's group, as the reference's traced loops do
//     (`total = sq[0] + sq[1] + ...`, paddle_tpu/nn/clip.py:55-61; the
//     per-group sums of paddle_tpu/observability/dynamics.py:229-247).
// Output, f32: [n_tensors sums | n_groups sums | total, sqrt(total),
// factor]; i32 flags: [n_tensors | n_groups | any], where given.
#pragma once

#include "attention_common.cuh"

namespace ptt {

constexpr int kFinishThreads = 1024;

// x / scale, as the reference unscales (g / scale, jit_api.py:329). A
// power-of-two scale (the loss scaler's only kind) divides exactly as a
// product with its exact inverse does, which is cheaper; any other scale
// takes the IEEE division.
struct Unscale {
  bool on = false, pow2 = false;
  float s = 1.f, inv = 1.f;
  __device__ explicit Unscale(const float* scale) {
    if (scale == nullptr) return;
    on = true;
    s = *scale;
    int e = 0;
    const float mant = frexpf(s, &e);
    inv = ldexpf(1.f, 1 - e);
    pow2 = mant == 0.5f && isfinite(s) && isfinite(inv);
  }
  __device__ __forceinline__ float operator()(float x) const {
    if (!on) return x;
    return pow2 ? __fmul_rn(x, inv) : __fdiv_rn(x, s);
  }
};

// Sum of `v` over a block of kBlock threads, in a fixed order; valid in
// thread 0. `sh` holds kBlock / 32 doubles.
template <int kBlock>
__device__ __forceinline__ double block_sum(double v, double* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  double r = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w) r += sh[w];
  }
  __syncthreads();
  return r;
}

// One block of kFinishThreads. `bad`, `flags` and `group` may be null.
__global__ void __launch_bounds__(kFinishThreads)
    sumsq_finish(const double* __restrict__ part, const int* __restrict__ bad,
                 const long long* __restrict__ starts,
                 const long long* __restrict__ group, int n_tensors,
                 int n_groups, int has_clip, float clip_norm,
                 float* __restrict__ out, int* __restrict__ flags) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < n_tensors; t += kFinishThreads / 32) {
    double acc = 0.0;
    int b = 0;
    for (long long c = starts[t] + lane; c < starts[t + 1]; c += 32) {
      acc += part[c];
      if (bad != nullptr) b |= bad[c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    b = __any_sync(0xffffffffu, b);
    if (lane == 0) {
      out[t] = __double2float_rn(acc);
      if (flags != nullptr) flags[t] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int g = 0; g < n_groups; ++g) {
    out[n_tensors + g] = 0.f;
    if (flags != nullptr) flags[n_tensors + g] = 0;
  }
  float total = 0.f;
  int any = 0;
  for (int t = 0; t < n_tensors; ++t) {
    total = __fadd_rn(total, out[t]);
    const int b = flags != nullptr ? flags[t] : 0;
    any |= b;
    const long long g = group != nullptr ? group[t] : -1;
    if (g >= 0) {
      out[n_tensors + g] = __fadd_rn(out[n_tensors + g], out[t]);
      if (flags != nullptr) flags[n_tensors + g] |= b;
    }
  }
  const float norm = __fsqrt_rn(total);
  float* tail = out + n_tensors + n_groups;
  tail[0] = total;
  tail[1] = norm;
  // factor = min(1, clip / max(norm, 1e-12)) (paddle_tpu/nn/clip.py:66),
  // a NaN carried through as jnp.minimum and jnp.maximum carry it
  const float r =
      __fdiv_rn(clip_norm, isnan(norm) ? norm : fmaxf(norm, 1e-12f));
  tail[2] = !has_clip ? 1.f : isnan(r) ? r : fminf(1.f, r);
  if (flags != nullptr) flags[n_tensors + n_groups] = any;
}

}  // namespace ptt
