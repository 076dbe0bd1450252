// Kernel A: the multi-tensor gradient norm. One launch reads every tensor of
// a list once and writes, per tensor, the f32 sum of squares of its
// elements (each first divided by an optional f32 scale) and a flag that
// some element is NaN or Inf; then the per-group sums, the total, its
// square root and the global-norm clip factor (sumsq_common.cuh).
//
// Replaces no TPU kernel. The reference's compiled step leaves this work
// to XLA, which fuses it into the step program: the unscale g / scale
// (paddle_tpu/jit_api.py:329), the finite check on every gradient
// (:334-337), the global norm of ClipGradByGlobalNorm
// (paddle_tpu/nn/clip.py:55-66) and the dynamics' per-group grad_sq and
// nf_mask (paddle_tpu/observability/dynamics.py:229-252). Run eagerly, the
// same work is two to four launches per gradient and a stack: about 580 a
// step at 32 layers. Here it is one pass over the gradients and one small
// finishing pass, and its one output buffer feeds the guard, the loss
// scaler, the clip (the factor stays on the device) and the dynamics.
//
// Each flag comes from the elements themselves, not from the sum: a finite
// bf16 gradient whose square overflows f32 makes an infinite sum but no
// flag, as the reference checks isfinite on the elements. An fp16 element
// is squared in f32, where no finite one overflows; only a NaN or an inf
// element (an fp16 backward that overflowed) sets its flag.
//
// Design: a table of (pointer, length, dtype) rows, f32, bf16 or fp16
// elements, cut into chunks of kChunk elements, one block per chunk (a block
// finds its tensor by a binary search over the chunk starts). A thread reads
// 16-byte vectors, neighbouring threads neighbouring vectors, squares each
// element in f32 (x = g / scale rounded to f32, then x * x rounded to f32, the
// reference's rounding points) and accumulates in f64; the block's tree writes
// one f64 partial and one flag. The finishing pass reduces them in a fixed
// order, so two launches give the same bits.
// What bounds it on the H100: bytes. Each element is read once (2 bytes in
// bf16 and fp16); a few operations per element are far below the card's rate.

#include "sumsq_common.cuh"

namespace {

using namespace ptt;

constexpr int kThreads = 256;
constexpr long long kChunk = 65536;   // grad_norm.py: CHUNK

template <typename T>
__device__ __forceinline__ void chunk_sumsq(const T* __restrict__ p,
                                            long long lo, long long hi,
                                            long long n, const Unscale& u,
                                            double& acc, int& bad) {
  constexpr int kVec = 16 / int(sizeof(T));
  const long long vec_end = (n / kVec) * kVec;
  const long long vhi = hi < vec_end ? hi : vec_end;
  for (long long i = lo + (long long)threadIdx.x * kVec; i < vhi;
       i += (long long)kThreads * kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float x = u(to_float(e[k]));
      bad |= !isfinite(x);
      acc += (double)__fmul_rn(x, x);
    }
  }
  for (long long i = (lo > vec_end ? lo : vec_end) + threadIdx.x; i < hi;
       i += kThreads) {
    const float x = u(to_float(p[i]));
    bad |= !isfinite(x);
    acc += (double)__fmul_rn(x, x);
  }
}

// meta (int64): ptr[n] | numel[n] | dtype[n] | starts[n + 1] | group[n]
__global__ void __launch_bounds__(kThreads)
    sumsq_partials(const long long* __restrict__ meta, int n_tensors,
                   const float* __restrict__ scale, double* __restrict__ part,
                   int* __restrict__ bad_out) {
  __shared__ double sh[kThreads / 32];
  const long long* starts = meta + 3 * n_tensors;
  const long long b = blockIdx.x;
  int lo_t = 0, hi_t = n_tensors - 1;   // last t with starts[t] <= b
  while (lo_t < hi_t) {
    const int mid = (lo_t + hi_t + 1) >> 1;
    if (starts[mid] <= b)
      lo_t = mid;
    else
      hi_t = mid - 1;
  }
  const int t = lo_t;
  const long long n = meta[n_tensors + t];
  const long long lo = (b - starts[t]) * kChunk;
  const long long hi = lo + kChunk < n ? lo + kChunk : n;
  const Unscale u(scale);
  double acc = 0.0;
  int bad = 0;
  const void* ptr = reinterpret_cast<const void*>(meta[t]);
  const long long dtype = meta[2 * n_tensors + t];
  if (dtype == kBFloat16)
    chunk_sumsq(static_cast<const __nv_bfloat16*>(ptr), lo, hi, n, u, acc,
                bad);
  else if (dtype == kFloat16)
    chunk_sumsq(static_cast<const __half*>(ptr), lo, hi, n, u, acc, bad);
  else
    chunk_sumsq(static_cast<const float*>(ptr), lo, hi, n, u, acc, bad);
  bad = __syncthreads_or(bad);
  const double sum = block_sum<kThreads>(acc, sh);
  if (threadIdx.x == 0) {
    part[b] = sum;
    bad_out[b] = bad;
  }
}

}  // namespace

// Plain C entry for ctypes. `meta` is the device table above (the tensors
// 16-byte aligned, contiguous, f32, bf16 or fp16, starts[t] the first chunk of
// tensor t, ceil(numel / kChunk) chunks each, starts[n] == n_chunks; group
// index per tensor, or -1), `scale` a device f32 or null, `part` and `bad`
// n_chunks scratch entries, `out` n_tensors + n_groups + 3 floats and
// `flags` n_tensors + n_groups + 1 ints (layout: sumsq_common.cuh).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int grad_sumsq_launch(const long long* meta, int n_tensors,
                                 long long n_chunks, int n_groups,
                                 const float* scale, int has_clip,
                                 float clip_norm, double* part, int* bad,
                                 float* out, int* flags, void* stream) {
  if (n_tensors < 1 || n_chunks < 0 || n_groups < 0 || n_chunks >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0)
    sumsq_partials<<<(unsigned)n_chunks, kThreads, 0, s>>>(
        meta, n_tensors, scale, part, bad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sumsq_finish<<<1, kFinishThreads, 0, s>>>(
      part, bad, meta + 3 * n_tensors, n_groups > 0 ? meta + 4 * n_tensors + 1
                                                    : nullptr,
      n_tensors, n_groups, has_clip, clip_norm, out, flags);
  return cudaGetLastError();
}
