// The Adam / AdamW update of one parameter, in place, in one pass.
//
// Replaces: the update rule of paddle_tpu/optimizer/optimizers.py
// (Adam._rule :51-62, AdamW._rule :86-89) as the reference's compiled
// TrainStep runs it: XLA fuses the whole rule into one elementwise program.
// It is no Pallas kernel; the port writes it by hand because the same rule
// as separate PyTorch operations makes some twenty passes over every
// parameter, the largest cost of a LLaMA-2-7B step after the products.
//
// Per element, with T the parameter's type and round() a rounding to T:
//   mf = round(m * b1) + round(g * (1 - b1))          (f32 sum)
//   vf = round(v * b2) + round(round(g * g) * (1 - b2))
//   m = round(mf), v = round(vf)
//   p = round(p * factor - lr * (mf / bc1) / (sqrt(vf / bc2) + eps))
// The scalars b1, 1 - b1, b2, 1 - b2 and factor come already rounded to T,
// as the reference's Python scalars are in a product with a T array; bc1
// and bc2 are the f32 bias corrections. Those are the rounding points of
// the reference's compiled step (each product in T, the sums and the rest
// in f32). Separate f32 operations (__fmul_rn, __fadd_rn, ...) keep nvcc
// from contracting a product and a sum into one FMA, which would round
// once where the reference rounds twice.
// What bounds it on the H100: bytes. Each element reads p, g, m, v and
// writes p, m, v once (14 bytes in bf16); some 20 flops per element are
// far below the card's rate.

#include "attention_common.cuh"

namespace {

using namespace ptt;

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void update(T& p, float gi, T& m, T& v, float b1,
                                       float c1, float b2, float c2,
                                       float factor, float lr, float bc1,
                                       float bc2, float eps) {
  const float mf = __fadd_rn(round_to<T>(__fmul_rn(to_float(m), b1)),
                             round_to<T>(__fmul_rn(gi, c1)));
  const float sq = round_to<T>(__fmul_rn(gi, gi));
  const float vf = __fadd_rn(round_to<T>(__fmul_rn(to_float(v), b2)),
                             round_to<T>(__fmul_rn(sq, c2)));
  m = from_float<T>(mf);
  v = from_float<T>(vf);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vf, bc2)), eps);
  const float upd = __fdiv_rn(__fmul_rn(__fdiv_rn(mf, bc1), lr), den);
  p = from_float<T>(__fsub_rn(__fmul_rn(to_float(p), factor), upd));
}

// Each thread takes 16-byte vectors of kVec elements (8 bf16, 4 f32) of
// p, g, m and v; the last n % kVec elements go one by one.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(T* __restrict__ p, const T* __restrict__ g,
                 T* __restrict__ m, T* __restrict__ v, long long n, float b1,
                 float c1, float b2, float c2, float factor, float lr,
                 float bc1, float bc2, float eps) {
  constexpr int kVec = 16 / int(sizeof(T));
  const long long n_vec = n / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    uint4 pu = reinterpret_cast<const uint4*>(p)[i];
    const uint4 gu = reinterpret_cast<const uint4*>(g)[i];
    uint4 mu = reinterpret_cast<const uint4*>(m)[i];
    uint4 vu = reinterpret_cast<const uint4*>(v)[i];
    T* pe = reinterpret_cast<T*>(&pu);
    const T* ge = reinterpret_cast<const T*>(&gu);
    T* me = reinterpret_cast<T*>(&mu);
    T* ve = reinterpret_cast<T*>(&vu);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      update<T>(pe[e], to_float(ge[e]), me[e], ve[e], b1, c1, b2, c2, factor,
                lr, bc1, bc2, eps);
    reinterpret_cast<uint4*>(p)[i] = pu;
    reinterpret_cast<uint4*>(m)[i] = mu;
    reinterpret_cast<uint4*>(v)[i] = vu;
  }
  for (long long i = n_vec * kVec + blockIdx.x * (long long)kThreads +
                     threadIdx.x;
       i < n; i += stride)
    update<T>(p[i], to_float(g[i]), m[i], v[i], b1, c1, b2, c2, factor, lr,
              bc1, bc2, eps);
}

template <typename T>
cudaError_t launch(void* p, const void* g, void* m, void* v, long long n,
                   float b1, float c1, float b2, float c2, float factor,
                   float lr, float bc1, float bc2, float eps,
                   cudaStream_t stream) {
  const long long vecs = n / (16 / (long long)sizeof(T)) + 1;
  const long long want = (vecs + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  adamw_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<T*>(m),
      static_cast<T*>(v), n, b1, c1, b2, c2, factor, lr, bc1, bc2, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. p, g, m, v: n contiguous elements of one dtype
// (0 f32, 1 bf16) on one device, 16-byte aligned; p, m and v are updated in
// place. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int adamw_update_launch(void* p, const void* g, void* m, void* v,
                                   long long n, float b1, float c1, float b2,
                                   float c2, float factor, float lr,
                                   float bc1, float bc2, float eps, int dtype,
                                   void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(p, g, m, v, n, b1, c1, b2, c2, factor, lr, bc1, bc2,
                         eps, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(p, g, m, v, n, b1, c1, b2, c2, factor, lr,
                                 bc1, bc2, eps, s);
  return cudaErrorInvalidValue;
}
