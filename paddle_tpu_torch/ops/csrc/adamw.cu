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
// writes p, m, v once (14 bytes in bf16 or fp16); some 20 flops per
// element are far below the card's rate. The same kernel takes the
// training recipe's gradient unscale, clip and regularization in registers
// and f32 master weights: a bf16 or fp16 parameter with an f32 master, m
// and v reads g, master, m, v and writes master, m, v and p, 28 bytes an
// element; the f32 gradients those transforms make are never stored.
// Every instance is the same code over the element types: T (m and v; p
// without a master) f32, bf16 or fp16, G (the gradient) f32 or the
// parameter's 16-bit type, P (p beside a master) bf16 or fp16. In fp16 the
// scalars b1, 1 - b1, b2, 1 - b2 and factor round to fp16 as in bf16; eps
// stays f32, as in the reference, whose bias-corrected sqrt(v) is f32
// before eps is added.

#include "sumsq_common.cuh"

namespace {

using namespace ptt;

constexpr int kThreads = 256;

// One Adam step of one element in f32 registers: returns the new p before
// its rounding to T; m and v come in as stored and leave as the f32 sums
// mf and vf (rounded where the caller stores them).
template <typename T>
__device__ __forceinline__ float adam_step(float p, float gi, float& m,
                                           float& v, float b1, float c1,
                                           float b2, float c2, float factor,
                                           float lr, float bc1, float bc2,
                                           float eps) {
  const float mf = __fadd_rn(round_to<T>(__fmul_rn(m, b1)),
                             round_to<T>(__fmul_rn(gi, c1)));
  const float sq = round_to<T>(__fmul_rn(gi, gi));
  const float vf = __fadd_rn(round_to<T>(__fmul_rn(v, b2)),
                             round_to<T>(__fmul_rn(sq, c2)));
  m = mf;
  v = vf;
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vf, bc2)), eps);
  const float upd = __fdiv_rn(__fmul_rn(__fdiv_rn(mf, bc1), lr), den);
  return __fsub_rn(__fmul_rn(p, factor), upd);
}

// ---- gradient transform, master weights, dynamics -------------------------
//
// Per element, the reference step's rounding points (jit_api.py:328-366,
// optimizer.py:161-198), with G the gradient's type and T the type of the
// updated weight `base` (the f32 master where there is one, else p):
//   x = g / scale          f32, given a scale (the loss scaler's unscale)
//   x = x * factor         f32, given a clip factor; then rounded to G when
//                          no scale made it f32 ((g.f32 * f).astype(g.dtype))
//   x = round_to<T>(x)     g.astype(base.dtype)
//   x = x + coeff * base   L2 (reg 1) or coeff * sign(base) (reg 2), each
//                          product and the sum rounded to T
// then adam_step in T's rounding points; a master instance stores the f32
// master and its rounding to P (bf16 or fp16) into p. The scale and the factor
// are read from device memory, so the host never waits for the clip or the
// scaler.
// With kDyn each block also sums p_old^2 and (p_new - p_old)^2 over the
// stored p (the dynamics' param_sq and upd_sq, dynamics.py:239-242) in f64
// and writes one partial of each: part[b] and part[part_stride + b]; grid ==
// n_part blocks. No copy of the old parameter is made.

struct Scalars {
  float b1, c1, b2, c2, factor, lr, bc1, bc2, eps;
};

struct GradIn {
  const float* scale;
  const float* factor;
  int reg;
  float reg_coeff;   // rounded to T by the wrapper
};

template <typename X>
__device__ __forceinline__ void load8(const X* __restrict__ p, long long i,
                                      float (&o)[8]) {
  if constexpr (sizeof(X) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + i);
    const X* e = reinterpret_cast<const X*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = to_float(e[k]);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i + 4 * h);
      const X* e = reinterpret_cast<const X*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) o[4 * h + k] = to_float(e[k]);
    }
  }
}

template <typename X>
__device__ __forceinline__ void store8(X* __restrict__ p, long long i,
                                       const float (&v)[8]) {
  if constexpr (sizeof(X) == 2) {
    uint4 u;
    X* e = reinterpret_cast<X*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = from_float<X>(v[k]);
    *reinterpret_cast<uint4*>(p + i) = u;
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 u;
      X* e = reinterpret_cast<X*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] = from_float<X>(v[4 * h + k]);
      *reinterpret_cast<uint4*>(p + i + 4 * h) = u;
    }
  }
}

template <typename T, typename G>
__device__ __forceinline__ float grad_in(float x, const Unscale& u,
                                         const float* factor, float f,
                                         const GradIn& gin, float base) {
  x = u(x);
  if (factor != nullptr) x = __fmul_rn(x, f);
  if (!u.on) x = round_to<G>(x);
  x = round_to<T>(x);
  if (gin.reg == 1) {
    x = round_to<T>(__fadd_rn(x, round_to<T>(__fmul_rn(gin.reg_coeff, base))));
  } else if (gin.reg == 2) {
    const float sg = base > 0.f ? 1.f : base < 0.f ? -1.f : base;
    x = round_to<T>(__fadd_rn(x, round_to<T>(__fmul_rn(gin.reg_coeff, sg))));
  }
  return x;
}

// One element of the update: the new weight, before its rounding.
template <typename T, typename G>
__device__ __forceinline__ float ex_element(float base, float gv, float& mv,
                                            float& vv, const Scalars& s,
                                            const Unscale& u, float f,
                                            const GradIn& gin) {
  const float gi = grad_in<T, G>(gv, u, gin.factor, f, gin, base);
  return adam_step<T>(base, gi, mv, vv, s.b1, s.c1, s.b2, s.c2, s.factor,
                      s.lr, s.bc1, s.bc2, s.eps);
}

// kMaster: p is P beside an f32 master (T f32); else p is T.
template <typename T, typename G, typename PM, bool kMaster, bool kDyn>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(void* __restrict__ p_, const G* __restrict__ g,
                    T* __restrict__ m, T* __restrict__ v,
                    float* __restrict__ master, long long n, Scalars s,
                    GradIn gin, double* __restrict__ part,
                    long long part_stride) {
  using P = std::conditional_t<kMaster, PM, T>;
  P* p = static_cast<P*>(p_);
  const Unscale u(gin.scale);
  const float f = gin.factor != nullptr ? *gin.factor : 1.f;
  double psq = 0.0, usq = 0.0;
  const long long n8 = n / 8;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j = blockIdx.x * (long long)kThreads + threadIdx.x; j < n8;
       j += stride) {
    const long long i = 8 * j;
    float pv[8], gv[8], mv[8], vv[8], bv[8], pn[8];
    load8(p, i, pv);
    load8(g, i, gv);
    load8(m, i, mv);
    load8(v, i, vv);
    if constexpr (kMaster) {
      load8(master, i, bv);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) bv[k] = pv[k];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      bv[k] = ex_element<T, G>(bv[k], gv[k], mv[k], vv[k], s, u, f, gin);
      pn[k] = round_to<P>(bv[k]);
    }
    store8(m, i, mv);
    store8(v, i, vv);
    if constexpr (kMaster) store8(master, i, bv);
    store8(p, i, pn);
    if constexpr (kDyn) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = __fsub_rn(pn[k], pv[k]);
        psq += (double)__fmul_rn(pv[k], pv[k]);
        usq += (double)__fmul_rn(d, d);
      }
    }
  }
  for (long long i = 8 * n8 + blockIdx.x * (long long)kThreads + threadIdx.x;
       i < n; i += stride) {
    const float po = to_float(p[i]);
    float mv = to_float(m[i]), vv = to_float(v[i]);
    const float nb = ex_element<T, G>(kMaster ? master[i] : po,
                                      to_float(g[i]), mv, vv, s, u, f, gin);
    const float pn = round_to<P>(nb);
    m[i] = from_float<T>(mv);
    v[i] = from_float<T>(vv);
    if constexpr (kMaster) master[i] = nb;
    p[i] = from_float<P>(pn);
    if constexpr (kDyn) {
      const float d = __fsub_rn(pn, po);
      psq += (double)__fmul_rn(po, po);
      usq += (double)__fmul_rn(d, d);
    }
  }
  if constexpr (kDyn) {
    __shared__ double sh[kThreads / 32];
    const double a = block_sum<kThreads>(psq, sh);
    const double b = block_sum<kThreads>(usq, sh);
    if (threadIdx.x == 0) {
      part[blockIdx.x] = a;
      part[part_stride + blockIdx.x] = b;
    }
  }
}

template <typename T, typename G, typename PM, bool kMaster>
cudaError_t launch(void* p, const void* g, void* m, void* v, float* master,
                   long long n, const Scalars& s, const GradIn& gin,
                   double* part, int n_part, long long stride,
                   cudaStream_t stream) {
  int blocks = n_part;
  if (part == nullptr) {
    const long long want = (n / 8 + 1 + kThreads - 1) / kThreads;
    blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  }
  if (part != nullptr)
    adamw_kernel<T, G, PM, kMaster, true><<<blocks, kThreads, 0, stream>>>(
        p, static_cast<const G*>(g), static_cast<T*>(m), static_cast<T*>(v),
        master, n, s, gin, part, stride);
  else
    adamw_kernel<T, G, PM, kMaster, false><<<blocks, kThreads, 0, stream>>>(
        p, static_cast<const G*>(g), static_cast<T*>(m), static_cast<T*>(v),
        master, n, s, gin, part, stride);
  return cudaGetLastError();
}

// The instance for the gradient's type g_dtype (T, PM and kMaster fixed):
// f32, or the parameter's 16-bit type (P beside a master; bf16 beside an
// f32 parameter).
template <typename T, typename PM, bool kMaster>
cudaError_t launch_gt(int g_dtype, void* p, const void* g, void* m, void* v,
                      float* master, long long n, const Scalars& s,
                      const GradIn& gin, double* part, int n_part,
                      long long stride, cudaStream_t stream) {
  using G16 = std::conditional_t<
      kMaster, PM,
      std::conditional_t<std::is_same_v<T, float>, __nv_bfloat16, T>>;
  constexpr int kG16 = std::is_same_v<G16, __half> ? kFloat16 : kBFloat16;
  if (g_dtype == kG16)
    return launch<T, G16, PM, kMaster>(p, g, m, v, master, n, s, gin, part,
                                       n_part, stride, stream);
  if (g_dtype == kFloat32)
    return launch<T, float, PM, kMaster>(p, g, m, v, master, n, s, gin, part,
                                         n_part, stride, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_g(int g_dtype, int p_dtype, void* p, const void* g,
                     void* m, void* v, float* master, long long n,
                     const Scalars& s, const GradIn& gin, double* part,
                     int n_part, long long stride, cudaStream_t stream) {
  if (master != nullptr) {
    if constexpr (std::is_same_v<T, float>) {
      if (p_dtype == kBFloat16)
        return launch_gt<float, __nv_bfloat16, true>(
            g_dtype, p, g, m, v, master, n, s, gin, part, n_part, stride,
            stream);
      if (p_dtype == kFloat16)
        return launch_gt<float, __half, true>(g_dtype, p, g, m, v, master, n,
                                              s, gin, part, n_part, stride,
                                              stream);
    }
    return cudaErrorInvalidValue;
  }
  return launch_gt<T, T, false>(g_dtype, p, g, m, v, master, n, s, gin, part,
                                n_part, stride, stream);
}

}  // namespace

// Plain C entry for ctypes. dtype: m and v's type (0 f32, 1 bf16, 2 fp16; p's
// too, without a master); a master instance takes an f32 master, m and v and a
// bf16 or fp16 p (p_dtype); p, m, v and the master are updated in place.
// g_dtype: the gradient's type (0, 1 or 2). scale, factor: device f32 or null.
// reg: 0 none, 1 L2, 2 L1, reg_coeff rounded to the moments' type. part: the
// dynamics epilogue's n_part f64 partials of p_old^2 at part and of (p_new -
// p_old)^2 at part + stride, or null (then the grid is sized by n alone).
// Every pointer 16-byte aligned, n elements each. Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int adamw_update_launch(
    void* p, const void* g, void* m, void* v, float* master, long long n,
    float b1, float c1, float b2, float c2, float factor, float lr, float bc1,
    float bc2, float eps, int dtype, int g_dtype, int p_dtype,
    const float* scale,
    const float* gfactor, int reg, float reg_coeff, double* part, int n_part,
    long long stride, void* stream) {
  if (n < 1 || (part != nullptr && n_part < 1)) return cudaErrorInvalidValue;
  const Scalars s{b1, c1, b2, c2, factor, lr, bc1, bc2, eps};
  const GradIn gin{scale, gfactor, reg, reg_coeff};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_g<float>(g_dtype, p_dtype, p, g, m, v, master, n, s, gin,
                           part, n_part, stride, st);
  if (dtype == kBFloat16)
    return launch_g<__nv_bfloat16>(g_dtype, p_dtype, p, g, m, v, master, n, s,
                                   gin, part, n_part, stride, st);
  if (dtype == kFloat16)
    return launch_g<__half>(g_dtype, p_dtype, p, g, m, v, master, n, s, gin,
                            part, n_part, stride, st);
  return cudaErrorInvalidValue;
}

// The dynamics partials of one step's updates reduced in a fixed order
// (sumsq_finish, twice): `meta` is the device table starts[n + 1] |
// group[n], `part` 2 * n_part f64 partials, `out` 2 * (n + n_groups + 3)
// floats: p_old^2 then (p_new - p_old)^2, per tensor and group.
extern "C" int adamw_dynamics_reduce_launch(const long long* meta,
                                            int n_tensors, long long n_part,
                                            int n_groups, const double* part,
                                            float* out, void* stream) {
  if (n_tensors < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long width = n_tensors + n_groups + 3;
  for (int q = 0; q < 2; ++q)
    sumsq_finish<<<1, kFinishThreads, 0, st>>>(
        part + q * n_part, nullptr, meta,
        n_groups > 0 ? meta + n_tensors + 1 : nullptr, n_tensors, n_groups, 0,
        0.f, out + q * width, nullptr);
  return cudaGetLastError();
}
