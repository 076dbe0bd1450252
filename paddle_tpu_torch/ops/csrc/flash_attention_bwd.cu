// K1/K2/K3 backward: flash attention gradients, hand-written for Hopper
// (sm_90a).
//
// Replaces: the backward half of paddle_tpu/ops/flash_attention.py::
// _get_pallas_impl (jax's Pallas TPU flash attention custom VJP: dq, dk, dv),
// of ::_splash_impl / _splash_kernel (GQA, kv heads unexpanded) and, with
// segment ids, of ::_splash_varlen and ::flash_attention_packed (K3).
//
// Given q, k, v (paddle layout [B, S, H, D]), the forward's out and f32
// lse [B, Hq, Sq], and dout, with P = exp(scale * Q K^T - lse) under the
// forward's mask:
//   delta = rowsum(dout * out)                      (f32, [B, Hq, Sq])
//   dS    = P * (dout V^T - delta)
//   dV    = P^T dout,   dK = scale * dS^T Q,   dQ = scale * dS K
// Three entries:
// 1. delta: one warp per (batch, row, head), a fused multiply and sum.
// 2. dK/dV: one block per (64-key tile, kv head, batch). It loops over the
//    `group` query heads of its kv head and, for each, over the query tiles
//    that can see its keys (K1/K2: on or below the diagonal; K3: the range
//    its key tile's segments reach, from a table built outside the kernel),
//    recomputing P from Q, K and the lse. dV and dK accumulate in registers
//    across all of them, so the GQA sum over the group happens inside the
//    block: no atomics, deterministic results.
// 3. dQ: one block per (64-row query tile, query head, batch), looping over
//    the key tiles up to its causal limit (K3: over its key-tile range); dQ
//    accumulates in registers.
// K3's mask (same segment and, under a causal mask, pos_q >= pos_k) is the
// forward's, from per-token ids staged in shared memory beside the tiles;
// a query row that saw no key has lse -inf and no visible entry, so P and
// dS are 0 there.
// P is written over S and dS over dP row by row, which keeps both gradient
// kernels at 107 KB of shared memory (K3: 108 KB), so two blocks share an
// SM. P and dS are rounded to the input type before their products, as the
// TPU kernel rounds them; every sum is f32.
// What bounds it on the H100: the products (about 2.5x the forward's, per
// visible pair) against 989 TFLOP/s bf16. Recomputing S in both the dK/dV
// and the dQ pass costs one extra Q K^T product over a design with atomic
// dQ, in exchange for deterministic sums.

#include "flash_common.cuh"

namespace {

using namespace ptt;
using namespace ptt::flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ out,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, int n_rows, int sq,
                           int hq) {
  constexpr int EPL = D / 32;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  float o[EPL];
  float g[EPL];
  load_row<T, EPL>(out + (size_t)row * D + lane * EPL, o);
  load_row<T, EPL>(dout + (size_t)row * D + lane * EPL, g);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) s = fmaf(o[e], g[e], s);
  s = warp_sum(s);
  if (lane == 0) {
    // row enumerates (b, i, h) in memory order of [B, Sq, Hq]
    const int h = row % hq;
    const int i = (row / hq) % sq;
    const int b = row / hq / sq;
    delta[((size_t)b * hq + h) * sq + i] = s;
  }
}

template <typename T, int D>
struct BwdSmem {
  static constexpr int kPD = D + kPad;
  static constexpr int kPS = kBc + kPad;
  static constexpr size_t kTile = aligned(sizeof(T) * kBr * kPD);
  static constexpr size_t kS = aligned(sizeof(float) * kBr * kPS);
  static constexpr size_t kRow = aligned(sizeof(float) * kBr);
  // Ss and dPs are adjacent: together they hold one f32 [64, D + kPad] tile
  // for the epilogue
  static_assert(2 * kS >= sizeof(float) * kBr * kPD, "epilogue scratch");
  // P overwrites S and dS overwrites dP row by row: row r of P or dS (in
  // T) starts where row r of S or dP (f32) starts
  static constexpr int kPP = kPS * int(sizeof(float) / sizeof(T));
  // bf16, D = 128: 107 KB, so two blocks share an SM
  static constexpr size_t kBytes = 4 * kTile + 2 * kS + 2 * kRow;
};

// Shared layout of both gradient kernels: four D-wide tiles (Q, dO, K, V),
// the f32 score and dP tiles (later P and dS in T), and the tile rows' lse
// and delta.
template <typename T, int D>
struct BwdTiles {
  T* Qs;
  T* dOs;
  T* Ks;
  T* Vs;
  float* Ss;
  float* dPs;
  float* lse_s;
  float* delta_s;

  __device__ explicit BwdTiles(unsigned char* p) {
    using L = BwdSmem<T, D>;
    Qs = reinterpret_cast<T*>(carve(p, L::kTile));
    dOs = reinterpret_cast<T*>(carve(p, L::kTile));
    Ks = reinterpret_cast<T*>(carve(p, L::kTile));
    Vs = reinterpret_cast<T*>(carve(p, L::kTile));
    Ss = reinterpret_cast<float*>(carve(p, L::kS));
    dPs = reinterpret_cast<float*>(carve(p, L::kS));
    lse_s = reinterpret_cast<float*>(carve(p, L::kRow));
    delta_s = reinterpret_cast<float*>(carve(p, L::kRow));
  }

  // S = Q K^T and dP = dO V^T for the staged tiles, into Ss and dPs.
  __device__ void scores() {
    using L = BwdSmem<T, D>;
    Acc<T, kBr, kBc> s;
    s.zero();
    s.template mma<false, true, D>(Qs, L::kPD, Ks, L::kPD);
    s.store(Ss, L::kPS);
    Acc<T, kBr, kBc> dp;
    dp.zero();
    dp.template mma<false, true, D>(dOs, L::kPD, Vs, L::kPD);
    dp.store(dPs, L::kPS);
  }

  // P = exp(scale * S - lse) under the mask and dS = P * (dP - delta), for
  // query rows i0.. and keys j0.., in T: P written over S and dS over dP
  // row by row (one warp owns a row and reads it whole before writing).
  // Returns the row pitch of P and dS in T elements.
  template <bool SEG>
  __device__ int probs_and_dscores(const Mask<SEG>& mask, int i0, int j0,
                                   float scale) {
    using L = BwdSmem<T, D>;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int r = warp; r < kBr; r += kWarps) {
      float pv[kBc / 32];
      float ds[kBc / 32];
#pragma unroll
      for (int c = 0; c < kBc / 32; ++c) {
        const int col = lane + 32 * c;
        pv[c] = mask(i0, r, j0, col)
                    ? __expf(Ss[r * L::kPS + col] * scale - lse_s[r])
                    : 0.f;
        ds[c] = pv[c] * (dPs[r * L::kPS + col] - delta_s[r]);
      }
      __syncwarp();
      T* p_row = reinterpret_cast<T*>(Ss + r * L::kPS);
      T* ds_row = reinterpret_cast<T*>(dPs + r * L::kPS);
#pragma unroll
      for (int c = 0; c < kBc / 32; ++c) {
        p_row[lane + 32 * c] = from_float<T>(pv[c]);
        ds_row[lane + 32 * c] = from_float<T>(ds[c]);
      }
    }
    return L::kPP;
  }

  // Stage a query tile of one head: Q, dO, and the rows' lse and delta.
  __device__ void load_query(const T* qb, const T* dob, const float* lse_h,
                             const float* delta_h, int i0, int sq,
                             size_t q_stride) {
    load_tiles<T, D, kBr>(Qs, qb, dOs, dob, i0, sq, q_stride);
    for (int r = threadIdx.x; r < kBr; r += kThreads) {
      const bool ok = i0 + r < sq;
      lse_s[r] = ok ? lse_h[i0 + r] : 0.f;
      delta_s[r] = ok ? delta_h[i0 + r] : 0.f;
    }
  }
};

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int sq, int sk, int hq,
                          int group, bool causal, float scale,
                          Segments segs) {
  using L = BwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdTiles<T, D> t(smem_raw);
  SegTile* ids =
      SEG ? reinterpret_cast<SegTile*>(smem_raw + L::kBytes) : nullptr;
  const Mask<SEG> mask{ids, sq, sk, causal};

  const int j0 = blockIdx.x * kBc;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = gridDim.y;
  const size_t q_stride = (size_t)hq * D;
  const size_t k_stride = (size_t)hkv * D;
  const size_t kv_off = ((size_t)b * sk * hkv + hk) * D;
  load_tiles<T, D, kBc>(t.Ks, k + kv_off, t.Vs, v + kv_off, j0, sk,
                        k_stride);
  // the query tiles [t_lo, t_hi) that can see this key tile
  const int n_qt = (sq + kBr - 1) / kBr;
  int t_lo;
  int t_hi = n_qt;
  if constexpr (SEG) {
    load_ids<kBc>(ids->seg_k, ids->pos_k, segs.seg_k + (size_t)b * sk,
                  segs.pos_k + (size_t)b * sk, j0, sk);
    const int2 rg = tile_range(segs.ranges, b, gridDim.x, blockIdx.x, n_qt);
    t_lo = rg.x;
    t_hi = rg.y;
  } else {
    // the first query row that sees key j0 under the causal mask
    t_lo = (causal ? max(0, j0 - (sk - sq)) : 0) / kBr;
  }

  Acc<T, kBc, D> dk_acc;
  Acc<T, kBc, D> dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t q_off = ((size_t)b * sq * hq + h) * D;
    const size_t row_off = ((size_t)b * hq + h) * sq;
    for (int it = t_lo; it < t_hi; ++it) {
      const int i0 = it * kBr;
      __syncthreads();  // the previous tile is consumed
      t.load_query(q + q_off, dout + q_off, lse + row_off, delta + row_off,
                   i0, sq, q_stride);
      if constexpr (SEG)
        load_ids<kBr>(ids->seg_q, ids->pos_q, segs.seg_q + (size_t)b * sq,
                      segs.pos_q + (size_t)b * sq, i0, sq);
      __syncthreads();
      t.scores();
      __syncthreads();
      const int pitch = t.probs_and_dscores(mask, i0, j0, scale);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q: A = P^T (dS^T) is P (dS) read
      // column-major
      dv_acc.template mma<true, false, kBr>(
          reinterpret_cast<const T*>(t.Ss), pitch, t.dOs, L::kPD);
      dk_acc.template mma<true, false, kBr>(
          reinterpret_cast<const T*>(t.dPs), pitch, t.Qs, L::kPD);
    }
  }
  dk_acc.scale(scale);
  float* scratch = t.Ss;  // Ss and dPs: one f32 [kBc, D + kPad] tile
  __syncthreads();
  dk_acc.store(scratch, L::kPD);
  __syncthreads();
  store_tile<T, D, kBc>(dk + kv_off, scratch, j0, sk, k_stride);
  __syncthreads();
  dv_acc.store(scratch, L::kPD);
  __syncthreads();
  store_tile<T, D, kBc>(dv + kv_off, scratch, j0, sk, k_stride);
}

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int sq, int sk, int group, bool causal, float scale,
                        Segments segs) {
  using L = BwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdTiles<T, D> t(smem_raw);
  SegTile* ids =
      SEG ? reinterpret_cast<SegTile*>(smem_raw + L::kBytes) : nullptr;
  const Mask<SEG> mask{ids, sq, sk, causal};

  const int i0 = blockIdx.x * kBr;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = gridDim.y;
  const int hkv = hq / group;
  const int hk = h / group;
  const size_t q_stride = (size_t)hq * D;
  const size_t k_stride = (size_t)hkv * D;
  const size_t q_off = ((size_t)b * sq * hq + h) * D;
  const size_t kv_off = ((size_t)b * sk * hkv + hk) * D;
  const size_t row_off = ((size_t)b * hq + h) * sq;
  t.load_query(q + q_off, dout + q_off, lse + row_off, delta + row_off, i0,
               sq, q_stride);
  // the key tiles [t_lo, t_hi) this query tile sees
  int t_lo = 0;
  int t_hi;
  if constexpr (SEG) {
    load_ids<kBr>(ids->seg_q, ids->pos_q, segs.seg_q + (size_t)b * sq,
                  segs.pos_q + (size_t)b * sq, i0, sq);
    const int2 rg = tile_range(segs.ranges, b, gridDim.x, blockIdx.x,
                               (sk + kBc - 1) / kBc);
    t_lo = rg.x;
    t_hi = rg.y;
  } else {
    const int last_row = min(i0 + kBr, sq) - 1;
    const int n_keys = causal ? min(sk, last_row + (sk - sq) + 1) : sk;
    t_hi = (n_keys + kBc - 1) / kBc;
  }

  Acc<T, kBr, D> dq_acc;
  dq_acc.zero();
  for (int jt = t_lo; jt < t_hi; ++jt) {
    const int j0 = jt * kBc;
    __syncthreads();  // the previous K, V, dS and ids are consumed
    load_tiles<T, D, kBc>(t.Ks, k + kv_off, t.Vs, v + kv_off, j0, sk,
                          k_stride);
    if constexpr (SEG)
      load_ids<kBc>(ids->seg_k, ids->pos_k, segs.seg_k + (size_t)b * sk,
                    segs.pos_k + (size_t)b * sk, j0, sk);
    __syncthreads();
    t.scores();
    __syncthreads();
    const int ds_pitch = t.probs_and_dscores(mask, i0, j0, scale);
    __syncthreads();
    // dQ += dS K
    dq_acc.template mma<false, false, kBc>(
        reinterpret_cast<const T*>(t.dPs), ds_pitch, t.Ks, L::kPD);
  }
  dq_acc.scale(scale);
  float* scratch = t.Ss;
  __syncthreads();
  dq_acc.store(scratch, L::kPD);
  __syncthreads();
  store_tile<T, D, kBr>(dq + q_off, scratch, i0, sq, q_stride);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch_delta(const void* out, const void* dout, void* delta,
                         int batch, int sq, int hq, cudaStream_t stream) {
  const int n_rows = batch * sq * hq;
  flash_bwd_delta_kernel<T, D><<<(n_rows + kWarps - 1) / kWarps, kThreads, 0,
                                 stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(delta), n_rows, sq, hq);
  return cudaGetLastError();
}

template <typename T, int D, bool SEG>
constexpr size_t grad_smem() {
  return BwdSmem<T, D>::kBytes + (SEG ? aligned(sizeof(SegTile)) : 0);
}

template <typename T, int D, bool SEG>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int batch, int sq, int sk, int hq,
                        int hkv, int causal, float scale, Segments segs,
                        cudaStream_t stream) {
  const size_t smem = grad_smem<T, D, SEG>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T, D, SEG>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + kBc - 1) / kBc, hkv, batch);
  flash_bwd_dkdv_kernel<T, D, SEG><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, hq, hq / hkv,
      causal != 0, scale, segs);
  return cudaGetLastError();
}

template <typename T, int D, bool SEG>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int batch, int sq, int sk, int hq, int hkv,
                      int causal, float scale, Segments segs,
                      cudaStream_t stream) {
  const size_t smem = grad_smem<T, D, SEG>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D, SEG>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBr - 1) / kBr, hq, batch);
  flash_bwd_dq_kernel<T, D, SEG><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), sq, sk, hq / hkv, causal != 0, scale, segs);
  return cudaGetLastError();
}

// Dispatch on (dtype, head_dim) to F<T, D>::run(args...).
template <template <typename, int> class F, typename... Args>
cudaError_t dispatch(int dtype, int head_dim, Args... args) {
  if (dtype == kFloat32) {
    if (head_dim == 64) return F<float, 64>::run(args...);
    if (head_dim == 128) return F<float, 128>::run(args...);
  } else if (dtype == kBFloat16) {
    if (head_dim == 64) return F<__nv_bfloat16, 64>::run(args...);
    if (head_dim == 128) return F<__nv_bfloat16, 128>::run(args...);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int D>
struct Delta {
  template <typename... Args>
  static cudaError_t run(Args... args) {
    return launch_delta<T, D>(args...);
  }
};
template <typename T, int D>
struct DkDv {
  template <typename... Args>
  static cudaError_t run(Args... args) {
    return launch_dkdv<T, D, false>(args...);
  }
};
template <typename T, int D>
struct Dq {
  template <typename... Args>
  static cudaError_t run(Args... args) {
    return launch_dq<T, D, false>(args...);
  }
};
template <typename T, int D>
struct SegDkDv {
  template <typename... Args>
  static cudaError_t run(Args... args) {
    return launch_dkdv<T, D, true>(args...);
  }
};
template <typename T, int D>
struct SegDq {
  template <typename... Args>
  static cudaError_t run(Args... args) {
    return launch_dq<T, D, true>(args...);
  }
};

// K1/K2's causal rule needs sq <= sk; K3's is per segment (causal 0 here).
bool bad_shape(int sq, int sk, int hq, int hkv, int causal) {
  return hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 ||
         (causal && sq > sk);
}

Segments segments(const void* seg_q, const void* pos_q, const void* seg_k,
                  const void* pos_k, const void* ranges) {
  return Segments{static_cast<const int*>(seg_q),
                  static_cast<const int*>(pos_q),
                  static_cast<const int*>(seg_k),
                  static_cast<const int*>(pos_k),
                  static_cast<const int*>(ranges)};
}

}  // namespace

// Plain C entries for ctypes. Layouts as flash_attention_fwd_launch: q,
// out, dout, dq [batch, seq_q, num_q_heads, head_dim]; k, v, dk, dv
// [batch, seq_k, num_kv_heads, head_dim]; lse and delta [batch,
// num_q_heads, seq_q] f32; contiguous, 16-byte aligned, one dtype (0 f32,
// 1 bf16) for the tensors in the paddle layout. Each launches on `stream`,
// allocates nothing and returns cudaGetLastError().

// delta = rowsum(dout * out) in f32.
extern "C" int flash_attention_bwd_delta_launch(const void* out,
                                                const void* dout, void* delta,
                                                int batch, int seq_q,
                                                int num_q_heads, int head_dim,
                                                int dtype, void* stream) {
  if (batch < 1 || seq_q < 1 || num_q_heads < 1) return cudaErrorInvalidValue;
  return dispatch<Delta>(dtype, head_dim, out, dout, delta, batch, seq_q,
                         num_q_heads, static_cast<cudaStream_t>(stream));
}

// dk, dv from the forward's lse and the delta pass.
extern "C" int flash_attention_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int seq_q, int seq_k, int num_q_heads, int num_kv_heads, int head_dim,
    int causal, float scale, int dtype, void* stream) {
  if (bad_shape(seq_q, seq_k, num_q_heads, num_kv_heads, causal))
    return cudaErrorInvalidValue;
  return dispatch<DkDv>(dtype, head_dim, q, k, v, dout, lse, delta, dk, dv,
                        batch, seq_q, seq_k, num_q_heads, num_kv_heads,
                        causal, scale, ptt::flash::Segments{},
                        static_cast<cudaStream_t>(stream));
}

// dq from the forward's lse and the delta pass.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int seq_q,
    int seq_k, int num_q_heads, int num_kv_heads, int head_dim, int causal,
    float scale, int dtype, void* stream) {
  if (bad_shape(seq_q, seq_k, num_q_heads, num_kv_heads, causal))
    return cudaErrorInvalidValue;
  return dispatch<Dq>(dtype, head_dim, q, k, v, dout, lse, delta, dq, batch,
                      seq_q, seq_k, num_q_heads, num_kv_heads, causal, scale,
                      ptt::flash::Segments{},
                      static_cast<cudaStream_t>(stream));
}

// K3 entries (K3's delta is flash_attention_bwd_delta_launch). seg_q/pos_q
// [batch, seq_q] and seg_k/pos_k [batch, seq_k] int32, as
// flash_attention_seg_fwd_launch; any seq_q, seq_k.

// dk, dv; query_ranges [batch, ceil(seq_k / 64), 2] int32, the query tiles
// [lo, hi) that can see each 64-key tile.
extern "C" int flash_attention_seg_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* seg_q,
    const void* pos_q, const void* seg_k, const void* pos_k,
    const void* query_ranges, int batch, int seq_q, int seq_k,
    int num_q_heads, int num_kv_heads, int head_dim, int causal, float scale,
    int dtype, void* stream) {
  if (batch < 1 || bad_shape(seq_q, seq_k, num_q_heads, num_kv_heads, 0))
    return cudaErrorInvalidValue;
  return dispatch<SegDkDv>(
      dtype, head_dim, q, k, v, dout, lse, delta, dk, dv, batch, seq_q,
      seq_k, num_q_heads, num_kv_heads, causal, scale,
      segments(seg_q, pos_q, seg_k, pos_k, query_ranges),
      static_cast<cudaStream_t>(stream));
}

// dq; key_ranges [batch, ceil(seq_q / 64), 2] int32, as the forward's.
extern "C" int flash_attention_seg_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* seg_q,
    const void* pos_q, const void* seg_k, const void* pos_k,
    const void* key_ranges, int batch, int seq_q, int seq_k, int num_q_heads,
    int num_kv_heads, int head_dim, int causal, float scale, int dtype,
    void* stream) {
  if (batch < 1 || bad_shape(seq_q, seq_k, num_q_heads, num_kv_heads, 0))
    return cudaErrorInvalidValue;
  return dispatch<SegDq>(dtype, head_dim, q, k, v, dout, lse, delta, dq,
                         batch, seq_q, seq_k, num_q_heads, num_kv_heads,
                         causal, scale,
                         segments(seg_q, pos_q, seg_k, pos_k, key_ranges),
                         static_cast<cudaStream_t>(stream));
}
