// K1/K2 forward: flash attention, hand-written for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/flash_attention.py::_get_pallas_impl (jax's Pallas
// TPU flash attention, MHA) and ::_splash_impl / _splash_kernel (the splash
// kernel, GQA with kv heads left unexpanded), forward half.
//
// Computes, for q [B, Sq, Hq, D] and k, v [B, Sk, Hkv, D] (paddle layout,
// contiguous), out[b, i, h] = softmax_j(scale * q[b,i,h] . k[b,j,h/group])
// . v[b,j,h/group] with group = Hq / Hkv, f32 online softmax, and the
// row's log-sum-exp lse[b, h, i] = max + log(sum) of the scaled scores in
// f32 for the backward. A causal mask is bottom-right aligned: query i sees
// keys j <= i + Sk - Sq (the reference's tril(k = sk - sq)).
//
// Design: one block per (64-row query tile, query head, batch). Query head
// h reads kv head h / group, which is all GQA needs: no expanded K/V. The
// block stages its Q tile once, then walks the K/V tiles of 64 keys up to
// the causal limit of its last row (tiles wholly past the diagonal are
// skipped; the diagonal tile and the tails past Sq / Sk are masked):
//   S = Q K^T (tensor cores for bf16, f32 accumulation) -> shared f32,
//   per-row max / sum update and P = exp(S - m) rounded to the input type
//   (as the TPU kernel rounds p before its P.V product), written over S
//   row by row (one warp owns a row),
//   O = O * corr + P V with O held in registers (wmma accumulators; the
//   per-row factors come in through a row-broadcast tile), so shared memory
//   holds only the Q, K, V and score tiles (74 KB for bf16, D = 128).
// What bounds it on the H100: the products (4 * Sq * Sk * D per head, half
// of it under a causal mask) against 989 TFLOP/s bf16; the bytes of Q, K,
// V and O are far below. This design uses wmma fragments (each warp a row
// strip, one A fragment per k-step), 8 warps and synchronous tile loads
// (all of a K/V pair's loads in flight at once); wgmma, TMA and
// double-buffered tiles are later work.

#include "flash_common.cuh"

namespace {

using namespace ptt;
using namespace ptt::flash;

template <typename T, int D>
struct FwdSmem {
  static constexpr int kPD = D + kPad;    // pitch of a D-wide tile
  static constexpr int kPS = kBc + kPad;  // pitch of a score tile
  static constexpr size_t kQ = aligned(sizeof(T) * kBr * kPD);
  static constexpr size_t kKV = aligned(sizeof(T) * kBc * kPD);
  // P overwrites S row by row: row r of P (in T) starts where row r of S
  // (f32) starts, so its pitch in T elements is kPS * 4 / sizeof(T)
  static constexpr int kPP = kPS * int(sizeof(float) / sizeof(T));
  static constexpr size_t kS = aligned(sizeof(float) * kBr * kPS);
  static constexpr size_t kBcast = aligned(sizeof(float) * kBr * kBcastLd);
  static constexpr size_t kRow = aligned(sizeof(float) * kBr);
  // the K and V tiles (adjacent) stage the f32 output tile at the end
  static_assert(2 * kKV >= sizeof(float) * kBr * kPD, "output staging");
  // bf16, D = 128: 74 KB
  static constexpr size_t kBytes = kQ + 2 * kKV + kS + kBcast + 2 * kRow;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk, int group,
                     bool causal, float scale) {
  using L = FwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  T* Qs = reinterpret_cast<T*>(carve(p, L::kQ));
  T* Ks = reinterpret_cast<T*>(carve(p, L::kKV));
  T* Vs = reinterpret_cast<T*>(carve(p, L::kKV));
  float* Ss = reinterpret_cast<float*>(carve(p, L::kS));
  T* Ps = reinterpret_cast<T*>(Ss);
  float* Cs = reinterpret_cast<float*>(carve(p, L::kBcast));
  float* m_s = reinterpret_cast<float*>(carve(p, L::kRow));
  float* l_s = reinterpret_cast<float*>(carve(p, L::kRow));

  const int i0 = blockIdx.x * kBr;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = gridDim.y;
  const int hkv = hq / group;
  const int hk = h / group;
  const size_t q_stride = (size_t)hq * D;
  const size_t k_stride = (size_t)hkv * D;
  const T* qb = q + ((size_t)b * sq * hq + h) * D;
  const T* kb = k + ((size_t)b * sk * hkv + hk) * D;
  const T* vb = v + ((size_t)b * sk * hkv + hk) * D;

  load_tile<T, D, kBr>(Qs, qb, i0, sq, q_stride);
  for (int r = threadIdx.x; r < kBr; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  const int last_row = min(i0 + kBr, sq) - 1;
  const int n_keys = causal ? min(sk, last_row + (sk - sq) + 1) : sk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Acc<T, kBr, D> o;  // the output tile, in registers across all K/V tiles
  o.zero();

  for (int j0 = 0; j0 < n_keys; j0 += kBc) {
    __syncthreads();  // the previous tile's K, V, P and factors are consumed
    load_tiles<T, D, kBc>(Ks, kb, Vs, vb, j0, sk, k_stride);
    __syncthreads();
    {
      Acc<T, kBr, kBc> s;
      s.zero();
      s.template mma<false, true, D>(Qs, L::kPD, Ks, L::kPD);
      s.store(Ss, L::kPS);
    }
    __syncthreads();
    // online softmax: each warp owns kBr / kWarps rows, a lane two columns
    for (int r = warp; r < kBr; r += kWarps) {
      const int i = i0 + r;
      float sv[kBc / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kBc / 32; ++c) {
        const int col = lane + 32 * c;
        const float x = Ss[r * L::kPS + col] * scale;
        sv[c] = visible(i, j0 + col, sq, sk, causal) ? x : -INFINITY;
        mx = fmaxf(mx, sv[c]);
      }
      mx = warp_max(mx);  // every lane has read its S values of row r
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kBc / 32; ++c) {
        const float pv = sv[c] == -INFINITY ? 0.f : __expf(sv[c] - m_new);
        Ps[r * L::kPP + lane + 32 * c] = from_float<T>(pv);
        sum += pv;
      }
      sum = warp_sum(sum);  // every lane has read m_s[r]
      const float corr = m_old == -INFINITY ? 0.f : __expf(m_old - m_new);
      if (lane < kBcastLd) Cs[r * kBcastLd + lane] = corr;
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    o.scale_rows(Cs);
    o.template mma<false, false, kBc>(Ps, L::kPP, Vs, L::kPD);
  }
  __syncthreads();  // the last tile's P, V and factors are consumed
  for (int r = threadIdx.x; r < kBr; r += kThreads) {
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int c = 0; c < kBcastLd; ++c) Cs[r * kBcastLd + c] = inv;
    if (i0 + r < sq)
      lse[((size_t)b * hq + h) * sq + i0 + r] =
          l > 0.f ? m_s[r] + logf(l) : -INFINITY;
  }
  __syncthreads();
  o.scale_rows(Cs);
  float* stage = reinterpret_cast<float*>(Ks);  // K and V tiles, adjacent
  o.store(stage, L::kPD);
  __syncthreads();
  store_tile<T, D, kBr>(out + ((size_t)b * sq * hq + h) * D, stage, i0, sq,
                        q_stride);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int sq, int sk, int hq, int group,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = FwdSmem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBr - 1) / kBr, hq, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), sq, sk, group, causal != 0, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int head_dim, const void* q, const void* k,
                       const void* v, void* out, void* lse, int batch, int sq,
                       int sk, int hq, int group, int causal, float scale,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, batch, sq, sk, hq, group,
                           causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, batch, sq, sk, hq, group,
                            causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes. q/out [batch, seq_q, num_q_heads, head_dim] and
// k/v [batch, seq_k, num_kv_heads, head_dim], contiguous, one dtype (0 f32,
// 1 bf16), 16-byte aligned; lse [batch, num_q_heads, seq_q] f32. num_kv_heads
// must divide num_q_heads; a causal call needs seq_q <= seq_k (every query
// row sees at least one key). Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int batch, int seq_q, int seq_k,
                                          int num_q_heads, int num_kv_heads,
                                          int head_dim, int causal,
                                          float scale, int dtype,
                                          void* stream) {
  if (num_kv_heads < 1 || num_q_heads % num_kv_heads != 0 || seq_q < 1 ||
      seq_k < 1 || (causal && seq_q > seq_k))
    return cudaErrorInvalidValue;
  const int group = num_q_heads / num_kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_dim<float>(head_dim, q, k, v, out, lse, batch, seq_q, seq_k,
                             num_q_heads, group, causal, scale, s);
  if (dtype == ptt::kBFloat16)
    return launch_dim<__nv_bfloat16>(head_dim, q, k, v, out, lse, batch,
                                     seq_q, seq_k, num_q_heads, group, causal,
                                     scale, s);
  return cudaErrorInvalidValue;
}
