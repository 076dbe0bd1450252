// K1/K2/K3/K6 forward: flash attention, hand-written for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/flash_attention.py::_get_pallas_impl (jax's Pallas
// TPU flash attention, MHA), ::_splash_impl / _splash_kernel (the splash
// kernel, GQA with kv heads left unexpanded) and, with segment ids,
// ::_splash_varlen and ::flash_attention_packed (K3: the splash kernel with
// SegmentIds), forward half; and paddle_tpu/ops/ring_attention.py::
// _ring_kernel_fwd_impl (K6: one ring visit, the flash forward of the
// resident query shard over the visiting key shard with its residuals,
// merged into the running state by _online_merge).
//
// Computes, for q [B, Sq, Hq, D] and k, v [B, Sk, Hkv, D] (paddle layout,
// contiguous), out[b, i, h] = softmax_j(scale * q[b,i,h] . k[b,j,h/group])
// . v[b,j,h/group] over the keys j visible to i, with group = Hq / Hkv, f32
// online softmax, and the row's log-sum-exp lse[b, h, i] = max + log(sum)
// of the scaled scores in f32 for the backward. K1/K2: a causal mask is
// bottom-right aligned, query i sees keys j <= i + Sk - Sq (the reference's
// tril(k = sk - sq)). K3: key j is visible to query i when their segment ids
// are equal and, under a causal mask, pos_q[i] >= pos_k[j]; a row that sees
// no key writes 0 and lse -inf.
//
// Design: one block per (64-row query tile, query head, batch). Query head
// h reads kv head h / group, which is all GQA needs: no expanded K/V. The
// block stages its Q tile once, then walks the K/V tiles of 64 keys: K1/K2
// up to the causal limit of its last row (tiles wholly past the diagonal
// are skipped; the diagonal tile and the tails past Sq / Sk are masked),
// K3 over the key-tile range its query tile's segments can see (from a
// table built outside the kernel, as the reference builds its segment ids
// outside Pallas), so a packed row of short segments visits a few tiles
// per query tile instead of every tile below the diagonal:
//   S = Q K^T (tensor cores for bf16, f32 accumulation) -> shared f32,
//   per-row max / sum update and P = exp(S - m) rounded to the input type
//   (as the TPU kernel rounds p before its P.V product), written over S
//   row by row (one warp owns a row),
//   O = O * corr + P V with O held in registers (wmma accumulators; the
//   per-row factors come in through a row-broadcast tile), so shared memory
//   holds only the Q, K, V and score tiles (74 KB for bf16, D = 128; K3
//   adds 1 KB of ids).
// What bounds it on the H100: the products (4 * D per visible pair and
// head) against 989 TFLOP/s bf16; the bytes of Q, K, V and O are far below.
// This design uses wmma fragments (each warp a row strip, one A fragment
// per k-step), 8 warps and synchronous tile loads (all of a K/V pair's
// loads in flight at once); wgmma, TMA and double-buffered tiles are later
// work.
//
// K6 (RING): the same tile loop for one ring visit (causal = the diagonal
// visit, bottom-right aligned with Sq == Sk; a full visit passes causal 0).
// Only the epilogue differs: instead of writing a fresh O and lse, the
// block merges its rows into the running state of the ring, an f32 output
// o_acc [B, Sq, Hq, D] (normalized) and lse_acc [B, Hq, Sq]:
//   lse' = logaddexp(lse_acc, lse_v)
//   o'   = o_acc * exp(lse_acc - lse') + o_v * exp(lse_v - lse'),
// the visit's o_v never leaving registers (its factor exp(m - lse') / l
// folds into the final row scale). Each block owns its rows, as in K1, so
// the merge needs no atomics and costs one f32 read and write of O per
// visit, where the reference's _online_merge is a separate XLA pass. The
// first visit reads no state (no -inf - -inf); the last writes o' in the
// input type to `out` instead of o_acc, so no cast pass follows the ring.

#include "flash_common.cuh"

namespace {

using namespace ptt;
using namespace ptt::flash;

// K6's running state (RING kernels only).
struct Ring {
  float* o_acc;  // [B, Sq, Hq, D] f32; null when this visit is first and last
  int first;     // the state holds nothing yet: read none of it
};

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

// RING: `lse` is the ring's lse_acc (read unless first, always written) and
// `out` is null except on the ring's last visit.
template <typename T, int D, bool SEG, bool RING>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk, int group,
                     bool causal, float scale, Segments segs, Ring ring) {
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
  SegTile* ids = SEG ? reinterpret_cast<SegTile*>(p) : nullptr;

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
  // the key tiles [t_lo, t_hi) this query tile visits
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
  const Mask<SEG> mask{ids, sq, sk, causal};
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Acc<T, kBr, D> o;  // the output tile, in registers across all K/V tiles
  o.zero();

  for (int jt = t_lo; jt < t_hi; ++jt) {
    const int j0 = jt * kBc;
    __syncthreads();  // the previous tile's K, V, P, factors, ids consumed
    load_tiles<T, D, kBc>(Ks, kb, Vs, vb, j0, sk, k_stride);
    if constexpr (SEG)
      load_ids<kBc>(ids->seg_k, ids->pos_k, segs.seg_k + (size_t)b * sk,
                    segs.pos_k + (size_t)b * sk, j0, sk);
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
      float sv[kBc / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kBc / 32; ++c) {
        const int col = lane + 32 * c;
        const float x = Ss[r * L::kPS + col] * scale;
        sv[c] = mask(i0, r, j0, col) ? x : -INFINITY;
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
  if constexpr (RING) {
    // merge factors per row: the visit's unnormalized O by exp(m - lse')
    // (= exp(lse_v - lse') / l) into Cs, the state's by exp(lse_acc -
    // lse') into l_s; rows past Sq keep 0 and are never written
    for (int r = threadIdx.x; r < kBr; r += kThreads) {
      const float l = l_s[r];
      float keep = 0.f;
      float add = 0.f;
      if (i0 + r < sq) {
        float* lp = lse + ((size_t)b * hq + h) * sq + i0 + r;
        const float lv = l > 0.f ? m_s[r] + logf(l) : -INFINITY;
        const float la = ring.first ? -INFINITY : *lp;
        const float mx = fmaxf(la, lv);
        float merged = -INFINITY;
        if (mx != -INFINITY) {
          merged = mx + logf(expf(la - mx) + expf(lv - mx));
          keep = la == -INFINITY ? 0.f : expf(la - merged);
          add = l > 0.f ? expf(m_s[r] - merged) : 0.f;
        }
        *lp = merged;
      }
      for (int c = 0; c < kBcastLd; ++c) Cs[r * kBcastLd + c] = add;
      l_s[r] = keep;
    }
  } else {
    for (int r = threadIdx.x; r < kBr; r += kThreads) {
      const float l = l_s[r];
      const float inv = l > 0.f ? 1.f / l : 0.f;
      for (int c = 0; c < kBcastLd; ++c) Cs[r * kBcastLd + c] = inv;
      if (i0 + r < sq)
        lse[((size_t)b * hq + h) * sq + i0 + r] =
            l > 0.f ? m_s[r] + logf(l) : -INFINITY;
    }
  }
  __syncthreads();
  o.scale_rows(Cs);
  float* stage = reinterpret_cast<float*>(Ks);  // K and V tiles, adjacent
  o.store(stage, L::kPD);
  __syncthreads();
  const size_t base = ((size_t)b * sq * hq + h) * D;
  if constexpr (RING) {
    for (int idx = threadIdx.x; idx < kBr * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx % D;
      if (i0 + r >= sq) continue;
      const size_t off = base + (size_t)(i0 + r) * q_stride + d;
      float x = stage[r * L::kPD + d];
      if (!ring.first) x = fmaf(l_s[r], ring.o_acc[off], x);
      if (out != nullptr)
        out[off] = from_float<T>(x);
      else
        ring.o_acc[off] = x;
    }
  } else {
    store_tile<T, D, kBr>(out + base, stage, i0, sq, q_stride);
  }
}

template <typename T, int D, bool SEG, bool RING>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int sq, int sk, int hq, int group,
                   int causal, float scale, Segments segs, Ring ring,
                   cudaStream_t stream) {
  const size_t smem =
      FwdSmem<T, D>::kBytes + (SEG ? aligned(sizeof(SegTile)) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, SEG, RING>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBr - 1) / kBr, hq, batch);
  flash_fwd_kernel<T, D, SEG, RING><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), sq, sk, group, causal != 0, scale, segs,
      ring);
  return cudaGetLastError();
}

template <bool SEG, bool RING = false>
cudaError_t launch_typed(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, void* out, void* lse,
                         int batch, int sq, int sk, int hq, int hkv,
                         int causal, float scale, Segments segs,
                         void* stream, Ring ring = Ring{nullptr, 1}) {
  if (hkv < 1 || hq % hkv != 0 || batch < 1 || sq < 1 || sk < 1)
    return cudaErrorInvalidValue;
  const int group = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && head_dim == 64)
    return launch<float, 64, SEG, RING>(q, k, v, out, lse, batch, sq, sk, hq,
                                        group, causal, scale, segs, ring, s);
  if (dtype == kFloat32 && head_dim == 128)
    return launch<float, 128, SEG, RING>(q, k, v, out, lse, batch, sq, sk,
                                         hq, group, causal, scale, segs, ring,
                                         s);
  if (dtype == kBFloat16 && head_dim == 64)
    return launch<__nv_bfloat16, 64, SEG, RING>(q, k, v, out, lse, batch, sq,
                                                sk, hq, group, causal, scale,
                                                segs, ring, s);
  if (dtype == kBFloat16 && head_dim == 128)
    return launch<__nv_bfloat16, 128, SEG, RING>(q, k, v, out, lse, batch,
                                                 sq, sk, hq, group, causal,
                                                 scale, segs, ring, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entries for ctypes. q/out [batch, seq_q, num_q_heads, head_dim] and
// k/v [batch, seq_k, num_kv_heads, head_dim], contiguous, one dtype (0 f32,
// 1 bf16), 16-byte aligned; lse [batch, num_q_heads, seq_q] f32. num_kv_heads
// must divide num_q_heads. Each launches on `stream`, allocates nothing and
// returns cudaGetLastError().

// K1/K2: a causal call needs seq_q <= seq_k (every query row sees a key).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int batch, int seq_q, int seq_k,
                                          int num_q_heads, int num_kv_heads,
                                          int head_dim, int causal,
                                          float scale, int dtype,
                                          void* stream) {
  if (causal && seq_q > seq_k) return cudaErrorInvalidValue;
  return launch_typed<false>(dtype, head_dim, q, k, v, out, lse, batch, seq_q,
                             seq_k, num_q_heads, num_kv_heads, causal, scale,
                             ptt::flash::Segments{}, stream);
}

// K3: seg_q/pos_q [batch, seq_q] and seg_k/pos_k [batch, seq_k] int32;
// key_ranges [batch, ceil(seq_q / 64), 2] int32, the key tiles [lo, hi)
// each 64-row query tile visits (they must cover every visible pair).
extern "C" int flash_attention_seg_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* seg_q, const void* pos_q, const void* seg_k,
    const void* pos_k, const void* key_ranges, int batch, int seq_q,
    int seq_k, int num_q_heads, int num_kv_heads, int head_dim, int causal,
    float scale, int dtype, void* stream) {
  const ptt::flash::Segments segs{static_cast<const int*>(seg_q),
                      static_cast<const int*>(pos_q),
                      static_cast<const int*>(seg_k),
                      static_cast<const int*>(pos_k),
                      static_cast<const int*>(key_ranges)};
  return launch_typed<true>(dtype, head_dim, q, k, v, out, lse, batch, seq_q,
                            seq_k, num_q_heads, num_kv_heads, causal, scale,
                            segs, stream);
}

// K6, one ring visit: q [batch, seq_q, num_q_heads, head_dim] against the
// visiting k, v [batch, seq_k, num_kv_heads, head_dim] (causal: the
// diagonal visit, seq_q == seq_k), merged into the running state o_acc
// (f32, q's shape) and lse_acc (f32 [batch, num_q_heads, seq_q]). `first`:
// the state is empty (neither is read). `out` (q's shape and dtype, may be
// null): the ring's last visit, which writes the merged output there and
// leaves o_acc unwritten; otherwise the merged output goes to o_acc. o_acc
// may be null only for a visit that is both first and last.
extern "C" int flash_attention_ring_fwd_launch(
    const void* q, const void* k, const void* v, void* o_acc, void* lse_acc,
    void* out, int first, int batch, int seq_q, int seq_k, int num_q_heads,
    int num_kv_heads, int head_dim, int causal, float scale, int dtype,
    void* stream) {
  if (causal && seq_q != seq_k) return cudaErrorInvalidValue;
  if (lse_acc == nullptr || (o_acc == nullptr && !(first && out != nullptr)))
    return cudaErrorInvalidValue;
  const ptt::flash::Segments none{};
  const Ring ring{static_cast<float*>(o_acc), first != 0};
  return launch_typed<false, true>(dtype, head_dim, q, k, v, out, lse_acc,
                                   batch, seq_q, seq_k, num_q_heads,
                                   num_kv_heads, causal, scale, none, stream,
                                   ring);
}
