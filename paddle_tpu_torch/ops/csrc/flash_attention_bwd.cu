// K1/K2/K3/K6 backward: flash attention gradients, hand-written for Hopper
// (sm_90a).
//
// Replaces: the backward half of paddle_tpu/ops/flash_attention.py::
// _get_pallas_impl (jax's Pallas TPU flash attention custom VJP, whose dKV
// and dQ are two pallas_calls, tiled at :99-105), of ::_splash_impl /
// _splash_kernel (GQA, kv heads unexpanded) and, with segment ids, of
// ::_splash_varlen and ::flash_attention_packed (K3); and the per-visit
// backward of paddle_tpu/ops/ring_attention.py's kernel tier (K6's ring runs
// these entries once per kept visit, adding into the ring's f32 sums).
//
// Given q, k, v (paddle layout [B, S, H, D]), the forward's out and f32
// lse [B, Hq, Sq], and dout, with P = exp(scale * Q K^T - lse) under the
// forward's mask:
//   delta = rowsum(dout * out)                      (f32, [B, Hq, Sq])
//   dS    = P * (dout V^T - delta)
//   dV    = P^T dout,   dK = scale * dS^T Q,   dQ = scale * dS K
// Three entries, three launches a backward:
// 1. delta: one warp per (batch, row, head), a fused multiply and sum.
// 2. dK/dV: recomputes S and dP for each (key tile, query tile) pair it
//    visits; the GQA sum over a kv head's group of query heads happens
//    inside one block.
// 3. dQ: recomputes S and dP again (7 products against an atomic-dQ
//    design's 5), so that no sum crosses blocks: no atomics, and two
//    launches give bit-identical gradients.
//
// What bounds it on the H100: the products, 2 x 4 D flops per visible
// (query, key) pair and head for dK/dV and 3 x 2 D for dQ, against 989
// TFLOP/s bf16 (0.139 and 0.104 ms at B 2, S 2048, 32 heads of 128, causal);
// their bytes take a tenth of that.
//
// Design (bf16 or fp16; D 64 or 128), after the forward
// (flash_attention_fwd.cu): blocks of three warpgroups, warpgroup 2 a TMA
// producer (one thread) and warpgroups 0 and 1 consumers, their registers
// split by setmaxnreg; tensor
// maps over the paddle layout (boxes of 64 elements, 128-byte swizzle; rows
// past Sq or Sk arrive as zeros) feed wgmma from shared memory, and every
// score-sized tile (S, P, dP, dS) lives in registers only.
// - dK/dV: a work tile is 128 keys of one kv head and batch; each consumer
//   owns 64 keys. The producer loads the tile's K and V once (K3 also their
//   ids), then streams (Q, dO, lse, delta; K3 also the query ids) in stages
//   of 64 query rows through a 2-stage ring, for each query head of the
//   group and each query tile that sees the keys. A consumer computes S^T =
//   K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands K-major in
//   shared memory), forms P^T = exp2(scale log2(e) S^T - lse log2(e)) with
//   each column's lse and dS^T = P^T (dP^T - delta) in registers, and
//   issues dV += P^T dO and dK += dS^T Q with P^T and dS^T as the register
//   A operand (m64nDk16, dO and Q the MN-major B operand, as V is in the
//   forward's P V). The exponentials of P^T overlap dP^T's wgmma; P^T and
//   dS^T are both formed before dV's and dK's products are issued together.
//   dK and dV (two 64 x D f32 accumulators, 128 registers at D 128) stay in
//   registers across the whole group, beside S^T and dP^T (64 more).
// - Registers are the constraint of dK/dV. Its consumers get 240 (the
//   producer 24), and even so the first versions spilled: P^T kept live
//   while dV's products ran made ptxas serialise every wgmma (warning
//   C7512); at 232 it spilled. What made it fit: shared memory by
//   32-bit addresses (descriptors plus offsets, lds_f32), one flat stage
//   loop, K1/K2's mask as two per-row column bounds compared with constant
//   offsets, K3's key ids staged by TMA instead of held, and the layout and
//   walk derived inside each role after its setmaxnreg. The build log's
//   -Xptxas -v shows no spill in any of these kernels.
// - dK/dV's walk: K1/K2 run one block per SM, tiles numbered key tile first
//   (heaviest first under the causal mask, a GQA tile carrying its group)
//   and dealt out in a snake (kv_work_index), so each block's heavy tiles
//   meet light ones; K3's work follows its segments, so it runs one block
//   per work tile, handed to the SMs as they free. A warpgroup skips the
//   products of a stage that none of its own 64 keys can see (the first
//   stage of a causal tile for warpgroup 1; K3's other segment).
// - dQ: a work tile is 128 query rows of one query head, as the forward's,
//   walked as the forward walks them (work_tile, flash_common.cuh); Q and dO
//   load once per tile, K and V stream in tiles of 128 keys through the
//   ring; 232 registers for the consumers, 40 for the producer. S = Q K^T
//   and dP = dO V^T (m64n128k16) from shared memory, P and dS in registers
//   with each row's lse and delta, dQ += dS K with dS the register A operand
//   and K the MN-major B operand.
// - P and dS are rounded to the storage type before their products (as the
//   TPU kernel rounds them; an fp16 dS past 65504 becomes inf, and so does
//   dQ: the loss scaler's skip rests on it); dS is formed from the
//   unrounded P; every sum is f32.
// - The mask is a policy, as in the forward: K1/K2 mask only the stages that
//   cross a warpgroup's causal diagonal or run past Sq or Sk, and never load
//   tiles wholly past the diagonal; K3 compares segment ids and positions on
//   every stage it visits (both sides' ids staged by TMA) and visits only
//   its range, converting the 64-unit tables per block (tile_pair_range,
//   seg_key_tiles). A row of 4-byte values (lse, delta, ids) loads from a
//   16-byte aligned box start (tma_load_row): an unaligned one faulted. A
//   query row that sees no key has lse -inf: lse_log2 makes it 0, its
//   masked scores are -inf, and its P, dS and dQ come out exactly 0.
// - The epilogue is a policy: K1/K2/K3 write dK, dV and dQ in E straight
//   from the accumulators (each quad of threads 16 contiguous bytes of a
//   row); K6's visits (ACC) add them into the ring's f32 sums instead (dQ
//   of the resident shard, dK and dV travelling with the visiting one), each
//   block owning its rows, so the visit's gradients never exist in E and
//   no add pass follows. Staging through shared memory for TMA stores is
//   later work.
// - Departures from a fuller FA3 backward: one K/V tile per dK/dV block at a
//   time (the ring drains at a work tile's end, while the epilogue stores),
//   no dQ atomics (the determinism above), and the consumers run each
//   stage's products in turn rather than beside the previous stage's.
//
// f32 runs the earlier CUDA-core tile loop (64-row tiles, shared-memory
// scores), kept as the correctness witness of the f32 phases; the dtype
// alone picks the kernel. cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint (hopper.cuh), so no -lcuda is linked.

#include "flash_common.cuh"
#include "hopper.cuh"

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

// -- the f32 gradients: CUDA cores, shared-memory scores ----------------------
//
// dK/dV: one block per (64-key tile, kv head, batch), looping over the
// group's query heads and the query tiles that can see its keys; dQ: one
// block per (64-row query tile, query head, batch), looping over its key
// tiles. S and dP go through shared memory, P and dS are written over them.

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
  // f32, D = 128: 173 KB
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
cudaError_t launch_dkdv_f32(const void* q, const void* k, const void* v,
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
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
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


// -- the bf16 and fp16 gradients: TMA, wgmma, warp specialisation ------------

namespace hop {

using namespace ptt::hopper;

constexpr int kKeys = 128;   // keys a dK/dV work tile: two warpgroups of 64
constexpr int kRows = 128;   // query rows a dQ work tile: two warpgroups of 64
constexpr int kQStep = 64;   // query rows a dK/dV stage
constexpr int kKStep = 128;  // keys a dQ stage
constexpr int kStages = 2;   // stages in flight: dQ's K/V, dK/dV's Q/dO
constexpr int kConsumers = 256;              // the two consumer warpgroups
constexpr int kThreadsH = kConsumers + 128;  // + the producer warpgroup
// registers a thread after setmaxnreg, of the launch's 384 x 168 = 64512:
// dQ 256 x 232 + 128 x 40; dK/dV, whose consumers hold dK and dV beside
// S^T and dP^T, 256 x 240 + 128 x 24 (232 spilled)
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kDkDvConsumerRegs = 240;
constexpr int kDkDvProducerRegs = 24;
// one 64-element column block (128 bytes a row) of a 128- or 64-row tile
constexpr int kBlock128 = 128 * 128;
constexpr int kBlock64 = 64 * 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  void* out0;          // dK/dV: dk; dQ: dq. E, or (ACC) f32 sums added to
  void* out1;          // dK/dV: dv
  const float* lse;    // [B, Hq, Sq]: dQ reads its rows' lse and delta here
  const float* delta;
  int batch, sq, sk, hq, group, causal;
  float scale;       // of dK and dQ
  float scale_log2;  // scale * log2(e): the exponentials run in base 2
  Segments segs;
};

// A row's lse in base 2. A row that sees no key (lse -inf) gets 0: all its
// scores are masked to -inf, so P = 2^-inf = 0 (-inf - -inf would be NaN).
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? 0.f : lse * kLog2e;
}

// Add a thread's two accumulator rows into f32 sums (ACC) or write them in
// E: `base` + off[r] is element col_in of row rows[r]; rows at or past
// `n` are dropped. Register i of an m64nDk16 accumulator is row r
// = (i >> 1) & 1, column 8 (i >> 2) + col_in + (i & 1). Each row's loads
// are issued before its stores.
template <typename E, int D, bool ACC>
__device__ __forceinline__ void store_rows(void* base, const size_t (&off)[2],
                                           const int (&rows)[2], int n,
                                           const float (&x)[D / 2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= n) continue;
    if constexpr (ACC) {
      float* p = static_cast<float*>(base) + off[r];
      float2 acc[D / 8];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        acc[j] = *reinterpret_cast<const float2*>(p + 8 * j);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(p + 8 * j) =
            make_float2(acc[j].x + x[4 * j + 2 * r],
                        acc[j].y + x[4 * j + 2 * r + 1]);
    } else {
      E* p = static_cast<E*>(base) + off[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_pair<E>(p + 8 * j, x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
    }
  }
}

// -- dK/dV --------------------------------------------------------------------

// Shared memory, offsets from a 1024-byte aligned base: the work tile's K
// and V (D / 64 column blocks of 128 rows each), the stages' Q and dO (64
// rows), the stages' rows (lse, delta; K3 also seg_q, pos_q), the barriers.
template <int D, bool SEG>
struct DkDvSmem {
  static constexpr int kKV = D / 64 * kBlock128;
  static constexpr int kQT = D / 64 * kBlock64;
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kQ = 2 * kKV;
  static constexpr int kDO = kQ + kStages * kQT;
  static constexpr int kRowsAt = kDO + kStages * kQT;
  // a stage's rows: lse, delta (f32) and K3's seg_q, pos_q (int32), each a
  // box of kQStep + kRowSlack values (tma_load_row) kRowArr bytes apart
  static constexpr int kRowBox = (kQStep + kRowSlack) * 4;
  static constexpr int kRowArr = (kRowBox + 127) / 128 * 128;
  static constexpr int kRowArrays = SEG ? 4 : 2;
  static constexpr int kRowsStage = kRowArrays * kRowArr;
  // K3's seg_k, pos_k of the work tile's keys (boxes of kKeys + kRowSlack)
  static constexpr int kKeyIds = kRowsAt + kStages * kRowsStage;
  static constexpr int kKeyIdBox = (kKeys + kRowSlack) * 4;
  static constexpr int kKeyIdArr = (kKeyIdBox + 127) / 128 * 128;
  static constexpr int kBars = kKeyIds + (SEG ? 2 * kKeyIdArr : 0);
  // kv_full, kv_empty, full[kStages], empty[kStages]
  static constexpr int kNumBars = 2 + 2 * kStages;
  // 130 KB at D 128
  static constexpr size_t kBytes = 1024 + kBars + 8 * kNumBars;
};

// A dK/dV work tile is one (128-key tile, kv head, batch). Tiles are
// numbered key tile first: under K1/K2's causal mask a key tile's work
// falls with its index (key tile 0 is seen by every query tile, the last by
// one or two), and a GQA tile carries its whole group. Round r of the walk
// gives block i tile r G + i when r is even and r G + G - 1 - i when it is
// odd (G = gridDim.x), so a block's heavy tiles meet light ones: GQA 64/8
// at B 2, S 2048 (256 tiles on 132 SMs) loads no block with more than 34
// query tiles x group against a mean of 33. K3's work follows its segments.
struct KvWork {
  int b, hk, kt;
};

__device__ __forceinline__ int kv_work_index(int r, int blk, int grid) {
  return r * grid + ((r & 1) ? grid - 1 - blk : blk);
}

__device__ __forceinline__ KvWork kv_work_tile(int w, int batch, int hkv) {
  const int bh = batch * hkv;
  return KvWork{(w % bh) / hkv, w % hkv, w / bh};
}

// The 64-row query tiles [lo, hi) that see a key tile: K1/K2 from the first
// row that sees its first key under the causal mask, K3 those its segments
// reach (the union of its two 64-key tiles' query_ranges entries).
template <bool SEG>
__device__ __forceinline__ int2 query_tiles(const Args& a, const KvWork& t) {
  const int n_qt = (a.sq + kQStep - 1) / kQStep;
  if constexpr (SEG) {
    return tile_pair_range(a.segs.ranges, t.b, (a.sk + 63) / 64, t.kt, n_qt);
  } else {
    const int first = a.causal ? max(0, t.kt * kKeys - (a.sk - a.sq)) : 0;
    return make_int2(first / kQStep, n_qt);
  }
}

// Persistent: one block per SM walks the work tiles of kv_work_index.
// Warpgroups 0 and 1 consume (64 keys each), warpgroup 2 produces (one
// thread issues the TMA loads). lse and delta ([B, Hq, Sq] f32) and K3's
// query ids and positions ([B, Sq] int32) come as 1-D tensor maps with
// boxes of 64 + kRowSlack (tma_load_row); other kernels ignore the two id
// maps. E: __nv_bfloat16 or __half.
template <typename E, int D, bool SEG, bool ACC>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_dkdv_hopper(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap lse_map,
                      const __grid_constant__ CUtensorMap delta_map,
                      const __grid_constant__ CUtensorMap seg_q_map,
                      const __grid_constant__ CUtensorMap pos_q_map,
                      const __grid_constant__ CUtensorMap seg_k_map,
                      const __grid_constant__ CUtensorMap pos_k_map, Args a) {
  using L = DkDvSmem<D, SEG>;
  // The shared layout and the walk are derived inside each role, after its
  // setmaxnreg: a value live across the role split cost a spill.
  const int grid = gridDim.x;

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(aligned_smem() + L::kBars);
    mbar_init(bars, 1);                // kv_full
    mbar_init(bars + 1, kConsumers);   // kv_empty
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 2 + s, 1);                      // full[s]
      mbar_init(bars + 2 + kStages + s, kConsumers);  // empty[s]
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // -- producer: each work tile's K and V, then the query stages ---------
    reg_dealloc<kDkDvProducerRegs>();
    unsigned char* base = aligned_smem();
    const int hkv = a.hq / a.group;
    const int n_kt = (a.sk + kKeys - 1) / kKeys;
    const int n_work = n_kt * hkv * a.batch;
    if (threadIdx.x == kConsumers) {
      // 32-bit shared addresses and one flat stage loop: this thread runs
      // within 24 registers
      const uint32_t sb = smem_addr(base);
      const uint32_t kv_full_s = sb + L::kBars;
      const uint32_t full_s = kv_full_s + 16;
      const uint32_t empty_s = full_s + 8 * kStages;
      int it = 0;  // stages loaded so far, over all work tiles
      for (int r = 0, wi = 0; r * grid < n_work; ++r) {
        const int w = kv_work_index(r, blockIdx.x, grid);
        if (w >= n_work) continue;
        const KvWork t = kv_work_tile(w, a.batch, hkv);
        const int2 qr = query_tiles<SEG>(a, t);
        // the consumers are done with the previous tile's K and V
        mbar_wait(kv_full_s + 8, (wi & 1) ^ 1);
        mbar_arrive_expect_tx(kv_full_s,
                              2 * L::kKV + (SEG ? 2 * L::kKeyIdBox : 0));
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sb + L::kK + c * kBlock128, &k_map, kv_full_s, 64 * c,
                      t.hk, t.kt * kKeys, t.b);
          tma_load_4d(sb + L::kV + c * kBlock128, &v_map, kv_full_s, 64 * c,
                      t.hk, t.kt * kKeys, t.b);
        }
        if constexpr (SEG) {
          tma_load_row(sb + L::kKeyIds, &seg_k_map, kv_full_s,
                       t.b * a.sk + t.kt * kKeys);
          tma_load_row(sb + L::kKeyIds + L::kKeyIdArr, &pos_k_map, kv_full_s,
                       t.b * a.sk + t.kt * kKeys);
        }
        // the stages: each query head h of the group, each query tile qt
        int h = t.hk * a.group;
        int qt = qr.x;
        for (int j = a.group * (qr.y - qr.x); j > 0; --j, ++it) {
          const int st = it % kStages;
          const uint32_t bar = full_s + 8 * st;
          mbar_wait(empty_s + 8 * st, ((it / kStages) & 1) ^ 1);
          const int i0 = qt * kQStep;
          mbar_arrive_expect_tx(bar, 2 * L::kQT + L::kRowArrays * L::kRowBox);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(sb + L::kQ + st * L::kQT + c * kBlock64, &q_map, bar,
                        64 * c, h, i0, t.b);
            tma_load_4d(sb + L::kDO + st * L::kQT + c * kBlock64, &do_map,
                        bar, 64 * c, h, i0, t.b);
          }
          // rows past Sq read the next head's values or zeros: the mask
          // drops them
          const uint32_t rows = sb + L::kRowsAt + st * L::kRowsStage;
          const int row0 = (t.b * a.hq + h) * a.sq + i0;
          tma_load_row(rows, &lse_map, bar, row0);
          tma_load_row(rows + L::kRowArr, &delta_map, bar, row0);
          if constexpr (SEG) {
            tma_load_row(rows + 2 * L::kRowArr, &seg_q_map, bar,
                         t.b * a.sq + i0);
            tma_load_row(rows + 3 * L::kRowArr, &pos_q_map, bar,
                         t.b * a.sq + i0);
          }
          if (++qt == qr.y) {
            qt = qr.x;
            ++h;
          }
        }
        ++wi;
      }
    }
  } else {
    // -- consumers: S^T, dP^T, P^T and dS^T in registers; dV, dK -----------
    // Shared memory is reached by 32-bit addresses (descriptors, lds_*):
    // at D 128, dK, dV, S^T and dP^T leave few of the 240 registers.
    reg_alloc<kDkDvConsumerRegs>();
    unsigned char* base = aligned_smem();
    uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBars);
    uint64_t* kv_full = bars;
    uint64_t* kv_empty = bars + 1;
    uint64_t* full = bars + 2;
    uint64_t* empty = bars + 2 + kStages;
    const int hkv = a.hq / a.group;
    const int n_kt = (a.sk + kKeys - 1) / kKeys;
    const int n_work = n_kt * hkv * a.batch;
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x & 127) >> 5;
    const int lane = threadIdx.x & 31;
    const int col_in = 2 * (lane & 3);  // first column in each 8-col chunk
    const int off = a.sk - a.sq;  // K1/K2: row i sees keys j <= i + off
    const bool causal = a.causal;
    const uint32_t sb = smem_addr(base);
    float s[32];
    float dp[32];
    int it = 0;  // stages consumed so far, over all work tiles
    for (int r = 0, wi = 0; r * grid < n_work; ++r) {
      const int w = kv_work_index(r, blockIdx.x, grid);
      if (w >= n_work) continue;
      const KvWork t = kv_work_tile(w, a.batch, hkv);
      const int2 qr = query_tiles<SEG>(a, t);
      const int wg_key = t.kt * kKeys + 64 * wg;
      // this thread's keys, key and key + 8: the rows of S^T, dK and dV it
      // holds (register i: key + 8 ((i >> 1) & 1))
      const int key = wg_key + 16 * warp + (lane >> 2);
      // the 64-row query tiles [own_lo, own_hi) this warpgroup's own 64
      // keys can see (K1/K2: from the first row that sees its first key;
      // K3: its 64-key tile's query_ranges entry): its other stages, wholly
      // masked, skip their products
      int own_lo;
      int own_hi = (a.sq + kQStep - 1) / kQStep;
      if constexpr (SEG) {
        const int u = 2 * t.kt + wg;
        const int n_own = (a.sk + 63) / 64;
        const int2 rg = u < n_own ? tile_range(a.segs.ranges, t.b, n_own, u,
                                               own_hi)
                                  : make_int2(0, 0);
        own_lo = rg.x;
        own_hi = rg.y;
      } else {
        own_lo = causal ? max(0, wg_key - off) / kQStep : 0;
        if (wg_key >= a.sk) own_hi = 0;
      }
      float dk[D / 2];
      float dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(kv_full, wi & 1);

      // the stages: each query head g of the group, each query tile qt
      int g = 0;
      int qt = qr.x;
      for (int j = a.group * (qr.y - qr.x); j > 0; --j, ++it) {
        {
          const int st = it % kStages;
          const uint32_t ph = (it / kStages) & 1;
          const int i0 = qt * kQStep;
          mbar_wait(&full[st], ph);
          if (qt < own_lo || qt >= own_hi) {
            mbar_arrive(&empty[st]);
            if (++qt == qr.y) {
              qt = qr.x;
              ++g;
            }
            continue;
          }
          // S^T = K Q^T, then dP^T = V dO^T: 64 keys x 64 query rows each;
          // a k-step adds its byte offset / 16 to a descriptor
          const uint32_t q_at = sb + L::kQ + st * L::kQT;
          const uint32_t do_at = sb + L::kDO + st * L::kQT;
          {
            const uint64_t k_desc =
                sw128_desc(sb + L::kK + 64 * 128 * wg, 16, 1024);
            const uint64_t q_desc = sw128_desc(q_at, 16, 1024);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
              const int ca = ((ks / 4) * kBlock128 + (ks % 4) * 32) >> 4;
              const int cb = ((ks / 4) * kBlock64 + (ks % 4) * 32) >> 4;
              wgmma_ss_n64<E>(s, k_desc + ca, q_desc + cb, ks > 0);
            }
            wgmma_commit();
          }
          {
            const uint64_t v_desc =
                sw128_desc(sb + L::kV + 64 * 128 * wg, 16, 1024);
            const uint64_t do_desc = sw128_desc(do_at, 16, 1024);
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
              const int ca = ((ks / 4) * kBlock128 + (ks % 4) * 32) >> 4;
              const int cb = ((ks / 4) * kBlock64 + (ks % 4) * 32) >> 4;
              wgmma_ss_n64<E>(dp, v_desc + ca, do_desc + cb, ks > 0);
            }
            wgmma_commit();
          }
          wgmma_wait<1>();  // S^T has landed; dP^T may still run
          fence_regs(s);
          // this stage's lse, then delta kRowArr bytes on, from their box's
          // unaligned start (tma_load_row)
          const uint32_t lse_at =
              sb + L::kRowsAt + st * L::kRowsStage +
              4 * (((t.b * a.hq + t.hk * a.group + g) * a.sq + i0) & 3);

          // the mask, without branches: K3 on every stage; K1/K2 where the
          // stage crosses this warpgroup's causal diagonal or runs past Sq
          // or Sk. Register i of S^T is key row (i >> 1) & 1, query column
          // 8 (i >> 2) + col_in + (i & 1).
          if constexpr (SEG) {
            // K3: the stage's query ids and the work tile's key ids, each
            // from their box's unaligned start
            const uint32_t ids_at = sb + L::kRowsAt + st * L::kRowsStage +
                                    2 * L::kRowArr +
                                    4 * ((t.b * a.sq + i0) & 3);
            const uint32_t kids_at =
                sb + L::kKeyIds + 4 * ((t.b * a.sk + t.kt * kKeys) & 3) +
                4 * (key - t.kt * kKeys);
            int seg_key[2];
            int pos_key[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              seg_key[k] = lds_s32(kids_at + 32 * k);
              pos_key[k] = lds_s32(kids_at + L::kKeyIdArr + 32 * k);
            }
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = 8 * jj + col_in + e;
                const bool q_ok = i0 + c < a.sq;
                const int q_seg = lds_s32(ids_at + 4 * c);
                const int q_pos = lds_s32(ids_at + L::kRowArr + 4 * c);
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                  const bool seen = q_ok & (key + 8 * k < a.sk) &
                                    (seg_key[k] == q_seg) &
                                    (!causal | (q_pos >= pos_key[k]));
                  const int i = 4 * jj + 2 * k + e;
                  s[i] = seen ? s[i] : -INFINITY;
                }
              }
            }
          } else if (i0 + kQStep > a.sq || wg_key + 64 > a.sk ||
                     (causal && wg_key + 63 > i0 + off)) {
            // K1/K2: key row kk sees column c (query i0 + c) when c < Sq -
            // i0 and, under the causal mask, c >= kk - off - i0; a key past
            // Sk sees none. Both bounds less col_in, so that each element
            // compares its constant offset 8 jj + e.
            const int hi = a.sq - i0 - col_in;
            int lo[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int kk = key + 8 * k;
              lo[k] = kk >= a.sk ? INT_MAX
                                 : causal ? kk - off - i0 - col_in : INT_MIN;
            }
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                  const int cc = 8 * jj + e;
                  const int i = 4 * jj + 2 * k + e;
                  s[i] = (cc >= lo[k]) & (cc < hi) ? s[i] : -INFINITY;
                }
              }
            }
          }

          // P^T = exp(scale S^T - lse), each column its query row's lse,
          // while dP^T's products run
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float l0 = lse_log2(lds_f32(lse_at + 4 * (8 * jj + col_in)));
            const float l1 =
                lse_log2(lds_f32(lse_at + 4 * (8 * jj + col_in + 1)));
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int i = 4 * jj + 2 * k;
              s[i] = ex2(fmaf(s[i], a.scale_log2, -l0));
              s[i + 1] = ex2(fmaf(s[i + 1], a.scale_log2, -l1));
            }
          }
          wgmma_wait<0>();  // dP^T has landed
          fence_regs(dp);
          // P^T and dS^T = P^T (dP^T - delta) (from the unrounded P^T, each
          // column its query row's delta), rounded to E in the A
          // operand's layout. Both are formed before dV's products are
          // issued: keeping P^T live beside dK, dV, S^T and dP^T while dV's
          // products run needs more than the consumers' registers, and
          // ptxas then serialises every wgmma.
          uint32_t p16[16];
          uint32_t ds16[16];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const uint32_t d_at = lse_at + L::kRowArr + 4 * (8 * jj + col_in);
            const float d0 = lds_f32(d_at);
            const float d1 = lds_f32(d_at + 4);
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int i = 4 * jj + 2 * k;
              p16[2 * jj + k] = pack16<E>(s[i], s[i + 1]);
              ds16[2 * jj + k] = pack16<E>(s[i] * (dp[i] - d0),
                                           s[i + 1] * (dp[i + 1] - d1));
            }
          }
          // dV += P^T dO and dK += dS^T Q: 4 k-steps of 16 query rows each,
          // dO and Q the MN-major B operand (column blocks kBlock64 bytes
          // apart, a k-step of 16 rows 2048 bytes on)
          const uint64_t do_mn = sw128_desc(do_at, kBlock64, 1024);
          const uint64_t q_mn = sw128_desc(q_at, kBlock64, 1024);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kQStep / 16; ++kk) {
            const uint32_t frag[4] = {p16[4 * kk], p16[4 * kk + 1],
                                      p16[4 * kk + 2], p16[4 * kk + 3]};
            if constexpr (D == 128)
              wgmma_rs_n128<E>(dv, frag, do_mn + kk * (2048 >> 4));
            else
              wgmma_rs_n64<E>(dv, frag, do_mn + kk * (2048 >> 4));
          }
#pragma unroll
          for (int kk = 0; kk < kQStep / 16; ++kk) {
            const uint32_t frag[4] = {ds16[4 * kk], ds16[4 * kk + 1],
                                      ds16[4 * kk + 2], ds16[4 * kk + 3]};
            if constexpr (D == 128)
              wgmma_rs_n128<E>(dk, frag, q_mn + kk * (2048 >> 4));
            else
              wgmma_rs_n64<E>(dk, frag, q_mn + kk * (2048 >> 4));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
          mbar_arrive(&empty[st]);
        }
        if (++qt == qr.y) {
          qt = qr.x;
          ++g;
        }
      }
      // the last stage read K and V: the producer may load the next tile's
      mbar_arrive(kv_empty);

      // epilogue: dK = scale dS^T Q, and dV, from the registers
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] *= a.scale;
      const int keys[2] = {key, key + 8};
      size_t row_off[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        row_off[k] =
            (((size_t)t.b * a.sk + keys[k]) * hkv + t.hk) * D + col_in;
      store_rows<E, D, ACC>(a.out0, row_off, keys, a.sk, dk);
      store_rows<E, D, ACC>(a.out1, row_off, keys, a.sk, dv);
      ++wi;
    }
  }
}

// -- dQ -----------------------------------------------------------------------

// Shared memory, offsets from a 1024-byte aligned base: the work tile's Q
// and dO, the K and V stages (each D / 64 column blocks of 128 rows), K3's
// key ids per stage, then the barriers.
template <int D, bool SEG>
struct DqSmem {
  static constexpr int kTile = D / 64 * kBlock128;
  static constexpr int kQ = 0;
  static constexpr int kDO = kTile;
  static constexpr int kK = 2 * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kIds = kV + kStages * kTile;
  // K3's seg_k, pos_k: boxes of kKStep + kRowSlack values (tma_load_row)
  static constexpr int kIdBox = (kKStep + kRowSlack) * 4;
  static constexpr int kIdArr = (kIdBox + 127) / 128 * 128;
  static constexpr int kIdsStage = SEG ? 2 * kIdArr : 0;
  static constexpr int kBars = kIds + kStages * kIdsStage;
  // q_full, q_empty, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kNumBars = 2 + 3 * kStages;
  // 194 KB at D 128
  static constexpr size_t kBytes = 1024 + kBars + 8 * kNumBars;
};

// The key tiles [lo, hi) of 128 keys a dQ work tile visits: K1/K2 up to
// the causal limit of its last row, K3 those its segments can see.
template <bool SEG>
__device__ __forceinline__ int2 key_tiles(const Args& a, const Work& w) {
  if constexpr (SEG) {
    return seg_key_tiles(a.segs.ranges, w.b, w.qt, a.sq, a.sk);
  } else {
    const int last_row = min((w.qt + 1) * kRows, a.sq) - 1;
    const int n_keys =
        a.causal ? min(a.sk, last_row + a.sk - a.sq + 1) : a.sk;
    return make_int2(0, (n_keys + kKStep - 1) / kKStep);
  }
}

// Persistent, as the forward: one block per SM walks the work tiles of
// work_tile. Warpgroups 0 and 1 consume (64 query rows each), warpgroup 2
// produces (each work tile's Q and dO, then the K/V ring). K3 also takes
// the key ids and positions ([B, Sk] int32) as 1-D tensor maps with boxes
// of 128 + kRowSlack (tma_load_row); other kernels ignore those two maps.
// E: __nv_bfloat16 or __half.
template <typename E, int D, bool SEG, bool ACC>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_dq_hopper(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap seg_k_map,
                    const __grid_constant__ CUtensorMap pos_k_map, Args a) {
  using L = DqSmem<D, SEG>;
  unsigned char* base = aligned_smem();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* v_full = bars + 2 + kStages;
  uint64_t* empty = bars + 2 + 2 * kStages;

  const int sq = a.sq;
  const int sk = a.sk;
  const int n_qt = (sq + kRows - 1) / kRows;
  const int n_work = n_qt * a.hq * a.batch;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // -- producer: each work tile's Q and dO, then the K/V ring -------------
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      int it = 0;  // K/V tiles loaded so far, over all work tiles
      for (int w = blockIdx.x, wi = 0; w < n_work; w += gridDim.x, ++wi) {
        // the consumers are done with the previous tile's Q and dO
        mbar_wait(q_empty, (wi & 1) ^ 1);
        const Work t = work_tile<SEG>(w, n_qt, a.hq, a.causal);
        const int2 kt = key_tiles<SEG>(a, t);
        const int hk = t.h / a.group;
        mbar_arrive_expect_tx(q_full, 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(base + L::kQ + c * kBlock128, &q_map, q_full, 64 * c,
                      t.h, t.qt * kRows, t.b);
          tma_load_4d(base + L::kDO + c * kBlock128, &do_map, q_full, 64 * c,
                      t.h, t.qt * kRows, t.b);
        }
        for (int jt = kt.x; jt < kt.y; ++jt, ++it) {
          const int st = it % kStages;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          const int j0 = jt * kKStep;
          unsigned char* Kt = base + L::kK + st * L::kTile;
          unsigned char* Vt = base + L::kV + st * L::kTile;
          // K3: the tile's key ids and positions ride on K's barrier (keys
          // past Sk read the next row's ids or zeros: the mask drops them)
          mbar_arrive_expect_tx(&k_full[st],
                                L::kTile + (SEG ? 2 * L::kIdBox : 0));
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            tma_load_4d(Kt + c * kBlock128, &k_map, &k_full[st], 64 * c, hk,
                        j0, t.b);
          if constexpr (SEG) {
            unsigned char* ids = base + L::kIds + st * L::kIdsStage;
            tma_load_row(ids, &seg_k_map, &k_full[st], t.b * sk + j0);
            tma_load_row(ids + L::kIdArr, &pos_k_map, &k_full[st],
                         t.b * sk + j0);
          }
          mbar_arrive_expect_tx(&v_full[st], L::kTile);
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            tma_load_4d(Vt + c * kBlock128, &v_map, &v_full[st], 64 * c, hk,
                        j0, t.b);
        }
      }
    }
  } else {
    // -- consumers: S, dP, P and dS in registers; dQ += dS K ---------------
    reg_alloc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x & 127) >> 5;
    const int lane = threadIdx.x & 31;
    const int col_in = 2 * (lane & 3);  // first column in each 8-col chunk
    const int off = sk - sq;  // K1/K2: row i sees keys j <= i + off
    const bool causal = a.causal;
    // the operands' descriptors; a k-step adds its byte offset / 16
    const uint64_t q_desc =
        sw128_desc(base + L::kQ + 64 * 128 * wg, 16, 1024);  // 64 rows each
    const uint64_t do_desc =
        sw128_desc(base + L::kDO + 64 * 128 * wg, 16, 1024);
    float s[64];
    float dp[64];
    int it = 0;  // K/V tiles consumed so far, over all work tiles
    for (int w = blockIdx.x, wi = 0; w < n_work; w += gridDim.x, ++wi) {
      mbar_wait(q_full, wi & 1);
      const Work t = work_tile<SEG>(w, n_qt, a.hq, a.causal);
      const int2 kt = key_tiles<SEG>(a, t);
      const int wg_row = t.qt * kRows + 64 * wg;
      // this thread's two rows, their lse (base 2) and delta
      const int rows[2] = {wg_row + 16 * warp + (lane >> 2),
                           wg_row + 16 * warp + (lane >> 2) + 8};
      const size_t lse_row = ((size_t)t.b * a.hq + t.h) * sq;
      float lse2[2] = {0.f, 0.f};
      float dl[2] = {0.f, 0.f};
      int seg_row[2] = {0, 0};
      int pos_row[2] = {0, 0};
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < sq) {
          lse2[r] = lse_log2(a.lse[lse_row + rows[r]]);
          dl[r] = a.delta[lse_row + rows[r]];
          if constexpr (SEG) {
            seg_row[r] = a.segs.seg_q[(size_t)t.b * sq + rows[r]];
            pos_row[r] = a.segs.pos_q[(size_t)t.b * sq + rows[r]];
          }
        }
      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

      for (int jt = kt.x; jt < kt.y; ++jt, ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int j0 = jt * kKStep;
        const unsigned char* Kt = base + L::kK + st * L::kTile;
        const uint64_t k_desc = sw128_desc(Kt, 16, 1024);
        const uint64_t v_desc =
            sw128_desc(base + L::kV + st * L::kTile, 16, 1024);
        // S = Q K^T, then dP = dO V^T: 64 rows x 128 keys each
        mbar_wait(&k_full[st], ph);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const int cb = ((ks / 4) * kBlock128 + (ks % 4) * 32) >> 4;
          wgmma_ss_n128<E>(s, q_desc + cb, k_desc + cb, ks > 0);
        }
        wgmma_commit();
        mbar_wait(&v_full[st], ph);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const int cb = ((ks / 4) * kBlock128 + (ks % 4) * 32) >> 4;
          wgmma_ss_n128<E>(dp, do_desc + cb, v_desc + cb, ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // S has landed; dP may still run
        fence_regs(s);

        // the mask, without branches: K3 on every tile; K1/K2 where the
        // tile crosses this warpgroup's causal diagonal or runs past Sk
        bool masked;
        if constexpr (SEG)
          masked = true;
        else
          masked = j0 + kKStep > sk ||
                   (causal && j0 + kKStep - 1 > wg_row + off);
        if (masked) {
          // K3's key ids from their box's unaligned start (tma_load_row)
          const int* seg_s =
              reinterpret_cast<const int*>(base + L::kIds +
                                           st * L::kIdsStage) +
              ((t.b * sk + j0) & 3);
          const int* pos_s = seg_s + L::kIdArr / 4;
#pragma unroll
          for (int jj = 0; jj < kKStep / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * jj + col_in + e;
              const bool key_ok = j0 + c < sk;
              int key_seg = 0;
              int key_pos = 0;
              if constexpr (SEG) {
                key_seg = seg_s[c];
                key_pos = pos_s[c];
              }
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                bool seen;
                if constexpr (SEG)
                  seen = key_ok & (rows[r] < sq) & (seg_row[r] == key_seg) &
                         (!causal | (pos_row[r] >= key_pos));
                else
                  seen = key_ok & (!causal | (j0 + c <= rows[r] + off));
                const int i = 4 * jj + 2 * r + e;
                s[i] = seen ? s[i] : -INFINITY;
              }
            }
          }
        }
        // P = exp(scale S - lse), each row its own lse
#pragma unroll
        for (int i = 0; i < 64; ++i)
          s[i] = ex2(fmaf(s[i], a.scale_log2, -lse2[(i >> 1) & 1]));
        wgmma_wait<0>();  // dP has landed
        fence_regs(dp);
        // dS = P (dP - delta) from the unrounded P, rounded to E, already
        // in the A operand's layout
        uint32_t ds16[32];
#pragma unroll
        for (int m = 0; m < 32; ++m)
          ds16[m] = pack16<E>(s[2 * m] * (dp[2 * m] - dl[m & 1]),
                              s[2 * m + 1] * (dp[2 * m + 1] - dl[m & 1]));
        // dQ += dS K: 8 k-steps of 16 keys, K the MN-major B operand
        const uint64_t k_mn = sw128_desc(Kt, kBlock128, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKStep / 16; ++kk) {
          const uint32_t frag[4] = {ds16[4 * kk], ds16[4 * kk + 1],
                                    ds16[4 * kk + 2], ds16[4 * kk + 3]};
          if constexpr (D == 128)
            wgmma_rs_n128<E>(dq, frag, k_mn + kk * (2048 >> 4));
          else
            wgmma_rs_n64<E>(dq, frag, k_mn + kk * (2048 >> 4));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        mbar_arrive(&empty[st]);
      }
      // this tile's last products are done: the producer may load the next
      // Q and dO
      mbar_arrive(q_empty);

      // epilogue: dQ = scale dS K, from the registers
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] *= a.scale;
      size_t row_off[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        row_off[r] = (((size_t)t.b * sq + rows[r]) * a.hq + t.h) * D + col_in;
      store_rows<E, D, ACC>(a.out0, row_off, rows, sq, dq);
    }
  }
}

// -- launches -----------------------------------------------------------------

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return err;
}

Args make_args(void* out0, void* out1, const void* lse, const void* delta,
               int batch, int sq, int sk, int hq, int hkv, int causal,
               float scale, Segments segs) {
  return Args{out0,  out1,  static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              batch, sq,    sk,
              hq,    hq / hkv, causal,
              scale, scale * kLog2e, segs};
}

template <typename E, int D, bool SEG, bool ACC>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int batch, int sq, int sk, int hq,
                        int hkv, int causal, float scale, Segments segs,
                        cudaStream_t stream) {
  const size_t n_rows = (size_t)batch * hq * sq;
  CUtensorMap q_map, do_map, k_map, v_map, lse_map, delta_map, seg_q_map,
      pos_q_map, seg_k_map, pos_k_map;
  cudaError_t err = paddle_layout_map<E>(&q_map, q, batch, sq, hq, D, kQStep);
  if (err == cudaSuccess)
    err = paddle_layout_map<E>(&do_map, dout, batch, sq, hq, D, kQStep);
  if (err == cudaSuccess)
    err = paddle_layout_map<E>(&k_map, k, batch, sk, hkv, D, kKeys);
  if (err == cudaSuccess)
    err = paddle_layout_map<E>(&v_map, v, batch, sk, hkv, D, kKeys);
  const int row_box = kQStep + kRowSlack;
  if (err == cudaSuccess) err = float32_map(&lse_map, lse, n_rows, row_box);
  if (err == cudaSuccess)
    err = float32_map(&delta_map, delta, n_rows, row_box);
  if (SEG && err == cudaSuccess)
    err = int32_map(&seg_q_map, segs.seg_q, (size_t)batch * sq, row_box);
  if (SEG && err == cudaSuccess)
    err = int32_map(&pos_q_map, segs.pos_q, (size_t)batch * sq, row_box);
  if (SEG && err == cudaSuccess)
    err = int32_map(&seg_k_map, segs.seg_k, (size_t)batch * sk,
                    kKeys + kRowSlack);
  if (SEG && err == cudaSuccess)
    err = int32_map(&pos_k_map, segs.pos_k, (size_t)batch * sk,
                    kKeys + kRowSlack);
  if (err != cudaSuccess) return err;
  if (!SEG) seg_q_map = pos_q_map = seg_k_map = pos_k_map = lse_map;
  const size_t smem = DkDvSmem<D, SEG>::kBytes;
  err = cudaFuncSetAttribute(flash_dkdv_hopper<E, D, SEG, ACC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // one block per SM (fewer when there are fewer work tiles)
  const long long n_work =
      (long long)((sk + kKeys - 1) / kKeys) * hkv * batch;
  if (n_work > INT_MAX) return cudaErrorInvalidValue;
  // K1/K2: one block per SM (fewer when there are fewer work tiles); K3:
  // one block per work tile, handed to the SMs as they free, since its
  // work follows its segments
  dim3 grid((unsigned)(SEG || n_work < sms ? n_work : sms), 1, 1);
  flash_dkdv_hopper<E, D, SEG, ACC><<<grid, kThreadsH, smem, stream>>>(
      q_map, do_map, k_map, v_map, lse_map, delta_map, seg_q_map, pos_q_map,
      seg_k_map, pos_k_map,
      make_args(dk, dv, lse, delta, batch, sq, sk, hq, hkv, causal, scale,
                segs));
  return cudaGetLastError();
}

template <typename E, int D, bool SEG, bool ACC>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int batch, int sq, int sk, int hq, int hkv,
                      int causal, float scale, Segments segs,
                      cudaStream_t stream) {
  CUtensorMap q_map, do_map, k_map, v_map, seg_k_map, pos_k_map;
  cudaError_t err = paddle_layout_map<E>(&q_map, q, batch, sq, hq, D, kRows);
  if (err == cudaSuccess)
    err = paddle_layout_map<E>(&do_map, dout, batch, sq, hq, D, kRows);
  if (err == cudaSuccess)
    err = paddle_layout_map<E>(&k_map, k, batch, sk, hkv, D, kKStep);
  if (err == cudaSuccess)
    err = paddle_layout_map<E>(&v_map, v, batch, sk, hkv, D, kKStep);
  if (SEG && err == cudaSuccess)
    err = int32_map(&seg_k_map, segs.seg_k, (size_t)batch * sk,
                    kKStep + kRowSlack);
  if (SEG && err == cudaSuccess)
    err = int32_map(&pos_k_map, segs.pos_k, (size_t)batch * sk,
                    kKStep + kRowSlack);
  if (err != cudaSuccess) return err;
  if (!SEG) seg_k_map = pos_k_map = k_map;  // unread
  const size_t smem = DqSmem<D, SEG>::kBytes;
  err = cudaFuncSetAttribute(flash_dq_hopper<E, D, SEG, ACC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long n_work = (long long)((sq + kRows - 1) / kRows) * hq * batch;
  if (n_work > INT_MAX) return cudaErrorInvalidValue;
  dim3 grid((unsigned)(n_work < sms ? n_work : sms), 1, 1);
  flash_dq_hopper<E, D, SEG, ACC><<<grid, kThreadsH, smem, stream>>>(
      q_map, do_map, k_map, v_map, seg_k_map, pos_k_map,
      make_args(dq, nullptr, lse, delta, batch, sq, sk, hq, hkv, causal,
                scale, segs));
  return cudaGetLastError();
}

}  // namespace hop

// The dtype alone picks the gradient kernels: bf16 and fp16 run the Hopper
// kernels' instances (ACC: adding into f32 sums), f32 the CUDA-core ones
// (which write their own outputs; f32 sums are refused).
struct Grad {
  const void *q, *k, *v, *dout, *lse, *delta;
  void* out0;  // dk (dK/dV) or dq
  void* out1;  // dv (dK/dV)
  int batch, sq, sk, hq, hkv, causal;
  float scale;
  Segments segs;
  cudaStream_t stream;
};

template <typename E, bool DKDV, int D, bool SEG, bool ACC>
cudaError_t run_hopper(const Grad& g) {
  if constexpr (DKDV)
    return hop::launch_dkdv<E, D, SEG, ACC>(
        g.q, g.k, g.v, g.dout, g.lse, g.delta, g.out0, g.out1, g.batch, g.sq,
        g.sk, g.hq, g.hkv, g.causal, g.scale, g.segs, g.stream);
  else
    return hop::launch_dq<E, D, SEG, ACC>(
        g.q, g.k, g.v, g.dout, g.lse, g.delta, g.out0, g.batch, g.sq, g.sk,
        g.hq, g.hkv, g.causal, g.scale, g.segs, g.stream);
}

template <bool DKDV, int D, bool SEG>
cudaError_t run_f32(const Grad& g) {
  if constexpr (DKDV)
    return launch_dkdv_f32<float, D, SEG>(
        g.q, g.k, g.v, g.dout, g.lse, g.delta, g.out0, g.out1, g.batch, g.sq,
        g.sk, g.hq, g.hkv, g.causal, g.scale, g.segs, g.stream);
  else
    return launch_dq_f32<float, D, SEG>(g.q, g.k, g.v, g.dout, g.lse,
                                        g.delta, g.out0, g.batch, g.sq, g.sk,
                                        g.hq, g.hkv, g.causal, g.scale,
                                        g.segs, g.stream);
}

// K3 (SEG) never accumulates: only K6's ring visits do, on K1's entries.
template <typename E, bool DKDV, bool SEG>
cudaError_t run_hopper_typed(int head_dim, bool acc, const Grad& g) {
  if (!acc) {
    if (head_dim == 64) return run_hopper<E, DKDV, 64, SEG, false>(g);
    if (head_dim == 128) return run_hopper<E, DKDV, 128, SEG, false>(g);
  } else if constexpr (!SEG) {
    if (head_dim == 64) return run_hopper<E, DKDV, 64, false, true>(g);
    if (head_dim == 128) return run_hopper<E, DKDV, 128, false, true>(g);
  }
  return cudaErrorInvalidValue;
}

template <bool DKDV, bool SEG>
cudaError_t run_grad(int dtype, int head_dim, bool acc, const Grad& g) {
  if (dtype == kBFloat16)
    return run_hopper_typed<__nv_bfloat16, DKDV, SEG>(head_dim, acc, g);
  if (dtype == kFloat16)
    return run_hopper_typed<__half, DKDV, SEG>(head_dim, acc, g);
  if (dtype == kFloat32 && !acc) {
    if (head_dim == 64) return run_f32<DKDV, 64, SEG>(g);
    if (head_dim == 128) return run_f32<DKDV, 128, SEG>(g);
  }
  return cudaErrorInvalidValue;
}

// K1/K2's causal rule needs sq <= sk; K3's is per segment (causal 0 here).
bool bad_shape(int batch, int sq, int sk, int hq, int hkv, int causal) {
  return batch < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 ||
         hq > 65535 || batch > 65535 || (causal && sq > sk);
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
// 1 bf16, 2 fp16) for the tensors in the paddle layout. Each launches on
// `stream`, allocates nothing and returns cudaGetLastError().

// delta = rowsum(dout * out) in f32.
extern "C" int flash_attention_bwd_delta_launch(const void* out,
                                                const void* dout, void* delta,
                                                int batch, int seq_q,
                                                int num_q_heads, int head_dim,
                                                int dtype, void* stream) {
  if (batch < 1 || seq_q < 1 || num_q_heads < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && head_dim == 64)
    return launch_delta<float, 64>(out, dout, delta, batch, seq_q,
                                   num_q_heads, s);
  if (dtype == kFloat32 && head_dim == 128)
    return launch_delta<float, 128>(out, dout, delta, batch, seq_q,
                                    num_q_heads, s);
  if (dtype == kBFloat16 && head_dim == 64)
    return launch_delta<__nv_bfloat16, 64>(out, dout, delta, batch, seq_q,
                                           num_q_heads, s);
  if (dtype == kBFloat16 && head_dim == 128)
    return launch_delta<__nv_bfloat16, 128>(out, dout, delta, batch, seq_q,
                                            num_q_heads, s);
  if (dtype == kFloat16 && head_dim == 64)
    return launch_delta<__half, 64>(out, dout, delta, batch, seq_q,
                                    num_q_heads, s);
  if (dtype == kFloat16 && head_dim == 128)
    return launch_delta<__half, 128>(out, dout, delta, batch, seq_q,
                                     num_q_heads, s);
  return cudaErrorInvalidValue;
}

// dk, dv from the forward's lse and the delta pass. `accumulate` (bf16 and
// fp16 only): dk and dv are f32 sums of k's shape that the kernel adds the
// gradients to (K6's ring visits) instead of writing them in the input
// dtype.
extern "C" int flash_attention_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int seq_q, int seq_k, int num_q_heads, int num_kv_heads, int head_dim,
    int causal, float scale, int dtype, int accumulate, void* stream) {
  if (bad_shape(batch, seq_q, seq_k, num_q_heads, num_kv_heads, causal))
    return cudaErrorInvalidValue;
  const Grad g{q, k, v, dout, lse, delta, dk, dv, batch, seq_q, seq_k,
               num_q_heads, num_kv_heads, causal, scale,
               ptt::flash::Segments{}, static_cast<cudaStream_t>(stream)};
  return run_grad<true, false>(dtype, head_dim, accumulate != 0, g);
}

// dq from the forward's lse and the delta pass; `accumulate` as above, dq
// an f32 sum of q's shape.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int seq_q,
    int seq_k, int num_q_heads, int num_kv_heads, int head_dim, int causal,
    float scale, int dtype, int accumulate, void* stream) {
  if (bad_shape(batch, seq_q, seq_k, num_q_heads, num_kv_heads, causal))
    return cudaErrorInvalidValue;
  const Grad g{q, k, v, dout, lse, delta, dq, nullptr, batch, seq_q, seq_k,
               num_q_heads, num_kv_heads, causal, scale,
               ptt::flash::Segments{}, static_cast<cudaStream_t>(stream)};
  return run_grad<false, false>(dtype, head_dim, accumulate != 0, g);
}

// K3 entries (K3's delta is flash_attention_bwd_delta_launch). seg_q/pos_q
// [batch, seq_q] and seg_k/pos_k [batch, seq_k] int32, as
// flash_attention_seg_fwd_launch; any seq_q, seq_k.

// dk, dv; query_ranges [batch, ceil(seq_k / 64), 2] int32, the 64-row query
// tiles [lo, hi) that can see each 64-key tile.
extern "C" int flash_attention_seg_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* seg_q,
    const void* pos_q, const void* seg_k, const void* pos_k,
    const void* query_ranges, int batch, int seq_q, int seq_k,
    int num_q_heads, int num_kv_heads, int head_dim, int causal, float scale,
    int dtype, void* stream) {
  if (bad_shape(batch, seq_q, seq_k, num_q_heads, num_kv_heads, 0))
    return cudaErrorInvalidValue;
  const Grad g{q, k, v, dout, lse, delta, dk, dv, batch, seq_q, seq_k,
               num_q_heads, num_kv_heads, causal, scale,
               segments(seg_q, pos_q, seg_k, pos_k, query_ranges),
               static_cast<cudaStream_t>(stream)};
  return run_grad<true, true>(dtype, head_dim, false, g);
}

// dq; key_ranges [batch, ceil(seq_q / 64), 2] int32, as the forward's.
extern "C" int flash_attention_seg_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* seg_q,
    const void* pos_q, const void* seg_k, const void* pos_k,
    const void* key_ranges, int batch, int seq_q, int seq_k, int num_q_heads,
    int num_kv_heads, int head_dim, int causal, float scale, int dtype,
    void* stream) {
  if (bad_shape(batch, seq_q, seq_k, num_q_heads, num_kv_heads, 0))
    return cudaErrorInvalidValue;
  const Grad g{q, k, v, dout, lse, delta, dq, nullptr, batch, seq_q, seq_k,
               num_q_heads, num_kv_heads, causal, scale,
               segments(seg_q, pos_q, seg_k, pos_k, key_ranges),
               static_cast<cudaStream_t>(stream)};
  return run_grad<false, true>(dtype, head_dim, false, g);
}
