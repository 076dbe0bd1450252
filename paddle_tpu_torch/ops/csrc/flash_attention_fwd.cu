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
// What bounds it on the H100: the products, 4 D flops per visible (query,
// key) pair and head, against 989 TFLOP/s bf16; Q, K, V and O move far
// fewer bytes than the tensor cores need time (0.0695 ms of products
// against 0.0100 ms of bytes at B 2, S 2048, 32 heads of 128, causal).
//
// Design (bf16 or fp16, an instance each; D 64 or 128): work tiles of (128
// query rows, query head, batch), walked by a persistent grid of one block
// of three warpgroups per SM (161 KB of shared memory at D 128). Query head
// h reads kv head h / group, which is all GQA needs: no expanded K/V.
// - Warpgroup 2 produces: after setmaxnreg lowers it to 40 registers, one
//   thread loads each work tile's Q and then its K/V tiles of 128 keys into
//   a ring of two stages with TMA (tensor maps over the paddle layout,
//   dims (D, H, S, B), boxes of 64 elements x 128 rows, 128-byte swizzle;
//   rows past Sq or Sk arrive as zeros), each stage guarded by full
//   barriers (K and V apart, counted in bytes) and an empty barrier the
//   consumers release. The ring runs on across work tiles, and the next
//   tile's Q loads as soon as the consumers have read the last one, so a
//   tile's epilogue overlaps the next one's loads.
// - Warpgroups 0 and 1 consume, 64 query rows each: S = Q K^T as wgmma
//   m64n128k16 from shared memory (both operands K-major), the f32 scores
//   in registers; the mask on the tiles that need it; the online softmax in
//   registers (row max and sum by two shuffles among a row's four threads,
//   scale * log2(e) folded into one FMA before exp2); P rounded to the
//   storage type (as the TPU kernel rounds p to q's dtype before its P.V
//   product) and fed as the register
//   A operand of O += P V (wgmma m64nDk16, V the transposed B operand from
//   shared memory); O rescaled in registers. The row sum is over the
//   unrounded p. No S, P or per-row factor goes through shared memory, and
//   the warpgroups synchronise only through the barriers, so one's softmax
//   overlaps the other's products. A warpgroup runs its own tile's S,
//   softmax and P.V in turn: issuing a tile's S beside the previous tile's
//   P.V needs S, O and that P live at once (160 registers a thread) beside
//   the loop's state; a trial of it spilled 128-224 bytes and took twice
//   the time, so that pipelining is later work. (ptxas does compile the
//   consumers to setmaxnreg's budget: the backward's dK/dV kernel spills
//   at 232 registers and not at 240.)
// - Order: work tiles are numbered batch, head, query tile, so the tiles
//   in flight share a few heads' K/V in L2. Block i walks tiles i, i +
//   grid, i + 2 grid, ..., so blocks and launches share no state; under
//   K1/K2's causal mask a head's heavy and light query tiles are placed
//   so that each block's stride meets them in pairs (work_tile). Tiles
//   drawn from a counter in device memory measured no faster on an H100.
// - The mask is a policy: K1/K2 mask only the tiles that cross a
//   warpgroup's causal diagonal or run past Sk (tiles wholly past the
//   diagonal are never loaded); K3 masks every tile it visits by the
//   segment and position compare, the key ids and positions loaded per
//   stage by TMA beside K, and visits only the key tiles its query tile's
//   segments can see (the 64-unit range table of the backward kernels,
//   converted per block: the union of its two 64-row entries, lo / 2 and
//   ceil(hi / 2)); a warpgroup whose own 64 rows see none of a visited
//   key tile (its own 64-row entry) skips that tile's products.
// - The epilogue is a policy: K1/K2/K3 write O (bf16 or fp16) and lse from
//   the registers; K6 merges into the ring's running state (below).
//
// K6 (RING): the same tile loop for one ring visit (causal = the diagonal
// visit, bottom-right aligned with Sq == Sk; a full visit passes causal 0).
// Only the epilogue differs: instead of writing a fresh O and lse, each
// thread merges its rows into the running state of the ring, an f32 output
// o_acc [B, Sq, Hq, D] (normalized) and lse_acc [B, Hq, Sq]:
//   lse' = logaddexp(lse_acc, lse_v)
//   o'   = o_acc * exp(lse_acc - lse') + o_v * exp(lse_v - lse'),
// the visit's o_v never leaving registers (its factor exp(m - lse') / l
// folds into the final row scale). Each block owns its rows, as in K1, so
// the merge needs no atomics and costs one f32 read and write of O per
// visit, where the reference's _online_merge is a separate XLA pass. The
// first visit reads no state (no -inf - -inf); the last writes o' in the
// input type to `out` instead of o_acc, so no cast pass follows the ring.
//
// f32 runs the earlier CUDA-core tile loop (64-row tiles, shared-memory
// scores), kept as the correctness witness of the f32 phases; the dtype
// alone picks the loop. cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint (hopper.cuh), so no -lcuda is linked.

#include <climits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace ptt;
using namespace ptt::flash;

// K6's running state (RING kernels only).
struct Ring {
  float* o_acc;  // [B, Sq, Hq, D] f32; null when this visit is first and last
  int first;     // the state holds nothing yet: read none of it
};

template <int D>
struct F32Smem {
  static constexpr int kPD = D + kPad;    // pitch of a D-wide tile
  static constexpr int kPS = kBc + kPad;  // pitch of a score tile
  static constexpr size_t kQ = aligned(sizeof(float) * kBr * kPD);
  static constexpr size_t kKV = aligned(sizeof(float) * kBc * kPD);
  static constexpr size_t kS = aligned(sizeof(float) * kBr * kPS);
  static constexpr size_t kBcast = aligned(sizeof(float) * kBr * kBcastLd);
  static constexpr size_t kRow = aligned(sizeof(float) * kBr);
  // the K and V tiles (adjacent) stage the f32 output tile at the end
  static_assert(2 * kKV >= sizeof(float) * kBr * kPD, "output staging");
  static constexpr size_t kBytes = kQ + 2 * kKV + kS + kBcast + 2 * kRow;
};

// The f32 forward on CUDA cores (the correctness witness of the f32
// phases). RING: `lse` is the ring's lse_acc (read unless first, always
// written) and `out` is null except on the ring's last visit.
template <int D, bool SEG, bool RING>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int sq, int sk, int group,
                  bool causal, float scale, Segments segs, Ring ring) {
  using L = F32Smem<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  float* Qs = reinterpret_cast<float*>(carve(p, L::kQ));
  float* Ks = reinterpret_cast<float*>(carve(p, L::kKV));
  float* Vs = reinterpret_cast<float*>(carve(p, L::kKV));
  float* Ss = reinterpret_cast<float*>(carve(p, L::kS));
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
  const float* qb = q + ((size_t)b * sq * hq + h) * D;
  const float* kb = k + ((size_t)b * sk * hkv + hk) * D;
  const float* vb = v + ((size_t)b * sk * hkv + hk) * D;

  load_tile<float, D, kBr>(Qs, qb, i0, sq, q_stride);
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
  Acc<float, kBr, D> o;  // the output tile, in registers across all K/V tiles
  o.zero();

  for (int jt = t_lo; jt < t_hi; ++jt) {
    const int j0 = jt * kBc;
    __syncthreads();  // the previous tile's K, V, P, factors, ids consumed
    load_tiles<float, D, kBc>(Ks, kb, Vs, vb, j0, sk, k_stride);
    if constexpr (SEG)
      load_ids<kBc>(ids->seg_k, ids->pos_k, segs.seg_k + (size_t)b * sk,
                    segs.pos_k + (size_t)b * sk, j0, sk);
    __syncthreads();
    {
      Acc<float, kBr, kBc> s;
      s.zero();
      s.template mma<false, true, D>(Qs, L::kPD, Ks, L::kPD);
      s.store(Ss, L::kPS);
    }
    __syncthreads();
    // online softmax: each warp owns kBr / kWarps rows, a lane two
    // columns; P overwrites S
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
        Ss[r * L::kPS + lane + 32 * c] = pv;
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
    o.template mma<false, false, kBc>(Ss, L::kPS, Vs, L::kPD);
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
        out[off] = x;
      else
        ring.o_acc[off] = x;
    }
  } else {
    store_tile<float, D, kBr>(out + base, stage, i0, sq, q_stride);
  }
}

// -- the bf16 and fp16 forward: TMA, wgmma, warp specialisation --------------

namespace hop {

using namespace ptt::hopper;

constexpr int kRows = 128;      // query rows a work tile: two warpgroups of 64
constexpr int kKeys = 128;      // keys per K/V tile
constexpr int kStages = 2;      // K/V tiles in flight
constexpr int kConsumers = 256;          // the two consumer warpgroups
constexpr int kThreadsH = kConsumers + 128;  // + the producer warpgroup
// one 64-element column block of a 128-row tile (128 bytes a row)
constexpr int kBlockBytes = 128 * 128;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory, offsets from a 1024-byte aligned base: the Q tile, the
// K and V stages (each D / 64 column blocks of 128 rows), K3's key ids
// per stage, then the barriers.
template <int D, bool SEG>
struct Smem {
  static constexpr int kTile = D / 64 * kBlockBytes;  // Q, K or V tile
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kIds = kV + kStages * kTile;
  // K3's seg_k, pos_k: boxes of kKeys + kRowSlack values (tma_load_row)
  static constexpr int kIdBox = (kKeys + kRowSlack) * 4;
  static constexpr int kIdArr = (kIdBox + 127) / 128 * 128;
  static constexpr int kIdsStage = SEG ? 2 * kIdArr : 0;
  static constexpr int kBars = kIds + kStages * kIdsStage;
  // q_full, q_empty, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kNumBars = 2 + 3 * kStages;
  // 161 KB at D 128. At least 116 KB, so that no two blocks share an SM:
  // the consumers' 232 registers take the whole register file.
  static constexpr size_t kBytes =
      1024 + kBars + 8 * kNumBars > 116 * 1024 ? 1024 + kBars + 8 * kNumBars
                                                : 116 * 1024;
};

struct Args {
  void* out;           // E; RING: null except on the ring's last visit
  float* lse;          // RING: the ring's lse_acc
  int batch, sq, sk, hq, group, causal;
  float scale_log2;    // scale * log2(e): the softmax runs in base 2
  Segments segs;
  Ring ring;
};

// The key tiles [lo, hi) a work tile visits: K1/K2 up to the causal limit
// of its last row (tiles wholly past the diagonal are never loaded), K3
// those its segments can see.
template <bool SEG>
__device__ __forceinline__ int2 key_tiles(const Args& a, const Work& w) {
  if constexpr (SEG) {
    return seg_key_tiles(a.segs.ranges, w.b, w.qt, a.sq, a.sk);
  } else {
    const int last_row = min((w.qt + 1) * kRows, a.sq) - 1;
    const int n_keys =
        a.causal ? min(a.sk, last_row + a.sk - a.sq + 1) : a.sk;
    return make_int2(0, (n_keys + kKeys - 1) / kKeys);
  }
}

// Persistent: one block per SM walks work tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... Warpgroups 0 and 1 consume (64 query rows each),
// warpgroup 2 produces (one thread issues the TMA loads, one work tile's Q
// at a time beside the K/V ring). K3 also takes the key ids and positions
// ([B, Sk] int32, flattened) as 1-D tensor maps with boxes of 128 +
// kRowSlack (tma_load_row, hopper.cuh); other kernels ignore those two
// maps. E, the element type of Q, K, V and O: __nv_bfloat16 or __half.
template <typename E, int D, bool SEG, bool RING>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap seg_k_map,
                     const __grid_constant__ CUtensorMap pos_k_map, Args a) {
  using L = Smem<D, SEG>;
  unsigned char* base = aligned_smem();
  unsigned char* Qs = base;
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
    // -- producer: TMA loads of each work tile's Q and of the K/V ring -----
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      int it = 0;  // K/V tiles loaded so far, over all work tiles
      for (int w = blockIdx.x, wi = 0; w < n_work; w += gridDim.x, ++wi) {
        // the consumers are done with the previous tile's Q
        mbar_wait(q_empty, (wi & 1) ^ 1);
        const Work t = work_tile<SEG>(w, n_qt, a.hq, a.causal);
        const int2 kt = key_tiles<SEG>(a, t);
        const int hk = t.h / a.group;
        mbar_arrive_expect_tx(q_full, L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(Qs + c * kBlockBytes, &q_map, q_full, 64 * c, t.h,
                      t.qt * kRows, t.b);
        for (int jt = kt.x; jt < kt.y; ++jt, ++it) {
          const int st = it % kStages;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          const int j0 = jt * kKeys;
          unsigned char* Kt = base + L::kK + st * L::kTile;
          unsigned char* Vt = base + L::kV + st * L::kTile;
          // K3: the tile's key ids and positions ride on K's barrier (keys
          // past Sk read the next row's ids or zeros: the mask drops them)
          mbar_arrive_expect_tx(&k_full[st],
                                L::kTile + (SEG ? 2 * L::kIdBox : 0));
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            tma_load_4d(Kt + c * kBlockBytes, &k_map, &k_full[st], 64 * c,
                        hk, j0, t.b);
          if constexpr (SEG) {
            unsigned char* ids = base + L::kIds + st * L::kIdsStage;
            tma_load_row(ids, &seg_k_map, &k_full[st], t.b * sk + j0);
            tma_load_row(ids + L::kIdArr, &pos_k_map, &k_full[st],
                         t.b * sk + j0);
          }
          mbar_arrive_expect_tx(&v_full[st], L::kTile);
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            tma_load_4d(Vt + c * kBlockBytes, &v_map, &v_full[st], 64 * c,
                        hk, j0, t.b);
        }
      }
    }
  } else {
    // -- consumers: S = Q K^T, softmax and O += P V in registers ------------
    reg_alloc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x & 127) >> 5;
    const int lane = threadIdx.x & 31;
    const int col_in = 2 * (lane & 3);  // first column in each 8-col chunk
    const int off = sk - sq;  // K1/K2: row i sees keys j <= i + off
    const unsigned char* Qw = Qs + 64 * 128 * wg;  // this warpgroup's rows
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    int it = 0;  // K/V tiles consumed so far, over all work tiles
    for (int w = blockIdx.x, wi = 0; w < n_work; w += gridDim.x, ++wi) {
      mbar_wait(q_full, wi & 1);
      const Work t = work_tile<SEG>(w, n_qt, a.hq, a.causal);
      const int2 kt = key_tiles<SEG>(a, t);
      const int b = t.b;
      const int h = t.h;
      const int wg_row = t.qt * kRows + 64 * wg;
      // this thread's two rows
      const int rows[2] = {wg_row + 16 * warp + (lane >> 2),
                           wg_row + 16 * warp + (lane >> 2) + 8};
      int seg_row[2] = {0, 0};
      int pos_row[2] = {0, 0};
      if constexpr (SEG) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < sq) {
            seg_row[r] = a.segs.seg_q[(size_t)b * sq + rows[r]];
            pos_row[r] = a.segs.pos_q[(size_t)b * sq + rows[r]];
          }
      }
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      // K3: the 64-key tiles [own_lo, own_hi) this warpgroup's own 64 rows
      // can see (its 64-row tile's key_ranges entry): a key tile outside
      // them skips its products
      int own_lo = 0;
      int own_hi = INT_MAX;
      if constexpr (SEG) {
        const int u = 2 * t.qt + wg;
        const int n_own = (sq + 63) / 64;
        const int2 rg = u < n_own ? tile_range(a.segs.ranges, b, n_own, u,
                                               (sk + 63) / 64)
                                  : make_int2(0, 0);
        own_lo = rg.x;
        own_hi = rg.y;
      }
      float m[2] = {-INFINITY, -INFINITY};  // row max of scores x scale_log2
      float l[2] = {0.f, 0.f};  // this thread's share of the row sums

      for (int jt = kt.x; jt < kt.y; ++jt, ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int j0 = jt * kKeys;
        const unsigned char* Kt = base + L::kK + st * L::kTile;
        const unsigned char* Vt = base + L::kV + st * L::kTile;
        mbar_wait(&k_full[st], ph);
        if (SEG && (2 * jt + 2 <= own_lo || 2 * jt >= own_hi)) {
          mbar_wait(&v_full[st], ph);
          mbar_arrive(&empty[st]);
          continue;
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const int cb = (ks / 4) * kBlockBytes + (ks % 4) * 32;
          wgmma_ss_n128<E>(s, sw128_desc(Qw + cb, 16, 1024),
                           sw128_desc(Kt + cb, 16, 1024), ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // the mask, without branches: K3 on every tile; K1/K2 where the
        // tile crosses this warpgroup's causal diagonal or runs past Sk
        bool masked;
        if constexpr (SEG)
          masked = true;
        else
          masked = j0 + kKeys > sk ||
                   (a.causal && j0 + kKeys - 1 > wg_row + off);
        if (masked) {
          // K3's key ids from their box's unaligned start (tma_load_row)
          const int* seg_s =
              reinterpret_cast<const int*>(base + L::kIds +
                                           st * L::kIdsStage) +
              ((t.b * sk + j0) & 3);
          const int* pos_s = seg_s + L::kIdArr / 4;
          const bool causal = a.causal;
#pragma unroll
          for (int jj = 0; jj < kKeys / 8; ++jj) {
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

        // online softmax in base 2: one FMA folds the scale into exp2's
        // argument; a row with no key yet keeps max -inf and p = 0
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 64; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float corr[2];
        float shift[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * a.scale_log2);
          corr[r] = m[r] == -INFINITY ? 0.f : ex2(m[r] - m_new);
          shift[r] = m_new == -INFINITY ? 0.f : m_new;
          m[r] = m_new;
          l[r] *= corr[r];
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          s[i] = ex2(fmaf(s[i], a.scale_log2, -shift[r]));
          l[r] += s[i];  // the sum is over the unrounded p
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        // P rounded to E (as the TPU kernel rounds p to q's dtype before
        // P.V), already in the A operand's layout
        uint32_t p16[32];
#pragma unroll
        for (int i = 0; i < 32; ++i)
          p16[i] = pack16<E>(s[2 * i], s[2 * i + 1]);

        mbar_wait(&v_full[st], ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          const uint32_t frag[4] = {p16[4 * kk], p16[4 * kk + 1],
                                    p16[4 * kk + 2], p16[4 * kk + 3]};
          const uint64_t dv = sw128_desc(Vt + kk * 2048, kBlockBytes, 1024);
          if constexpr (D == 128)
            wgmma_rs_n128<E>(o, frag, dv);
          else
            wgmma_rs_n64<E>(o, frag, dv);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&empty[st]);
      }
      // this tile's last S is done: the producer may load the next Q
      mbar_arrive(q_empty);

      // epilogue: the rows' sums over their four threads, then O and lse
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const size_t lse_row = ((size_t)b * a.hq + h) * sq;
      if constexpr (!RING) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (rows[r] >= sq) continue;
          const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
          E* orow = static_cast<E*>(a.out) +
                    (((size_t)b * sq + rows[r]) * a.hq + h) * D + col_in;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            store_pair<E>(orow + 8 * j, o[4 * j + 2 * r] * inv,
                          o[4 * j + 2 * r + 1] * inv);
          if ((lane & 3) == 0)
            a.lse[lse_row + rows[r]] =
                l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : -INFINITY;
        }
      } else {
        // K6: merge into the ring's running state. lse' =
        // logaddexp(lse_acc, lse_v); o' = o_acc exp(lse_acc - lse') + o_v
        // exp(lse_v - lse'), where o_v exp(lse_v - lse') is the
        // unnormalized O times exp(m - lse'). Every thread reads the row's
        // lse_acc before one of its four threads writes lse'.
        float merged[2];
        float keep[2];
        float add[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool ok = rows[r] < sq;
          const float mr = m[r] * kLn2;
          const float lv = l[r] > 0.f ? mr + logf(l[r]) : -INFINITY;
          const float la =
              a.ring.first || !ok ? -INFINITY : a.lse[lse_row + rows[r]];
          const float mx = fmaxf(la, lv);
          merged[r] = -INFINITY;
          keep[r] = 0.f;
          add[r] = 0.f;
          if (mx != -INFINITY) {
            merged[r] = mx + logf(expf(la - mx) + expf(lv - mx));
            keep[r] = la == -INFINITY ? 0.f : expf(la - merged[r]);
            add[r] = l[r] > 0.f ? expf(mr - merged[r]) : 0.f;
          }
        }
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (rows[r] >= sq) continue;
          if ((lane & 3) == 0) a.lse[lse_row + rows[r]] = merged[r];
          const size_t row_off =
              (((size_t)b * sq + rows[r]) * a.hq + h) * D + col_in;
          // the row's state, every load issued before the first store
          float2 acc[D / 8];
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            acc[j] = a.ring.first ? make_float2(0.f, 0.f)
                                  : *reinterpret_cast<const float2*>(
                                        a.ring.o_acc + row_off + 8 * j);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            float2 x = make_float2(o[4 * j + 2 * r] * add[r],
                                   o[4 * j + 2 * r + 1] * add[r]);
            x.x = fmaf(keep[r], acc[j].x, x.x);
            x.y = fmaf(keep[r], acc[j].y, x.y);
            if (a.out != nullptr)
              store_pair<E>(static_cast<E*>(a.out) + row_off + 8 * j, x.x,
                            x.y);
            else
              *reinterpret_cast<float2*>(a.ring.o_acc + row_off + 8 * j) =
                  x;
          }
        }
      }
    }
  }
}

template <typename E, int D, bool SEG, bool RING>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int sq, int sk, int hq, int group,
                   int causal, float scale, Segments segs, Ring ring,
                   cudaStream_t stream) {
  const int hkv = hq / group;
  CUtensorMap q_map, k_map, v_map, seg_k_map, pos_k_map;
  cudaError_t err = paddle_layout_map<E>(&q_map, q, batch, sq, hq, D, kRows);
  if (err == cudaSuccess)
    err = paddle_layout_map<E>(&k_map, k, batch, sk, hkv, D, kKeys);
  if (err == cudaSuccess)
    err = paddle_layout_map<E>(&v_map, v, batch, sk, hkv, D, kKeys);
  if (SEG && err == cudaSuccess)
    err = int32_map(&seg_k_map, segs.seg_k, (size_t)batch * sk,
                    kKeys + kRowSlack);
  if (SEG && err == cudaSuccess)
    err = int32_map(&pos_k_map, segs.pos_k, (size_t)batch * sk,
                    kKeys + kRowSlack);
  if (err != cudaSuccess) return err;
  if (!SEG) seg_k_map = pos_k_map = k_map;  // unread
  const size_t smem = Smem<D, SEG>::kBytes;
  err = cudaFuncSetAttribute(flash_fwd_hopper<E, D, SEG, RING>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const Args args{out,
                  static_cast<float*>(lse),
                  batch,
                  sq,
                  sk,
                  hq,
                  group,
                  causal,
                  scale * 1.4426950408889634f,
                  segs,
                  ring};
  int device = 0;
  int sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // one block per SM (fewer when there are fewer work tiles)
  const long long n_work = (long long)((sq + kRows - 1) / kRows) * hq * batch;
  if (n_work > INT_MAX) return cudaErrorInvalidValue;
  dim3 grid((unsigned)(n_work < sms ? n_work : sms), 1, 1);
  flash_fwd_hopper<E, D, SEG, RING><<<grid, kThreadsH, smem, stream>>>(
      q_map, k_map, v_map, seg_k_map, pos_k_map, args);
  return cudaGetLastError();
}

}  // namespace hop

template <int D, bool SEG, bool RING>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       void* lse, int batch, int sq, int sk, int hq,
                       int group, int causal, float scale, Segments segs,
                       Ring ring, cudaStream_t stream) {
  const size_t smem =
      F32Smem<D>::kBytes + (SEG ? aligned(sizeof(SegTile)) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D, SEG, RING>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBr - 1) / kBr, hq, batch);
  flash_fwd_f32<D, SEG, RING><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), sq, sk, group, causal != 0, scale, segs,
      ring);
  return cudaGetLastError();
}

// The dtype alone picks the loop: bf16 and fp16 run the Hopper kernel's
// instances, f32 the CUDA-core one.
template <bool SEG, bool RING = false>
cudaError_t launch_typed(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, void* out, void* lse,
                         int batch, int sq, int sk, int hq, int hkv,
                         int causal, float scale, Segments segs,
                         void* stream, Ring ring = Ring{nullptr, 1}) {
  if (hkv < 1 || hq % hkv != 0 || batch < 1 || sq < 1 || sk < 1 ||
      hq > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  const int group = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && head_dim == 64)
    return launch_f32<64, SEG, RING>(q, k, v, out, lse, batch, sq, sk, hq,
                                     group, causal, scale, segs, ring, s);
  if (dtype == kFloat32 && head_dim == 128)
    return launch_f32<128, SEG, RING>(q, k, v, out, lse, batch, sq, sk, hq,
                                      group, causal, scale, segs, ring, s);
  if (dtype == kBFloat16 && head_dim == 64)
    return hop::launch<__nv_bfloat16, 64, SEG, RING>(
        q, k, v, out, lse, batch, sq, sk, hq, group, causal, scale, segs,
        ring, s);
  if (dtype == kBFloat16 && head_dim == 128)
    return hop::launch<__nv_bfloat16, 128, SEG, RING>(
        q, k, v, out, lse, batch, sq, sk, hq, group, causal, scale, segs,
        ring, s);
  if (dtype == kFloat16 && head_dim == 64)
    return hop::launch<__half, 64, SEG, RING>(q, k, v, out, lse, batch, sq,
                                              sk, hq, group, causal, scale,
                                              segs, ring, s);
  if (dtype == kFloat16 && head_dim == 128)
    return hop::launch<__half, 128, SEG, RING>(q, k, v, out, lse, batch, sq,
                                               sk, hq, group, causal, scale,
                                               segs, ring, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entries for ctypes. q/out [batch, seq_q, num_q_heads, head_dim] and
// k/v [batch, seq_k, num_kv_heads, head_dim], contiguous, one dtype (0 f32,
// 1 bf16, 2 fp16), 16-byte aligned; lse [batch, num_q_heads, seq_q] f32.
// num_kv_heads must divide num_q_heads. Each launches on `stream`,
// allocates nothing and returns cudaGetLastError().

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
