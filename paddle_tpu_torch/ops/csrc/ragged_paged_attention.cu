// K4: ragged paged attention, hand-written for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/ragged_paged_attention.py::_ragged_pallas and its
// body _ragged_kernel, the Pallas TPU kernel of the mixed prefill+decode
// dispatch.
//
// Computes attention for a packed query stream q[T, Hq, D]: row b owns the
// tokens cu_q_lens[b] .. cu_q_lens[b+1] (q_len tokens), and its token at
// position q_pos sees the kv positions < kv_lens[b] - q_len + q_pos + 1 of
// the row, read from the pool [Hkv, num_pages, page_size, D] through
// page_indices[b, :]. kv_lens counts the tokens after this step's writes.
// Query head hq reads kv head hq / group (GQA). cu_q_lens[0] must be 0.
// The pool is int8 (codes and one f32 scale per row, K4-int8) or q's type
// (bf16 or f32).
//
// The TPU kernel walks rows one after another through a sequential grid
// into one shared VMEM accumulator. Blocks on Hopper run in no order, so
// here every block owns its output outright.
//
// What bounds it on the H100: bytes. A live K/V row costs D + 4 bytes in
// int8, 2 D in bf16, 4 D in f32; at the mixed dispatch's shapes (six
// decode rows and a 256-token chunk over kv ~1100) the products (4.2
// GFLOP, 4.2 us at the bf16 peak) sit under the bytes (144 MB in bf16, 43
// us; 76 MB in int8). The design, one tile kernel for every pool type
// (ragged_tile_kernel<Pool, T, D>) and K5's split kernel:
// - tiles of 64 (token, head) pairs (64 / group tokens with the group's
//   heads together): a 256-token chunk's K/V is read 4 times per head at
//   MHA; the grid numbers the rows' tiles compactly, so that the live ones
//   are dispatched first, and the work tile after them zeroes the pad
//   tokens past cu_q_lens[num_seqs];
// - three groups of four warps take every third step of the tile's walk
//   (32 rows of an int8 or a bf16 pool, 16 of an f32 one, in pieces of 16
//   rows of a page, so that neither the step nor the shared memory grows
//   with the page size) and merge at the end in a fixed order. A group's threads copy
//   their 16-byte chunks of the group's coming steps by cp.async, two steps
//   ahead, while the group works the current one (a producer thread's
//   bulk-copy ring, as K5's, was built here first for int8 and timed
//   slower on the card: 128 blocks each walking 57-69 pages in order want
//   many threads' copies in flight, not one thread's);
// - bf16 q: S = Q.K^T and O += P.V on tensor cores, mma.sync m16n8k16 in
//   bf16 with f32 accumulation, the K and V rows read by ldmatrix from
//   swizzled bf16 rows (16-byte chunk c of row r at c ^ (r % 8)). A bf16
//   pool's chunks land there directly: the step buffers are the copies'
//   ring (three stages a group), with no staging and no conversion pass.
//   An int8 pool's chunks land in staging slots, and the group converts
//   each page once into those rows (exactly: |code| <= 128 has 8
//   significant bits); k_scale / 127.5 multiplies S's columns, v_scale /
//   127.5 P's columns before P rounds to bf16 (as the flash kernels round
//   P). mma.sync and not wgmma: wgmma would need whole 64-key tiles of one
//   kv head, and the products are not the bound even at mma.sync's rate;
// - f32 q (int8 or f32 pools): the same tiles, with the products as f32
//   FMAs on CUDA cores in the same register layout; an f32 pool's rows land
//   unswizzled in a ring of one 16-row piece a step;
// - decode rows (one query token) never walk their pages alone in a tile:
//   the tile kernel skips them, and K5's split-KV kernel (with its merge)
//   takes them, over the same pool type, reading q and writing the output
//   at cu_q_lens[b].

#include <type_traits>

#include "paged_common.cuh"

namespace {

using namespace ptt;
using namespace ptt::hopper;
namespace pg = ptt::paged;

constexpr int kTilePairs = 16 * pg::kConsumerWarps;  // 64 (token, head) pairs

struct TileArgs {
  pg::PoolArgs pool;
  const void* q;
  const int* kv_lens;
  const int* page_indices;
  const int* cu_q_lens;
  void* out;
  int num_tokens, num_seqs, group, bs, pages_per_seq;
  float scale;
};

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

constexpr int kGroups = 3;  // warp groups, each taking every third step
constexpr int kGroupThreads = 32 * 4;
constexpr int kTileThreads = kGroups * kGroupThreads;
constexpr int kPieceRows = 16;  // rows of a piece, every pool type
constexpr int kMaxChunks = 1;  // int8: 16-byte code chunks a thread loads a piece
constexpr int kTileStages = 3;  // steps in flight a group (copies' slots)

// 16-row pieces of a step: two in int8 and bf16, one in f32 (whose rows
// are twice as wide).
template <typename P>
constexpr int kStepPieces = P::kBytes == 4 ? 1 : 2;

// The tile kernel's shared memory: a region per group, then for an f32 q
// the tile's q. An int8 pool's group region holds two step buffers (a
// step's pieces: for a bf16 q, bf16 K rows and then V rows with 16-byte
// chunk c of row r at chunk c ^ (r % 8); for an f32 q, the int8 K rows and
// then V rows; then the step's key factors and value factors, or raw
// scales) and its kTileStages staging slots, into which a thread copies
// its chunks of the group's coming steps (per piece: int8 K and V rows,
// then the scales). A float pool's group region is kTileStages step
// buffers, into which the copies land as the products read them (bf16:
// swizzled as above; f32: plain rows). After its last step, group gi > 0
// hands its accumulators to group 0 in its own region.
template <typename P, typename T, int D>
struct TileSmem {
  static constexpr bool kTC = std::is_same_v<T, __nv_bfloat16>;
  static constexpr int kPieces = kStepPieces<P>;
  static constexpr size_t kRows = kPieceRows;
  // int8: a step buffer, a staging slot (one piece)
  static constexpr size_t kBuffer = kPieces * (4 * kRows * D + 8 * kRows);
  static constexpr size_t kStage = 2 * kRows * D + 8 * kRows;
  // float: a step's K rows and then V rows, 16 kPieces rows each
  static constexpr size_t kStep = 2 * (size_t)kPieces * kRows * D * P::kBytes;
  // >= the exchange's kGroupThreads * (D / 2 + 4) floats
  static constexpr size_t kGroup =
      P::kScaled ? 2 * kBuffer + kTileStages * kPieces * kStage
                 : kTileStages * kStep;
  static constexpr size_t kQs = kGroups * kGroup;
  static constexpr size_t kBytes =
      kQs + (kTC ? 0 : (size_t)kTilePairs * D * sizeof(float));
  static_assert(kGroup >= kGroupThreads * (D / 2 + 4) * sizeof(float),
                "a group region holds the accumulators' exchange");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// An int8 pool: a group thread's share of 16-row piece j of the row
// (positions 16 j .. 16 j + 15, on page pt[16 j / bs]), its 16-byte chunk
// tg of the piece's K and V codes (D chunks a tensor) and its element tg
// of [K scales, V scales], copied asynchronously (cp.async) into the
// staging buffer `st`.
template <int D>
__device__ __forceinline__ void stage_rows(const pg::PoolArgs& pool, int h,
                                           const int* pt, int j, int bs,
                                           int tg, unsigned char* st) {
  constexpr int kChunks = kPieceRows * D / 16;
  static_assert(kChunks <= kMaxChunks * kGroupThreads,
                "a group thread copies at most kMaxChunks chunks");
  const int pos = kPieceRows * j;
  // the piece's first row in the pool
  const size_t row0 =
      ((size_t)h * pool.num_pages + pt[pos / bs]) * bs + pos % bs;
  const unsigned char* kc = static_cast<const unsigned char*>(pool.k) +
                            row0 * D;
  const unsigned char* vc = static_cast<const unsigned char*>(pool.v) +
                            row0 * D;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int idx = tg + kGroupThreads * c;
    if (idx < kChunks) {
      cp_async16(st + 16 * idx, kc + 16 * idx);
      cp_async16(st + 16 * (kChunks + idx), vc + 16 * idx);
    }
  }
  if (tg < 2 * kPieceRows) {
    const float* src = tg < kPieceRows
                           ? pool.k_scales + row0 + tg
                           : pool.v_scales + row0 + tg - kPieceRows;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(st + 32 * kChunks + 4 * tg)),
                 "l"(src)
                 : "memory");
  }
}

// A float pool: a group thread's share of 16-row piece j of the row
// (positions 16 j .. 16 j + 15, on page pt[16 j / bs]) into rows
// 16 p .. 16 p + 15 of the step buffer `dst` (K rows, then V rows from
// byte v_off): chunk c of row r at 16 (c ^ (r % 8)) for the tensor cores'
// swizzled rows (kSwizzle), at 16 c else.
template <typename P, int D, bool kSwizzle>
__device__ __forceinline__ void stage_piece(const pg::PoolArgs& pool, int h,
                                            const int* pt, int j, int bs,
                                            int p, int tg, unsigned char* dst,
                                            int v_off) {
  constexpr int kRowBytes = D * P::kBytes;
  constexpr int kCpr = kRowBytes / 16;  // chunks a row
  const int pos = 16 * j;
  const size_t off =
      (((size_t)h * pool.num_pages + pt[pos / bs]) * bs + pos % bs) *
      kRowBytes;
  const unsigned char* ks = static_cast<const unsigned char*>(pool.k) + off;
  const unsigned char* vs = static_cast<const unsigned char*>(pool.v) + off;
#pragma unroll
  for (int i = 0; i < 16 * kCpr / kGroupThreads; ++i) {
    const int idx = tg + kGroupThreads * i;
    const int r = 16 * p + idx / kCpr;
    const int c = idx % kCpr;
    const int at = r * kRowBytes + 16 * (kSwizzle ? c ^ (r & 7) : c);
    cp_async16(dst + at, ks + 16 * idx);
    cp_async16(dst + v_off + at, vs + 16 * idx);
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block (kv head h, work tile): the 64 pairs of the tile against the row's
// keys up to its last token's causal extent, in steps of kStepPieces
// pieces of 16 rows. Group gi of
// four warps takes steps gi, gi + 3, ...: its threads copy their chunks of
// the group's coming steps (cp.async, kTileStages - 1 steps ahead); an
// int8 pool's step is then stored once to a step buffer (bf16 rows for a
// bf16 q, read back by ldmatrix), a float pool's is read where it landed;
// the group's warps work it 32 keys at a time (16 for an f32 q). Warp w
// of a group owns pairs 16 w .. 16 w + 15, and lane l (quad g = l / 4,
// t = l % 4) holds, as the m16n8k16 accumulator lays it out, pairs
// 16 w + g and + 8 against keys 2t, 2t + 1 of each 8-key n-tile. At the
// end groups 1 and 2 hand their (o, m, l) to group 0, which merges and
// writes. The work tile after the rows' tiles zeroes the pad tokens past
// cu_q_lens[num_seqs]; rows of one query token are the split kernel's and
// have no tiles here.
template <typename P, typename T, int D>
__global__ void __launch_bounds__(kTileThreads)
    ragged_tile_kernel(const TileArgs a) {
  using L = TileSmem<P, T, D>;
  constexpr bool kTC = L::kTC;          // tensor cores
  constexpr bool kInt8 = P::kScaled;    // staged, converted, scaled
  constexpr int kPieces = L::kPieces;
  constexpr int KS = D / 16;    // k-steps of Q.K^T
  constexpr int NT = D / 8;     // n-tiles of P.V
  constexpr int DQ = D / 4;     // f32 q: a quad lane's share of a row
  const int h = blockIdx.x;
  const int G = a.group;
  const int hq = gridDim.x * G;
  const int tpt = kTilePairs / G;
  // work tile blockIdx.y: the rows' tiles in order (rows of one query
  // token have none), then the pad span's, then nothing
  int b = 0;
  int tile = blockIdx.y;
  for (; b < a.num_seqs; ++b) {
    const int q_len = a.cu_q_lens[b + 1] - a.cu_q_lens[b];
    const int nt = q_len >= 2 ? (q_len + tpt - 1) / tpt : 0;
    if (tile < nt) break;
    tile -= nt;
  }
  const bool pad = b == a.num_seqs;
  const int start = a.cu_q_lens[b];
  const int end = pad ? a.num_tokens : a.cu_q_lens[b + 1];
  const int t0 = start + tile * tpt;
  if (t0 >= end) return;  // uniform over the block
  const int t1 = min(t0 + tpt, end);
  const int q_len = end - start;
  T* out = static_cast<T*>(a.out);
  const int bs = a.bs;
  constexpr int ir = kPieceRows;  // rows of a piece
  // token t of this row sees kv positions < base_lim + t
  const int base_lim = pad ? 0 : a.kv_lens[b] - q_len - start + 1;
  const int block_lim = min(base_lim + t1 - 1, a.pages_per_seq * bs);
  const int npieces =
      pad || block_lim <= 0 ? 0 : (block_lim + ir - 1) / ir;
  if (npieces == 0) {  // pad tokens (or tokens that see no key): zeros
    const int span = G * D;
    for (int i = threadIdx.x; i < (t1 - t0) * span; i += blockDim.x)
      out[((size_t)(t0 + i / span) * hq + (size_t)h * G) * D + i % span] =
          from_float<T>(0.f);
    return;
  }

  constexpr int chunks = ir * D / 16;  // int8: a piece's chunks a tensor
  constexpr int kRowBytes = D * (kTC ? 2 : P::kBytes);  // a stored row
  const int step_keys = kPieces * ir;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  float* qs = reinterpret_cast<float*>(tile_smem + L::kQs);  // f32 q
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gi = warp / 4;                  // group
  const int wr = warp % 4;                  // pairs 16 wr .. 16 wr + 15
  const int tg = threadIdx.x % kGroupThreads;
  const int* pt = a.page_indices + (size_t)b * a.pages_per_seq;
  unsigned char* grp = tile_smem + gi * L::kGroup;
  const auto slot = [&](int k) {
    if constexpr (kInt8)
      return grp + 2 * L::kBuffer + (k % kTileStages) * kPieces * L::kStage;
    else
      return grp + (k % kTileStages) * L::kStep;
  };
  // step u takes pieces kPieces u .. + kPieces - 1; a piece past the
  // row's last is loaded as its step's first again (its keys lie past
  // every limit, so the mask drops them)
  const auto stage_step = [&](int u, unsigned char* dst) {
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int j = kPieces * u + p;
      const int jj = j < npieces ? j : kPieces * u;
      if constexpr (kInt8)
        stage_rows<D>(a.pool, h, pt, jj, bs, tg, dst + p * L::kStage);
      else
        stage_piece<P, D, kTC>(a.pool, h, pt, jj, bs, p, tg, dst,
                               step_keys * kRowBytes);
    }
  };
  // the group's first kTileStages - 1 steps in flight first
  for (int k = 0; k < kTileStages - 1; ++k) {
    const int uk = gi + kGroups * k;
    if (kPieces * uk < npieces) stage_step(uk, slot(k));
    commit_copies();
  }
  const T* qg = static_cast<const T*>(a.q);
  if constexpr (!kTC) {
    for (int i = threadIdx.x; i < kTilePairs * D; i += kTileThreads) {
      const int row = i / D;
      const int tok = t0 + row / G;
      qs[i] = tok < t1 ? round_to<T>(to_float(
                             qg[((size_t)tok * hq + (size_t)h * G + row % G) *
                                    D + i % D]) *
                         a.scale)
                       : 0.f;
    }
  }
  __syncthreads();

  const int g = lane >> 2;
  const int t = lane & 3;
  int lim[2];
  int tok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr * 16 + g + 8 * i;
    tok[i] = t0 + row / G;
    lim[i] = tok[i] < t1 ? base_lim + tok[i] : 0;
  }
  // the warp's largest limit: its last live pair's
  const int last_row = min(wr * 16 + 15, (t1 - t0) * G - 1);
  const int warp_lim = last_row < wr * 16 ? 0 : base_lim + t0 + last_row / G;

  uint32_t qa[kTC ? KS : 1][4];  // bf16 q: the A fragments of Q.K^T
  if constexpr (kTC) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wr * 16 + g + 8 * i;
      const bool live = tok[i] < t1;
      const __nv_bfloat16* qrow =
          qg + ((size_t)(live ? tok[i] : t0) * hq + (size_t)h * G + row % G) *
                   D;
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
              qrow + 16 * s + 8 * hi + 2 * t);
          qa[s][i + 2 * hi] =
              live ? pack_bf16(__low2float(x) * a.scale,
                               __high2float(x) * a.scale)
                   : 0u;
        }
    }
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  constexpr int NK = kTC ? 32 : 16;  // keys of a compute step
  for (int u = gi, it = 0; kPieces * u < npieces; u += kGroups, ++it) {
    const int un = u + kGroups * (kTileStages - 1);
    unsigned char* buf;
    const float* kfac = nullptr;  // int8: the step's key factors
    const float* vfac = nullptr;  // and value factors (or raw scales)
    if constexpr (kInt8) {
      if (kPieces * un < npieces) stage_step(un, slot(it + kTileStages - 1));
      commit_copies();
      wait_copies<kTileStages - 1>();  // this thread's copies of step u
      // the group stores the step: bf16 rows and factors, or int8 rows and
      // raw scales; a thread reads only the staging bytes it copied
      buf = grp + (it & 1) * L::kBuffer;
      float* fk = reinterpret_cast<float*>(buf + 4 * (size_t)step_keys * D);
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        const unsigned char* cur = slot(it) + p * L::kStage;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const int idx = tg + kGroupThreads * c;
          if (idx >= chunks) continue;
          const uint4 kw = reinterpret_cast<const uint4*>(cur)[idx];
          const uint4 vw = reinterpret_cast<const uint4*>(cur)[chunks + idx];
          if constexpr (kTC) {
            const int row = p * ir + idx / (D / 16);
            const int cc = idx % (D / 16);
#pragma unroll
            for (int kv = 0; kv < 2; ++kv) {
              float f[16];
              pg::codes_to_f32<16>(
                  reinterpret_cast<const uint32_t*>(kv ? &vw : &kw), f);
              unsigned char* dst =
                  buf + (kv ? 2 * (size_t)step_keys * D : 0) +
                  (size_t)row * 2 * D;
#pragma unroll
              for (int hc = 0; hc < 2; ++hc)
                *reinterpret_cast<uint4*>(dst +
                                          16 * ((2 * cc + hc) ^ (row & 7))) =
                    make_uint4(pack_bf16(f[8 * hc], f[8 * hc + 1]),
                               pack_bf16(f[8 * hc + 2], f[8 * hc + 3]),
                               pack_bf16(f[8 * hc + 4], f[8 * hc + 5]),
                               pack_bf16(f[8 * hc + 6], f[8 * hc + 7]));
            }
          } else {
            reinterpret_cast<uint4*>(buf + (size_t)p * ir * D)[idx] = kw;
            reinterpret_cast<uint4*>(buf + (size_t)(step_keys + p * ir) * D)
                [idx] = vw;
          }
        }
        for (int e = tg; e < 2 * ir; e += kGroupThreads) {
          const float sc =
              reinterpret_cast<const float*>(cur + 32 * (size_t)chunks)[e];
          if (e < ir)
            fk[p * ir + e] = kTC ? sc * pg::PoolInt8::kKeyFactor : sc;
          else
            fk[step_keys + p * ir + e - ir] =
                kTC ? sc * pg::PoolInt8::kValueFactor : sc;
        }
      }
      pg::named_barrier_sync(1 + gi, kGroupThreads);
      kfac = fk;
      vfac = fk + step_keys;
    } else {
      wait_copies<kTileStages - 2>();  // this thread's copies of step u
      // every copy of step u has landed, and the group is done with the
      // slot that step un takes
      pg::named_barrier_sync(1 + gi, kGroupThreads);
      if (kPieces * un < npieces) stage_step(un, slot(it + kTileStages - 1));
      commit_copies();
      buf = slot(it);
    }
    const unsigned char* kt = buf;  // f32 q: int8 or f32 rows
    const unsigned char* vt = buf + (size_t)step_keys * kRowBytes;
    // int8 with an f32 q: raw scales, their factors taken here
    const float kmul = kTC ? 1.f : pg::PoolInt8::kKeyFactor;
    const float vmul = kTC ? 1.f : pg::PoolInt8::kValueFactor;
    for (int kb = 0; kb < step_keys; kb += NK) {
      const int p0 = u * step_keys + kb;  // position of the first key
      if (p0 >= warp_lim) break;          // no pair of the warp sees these
      float sc[NK / 8][4];  // [8-key n-tile][accumulator register]
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
      if constexpr (kTC) {
        // K rows kb + 16 hh .. + 15: lane l addresses row 8 (l / 16) + l % 8
        // of them, 8-element chunk 2s + (l / 8) % 2
#pragma unroll
        for (int hh = 0; hh < NK / 16; ++hh) {
          const int krow = kb + 16 * hh + 8 * (lane >> 4) + (lane & 7);
          const uint32_t kbase = smem_addr(buf) + krow * 2 * D;
#pragma unroll
          for (int s = 0; s < KS; ++s) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4(kbase + 16 * ((2 * s + ((lane >> 3) & 1)) ^ (krow & 7)),
                    b0, b1, b2, b3);
            mma_16816(sc[2 * hh], qa[s], b0, b1);
            mma_16816(sc[2 * hh + 1], qa[s], b2, b3);
          }
        }
      } else {
#pragma unroll 1
        for (int c0 = 0; c0 < D / 16; ++c0) {
          // the quad's lanes start at different 16-element chunks: fewer
          // of them read one bank
          const int c = (c0 + t) % (D / 16);
          float kf[4][16];  // keys kb + 8n + 2t + e, as [2n + e]
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int key = kb + 8 * (k >> 1) + 2 * t + (k & 1);
            pg::lds_f32<P, 16>(kt, key * D + 16 * c, kf[k]);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float* qrow = qs + (wr * 16 + g + 8 * i) * D + 16 * c;
            float qv[16];
#pragma unroll
            for (int e = 0; e < 16; e += 4) {
              const float4 x = *reinterpret_cast<const float4*>(qrow + e);
              qv[e] = x.x;
              qv[e + 1] = x.y;
              qv[e + 2] = x.z;
              qv[e + 3] = x.w;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float acc = sc[k >> 1][2 * i + (k & 1)];
#pragma unroll
              for (int e = 0; e < 16; ++e) acc = fmaf(qv[e], kf[k][e], acc);
              sc[k >> 1][2 * i + (k & 1)] = acc;
            }
          }
        }
      }
      // the key factors (int8: hoisted K scales), the causal mask, one max
      // and correction per row
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kb + 8 * n + 2 * t + (i & 1);
          float kf;
          if constexpr (kInt8)
            kf = kfac[key] * kmul;
          else
            kf = pg::kLog2e;
          const float s = p0 + 8 * n + 2 * t + (i & 1) < lim[i >> 1]
                              ? sc[n][i] * kf
                              : -INFINITY;
          sc[n][i] = s;
          mx[i >> 1] = fmaxf(mx[i >> 1], s);
        }
      float mu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        mu[i] = m_new == -INFINITY ? 0.f : m_new;  // a row that saw nothing
        const float corr = ex2(m[i] - mu[i]);
        m[i] = m_new;
        l[i] *= corr;
        // once the running max settles, a step rescales nothing
        if (__any_sync(0xffffffffu, corr != 1.f)) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            o[n][2 * i] *= corr;
            o[n][2 * i + 1] *= corr;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kb + 8 * n + 2 * t + (i & 1);
          const float p = ex2(sc[n][i] - mu[i >> 1]);
          l[i >> 1] += p;
          if constexpr (kInt8)
            sc[n][i] = p * (vfac[key] * vmul);  // hoisted V scale
          else
            sc[n][i] = p;
        }
      if constexpr (kTC) {
#pragma unroll
        for (int hh = 0; hh < NK / 16; ++hh) {
          // keys kb + 16 hh .. + 15 as the A fragment of P.V
          const uint32_t pa[4] = {pack_bf16(sc[2 * hh][0], sc[2 * hh][1]),
                                  pack_bf16(sc[2 * hh][2], sc[2 * hh][3]),
                                  pack_bf16(sc[2 * hh + 1][0], sc[2 * hh + 1][1]),
                                  pack_bf16(sc[2 * hh + 1][2], sc[2 * hh + 1][3])};
          // their V rows, transposed: lane l addresses row 8 ((l / 8) % 2)
          // + l % 8 of them, chunk 2 jj + l / 16
          const int vrow = kb + 16 * hh + 8 * ((lane >> 3) & 1) + (lane & 7);
          const uint32_t vbase =
              smem_addr(buf) + 2 * step_keys * D + vrow * 2 * D;
#pragma unroll
          for (int jj = 0; jj < NT / 2; ++jj) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(vbase + 16 * ((2 * jj + (lane >> 4)) ^ (vrow & 7)), b0,
                      b1, b2, b3);
            mma_16816(o[2 * jj], pa, b0, b1);
            mma_16816(o[2 * jj + 1], pa, b2, b3);
          }
        }
      } else {
        // each key's weights for the lane's two pairs, from the quad lane
        // that holds them; the lane's outputs [DQ t, DQ t + DQ) in o's
        // layout: element e at o[e % NT][2 i + e / NT]
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int src = (lane & ~3) | ((k & 7) >> 1);
          const int reg = k & 1;
          const float w0 = __shfl_sync(0xffffffffu, sc[k >> 3][reg], src);
          const float w1 = __shfl_sync(0xffffffffu, sc[k >> 3][2 + reg], src);
          float vf[DQ];
          pg::lds_f32<P, DQ>(vt, (kb + k) * D + DQ * t, vf);
#pragma unroll
          for (int e = 0; e < DQ; ++e) {
            o[e % NT][e / NT] = fmaf(w0, vf[e], o[e % NT][e / NT]);
            o[e % NT][2 + e / NT] = fmaf(w1, vf[e], o[e % NT][2 + e / NT]);
          }
        }
      }
    }
  }

  // groups 1 .. kGroups - 1 hand (o, m, l) to group 0, thread for thread,
  // which merges them in order
  const int xstride = D / 2 + 4;
  if (gi > 0) {
    wait_copies<0>();
    pg::named_barrier_sync(1 + gi, kGroupThreads);  // the group's region
    float* x = reinterpret_cast<float*>(grp) + (size_t)tg * xstride;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[4 * n + i] = o[n][i];
    x[4 * NT] = m[0];
    x[4 * NT + 1] = m[1];
    x[4 * NT + 2] = l[0];
    x[4 * NT + 3] = l[1];
  }
  __syncthreads();
  if (gi > 0) return;
  for (int gx = 1; gx < kGroups; ++gx) {
    const float* x = reinterpret_cast<const float*>(
                         tile_smem + gx * L::kGroup) +
                     (size_t)tg * xstride;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = x[4 * NT + i];
      const float mt = fmaxf(m[i], m1);
      const float mref = mt == -INFINITY ? 0.f : mt;
      const float f0 = ex2(m[i] - mref);
      const float f1 = ex2(m1 - mref);
      m[i] = mt;
      l[i] = l[i] * f0 + x[4 * NT + 2 + i] * f1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * i] = o[n][2 * i] * f0 + x[4 * n + 2 * i] * f1;
        o[n][2 * i + 1] = o[n][2 * i + 1] * f0 + x[4 * n + 2 * i + 1] * f1;
      }
    }
  }

  // the quad's sums, then the pairs' outputs
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (tok[i] >= t1) continue;
    const int row = wr * 16 + g + 8 * i;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = out + ((size_t)tok[i] * hq + (size_t)h * G + row % G) * D;
    if constexpr (kTC) {
      // n-tile n holds columns 8n + 2t, + 1
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
            pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    } else {
      float ov[DQ];
#pragma unroll
      for (int e = 0; e < DQ; ++e) ov[e] = o[e % NT][2 * i + e / NT] * inv;
      store_row<T, DQ>(orow + DQ * t, ov);
    }
  }
}

template <typename P, typename T, int D>
cudaError_t launch_tile(const TileArgs& a, int num_kv_heads,
                        cudaStream_t stream) {
  const int tpt = kTilePairs / a.group;
  const size_t smem = TileSmem<P, T, D>::kBytes;
  cudaError_t err = pg::allow_smem(ragged_tile_kernel<P, T, D>, smem);
  if (err != cudaSuccess) return err;
  // work tiles: at most ceil(T / tpt) + num_seqs for the rows and one
  // more for the pad span's remainder
  dim3 grid(num_kv_heads, (a.num_tokens + tpt - 1) / tpt + a.num_seqs + 1);
  ragged_tile_kernel<P, T, D><<<grid, kTileThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename P, typename T>
cudaError_t launch_tile_dim(int head_dim, const TileArgs& a,
                            int num_kv_heads, cudaStream_t stream) {
  return head_dim == 64 ? launch_tile<P, T, 64>(a, num_kv_heads, stream)
                        : launch_tile<P, T, 128>(a, num_kv_heads, stream);
}

// The tile kernel, then the split kernel over the decode rows (and their
// merge), for an int8 pool (`quant`) or a float pool of q's type.
int ragged(const pg::PoolArgs& pool, bool quant, const void* q,
           const void* kv_lens, const void* page_indices,
           const void* cu_q_lens, void* out, void* o_part, void* ml_part,
           int num_tokens, int num_seqs, int num_kv_heads, int group,
           int head_dim, int page_size, int pages_per_seq, int num_splits,
           int pages_per_split, float scale, int dtype, void* stream) {
  if (page_size % kPieceRows != 0 || (head_dim != 64 && head_dim != 128) ||
      (group != 1 && group != 2 && group != 4 && group != 8) ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TileArgs ta{pool,
                    q,
                    static_cast<const int*>(kv_lens),
                    static_cast<const int*>(page_indices),
                    static_cast<const int*>(cu_q_lens),
                    out,
                    num_tokens,
                    num_seqs,
                    group,
                    page_size,
                    pages_per_seq,
                    scale};
  cudaError_t err;
  if (quant && dtype == kFloat32)
    err = launch_tile_dim<pg::PoolInt8, float>(head_dim, ta, num_kv_heads, s);
  else if (quant)
    err = launch_tile_dim<pg::PoolInt8, __nv_bfloat16>(head_dim, ta,
                                                       num_kv_heads, s);
  else if (dtype == kFloat32)
    err = launch_tile_dim<pg::PoolF32, float>(head_dim, ta, num_kv_heads, s);
  else
    err = launch_tile_dim<pg::PoolBf16, __nv_bfloat16>(head_dim, ta,
                                                       num_kv_heads, s);
  if (err != cudaSuccess) return err;
  const pg::SplitArgs sa{pool,
                         q,
                         static_cast<const int*>(kv_lens),
                         static_cast<const int*>(page_indices),
                         static_cast<const int*>(cu_q_lens),
                         out,
                         static_cast<float*>(o_part),
                         static_cast<float*>(ml_part),
                         num_seqs,
                         page_size,
                         pages_per_seq,
                         pages_per_split,
                         num_splits,
                         scale};
  return pg::decode_splits(sa, quant, num_kv_heads, group, head_dim, dtype,
                           s);
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers of contiguous
// tensors, each 16-byte aligned: q/out [num_tokens, num_kv_heads * group,
// head_dim] f32 or bf16 (dtype), pools [num_kv_heads, num_pages,
// page_size, head_dim] in q's dtype, kv_lens [num_seqs] int32,
// page_indices [num_seqs, pages_per_seq] int32, cu_q_lens [num_seqs + 1]
// int32; group 1, 2, 4 or 8; page_size a multiple of 16. Two or three
// launches on `stream`: the tile kernel (rows of other than one query
// token, and the pad tokens), the split kernel over the decode rows
// (num_splits splits of pages_per_split pages), and, with more than one
// split, their merge. o_part [num_seqs, Hq, num_splits, head_dim] and
// ml_part [num_seqs, Hq, num_splits, 2] are f32 scratch. Allocates
// nothing; returns cudaGetLastError().
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* kv_lens, const void* page_indices, const void* cu_q_lens,
    void* out, void* o_part, void* ml_part, int num_tokens, int num_seqs,
    int num_kv_heads, int group, int head_dim, int num_pages, int page_size,
    int pages_per_seq, int num_splits, int pages_per_split, float scale,
    int dtype, void* stream) {
  const pg::PoolArgs pool{k_pages, v_pages, nullptr, nullptr, num_pages};
  return ragged(pool, false, q, kv_lens, page_indices, cu_q_lens, out,
                o_part, ml_part, num_tokens, num_seqs, num_kv_heads, group,
                head_dim, page_size, pages_per_seq, num_splits,
                pages_per_split, scale, dtype, stream);
}

// K4-int8: the same operands, each pool given as int8 codes [num_kv_heads,
// num_pages, page_size, head_dim] and f32 scales [num_kv_heads, num_pages,
// page_size, 1]; q/out f32 or bf16 (dtype); page_size a multiple of 16
// (the tile kernel stages 16-row pieces of a page, whatever its size).
extern "C" int ragged_paged_attention_int8_launch(
    const void* q, const void* k_codes, const void* k_scales,
    const void* v_codes, const void* v_scales, const void* kv_lens,
    const void* page_indices, const void* cu_q_lens, void* out, void* o_part,
    void* ml_part, int num_tokens, int num_seqs, int num_kv_heads, int group,
    int head_dim, int num_pages, int page_size, int pages_per_seq,
    int num_splits, int pages_per_split, float scale, int dtype,
    void* stream) {
  const pg::PoolArgs pool{k_codes, v_codes,
                          static_cast<const float*>(k_scales),
                          static_cast<const float*>(v_scales), num_pages};
  return ragged(pool, true, q, kv_lens, page_indices, cu_q_lens, out, o_part,
                ml_part, num_tokens, num_seqs, num_kv_heads, group, head_dim,
                page_size, pages_per_seq, num_splits, pages_per_split, scale,
                dtype, stream);
}
