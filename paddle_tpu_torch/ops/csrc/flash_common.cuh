// Tiles, masks and work-tile walks shared by the flash-attention forward
// (K1/K2/K3/K6) and backward kernels.
//
// The f32 kernels (the correctness witness of the f32 phases) work on 64-row
// tiles of one (batch, head) slice of the paddle layout [B, S, H, D], staged
// in shared memory with rows padded by 8 elements, and compute C[M x N] (+)=
// A[M x K] * B[K x N] on CUDA cores (Acc<float>): each thread owns a fixed
// set of elements of C. The bf16 kernels are Hopper kernels (TMA, wgmma,
// warp specialisation; hopper.cuh) that share the K3 range tables and the
// persistent grid's work-tile walk below.
#pragma once

#include <climits>
#include <math.h>

#include "attention_common.cuh"

namespace ptt {
namespace flash {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBr = 64;   // query rows per tile
constexpr int kBc = 64;   // key rows per tile
constexpr int kPad = 8;   // padding elements per shared-memory row
// pitch of a row-broadcast tile: kBcastLd copies of one factor per row
constexpr int kBcastLd = 16;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Copy rows [row0, row0 + R) of one head of two tensors (D contiguous
// elements a row, rows `row_stride` elements apart, the same rows of
// both) into two padded shared tiles; rows at or past `n_rows` are
// zero-filled. 16-byte vectors, neighbouring threads on neighbouring
// addresses within a row. Every load of both tiles is issued before the
// first store, so the block waits for device memory once per pair, not
// once per vector.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tiles(T* __restrict__ dst0,
                                           const T* __restrict__ src0,
                                           T* __restrict__ dst1,
                                           const T* __restrict__ src1,
                                           int row0, int n_rows,
                                           size_t row_stride) {
  constexpr int kVec = D * int(sizeof(T)) / 16;
  constexpr int kPitch = D + kPad;
  constexpr int kPer = R * kVec / kThreads;
  static_assert(R * kVec % kThreads == 0, "tile must split over the block");
  uint4 a[kPer];
  uint4 b[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kVec;
    const size_t off = (size_t)(row0 + r) * row_stride;
    const bool ok = row0 + r < n_rows;
    a[i] = ok ? reinterpret_cast<const uint4*>(src0 + off)[idx % kVec]
              : make_uint4(0u, 0u, 0u, 0u);
    b[i] = ok ? reinterpret_cast<const uint4*>(src1 + off)[idx % kVec]
              : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kVec;
    reinterpret_cast<uint4*>(dst0 + r * kPitch)[idx % kVec] = a[i];
    reinterpret_cast<uint4*>(dst1 + r * kPitch)[idx % kVec] = b[i];
  }
}

// One tile: as load_tiles, for a single tensor.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int row0, int n_rows,
                                          size_t row_stride) {
  constexpr int kVec = D * int(sizeof(T)) / 16;
  constexpr int kPitch = D + kPad;
  constexpr int kPer = R * kVec / kThreads;
  static_assert(R * kVec % kThreads == 0, "tile must split over the block");
  uint4 a[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kVec;
    a[i] = row0 + r < n_rows
               ? reinterpret_cast<const uint4*>(
                     src + (size_t)(row0 + r) * row_stride)[idx % kVec]
               : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    reinterpret_cast<uint4*>(dst + (idx / kVec) * kPitch)[idx % kVec] = a[i];
  }
}

// Write rows [row0, row0 + R) of a padded f32 shared tile (pitch D + kPad)
// to global memory in T; rows at or past `n_rows` are dropped.
template <typename T, int D, int R>
__device__ __forceinline__ void store_tile(T* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int row0, int n_rows,
                                           size_t row_stride) {
  constexpr int kPitch = D + kPad;
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    if (row0 + r < n_rows)
      dst[(size_t)(row0 + r) * row_stride + d] =
          from_float<T>(src[r * kPitch + d]);
  }
}

// Is key j visible to query i? Causal masks are bottom-right aligned:
// query i sees keys j <= i + (sk - sq).
__device__ __forceinline__ bool visible(int i, int j, int sq, int sk,
                                        bool causal) {
  return i < sq && j < sk && (!causal || j <= i + (sk - sq));
}

// K3 (segment-masked attention): per-token int32 segment ids and positions
// of the queries ([B, Sq]) and keys ([B, Sk]), and a tile-range table
// [B, n_tiles, 2] giving, for each tile of the block's own side (query
// tiles for the forward and dQ, key tiles for dK/dV), the tiles [lo, hi) of
// the other side that can hold a visible pair. The ranges only skip work:
// the in-tile mask below decides what is visible. K1/K2 pass nulls.
struct Segments {
  const int* seg_q;
  const int* pos_q;
  const int* seg_k;
  const int* pos_k;
  const int* ranges;
};

// Shared copies of one query tile's and one key tile's ids and positions.
struct SegTile {
  int seg_q[kBr];
  int pos_q[kBr];
  int seg_k[kBc];
  int pos_k[kBc];
};

// Is key j0 + c visible to query i0 + r? K1/K2 (SEG false): the
// bottom-right causal or the full mask. K3 (SEG true): the same segment
// and, under a causal mask, pos_q >= pos_k, from the staged ids.
template <bool SEG>
struct Mask {
  const SegTile* ids;
  int sq;
  int sk;
  bool causal;

  __device__ __forceinline__ bool operator()(int i0, int r, int j0,
                                             int c) const {
    if constexpr (SEG)
      return i0 + r < sq && j0 + c < sk && ids->seg_q[r] == ids->seg_k[c] &&
             (!causal || ids->pos_q[r] >= ids->pos_k[c]);
    else
      return visible(i0 + r, j0 + c, sq, sk, causal);
  }
};

// Stage the ids and positions of rows [row0, row0 + R) of one batch row
// (rows past n_rows are never visible: the mask bounds them).
template <int R>
__device__ __forceinline__ void load_ids(int* __restrict__ seg_dst,
                                         int* __restrict__ pos_dst,
                                         const int* __restrict__ seg,
                                         const int* __restrict__ pos,
                                         int row0, int n_rows) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const bool ok = row0 + r < n_rows;
    seg_dst[r] = ok ? seg[row0 + r] : 0;
    pos_dst[r] = ok ? pos[row0 + r] : 0;
  }
}

// The tile range [lo, hi) of this block's tile from a K3 range table,
// clamped to the other side's n_tiles.
__device__ __forceinline__ int2 tile_range(const int* __restrict__ ranges,
                                           int b, int n_own, int own,
                                           int n_tiles) {
  const int* rg = ranges + ((size_t)b * n_own + own) * 2;
  return make_int2(max(rg[0], 0), min(rg[1], n_tiles));
}

// K3: the union of the non-empty ranges of the 64-unit tiles 2t and 2t + 1
// of a range table [B, n_own, 2] (one 128-unit tile of the table's own
// side), clamped to [0, n_other); (0, 0) when both are empty.
__device__ __forceinline__ int2 tile_pair_range(const int* __restrict__ ranges,
                                                int b, int n_own, int t,
                                                int n_other) {
  int lo = INT_MAX;
  int hi = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int u = 2 * t + half;
    if (u < n_own) {
      const int2 rg = tile_range(ranges, b, n_own, u, n_other);
      if (rg.x < rg.y) {
        lo = min(lo, rg.x);
        hi = max(hi, rg.y);
      }
    }
  }
  return lo < hi ? make_int2(lo, hi) : make_int2(0, 0);
}

// K3: the key tiles [lo, hi) of 128 keys that query tile `qt` (128 rows)
// visits, from the 64-unit key_ranges table: the union of its two 64-row
// tiles' ranges, then lo / 2 and ceil(hi / 2)
// (ops/flash_attention.py::_fwd_key_ranges is the same arithmetic).
__device__ __forceinline__ int2 seg_key_tiles(const int* __restrict__ ranges,
                                              int b, int qt, int sq, int sk) {
  const int2 r = tile_pair_range(ranges, b, (sq + 63) / 64, qt, (sk + 63) / 64);
  return make_int2(r.x / 2, (r.y + 1) / 2);
}

// The Hopper kernels' persistent grid: one block per SM walks the work
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... A work tile of the forward
// and of dQ is one (128-row query tile, query head, batch). Tiles are
// numbered batch-major, then head, then query tile, so the tiles in flight
// at once share a few heads' K/V in L2. Under K1/K2's causal mask a head's
// query tiles run heavy half first, heaviest first, then the light half,
// lightest first: positions t and t + n_qt / 2 hold the t-th heaviest and
// the t-th lightest tile, about n_qt + 1 key tiles together. A block's
// fixed stride (132 SMs: 4 modulo a power-of-two n_qt of 8 or more) meets
// both tiles of its pairs, so the causal work per block evens out. K3's
// work follows its segments, and its causal tiles run last first.
struct Work {
  int b, h, qt;
};

template <bool SEG>
__device__ __forceinline__ Work work_tile(int w, int n_qt, int hq,
                                          int causal) {
  const int t = w % n_qt;
  const int heavy = (n_qt + 1) / 2;
  int qt = t;
  if (causal)
    qt = SEG || t < heavy ? n_qt - 1 - t : t - heavy;
  return Work{w / (n_qt * hq), (w / n_qt) % hq, qt};
}

template <typename T, int M, int N>
struct Acc;

// f32: CUDA cores. Thread t owns the elements e * kThreads + t of C.
template <int M, int N>
struct Acc<float, M, N> {
  static constexpr int kE = M * N / kThreads;
  static_assert(M * N % kThreads == 0, "tile must split over the block");
  float x[kE];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < kE; ++e) x[e] = 0.f;
  }

  // C += A * B; A is M x K (column-major when A_COL: A(m, k) = A[k*lda + m]),
  // B is K x N (column-major when B_COL: B(k, n) = B[n*ldb + k]).
  template <bool A_COL, bool B_COL, int K>
  __device__ __forceinline__ void mma(const float* __restrict__ A, int lda,
                                      const float* __restrict__ B, int ldb) {
#pragma unroll 4
    for (int e = 0; e < kE; ++e) {
      const int idx = e * kThreads + threadIdx.x;
      const int m = idx / N;
      const int n = idx % N;
      float s = x[e];
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float a = A_COL ? A[k * lda + m] : A[m * lda + k];
        const float b = B_COL ? B[n * ldb + k] : B[k * ldb + n];
        s = fmaf(a, b, s);
      }
      x[e] = s;
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ C, int ldc) const {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int idx = e * kThreads + threadIdx.x;
      C[(idx / N) * ldc + idx % N] = x[e];
    }
  }

  __device__ __forceinline__ void scale(float s) {
#pragma unroll
    for (int e = 0; e < kE; ++e) x[e] *= s;
  }

  // Multiply row r of C by bcast[r * kBcastLd].
  __device__ __forceinline__ void scale_rows(const float* __restrict__ bcast) {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      x[e] *= bcast[(e * kThreads + threadIdx.x) / N * kBcastLd];
  }
};

// Carve shared memory into 128-byte aligned regions.
__device__ __forceinline__ unsigned char* carve(unsigned char*& p,
                                                size_t bytes) {
  unsigned char* out = p;
  p += (bytes + 127) / 128 * 128;
  return out;
}

__host__ __device__ constexpr size_t aligned(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

}  // namespace flash
}  // namespace ptt
