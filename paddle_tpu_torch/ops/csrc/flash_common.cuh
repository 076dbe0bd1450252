// Tiles, products and masks shared by the flash-attention forward (K1/K2)
// and backward kernels.
//
// Every kernel works on 64-row tiles of one (batch, head) slice of the
// paddle layout [B, S, H, D], staged in shared memory with rows padded by 8
// elements (so the tensor-core fragment loads of neighbouring rows fall on
// other banks). A product C[M x N] (+)= A[M x K] * B[K x N] reads A and B
// from shared memory, row- or column-major, and keeps C in an accumulator:
// - bf16: tensor cores through nvcuda::wmma 16x16x16 fragments with f32
//   accumulation; each of the 8 warps owns a row strip of 16x16 tiles of C;
// - f32: CUDA cores; each thread owns a fixed set of elements of C.
// Both accumulators expose the same zero / mma / store / scale / scale_rows
// calls, so the kernels are written once for both types.
#pragma once

#include <math.h>
#include <mma.h>

#include <type_traits>

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

// bf16: tensor cores. Each warp owns one row strip of C: kNT adjacent
// 16x16 tiles in one 16-row block, so one A fragment per k-step serves all
// of the warp's tiles.
template <int M, int N>
struct Acc<__nv_bfloat16, M, N> {
  static constexpr int kTN = N / 16;
  static constexpr int kNT = (M / 16) * kTN / kWarps;
  static constexpr int kWarpsPerRow = kTN / kNT;
  static_assert((M / 16) * kTN % kWarps == 0, "tiles must split over warps");
  static_assert(kTN % kNT == 0, "a warp's tiles must lie in one row block");
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      f[kNT];

  __device__ __forceinline__ static int row_block() {
    return (threadIdx.x >> 5) / kWarpsPerRow;
  }
  __device__ __forceinline__ static int col_block(int i) {
    return ((threadIdx.x >> 5) % kWarpsPerRow) * kNT + i;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kNT; ++i) nvcuda::wmma::fill_fragment(f[i], 0.f);
  }

  template <bool A_COL, bool B_COL, int K>
  __device__ __forceinline__ void mma(const __nv_bfloat16* __restrict__ A,
                                      int lda,
                                      const __nv_bfloat16* __restrict__ B,
                                      int ldb) {
    using namespace nvcuda;
    using ALayout = typename std::conditional<A_COL, wmma::col_major,
                                              wmma::row_major>::type;
    using BLayout = typename std::conditional<B_COL, wmma::col_major,
                                              wmma::row_major>::type;
    const int tm = row_block();
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a;
      wmma::load_matrix_sync(
          a, A_COL ? A + k0 * lda + tm * 16 : A + tm * 16 * lda + k0, lda);
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int tn = col_block(i);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
        wmma::load_matrix_sync(
            b, B_COL ? B + tn * 16 * ldb + k0 : B + k0 * ldb + tn * 16, ldb);
        wmma::mma_sync(f[i], a, b, f[i]);
      }
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ C, int ldc) const {
#pragma unroll
    for (int i = 0; i < kNT; ++i)
      nvcuda::wmma::store_matrix_sync(
          C + row_block() * 16 * ldc + col_block(i) * 16, f[i], ldc,
          nvcuda::wmma::mem_row_major);
  }

  __device__ __forceinline__ void scale(float s) {
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < f[i].num_elements; ++e) f[i].x[e] *= s;
  }

  // Multiply row r of C by bcast[r * kBcastLd] (every one of the kBcastLd
  // columns of a row of bcast holds the row's factor). The factors come in
  // through an accumulator fragment loaded from bcast, which has the same
  // element layout as the warp's own fragments, so no layout is assumed.
  __device__ __forceinline__ void scale_rows(const float* __restrict__ bcast) {
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> r;
    nvcuda::wmma::load_matrix_sync(r, bcast + row_block() * 16 * kBcastLd,
                                   kBcastLd, nvcuda::wmma::mem_row_major);
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < r.num_elements; ++e) f[i].x[e] *= r.x[e];
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
