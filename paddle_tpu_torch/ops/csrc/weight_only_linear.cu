// Kernel C: the weight-only linear y = x @ dequant(W)^T for x [M, K] with M
// <= 64 rows (a decode step's batch, beam rows, a speculative verify block)
// and W stored as int8 codes [N, K] or int4 codes packed two to a byte
// [N, ceil(K/2)] (byte j: k = 2j in the low nibble, 2j + 1 in the high),
// with one f32 scale per output channel n.
//
// Replaces no TPU kernel. The reference leaves weight_only_linear
// (paddle_tpu/nn/quant/__init__.py:70-104) to XLA, which fuses the codes'
// dequantization into the product's operand read, so a weight is read as
// int8 (or int4) and never lands in HBM as bf16 (:6-11, :72-74). Plain
// PyTorch would dequantize into a bf16 weight first (1 byte read, 2
// written, 2 read again): slower than a bf16 weight. This kernel is that
// fusion: each weight byte is read from HBM once per call.
//
// Rounding points are the reference's (:78-102):
// - int8, bf16 x: w = bf16(bf16(q) * bf16(s)), then y = bf16(sum x * w),
//   the sum in f32 (mma.sync on bf16 fragments dequantized in registers);
// - int8, f32 x: w = q * s rounded to f32 (__fmul_rn, so no FMA merges it
//   into the product), y = sum x * w in f32 (CUDA cores);
// - int4: two f32 sums, even k against the low nibbles and odd k against
//   the high ones, each rounded to x's dtype; then y = dt(dt(y_lo + y_hi)
//   * dt(s)). Signs extend as (q << 4) >> 4 and q >> 4 on int8.
//
// What bounds it on the H100: bytes. A decode step's products are M x N x K
// multiply-adds for N x K weight bytes, 2M operations a byte (int8), well
// under the bf16 tensor cores' ~295 a byte; so the bf16 instance runs its
// products on tensor cores and the f32 one (the f32 parity runs only) on
// CUDA cores.
//
// Design: block b owns output columns [32 b, 32 b + 32), four warps of
// eight columns each, and walks its share of K in chunks of 256 code
// bytes (int4: 128). Four lanes share a column; each copies 16 code
// bytes of it per 64-byte slab, and x's chunk (all M rows, rounded up to
// 16) is staged beside them, by cp.async into a ring of stages in shared
// memory ahead of the products that use them. A lane's 16 codes feed four
// m16n8k16 products whose k positions are a permutation of the chunk's,
// the same one for the x fragment, so no code byte is shuffled. Where N
// gives fewer than two blocks an SM, K is split over blocks too, and a
// second launch adds the splits' f32 partial sums. Every sum runs in a
// fixed order (no atomics): two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockN = kWarps * 8;   // output columns a block owns
constexpr int kChunk = 256;           // the f32 kernel's chunk: code bytes
constexpr int kSlabs = kChunk / 64;   // a lane's 16-byte loads of a chunk
constexpr int kMaxRows = 64;

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ float lo_nibble(int8_t q) {
  return (float)(int8_t)((int8_t)(q << 4) >> 4);
}
__device__ __forceinline__ float hi_nibble(int8_t q) {
  return (float)(int8_t)(q >> 4);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 code bytes of column n from byte b of its row (zeros past the row or
// past N). vec: rows and base are 16-byte aligned.
__device__ __forceinline__ uint4 load_codes(const int8_t* __restrict__ w,
                                            int n, int N, int row_bytes,
                                            int b, bool vec) {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (n >= N || b >= row_bytes) return u;
  const int8_t* p = w + (size_t)n * row_bytes + b;
  if (vec && b + 16 <= row_bytes)
    return __ldg(reinterpret_cast<const uint4*>(p));
  int8_t* e = reinterpret_cast<int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) e[i] = b + i < row_bytes ? p[i] : 0;
  return u;
}

// N consecutive f32 x values of row r from column k (zeros past M or K);
// vec: rows and base are 16-byte aligned.
template <int N>
__device__ __forceinline__ void load_x(const float* __restrict__ x, int r,
                                       int k, int M, int K, bool vec,
                                       float (&v)[N]) {
  const float* p = x + (size_t)r * K + k;
  if (vec && r < M && k + N <= K) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p) + c);
      v[4 * c] = u.x, v[4 * c + 1] = u.y, v[4 * c + 2] = u.z,
      v[4 * c + 3] = u.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = r < M && k + i < K ? p[i] : 0.f;
}

// Stage the f32 kernel's x chunk, eight chunk positions a thread at a
// time: plane 0 holds x[r][b0 + j] (int8) or x[r][2 (b0 + j)] (int4, plane
// 1 the odd k), j < kChunk, zeros past K; M rows of kChunk a plane.
template <bool INT4>
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ x,
                                        int M, int K, int b0, bool vec) {
  constexpr int kGroups = kChunk / 8;
  for (int i = threadIdx.x; i < M * kGroups; i += kThreads) {
    const int r = i / kGroups, j = (i % kGroups) * 8;
    float* lo = xs + r * kChunk + j;
    if constexpr (INT4) {
      float v[16];
      load_x<16>(x, r, 2 * (b0 + j), M, K, vec, v);
      float* hi = lo + M * kChunk;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        lo[e] = v[2 * e];
        hi[e] = v[2 * e + 1];
      }
    } else {
      float v[8];
      load_x<8>(x, r, b0 + j, M, K, vec, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) lo[e] = v[e];
    }
  }
}

// -- bf16 x: tensor cores ---------------------------------------------------
//
// A chunk's codes and x rows (raw; int4: even and odd k side by side)
// land in shared memory by cp.async, two or three chunks deep, so one or
// two chunks' bytes are in flight while the warps multiply another. Blocks
// split K over blockIdx.y when N alone gives the card too few of them;
// each split then writes f32 partial sums, which a second pass adds in
// split order.

constexpr int kXC = 256;   // x values a staged row of a chunk
constexpr int kXR = kXC + 8;   // its padded length

// A chunk's code bytes of a column (int4 packs kXC values in half as
// many) and a lane's 16-byte copies of them.
template <bool INT4>
__host__ __device__ constexpr int chunk_bytes() {
  return INT4 ? kXC / 2 : kXC;
}
template <bool INT4>
__host__ __device__ constexpr int slabs() {
  return chunk_bytes<INT4>() / 64;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage chunk `chunk` of x: rows of kXC values x[r][kXC chunk + j], zeros
// past M or K. vec: 16-byte rows, filled by cp.async (zero-filled past K);
// else element by element.
__device__ __forceinline__ void stage_raw(__nv_bfloat16* xs,
                                          const __nv_bfloat16* __restrict__ x,
                                          int rows, int M, int K, int chunk,
                                          bool vec) {
  const int kx0 = chunk * kXC;
  if (vec) {
    for (int i = threadIdx.x; i < rows * (kXC / 8); i += kThreads) {
      const int r = i / (kXC / 8), j = (i % (kXC / 8)) * 8, k = kx0 + j;
      const int valid = r < M ? min(max(K - k, 0), 8) : 0;
      cp_async16(xs + r * kXR + j, valid ? x + (size_t)r * K + k : x,
                 2 * valid);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * kXC; i += kThreads) {
    const int r = i / kXC, j = i % kXC, k = kx0 + j;
    xs[r * kXR + j] = r < M && k < K ? x[(size_t)r * K + k]
                                     : __float2bfloat16_rn(0.f);
  }
}

// Issue one chunk's copies into a pipeline stage: x's rows (stage_raw) and
// this lane's 16 code bytes of each 64-byte slab of its column, which the
// lane alone reads back (slab i at ws[i * kThreads + thread]).
template <bool INT4>
__device__ __forceinline__ void issue_stage(
    __nv_bfloat16* xs, uint4* ws, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ w, int rows, int M, int N, int K,
    int row_bytes, int chunk, int n, int c, bool vec, bool vec_x) {
  stage_raw(xs, x, rows, M, K, chunk, vec_x);
#pragma unroll
  for (int i = 0; i < slabs<INT4>(); ++i) {
    const int b = chunk * chunk_bytes<INT4>() + 64 * i + 16 * c;
    uint4* dst = ws + i * kThreads + threadIdx.x;
    if (vec) {
      const int valid = n < N ? min(max(row_bytes - b, 0), 16) : 0;
      cp_async16(dst, valid ? w + (size_t)n * row_bytes + b : w, valid);
    } else {
      *dst = load_codes(w, n, N, row_bytes, b, false);
    }
  }
}

// One staged chunk into the tiles' sums. Codes e[4s .. 4s + 3] of slab i
// sit at chunk positions jb .. jb + 3 and play k = 2c, 2c + 1, 2c + 8,
// 2c + 9 of one m16n8k16 product, and so do the x values at the same
// positions (int4: the even k against the low nibbles, the odd k against
// the high ones, each pair picked out of one 16-byte row load).
template <bool INT4>
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* xs,
                                          const uint4 (&q)[slabs<INT4>()],
                                          int mt, int g, int c, float s_bf,
                                          float (&acc)[4][4],
                                          float (&acc_hi)[4][4]) {
  constexpr int XR = kXR;
#pragma unroll
  for (int i = 0; i < slabs<INT4>(); ++i) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&q[i]);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int jb = 64 * i + 16 * c + 4 * s;
      uint32_t b0r, b1r, h0r = 0, h1r = 0;
      if constexpr (INT4) {
        b0r = pack2(lo_nibble(e[4 * s]), lo_nibble(e[4 * s + 1]));
        b1r = pack2(lo_nibble(e[4 * s + 2]), lo_nibble(e[4 * s + 3]));
        h0r = pack2(hi_nibble(e[4 * s]), hi_nibble(e[4 * s + 1]));
        h1r = pack2(hi_nibble(e[4 * s + 2]), hi_nibble(e[4 * s + 3]));
      } else {
        // w = bf16(bf16(q) * bf16(s)): the product of two bf16 is exact in
        // f32, so one rounding
        b0r = pack2(__fmul_rn((float)e[4 * s], s_bf),
                    __fmul_rn((float)e[4 * s + 1], s_bf));
        b1r = pack2(__fmul_rn((float)e[4 * s + 2], s_bf),
                    __fmul_rn((float)e[4 * s + 3], s_bf));
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t >= mt) continue;
        const __nv_bfloat16* r0 = xs + (16 * t + g) * XR;
        const __nv_bfloat16* r1 = r0 + 8 * XR;
        if constexpr (INT4) {
          const uint4 u0 = *reinterpret_cast<const uint4*>(r0 + 2 * jb);
          const uint4 u1 = *reinterpret_cast<const uint4*>(r1 + 2 * jb);
          const uint32_t a[4] = {__byte_perm(u0.x, u0.y, 0x5410),
                                 __byte_perm(u1.x, u1.y, 0x5410),
                                 __byte_perm(u0.z, u0.w, 0x5410),
                                 __byte_perm(u1.z, u1.w, 0x5410)};
          const uint32_t ah[4] = {__byte_perm(u0.x, u0.y, 0x7632),
                                  __byte_perm(u1.x, u1.y, 0x7632),
                                  __byte_perm(u0.z, u0.w, 0x7632),
                                  __byte_perm(u1.z, u1.w, 0x7632)};
          mma_bf16(acc[t], a, b0r, b1r);
          mma_bf16(acc_hi[t], ah, h0r, h1r);
        } else {
          const uint2 v0 = *reinterpret_cast<const uint2*>(r0 + jb);
          const uint2 v1 = *reinterpret_cast<const uint2*>(r1 + jb);
          const uint32_t a[4] = {v0.x, v1.x, v0.y, v1.y};
          mma_bf16(acc[t], a, b0r, b1r);
        }
      }
    }
  }
}

// y (or, split over K, the f32 partials) of one element of the D fragment.
template <bool INT4>
__device__ __forceinline__ float finish_value(float lo, float hi, float s) {
  if constexpr (INT4) return __fmul_rn(bf(bf(lo) + bf(hi)), bf(s));
  return lo;
}

template <bool INT4, int STAGES>
__global__ void __launch_bounds__(kThreads)
    wo_mma_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w, const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                  int M, int N, int K, int row_bytes, bool vec, bool vec_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int XR = kXR, kSlabs = slabs<INT4>();
  const int mt = (M + 15) / 16, rows = mt * 16;
  // STAGES stages of (codes, x): codes first, 16-byte aligned
  uint4* ws = reinterpret_cast<uint4*>(smem_raw);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
      ws + STAGES * kSlabs * kThreads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int n0 = blockIdx.x * kBlockN + warp * 8;
  const int n_col = n0 + g;   // the column this lane's codes belong to
  const float s_bf = bf(n_col < N ? scale[n_col] : 0.f);
  // this split's chunks
  const int chunks =
      (row_bytes + chunk_bytes<INT4>() - 1) / chunk_bytes<INT4>();
  const int c_begin = (int)((long long)chunks * blockIdx.y / gridDim.y);
  const int n_chunks =
      (int)((long long)chunks * (blockIdx.y + 1) / gridDim.y) - c_begin;
  float acc[4][4], acc_hi[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = acc_hi[t][i] = 0.f;

  // a ring of STAGES: chunk i lands in stage i % STAGES, issued
  // STAGES - 1 chunks ahead of its products
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_chunks)
      issue_stage<INT4>(xs + st * rows * XR, ws + st * kSlabs * kThreads, x, w,
                        rows, M, N, K, row_bytes, c_begin + st, n_col, c, vec,
                        vec_x);
    cp_async_commit();
  }
  for (int it = 0; it < n_chunks; ++it) {
    const int ahead = it + STAGES - 1;
    if (ahead < n_chunks) {
      // the stage the previous iteration read, freed by its last barrier
      const int st = ahead % STAGES;
      issue_stage<INT4>(xs + st * rows * XR, ws + st * kSlabs * kThreads, x,
                        w, rows, M, N, K, row_bytes, c_begin + ahead, n_col, c,
                        vec, vec_x);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // chunk it has landed (this thread's)
    __syncthreads();               // ... and every thread's x
    const int st = it % STAGES;
    uint4 q[kSlabs];
#pragma unroll
    for (int i = 0; i < kSlabs; ++i)
      q[i] = ws[(st * kSlabs + i) * kThreads + threadIdx.x];
    mma_chunk<INT4>(xs + st * rows * XR, q, mt, g, c, s_bf, acc, acc_hi);
    __syncthreads();   // every warp is done with stage st
  }
  // D fragment: acc[t][0..1] at row 16 t + g, columns n0 + 2c, + 1;
  // acc[t][2..3] at row + 8
  const size_t plane = (size_t)M * N;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= mt) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * t + g + (i >= 2 ? 8 : 0);
      const int n = n0 + 2 * c + (i & 1);
      if (r >= M || n >= N) continue;
      const size_t at = (size_t)r * N + n;
      if (gridDim.y == 1) {
        y[at] = __float2bfloat16_rn(
            finish_value<INT4>(acc[t][i], acc_hi[t][i], scale[n]));
      } else {
        float* p = part + (size_t)blockIdx.y * (INT4 ? 2 : 1) * plane;
        p[at] = acc[t][i];
        if constexpr (INT4) p[plane + at] = acc_hi[t][i];
      }
    }
  }
}

// The splits' partial sums added in split order, then y's rounding.
template <bool INT4>
__global__ void wo_split_finish(const float* __restrict__ part,
                                const float* __restrict__ scale,
                                __nv_bfloat16* __restrict__ y, int M, int N,
                                int splits) {
  const size_t plane = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  constexpr int kPlanes = INT4 ? 2 : 1;
  float lo = 0.f, hi = 0.f;
  for (int s = 0; s < splits; ++s) {
    lo += part[s * kPlanes * plane + i];
    if constexpr (INT4) hi += part[(s * kPlanes + 1) * plane + i];
  }
  y[i] = __float2bfloat16_rn(finish_value<INT4>(lo, hi, scale[i % N]));
}

// f32 x: CUDA cores. Each column's partial dot products over a chunk go to
// shared sums in chunk order.
template <bool INT4>
__global__ void __launch_bounds__(kThreads)
    wo_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ y,
                  int M, int N, int K, int row_bytes, bool vec, bool vec_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kPlanes = INT4 ? 2 : 1;
  float* xs = reinterpret_cast<float*>(smem_raw);  // [planes][M][kChunk]
  float* sums = xs + kPlanes * M * kChunk;         // [planes][M][kBlockN]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int col = warp * 8 + g;
  const int n_col = blockIdx.x * kBlockN + col;
  const float s_col = n_col < N ? scale[n_col] : 0.f;
  for (int i = threadIdx.x; i < kPlanes * M * kBlockN; i += kThreads)
    sums[i] = 0.f;

  for (int b0 = 0; b0 < row_bytes; b0 += kChunk) {
    uint4 q[kSlabs];
#pragma unroll
    for (int i = 0; i < kSlabs; ++i)
      q[i] = load_codes(w, n_col, N, row_bytes, b0 + 64 * i + 16 * c, vec);
    __syncthreads();
    stage_x<INT4>(xs, x, M, K, b0, vec_x);
    __syncthreads();
    for (int m = 0; m < M; ++m) {
      float part = 0.f, part_hi = 0.f;
#pragma unroll
      for (int i = 0; i < kSlabs; ++i) {
        const int8_t* e = reinterpret_cast<const int8_t*>(&q[i]);
        const float* xr = xs + m * kChunk + 64 * i + 16 * c;
#pragma unroll
        for (int v = 0; v < 16; ++v) {
          if constexpr (INT4) {
            part = fmaf(xr[v], lo_nibble(e[v]), part);
            part_hi = fmaf(xr[M * kChunk + v], hi_nibble(e[v]), part_hi);
          } else {
            part = fmaf(xr[v], __fmul_rn((float)e[v], s_col), part);
          }
        }
      }
      // the four lanes of a column, in a fixed order
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if constexpr (INT4) {
        part_hi += __shfl_xor_sync(0xffffffffu, part_hi, 1);
        part_hi += __shfl_xor_sync(0xffffffffu, part_hi, 2);
      }
      if (c == 0) {
        sums[m * kBlockN + col] += part;
        if constexpr (INT4) sums[(M + m) * kBlockN + col] += part_hi;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * kBlockN; i += kThreads) {
    const int m = i / kBlockN, cl = i % kBlockN;
    const int n = blockIdx.x * kBlockN + cl;
    if (n >= N) continue;
    float v = sums[i];
    if constexpr (INT4)
      v = __fmul_rn(__fadd_rn(v, sums[M * kBlockN + i]), scale[n]);
    y[(size_t)m * N + n] = v;
  }
}

// The tensor-core kernel's stages, three up to 32 rows of x (two chunks
// in flight), two above (one; the rows' staging would otherwise leave one
// block an SM), each the codes (16 bytes a thread a slab) and x's rows.
int mma_stages(int rows) { return rows <= 32 ? 3 : 2; }

template <bool INT4>
size_t mma_smem_bytes(int rows) {
  return (size_t)mma_stages(rows) *
         (slabs<INT4>() * kThreads * sizeof(uint4) +
          rows * kXR * sizeof(__nv_bfloat16));
}

// The kernels' dynamic shared memory at its largest (64 rows), allowed
// once per instance.
template <bool INT4>
cudaError_t allow_smem() {
  static cudaError_t status = [] {
    constexpr int kPlanes = INT4 ? 2 : 1;
    cudaError_t err = cudaFuncSetAttribute(
        wo_mma_kernel<INT4, 3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)mma_smem_bytes<INT4>(32));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        wo_mma_kernel<INT4, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)mma_smem_bytes<INT4>(kMaxRows));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(
        wo_f32_kernel<INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kPlanes * kMaxRows * (kChunk + kBlockN) * sizeof(float)));
  }();
  return status;
}

template <bool INT4>
cudaError_t launch(const void* x, const int8_t* w, const float* scale, void* y,
                   int M, int N, int K, int dtype, int splits, float* part,
                   cudaStream_t s) {
  const int row_bytes = INT4 ? (K + 1) / 2 : K;
  const bool vec =
      row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  // x rows start 16-byte aligned: K a multiple of 16 bytes' elements
  const bool vec_x = K % (dtype == 1 ? 8 : 4) == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int blocks = (N + kBlockN - 1) / kBlockN;
  constexpr int kPlanes = INT4 ? 2 : 1;
  const cudaError_t err = allow_smem<INT4>();
  if (err != cudaSuccess) return err;
  if (dtype == 1) {
    const int rows = (M + 15) / 16 * 16;
    const size_t bytes = mma_smem_bytes<INT4>(rows);
    auto kernel = mma_stages(rows) == 3 ? wo_mma_kernel<INT4, 3>
                                        : wo_mma_kernel<INT4, 2>;
    kernel<<<dim3(blocks, splits), kThreads, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, scale,
        static_cast<__nv_bfloat16*>(y), part, M, N, K, row_bytes, vec, vec_x);
    if (splits > 1) {
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      const int threads = 256;
      wo_split_finish<INT4><<<(M * N + threads - 1) / threads, threads, 0, s>>>(
          part, scale, static_cast<__nv_bfloat16*>(y), M, N, splits);
    }
  } else {
    const size_t bytes =
        (size_t)kPlanes * M * (kChunk + kBlockN) * sizeof(float);
    wo_f32_kernel<INT4><<<blocks, kThreads, bytes, s>>>(
        static_cast<const float*>(x), w, scale, static_cast<float*>(y), M, N,
        K, row_bytes, vec, vec_x);
  }
  return cudaGetLastError();
}

}  // namespace

// y [M, N] = x [M, K] @ dequant(w)^T. int4: w is [N, ceil(K/2)] packed;
// else [N, K]. dtype: 0 f32, 1 bf16 (attention_common.cuh: ptt::DType).
// splits: the bf16 kernel's split of K over blocks (1 for f32); past 1,
// part holds splits x (int4 ? 2 : 1) x M x N f32 partial sums.
extern "C" int weight_only_linear_launch(const void* x, const int8_t* w,
                                         const float* scale, void* y, int M,
                                         int N, int K, int int4, int dtype,
                                         int splits, float* part,
                                         void* stream) {
  const int row_bytes = int4 ? (K + 1) / 2 : K;
  const int per_chunk = int4 ? chunk_bytes<true>() : chunk_bytes<false>();
  const int chunks = (row_bytes + per_chunk - 1) / per_chunk;
  if (M < 1 || M > kMaxRows || N < 1 || K < 1 || (dtype != 0 && dtype != 1) ||
      splits < 1 || splits > chunks || (splits > 1 && (dtype != 1 || !part)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int4 ? launch<true>(x, w, scale, y, M, N, K, dtype, splits, part, s)
              : launch<false>(x, w, scale, y, M, N, K, dtype, splits, part, s);
}
