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
//   the sum in f32;
// - int8, f32 x: w = q * s rounded to f32 (__fmul_rn, so no FMA merges it
//   into the product), y = sum x * w in f32 (CUDA cores);
// - int4: two f32 sums, even k against the low nibbles and odd k against
//   the high ones, each rounded to x's dtype; then y = dt(dt(y_lo + y_hi)
//   * dt(s)). Signs extend as (q << 4) >> 4 and q >> 4 on int8.
//
// What bounds it on the H100: bytes. A decode step's products are M x N x K
// multiply-adds for N x K weight bytes, 2M operations a byte (int8), well
// under the bf16 tensor cores' ~295 a byte; the kernel has to keep the
// HBM busy and spend few instructions a code byte.
//
// Design of the bf16 instance (wo_hopper_kernel), one block a tile of 64
// or 128 channels of W and a contiguous share of its K:
// - the operands are swapped: the output channels are wgmma's M (64 per
//   consumer warpgroup) and x's rows its N, rounded up to 8 (instances n8
//   .. n64), so no product row is padding. A is the dequantized codes in
//   registers, B is x, K-major in shared memory;
// - a producer warp keeps a ring of 2-24 stages full by TMA: a stage is
//   128 code bytes of each of the tile's rows (one 2-D box, 128-byte
//   swizzle: 8 or 16 KB) and x's rows over the same k (64-element boxes);
//   the consumers wait on the stage's mbarrier and free it on another. A
//   group of tile / 64 consumer warpgroups covers the tile's channels;
//   where registers allow, the block's 4 (n16-n32 int8, n16-n24 int4) or
//   6 (n8) warpgroups make several groups that take turns at the stages;
// - dequantization in registers, the same bits as the reference's: an
//   int8 code's low 7 bits under the bf16 exponent of 128, less 128 or
//   256 by its sign bit, is q exactly, and one bf16 multiply by s rounds
//   q s once (exact in f32, so the reference's bf16(bf16(q) * bf16(s)));
//   an int4 nibble n xor 8 under the same exponent is 136 + n, less 136.
//   The scale stays out of the int4 sums, as the reference has it;
// - the A fragment's k positions (2c, 2c + 1, 2c + 8, 2c + 9 for lane
//   4g + c, hopper.cuh) are two 4-byte words of a code row a k-step, read
//   conflict-free from the swizzled rows; for int4 a stage's x is split in
//   place into its even and odd k, so each code byte's low nibble meets
//   x[2j] and its high nibble x[2j + 1] in two products a k-step;
// - K is split over a thread block cluster of 1-8 blocks along K (the
//   launch plan, ops/weight_only.py: plan, which also picks the tile):
//   each block sums its share, the others' f32 sums reach block 0 through
//   distributed shared memory and are added in rank order, and block 0
//   rounds and stores y. One launch,
//   no partial buffer in HBM, every sum in a fixed order: two launches give
//   the same bits. A cluster spans K, so its blocks read different parts
//   of x and TMA multicast has nothing to share; x (at most 1.4 MB) comes
//   from the L2;
// - code rows or x rows that TMA cannot address (a row no multiple of 16
//   bytes, an unaligned base) are copied by the producer warp's 32 threads
//   into the same swizzled layout instead: slower, same kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace ptt::hopper;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockN = kWarps * 8;   // the f32 kernel's output columns
constexpr int kChunk = 256;           // the f32 kernel's chunk: code bytes
constexpr int kSlabs = kChunk / 64;   // a lane's 16-byte loads of a chunk
constexpr int kMaxRows = 64;

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float lo_nibble(int8_t q) {
  return (float)(int8_t)((int8_t)(q << 4) >> 4);
}
__device__ __forceinline__ float hi_nibble(int8_t q) {
  return (float)(int8_t)(q >> 4);
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

// -- bf16 x: TMA ring, register-A wgmma, split K over a cluster -------------
//
// A stage is kUnitBytes code bytes of each of the tile's TN rows (a
// "unit": 128 k of int8, 256 k of int4; TN 64 or 128 channels) and x's NT
// rows over the same k. The launch plan (ops/weight_only.py: plan, which
// mirrors the constants and stage_bytes below) picks the tile, the
// cluster size and the ring's depth.

constexpr int kUnitBytes = 128;        // code bytes a row a stage
constexpr int kCodeBoxes = kUnitBytes / 128;
constexpr int kMaxSplits = 8;          // blocks a cluster (portable limit)
constexpr int kMaxStages = 24;
constexpr int kSmemLimit = 232448;     // an H100 block's shared memory
constexpr int kAlignSlack = 1024;      // the 128-byte swizzle's alignment

// x values a stage covers and their 64-element TMA boxes.
template <bool INT4>
__host__ __device__ constexpr int unit_k() {
  return INT4 ? 2 * kUnitBytes : kUnitBytes;
}

// A stage's bytes: the codes, then x's boxes, NT rows of 128 bytes each.
template <bool INT4>
__host__ __device__ constexpr int stage_bytes(int nt, int tn) {
  return tn * kUnitBytes + unit_k<INT4>() / 64 * nt * 128;
}

// Consumer warpgroups a block: a group of TN / 64 covers the tile's
// channels, and where their registers fit 4 or 6 warpgroups make several
// groups that take turns at the stages (on the card 16 consumer warps beat
// 8 by some 15%, 24 beat 16 by 3-5% at n8).
__host__ __device__ constexpr int consumer_wgs(bool int4, int nt) {
  return nt <= 8 ? 6 : (int4 ? nt <= 24 : nt <= 32) ? 4 : 2;
}

// The block's dynamic shared memory: the ring (2-24 stages, on a 1024-byte
// boundary) and its full and empty mbarriers. After the main loop the ring
// holds the f32 sums the groups and the cluster add (weight_only_linear_
// launch refuses a ring too small for them).
template <bool INT4>
__host__ __device__ constexpr int hopper_smem_bytes(int nt, int stages,
                                                   int tn) {
  return kAlignSlack + stages * (stage_bytes<INT4>(nt, tn) + 16);
}

struct WoArgs {
  const __nv_bfloat16* x;
  const int8_t* w;
  const float* scale;
  __nv_bfloat16* y;
  int M, N, K, row_bytes;
  int units;    // kUnitBytes units a code row
  int splits;   // blocks a cluster: K's split
  int stages;   // the ring's depth
  int tma_w, tma_x;   // TMA can address the codes / x (else threads copy)
};

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts64(uint32_t addr, uint32_t v0,
                                      uint32_t v1) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v0),
               "r"(v1)
               : "memory");
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two int8 codes q (bytes 0 and 2 of p) as the bf16 pair bf16(q s): q's low
// 7 bits below the exponent of 128 read 128 + (q & 127), and less 128 (q
// >= 0) or 256 (bit 7 set: q < 0) that is q exactly; one bf16 multiply by
// s2 = (s, s) rounds q s once, as the reference's bf16(q) * bf16(s) in f32
// (an 8-bit code times a bf16 scale is exact in f32).
__device__ __forceinline__ uint32_t dq8_pair(uint32_t p, __nv_bfloat162 s2) {
  const uint32_t v = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (p & 0x00800080u) | 0x43004300u;
  return as_u32(__hmul2(__hsub2(as_bf162(v), as_bf162(c)), s2));
}

// Low and high nibbles of bytes 0 and 2 of p as bf16 pairs (n0, n2): each
// nibble xor 8 is n + 8, below the bf16 136's exponent 0x4300 it reads as
// 136 + n, and 136 - 136 leaves n exactly.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t p) {
  return as_u32(__hsub2(as_bf162((p & 0x000F000Fu) ^ 0x43084308u),
                        as_bf162(0x43084308u)));   // (136, 136)
}

template <bool INT4, int NT, int TN>
__global__ void __launch_bounds__(consumer_wgs(INT4, NT) * 128 + 32, 1)
    wo_hopper_kernel(const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap x_map, WoArgs a) {
  constexpr int kConsumers = consumer_wgs(INT4, NT) * 128;
  constexpr int kGroupThreads = 2 * TN;        // TN / 64 warpgroups
  constexpr int kGroups = kConsumers / kGroupThreads;
  constexpr int kCodeBox = TN * 128;           // one code box: 128 B a row
  constexpr int kCodeBytes = TN * kUnitBytes;  // a stage's codes
  constexpr int kSB = stage_bytes<INT4>(NT, TN);
  constexpr int kBox = NT * 128;               // one x box's bytes
  constexpr int kXBoxes = unit_k<INT4>() / 64;
  constexpr int kSteps = kUnitBytes / 16;      // k-steps a stage
  constexpr int kBatch = 4;                    // k-steps a wgmma batch
  constexpr int kSub = kSteps / kBatch;        // wgmma batches a stage: 2
  constexpr int kAcc = NT / 2;                 // accumulators a thread
  static_assert(kSub % 2 == 0, "the fragments alternate within a stage");
  unsigned char* base = aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(base + a.stages * kSB);
  uint64_t* empty = full + a.stages;
  const int rank = blockIdx.x;   // the cluster spans gridDim.x = splits
  const int n0 = blockIdx.y * TN;
  const int u0 = (int)((long long)a.units * rank / a.splits);
  const int n_it = (int)((long long)a.units * (rank + 1) / a.splits) - u0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);    // the producer's lane 0, with the bytes
      mbar_init(&empty[s], kGroupThreads / 32);   // the group's warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // -- producer warp: TMA (or copies) into the ring ------------------------
    const int lane = threadIdx.x & 31;
    for (int it = 0; it < n_it; ++it) {
      const int st = it % a.stages;
      mbar_wait_sleep(&empty[st], ((it / a.stages) & 1) ^ 1);
      unsigned char* stage = base + st * kSB;
      const int u = u0 + it;
      if (!a.tma_w) {
        // 4-byte words of the tile's rows, zeros past N or the row
        for (int i = lane; i < kCodeBoxes * TN * 32; i += 32) {
          const int j = i / (TN * 32), r = (i >> 5) % TN;
          const int wd = i & 31, n = n0 + r;
          const int b = u * kUnitBytes + 128 * j + 4 * wd;
          uint32_t v = 0;
          if (n < a.N) {
            const unsigned char* p = reinterpret_cast<const unsigned char*>(
                a.w + (size_t)n * a.row_bytes);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (b + e < a.row_bytes) v |= (uint32_t)p[b + e] << (8 * e);
          }
          sts32(smem_addr(stage + j * kCodeBox + r * 128 +
                          (((wd >> 2) ^ (r & 7)) << 4) + 4 * (wd & 3)),
                v);
        }
      }
      if (!a.tma_x) {
        // bf16 pairs of x's rows, zeros past M or K
        const unsigned short* xs =
            reinterpret_cast<const unsigned short*>(a.x);
        for (int i = lane; i < kXBoxes * NT * 32; i += 32) {
          const int j = i / (NT * 32), r = (i >> 5) % NT, wd = i & 31;
          const int k = u * unit_k<INT4>() + 64 * j + 2 * wd;
          uint32_t v = 0;
          if (r < a.M) {
            const unsigned short* p = xs + (size_t)r * a.K;
            if (k < a.K) v = p[k];
            if (k + 1 < a.K) v |= (uint32_t)p[k + 1] << 16;
          }
          sts32(smem_addr(stage + kCodeBytes + j * kBox + r * 128 +
                          (((wd >> 2) ^ (r & 7)) << 4) + 4 * (wd & 3)),
                v);
        }
      }
      if (!a.tma_w || !a.tma_x) fence_proxy_async();
      __syncwarp();   // the lanes' copies before lane 0's arrival
      if (lane == 0) {
        const uint32_t tx = (a.tma_w ? kCodeBytes : 0) +
                            (a.tma_x ? kSB - kCodeBytes : 0);
        mbar_arrive_expect_tx(&full[st], tx);
        if (a.tma_w)
#pragma unroll
          for (int j = 0; j < kCodeBoxes; ++j)
            tma_load_2d(smem_addr(stage + j * kCodeBox), &w_map,
                        smem_addr(&full[st]), u * kUnitBytes + 128 * j, n0);
        if (a.tma_x)
#pragma unroll
          for (int j = 0; j < kXBoxes; ++j)
            tma_load_2d(smem_addr(stage + kCodeBytes + j * kBox), &x_map,
                        smem_addr(&full[st]), u * unit_k<INT4>() + 64 * j, 0);
      }
    }
    if (a.splits > 1) {
      cluster_sync();   // the consumers' sums are in shared memory
      cluster_sync();   // block 0 has read them
    }
    return;
  }

  // -- consumers: dequantize into A fragments, wgmma against x -------------
  // group p takes stages p, p + kGroups, ...; a group's thread t owns the
  // same channels in every group
  const int group = threadIdx.x / kGroupThreads;
  const int tid = threadIdx.x % kGroupThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  // this thread's two code rows (channels): r_local and r_local + 8
  const int r_local = 16 * warp + g;   // warp 4..7 is warpgroup 1: + 64
  const int ch[2] = {n0 + r_local, n0 + r_local + 8};
  float s_bf[2];
  __nv_bfloat162 s2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s_bf[h] = bf(ch[h] < a.N ? a.scale[ch[h]] : 0.f);
    s2[h] = __floats2bfloat162_rn(s_bf[h], s_bf[h]);
  }
  // the lane's codes at k = 2c, 2c + 1 are bytes 2 (c & 1), + 1 of word
  // c >> 1 of a k-step's 16 bytes (k = 2c + 8, + 9: of word 2 + (c >> 1));
  // the byte permute puts them in bytes 0 and 2 (16-bit lanes)
  const uint32_t sel = 0x1100u * (2u * (c & 1) + 1) + 0x11u * (2u * (c & 1));

  float acc[kAcc], acc_hi[INT4 ? kAcc : 1];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (INT4 ? kAcc : 1); ++i) acc_hi[i] = 0.f;

  // Batches of kBatch k-steps alternate between two fragment sets: a batch
  // is dequantized while the one before it runs on the tensor cores, and
  // a stage is freed once its last batch has run (the next stage's first
  // wait).
  uint32_t frag[2][kBatch][4], frag_hi[2][INT4 ? kBatch : 1][4];
  int prev_st = -1;
  for (int it = group; it < n_it; it += kGroups) {
    const int st = it % a.stages;
    mbar_wait_sleep(&full[st], (it / a.stages) & 1);
    const uint32_t codes = smem_addr(base + st * kSB) + r_local * 128;
    const uint32_t xs = smem_addr(base + st * kSB + kCodeBytes);
    if constexpr (INT4) {
      // x's even k to boxes 0 and 1, its odd k to 2 and 3, in place: the
      // group's threads read their 16-byte chunks (8 values), wait for
      // each other, write them split and fence them for wgmma
      constexpr int kChunks = NT * 32 / kGroupThreads;   // of NT rows x 32
      uint4 v[kChunks];
#pragma unroll
      for (int t = 0; t < kChunks; ++t) {
        const int i = tid + kGroupThreads * t, r = i >> 5, q = i & 31;
        v[t] = lds128(xs + (q >> 3) * kBox + r * 128 +
                      (((q & 7) ^ (r & 7)) << 4));
      }
      named_bar_sync(2 + group, kGroupThreads);
#pragma unroll
      for (int t = 0; t < kChunks; ++t) {
        // pairs 4q .. 4q + 3: box q / 16, 8 bytes at 8 (q % 16) of row r
        const int i = tid + kGroupThreads * t, r = i >> 5, q = i & 31;
        const uint32_t at = xs + (q >> 4) * kBox + r * 128 +
                            ((((q & 15) >> 1) ^ (r & 7)) << 4) + 8 * (q & 1);
        sts64(at, __byte_perm(v[t].x, v[t].y, 0x5410),
              __byte_perm(v[t].z, v[t].w, 0x5410));
        sts64(at + 2 * kBox, __byte_perm(v[t].x, v[t].y, 0x7632),
              __byte_perm(v[t].z, v[t].w, 0x7632));
      }
      fence_proxy_async();
      named_bar_sync(2 + group, kGroupThreads);
    }
#pragma unroll
    for (int sb = 0; sb < kSub; ++sb) {
      uint32_t(&f)[kBatch][4] = frag[sb & 1];
      uint32_t(&fh)[INT4 ? kBatch : 1][4] = frag_hi[sb & 1];
#pragma unroll
      for (int s4 = 0; s4 < kBatch; ++s4) {
        const int s = kBatch * sb + s4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // row r_local + 8 h: the same swizzle (r & 7 == g)
          const uint32_t row = codes + h * 1024;
          // 16 code bytes a k-step: box s / 8, chunk s % 8
          const uint32_t at = row + (s >> 3) * kCodeBox +
                              (((s & 7) ^ g) << 4) + 4 * (c >> 1);
          const uint32_t p0 = __byte_perm(lds32(at), 0u, sel);
          const uint32_t p1 = __byte_perm(lds32(at + 8), 0u, sel);
          if constexpr (INT4) {
            // the low nibbles against x's even k, the high ones the odd
            f[s4][h] = nibbles_bf16(p0);
            f[s4][2 + h] = nibbles_bf16(p1);
            fh[s4][h] = nibbles_bf16(p0 >> 4);
            fh[s4][2 + h] = nibbles_bf16(p1 >> 4);
          } else {
            f[s4][h] = dq8_pair(p0, s2[h]);
            f[s4][2 + h] = dq8_pair(p1, s2[h]);
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int s4 = 0; s4 < kBatch; ++s4) {
        const int s = kBatch * sb + s4;
        const uint64_t desc =
            sw128_desc(xs + (s >> 2) * kBox + (s & 3) * 32, 16, 1024);
        wgmma_rs_kb<NT>(acc, f[s4], desc);
        if constexpr (INT4)   // the odd k's boxes follow the even ones'
          wgmma_rs_kb<NT>(acc_hi, fh[s4], desc + 2 * kBox / 16);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the batch before this one has run
      if (sb == 0 && prev_st >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev_st]);
      }
    }
    prev_st = st;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (INT4) fence_regs(acc_hi);

  // the groups' sums, then the cluster's: f32 sums in the ring (register
  // i of thread t at [i][t], a region for each source), added in a fixed
  // order: group 0's plus group 1's, 2's..., then block 0's plus the other
  // blocks' in rank order through distributed shared memory
  constexpr int kSumBytes = (INT4 ? 2 : 1) * kAcc * kGroupThreads * 4;
  auto sum_at = [&](int region, int i) {
    return smem_addr(base) + region * kSumBytes +
           4 * (i * kGroupThreads + tid);
  };
  auto store_sums = [&](int region) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(sum_at(region, i)),
                   "f"(acc[i])
                   : "memory");
      if constexpr (INT4)
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(
                         sum_at(region, kAcc + i)),
                     "f"(acc_hi[i])
                     : "memory");
    }
  };
  // a source's sums are loaded before any is added: the loads' latencies
  // overlap
  auto add_sums = [&](int region, auto load) {
    float lo[kAcc], hi[INT4 ? kAcc : 1];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      lo[i] = load(sum_at(region, i));
      if constexpr (INT4) hi[i] = load(sum_at(region, kAcc + i));
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      acc[i] += lo[i];
      if constexpr (INT4) acc_hi[i] += hi[i];
    }
  };
  if (kGroups > 1 || a.splits > 1)   // every consumer is done with the ring
    named_bar_sync(1, kConsumers);
  if constexpr (kGroups > 1) {
    if (group > 0) store_sums(group - 1);
    named_bar_sync(1, kConsumers);
    if (group == 0)
      for (int q = 1; q < kGroups; ++q)
        add_sums(q - 1, [](uint32_t at) { return lds_f32(at); });
  }
  if (a.splits > 1) {
    if (rank != 0 && group == 0) store_sums(0);
    cluster_sync();
    if (rank == 0 && group == 0)
      for (int r = 1; r < a.splits; ++r)
        add_sums(0, [r](uint32_t at) { return ld_cluster_f32(at, r); });
    cluster_sync();
  }
  if (rank != 0 || group != 0) return;

  // D fragment: register i is channel r_local + 8 ((i >> 1) & 1), x row
  // 8 (i >> 2) + 2c + (i & 1)
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int h = (i >> 1) & 1;
    const int m = 8 * (i >> 2) + 2 * c + (i & 1);
    if (m >= a.M || ch[h] >= a.N) continue;
    float v = acc[i];
    if constexpr (INT4) v = __fmul_rn(bf(bf(acc[i]) + bf(acc_hi[i])), s_bf[h]);
    a.y[(size_t)m * a.N + ch[h]] = __float2bfloat16_rn(v);
  }
}

// f32 x: CUDA cores. Each column's partial dot products over a chunk go to
// shared sums in chunk order.
template <bool INT4>
__global__ void __launch_bounds__(kThreads)
    wo_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ y,
                  int M, int N, int K, int row_bytes, bool vec, bool vec_x) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  constexpr int kPlanes = INT4 ? 2 : 1;
  float* xs = reinterpret_cast<float*>(smem_f32);  // [planes][M][kChunk]
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


// The instances' dynamic shared memory ceiling, allowed once each.
template <bool INT4, int NT, int TN>
cudaError_t allow_hopper_smem() {
  static const cudaError_t status = cudaFuncSetAttribute(
      wo_hopper_kernel<INT4, NT, TN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  return status;
}

template <bool INT4>
cudaError_t allow_f32_smem() {
  static const cudaError_t status = cudaFuncSetAttribute(
      wo_f32_kernel<INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)((INT4 ? 2 : 1) * kMaxRows * (kChunk + kBlockN) * sizeof(float)));
  return status;
}

template <bool INT4, int NT, int TN>
cudaError_t launch_hopper(const WoArgs& a, cudaStream_t s) {
  CUtensorMap w_map = {}, x_map = {};
  cudaError_t err = cudaSuccess;
  if (a.tma_w)
    err = swizzled_2d_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w,
                          a.row_bytes, a.N, a.row_bytes, 128, TN);
  if (err == cudaSuccess && a.tma_x)
    err = swizzled_2d_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.K,
                          a.M, (size_t)a.K * 2, 64, NT);
  if (err == cudaSuccess) err = allow_hopper_smem<INT4, NT, TN>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, (a.N + TN - 1) / TN, 1);
  cfg.blockDim = dim3(consumer_wgs(INT4, NT) * 128 + 32, 1, 1);
  cfg.dynamicSmemBytes = hopper_smem_bytes<INT4>(NT, a.stages, TN);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, wo_hopper_kernel<INT4, NT, TN>, w_map,
                            x_map, a);
}

template <bool INT4, int NT>
cudaError_t launch_tile(const WoArgs& a, int tile_n, cudaStream_t s) {
  return tile_n == 64 ? launch_hopper<INT4, NT, 64>(a, s)
                      : launch_hopper<INT4, NT, 128>(a, s);
}

template <bool INT4>
cudaError_t launch_bf16(const WoArgs& a, int tile_n, cudaStream_t s) {
  switch ((a.M + 7) / 8) {
    case 1: return launch_tile<INT4, 8>(a, tile_n, s);
    case 2: return launch_tile<INT4, 16>(a, tile_n, s);
    case 3: return launch_tile<INT4, 24>(a, tile_n, s);
    case 4: return launch_tile<INT4, 32>(a, tile_n, s);
    case 5: return launch_tile<INT4, 40>(a, tile_n, s);
    case 6: return launch_tile<INT4, 48>(a, tile_n, s);
    case 7: return launch_tile<INT4, 56>(a, tile_n, s);
    default: return launch_tile<INT4, 64>(a, tile_n, s);
  }
}

template <bool INT4>
cudaError_t launch_f32(const float* x, const int8_t* w, const float* scale,
                       float* y, int M, int N, int K, cudaStream_t s) {
  const int row_bytes = INT4 ? (K + 1) / 2 : K;
  const bool vec =
      row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaError_t err = allow_f32_smem<INT4>();
  if (err != cudaSuccess) return err;
  const size_t bytes =
      (size_t)(INT4 ? 2 : 1) * M * (kChunk + kBlockN) * sizeof(float);
  wo_f32_kernel<INT4><<<(N + kBlockN - 1) / kBlockN, kThreads, bytes, s>>>(
      x, w, scale, y, M, N, K, row_bytes, vec, vec_x);
  return cudaGetLastError();
}

}  // namespace

// y [M, N] = x [M, K] @ dequant(w)^T. int4: w is [N, ceil(K/2)] packed;
// else [N, K]. dtype: 0 f32, 1 bf16 (attention_common.cuh: ptt::DType).
// splits, stages and tile_n: the bf16 kernel's launch plan
// (ops/weight_only.py: plan): blocks a cluster along K (1..8, at most one
// a 128-byte unit of a code row), the ring's depth (2..12, within the
// block's shared memory) and a block's channels (64 or 128); the f32
// kernel takes none of them.
extern "C" int weight_only_linear_launch(const void* x, const int8_t* w,
                                         const float* scale, void* y, int M,
                                         int N, int K, int int4, int dtype,
                                         int splits, int stages, int tile_n,
                                         void* stream) {
  const int row_bytes = int4 ? (K + 1) / 2 : K;
  const int units = (row_bytes + kUnitBytes - 1) / kUnitBytes;
  if (M < 1 || M > kMaxRows || N < 1 || K < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int4 ? launch_f32<true>(static_cast<const float*>(x), w, scale,
                                   static_cast<float*>(y), M, N, K, s)
                : launch_f32<false>(static_cast<const float*>(x), w, scale,
                                    static_cast<float*>(y), M, N, K, s);
  const int nt = (M + 7) / 8 * 8;
  const int smem = int4 ? hopper_smem_bytes<true>(nt, stages, tile_n)
                        : hopper_smem_bytes<false>(nt, stages, tile_n);
  // a group keeps its last stage until its next one lands: the ring holds
  // a stage beyond the groups' unless a block's stages all fit at once
  const int groups = consumer_wgs(int4, nt) / (tile_n / 64);
  const int most = (units + splits - 1) / splits;   // a block's stages
  // the other groups' sums, or the cluster's, a region each (the kernel's
  // kSumBytes: f32 accumulators of a group's 2 tile_n threads)
  const int regions = groups > 2 ? groups - 1 : 1;
  const long long sums = (long long)regions * (int4 ? 2 : 1) * (nt / 2) *
                         (2 * tile_n) * 4;
  const long long ring =
      (long long)stages * (int4 ? stage_bytes<true>(nt, tile_n)
                                : stage_bytes<false>(nt, tile_n));
  if (splits < 1 || splits > kMaxSplits || splits > units || stages < 2 ||
      stages > kMaxStages || (tile_n != 64 && tile_n != 128) ||
      stages < (most < groups + 1 ? most : groups + 1) || sums > ring ||
      smem > kSmemLimit)
    return cudaErrorInvalidValue;
  WoArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = w;
  a.scale = scale;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.M = M;
  a.N = N;
  a.K = K;
  a.row_bytes = row_bytes;
  a.units = units;
  a.splits = splits;
  a.stages = stages;
  // TMA's global rows are 16-byte multiples from a 16-byte aligned base
  a.tma_w = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  a.tma_x = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return int4 ? launch_bf16<true>(a, tile_n, s)
              : launch_bf16<false>(a, tile_n, s);
}
