// Device code shared by the paged attention kernels over every pool type,
// the paged decode (K5, paged_attention.cu) and the ragged paged (K4,
// ragged_paged_attention.cu) entries: the pool types and their element
// conversion, the page ring, and the split-KV decode kernel with its
// merge. K4 hands its decode rows (one query token) to the same kernel.
//
// Pool layout [Hkv, P, bs, D], three pool types (the split kernel and the
// merge are templated on them, as K4's tile kernel is):
// - PoolInt8: the reference's QuantizedTensor, int8 codes and one f32
//   scale per row ([Hkv, P, bs, 1]); a value is code * scale / 127.5;
// - PoolBf16, PoolF16, PoolF32: rows in q's storage type, no scales.
//
// What bounds both kernels on the H100 is bytes: a K/V row costs D + 4
// bytes (int8), 2 D (bf16, fp16) or 4 D (f32) and is used for a handful of
// products per byte (2 G per element, G <= 8 query heads a kv head), far
// below the ~295 operations a byte where tensor cores would matter. The
// design keeps many pages in flight and does little per byte:
// - split-KV decode: a decode row's pages are cut into splits of
//   pages_per_split; each block (kv head, one of the rows' live splits)
//   writes an unnormalised f32 partial (o, m, l per query head), and a
//   second launch merges a row's splits in a fixed order. No atomics, no
//   counters: two calls give the same bits;
// - page ring: one producer thread copies the split's K and V rows by 1-D
//   bulk copies (cp.async.bulk) into a ring, completion counted in bytes on
//   an mbarrier. A ring item is a page of an int8 pool (2 KB a tensor at
//   bs 16, D 128; its scale rows are read once, at the start) and 16 rows
//   of a float pool (4 KB in bf16, 8 KB in f32 at D 128), so that a float
//   ring's size does not grow with the page size. Stages: 8 for int8 and
//   bf16 (a ring of 32 or 64 KB), 4 for f32 (64 KB), so that a block needs
//   at most ~73 KB and three blocks share an SM in every pool type;
// - element conversion: an int8 code becomes a float by a byte permute
//   into the mantissa of 2^23 and one subtract (exact), a bf16 element by
//   a shift or a mask into the high half of a 32-bit word, not by a
//   conversion call per element. Scales are hoisted: a score is
//   (q . codes) * (k_scale / 127.5) and the softmax weight takes
//   v_scale / 127.5 before the V sum; a float pool's key factor is log2(e)
//   alone and its value factor 1.
//
// Scores and the running max live in base 2 (log2(e) is folded into the
// key factor), as in the flash kernels. Both kernels read whole 16-row
// blocks and give the rows past a row's length weight 0, so those rows of
// a page that a table names must hold finite values, as the plain
// versions need too (the engine zero-fills its pools).
#pragma once

#include <math.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace ptt {
namespace paged {

using namespace hopper;

constexpr int kConsumerWarps = 4;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// -- element conversion --------------------------------------------------------

// Four int8 codes of a 32-bit word to f32, exactly: code ^ 0x80 is
// code + 128 as an unsigned byte; placed in the low mantissa byte of
// 2^23 (0x4B000000) it reads as 2^23 + code + 128.
__device__ __forceinline__ void codes4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.f;  // 2^23 + 128
}

// N (a multiple of 4) codes loaded as 32-bit words.
template <int N>
__device__ __forceinline__ void codes_to_f32(const uint32_t* w, float* f) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) codes4(w[i], f + 4 * i);
}

// Two bf16 elements of a 32-bit word to f32: the low one shifted into the
// high half, the high one masked (a bf16 is an f32's high 16 bits).
__device__ __forceinline__ void bf16x2(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// Two fp16 elements of a 32-bit word to f32 (exact).
__device__ __forceinline__ void f16x2(uint32_t w, float* f) {
  const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w));
  f[0] = v.x;
  f[1] = v.y;
}

// -- pool types ------------------------------------------------------------------

// kBytes: bytes of an element; kScaled: per-row scales beside the codes
// (and ring items of a whole page); kStages: the split kernel's ring;
// cvt16: the elements of 16 bytes to f32; vals<N>: the N (2 or 4)
// elements at p (N * kBytes bytes, aligned to that) to f32.
struct PoolInt8 {
  static constexpr int kBytes = 1;
  static constexpr bool kScaled = true;
  static constexpr int kStages = 8;
  static constexpr float kKeyFactor = kLog2e / 127.5f;
  static constexpr float kValueFactor = 1.f / 127.5f;
  __device__ static __forceinline__ void cvt16(const uint4& w, float* f) {
    codes_to_f32<16>(reinterpret_cast<const uint32_t*>(&w), f);
  }
  template <int N>
  __device__ static __forceinline__ void vals(const unsigned char* p,
                                              float* f) {
    if constexpr (N == 4)
      codes4(*reinterpret_cast<const uint32_t*>(p), f);
    else
      codes4(*reinterpret_cast<const uint16_t*>(p), f);
  }
};

struct PoolBf16 {
  static constexpr int kBytes = 2;
  static constexpr bool kScaled = false;
  static constexpr int kStages = 8;
  __device__ static __forceinline__ void cvt16(const uint4& w, float* f) {
    bf16x2(w.x, f);
    bf16x2(w.y, f + 2);
    bf16x2(w.z, f + 4);
    bf16x2(w.w, f + 6);
  }
  template <int N>
  __device__ static __forceinline__ void vals(const unsigned char* p,
                                              float* f) {
    if constexpr (N == 4) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      bf16x2(w.x, f);
      bf16x2(w.y, f + 2);
    } else {
      bf16x2(*reinterpret_cast<const uint32_t*>(p), f);
    }
  }
};

// fp16 rows: PoolBf16's ring and stages, each pair converted by one
// __half22float2.
struct PoolF16 {
  static constexpr int kBytes = 2;
  static constexpr bool kScaled = false;
  static constexpr int kStages = 8;
  __device__ static __forceinline__ void cvt16(const uint4& w, float* f) {
    f16x2(w.x, f);
    f16x2(w.y, f + 2);
    f16x2(w.z, f + 4);
    f16x2(w.w, f + 6);
  }
  template <int N>
  __device__ static __forceinline__ void vals(const unsigned char* p,
                                              float* f) {
    if constexpr (N == 4) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      f16x2(w.x, f);
      f16x2(w.y, f + 2);
    } else {
      f16x2(*reinterpret_cast<const uint32_t*>(p), f);
    }
  }
};

struct PoolF32 {
  static constexpr int kBytes = 4;
  static constexpr bool kScaled = false;
  static constexpr int kStages = 4;
  __device__ static __forceinline__ void cvt16(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
  template <int N>
  __device__ static __forceinline__ void vals(const unsigned char* p,
                                              float* f) {
    if constexpr (N == 4) {
      const float4 w = *reinterpret_cast<const float4*>(p);
      f[0] = w.x;
      f[1] = w.y;
      f[2] = w.z;
      f[3] = w.w;
    } else {
      const float2 w = *reinterpret_cast<const float2*>(p);
      f[0] = w.x;
      f[1] = w.y;
    }
  }
};

// Elements of a 16-byte chunk.
template <typename P>
constexpr int kPer16 = 16 / P::kBytes;

// 16 bytes of a shared-memory tile at byte `off`.
__device__ __forceinline__ uint4 lds16(const unsigned char* tile,
                                       uint32_t off) {
  return *reinterpret_cast<const uint4*>(tile + off);
}

// N (a multiple of kPer16) consecutive elements of a row in shared memory,
// from element `elem` on, to f32.
template <typename P, int N>
__device__ __forceinline__ void lds_f32(const unsigned char* tile,
                                        uint32_t elem, float* f) {
#pragma unroll
  for (int c = 0; c < N / kPer16<P>; ++c)
    P::cvt16(lds16(tile, (elem + c * kPer16<P>) * P::kBytes),
             f + c * kPer16<P>);
}

// Rows of a ring item: a page of an int8 pool (its scale rows are per
// page), 16 rows of a float pool (pages are multiples of 16 rows).
template <typename P>
__host__ __device__ inline int item_rows(int bs) {
  return P::kScaled ? bs : 16;
}

// -- pools -------------------------------------------------------------------

// A pool pair: rows [Hkv, P, bs, D] (int8 codes, or elements of the float
// pool's type), and for an int8 pool its scales [Hkv, P, bs].
struct PoolArgs {
  const void* k;
  const void* v;
  const float* k_scales;
  const float* v_scales;
  int num_pages;
};

// The scale rows (bs floats each) of pages[0 .. n) of kv head h into
// dst [n][K, V][bs], by `threads` threads from thread index `tid`.
__device__ __forceinline__ void load_scales(const PoolArgs& pool,
                                            const int* pages, int n, int h,
                                            int bs, float* dst, int tid,
                                            int threads) {
  const int chunks = bs / 4;  // 16-byte chunks of a row
  for (int idx = tid; idx < 2 * n * chunks; idx += threads) {
    const int row = idx / chunks;  // page row / 2, K or V row % 2
    const int c = idx % chunks;
    const size_t src =
        ((size_t)h * pool.num_pages + pages[row >> 1]) * bs + 4 * c;
    reinterpret_cast<float4*>(dst + (size_t)row * bs)[c] =
        *reinterpret_cast<const float4*>(
            ((row & 1) ? pool.v_scales : pool.k_scales) + src);
  }
}

// -- the page ring -----------------------------------------------------------

// Shared-memory layout of a ring of P::kStages items of `rows` rows of D
// elements: [stage][K, V] row tiles, then the full and empty barriers,
// then `extra` bytes for the kernel.
template <typename P>
struct Ring {
  unsigned char* tiles;
  uint64_t* full;
  uint64_t* empty;
  unsigned char* extra;
  int item;  // bytes of one item's tile: rows * D * kBytes

  __device__ __forceinline__ Ring(unsigned char* base, int rows, int d) {
    item = rows * d * P::kBytes;
    tiles = base;
    full = reinterpret_cast<uint64_t*>(base + 2 * P::kStages * item);
    empty = full + P::kStages;
    extra = reinterpret_cast<unsigned char*>(empty + P::kStages);
  }
  __device__ __forceinline__ const unsigned char* k(int st) const {
    return tiles + (2 * st) * item;
  }
  __device__ __forceinline__ const unsigned char* v(int st) const {
    return tiles + (2 * st + 1) * item;
  }
};

// Dynamic shared memory of a ring plus `extra` bytes (with the slack that
// aligned_smem() may skip to reach a 1024-byte boundary).
template <typename P>
inline size_t ring_smem(int rows, int d, size_t extra) {
  return 1024 + 2 * (size_t)P::kStages * rows * d * P::kBytes +
         2 * (size_t)P::kStages * sizeof(uint64_t) + extra;
}

// One thread: barriers for `consumers` releasing warps per stage.
template <typename P>
__device__ __forceinline__ void ring_init(const Ring<P>& r, int consumers) {
  for (int s = 0; s < P::kStages; ++s) {
    mbar_init(&r.full[s], 1);
    mbar_init(&r.empty[s], consumers);
  }
  mbar_fence_init();
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(const void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The producer (one thread): the K and V rows of items [0, n) of a split
// whose pages are pages[...] (item i: rows i * rows .. of the split, on
// page pages[i * rows / bs], counted without a division) of kv head h into
// the ring in order (the i-th into stage i % kStages), each stage reused
// once its consumers have released it.
template <typename P>
__device__ __forceinline__ void produce(const Ring<P>& r,
                                        const PoolArgs& pool,
                                        const int* pages, int n, int h,
                                        int bs, int rows) {
  const unsigned char* kb = static_cast<const unsigned char*>(pool.k);
  const unsigned char* vb = static_cast<const unsigned char*>(pool.v);
  const int row_bytes = r.item / rows;
  int pg = 0, row = 0;  // a float pool's item: its page and first row
  for (int i = 0; i < n; ++i) {
    const int st = i % P::kStages;
    mbar_wait(&r.empty[st], ((i / P::kStages) & 1) ^ 1);
    size_t off;
    if constexpr (P::kScaled) {  // item i is page i
      off = ((size_t)h * pool.num_pages + pages[i]) * r.item;
    } else {
      off = (((size_t)h * pool.num_pages + pages[pg]) * bs + row) *
            row_bytes;
      row += rows;
      if (row == bs) {
        row = 0;
        ++pg;
      }
    }
    mbar_arrive_expect_tx(&r.full[st], 2 * r.item);
    bulk_load(r.k(st), kb + off, r.item, &r.full[st]);
    bulk_load(r.v(st), vb + off, r.item, &r.full[st]);
  }
}

// A consumer warp is done with stage st (count: one arrival per warp).
template <typename P>
__device__ __forceinline__ void release(const Ring<P>& r, int st) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[st]);
}

// bar.sync on named barrier `id` for `threads` threads (warps of one
// role synchronising without the others).
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- host ----------------------------------------------------------------

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// -- split-KV decode ---------------------------------------------------------

struct SplitArgs {
  PoolArgs pool;
  const void* q;            // [rows, Hq, D] in T (ragged: the token stream)
  const int* lengths;       // [B]: kv tokens of row b, the new one included
  const int* page_indices;  // [B, pages_per_seq]
  const int* cu_q_lens;     // ragged: [B + 1], rows with one query token
                            // only (their q row is cu_q_lens[b]); else null
  void* out;                // like q
  float* o_part;            // [B, Hq, num_splits, D] unnormalised partials
  float* ml_part;           // [B, Hq, num_splits, 2]: running max (base 2),
                            // sum of weights; an empty row's (-inf, 0)
  int rows, bs, pages_per_seq, pages_per_split, num_splits;
  float scale;
};

// The q row of decode row b, or -1 when the kernel skips it (ragged: a row
// with other than one query token belongs to the tile kernel).
__device__ __forceinline__ int decode_q_row(const int* cu, int b) {
  if (cu == nullptr) return b;
  const int c0 = cu[b];
  return cu[b + 1] - c0 == 1 ? c0 : -1;
}

// The splits of decode row b that hold pages (at least one, so that an
// empty row still writes its zeros), or 0 for a row the kernel skips.
__device__ __forceinline__ int live_splits(const SplitArgs& a, int b) {
  if (decode_q_row(a.cu_q_lens, b) < 0) return 0;
  const int len = max(a.lengths[b], 0);
  const int npages = min((len + a.bs - 1) / a.bs, a.pages_per_seq);
  return max(1, (npages + a.pages_per_split - 1) / a.pages_per_split);
}

// The split kernel's shared memory beyond the ring, in floats: q [G][D],
// the warps' weights [warps][16][G], their max and sum [warps][G] each,
// for an int8 pool the split's scale rows [pages][K, V][bs]; then its page
// list.
template <typename P, int D, int G>
__host__ __device__ inline size_t split_extra(int bs, int pages) {
  return (G * D + kConsumerWarps * 16 * G + 2 * kConsumerWarps * G +
          (P::kScaled ? 2 * (size_t)pages * bs : 0)) * sizeof(float) +
         pages * sizeof(int);
}

// Block (kv head h, work item): the split's rows through the ring in
// items (a page of an int8 pool, 16 rows of a float pool), consumer warp
// w taking items w, w + 4, ... The work items are the rows' splits that
// hold pages, numbered compactly, so that the SMs take them evenly and no
// block is launched for a split past its row's length (the merge reads a
// row's live splits only). An item is worked in blocks of 16 tokens.
// Scores: lane l holds 16 elements of token l / (D / 16) of each of D / 32
// passes, c = l % (D / 16): the 16-byte chunks c, c + D / 16, ... of the
// row (16 elements of an int8 row, 2 x 8 of a bf16 row, 4 x 4 of an f32
// row), so that the token's lanes read adjacent chunks; a score's partial
// sums are added over D / 16 lanes once per block. Values: the block's
// weights go through shared memory, and lane l owns the D / 32 outputs
// [l D / 32, (l + 1) D / 32) of each query head, reading those elements of
// all 16 tokens: no output is held twice in a warp, and none is summed
// across lanes. The `G` query heads of the kv head share every item.
template <typename P, typename T, int D, int G>
__global__ void __launch_bounds__(kThreads, 3)
    paged_split_kernel(const SplitArgs a) {
  constexpr int LPT = D / 16;       // lanes per token (scores)
  constexpr int TPP = 32 / LPT;     // tokens per pass
  constexpr int NP = 16 / TPP;      // passes per 16-token block
  constexpr int DPL = D / 32;       // outputs per lane (values)
  constexpr int E16 = kPer16<P>;    // elements of a 16-byte chunk
  constexpr bool kQRegs = G <= 2;   // q in registers, else read from smem
  const int h = blockIdx.x;
  const int hq = gridDim.x * G;
  // work item blockIdx.y: the rows' live splits in order, then nothing
  int b = 0;
  int split = blockIdx.y;
  for (; b < a.rows; ++b) {
    const int nl = live_splits(a, b);
    if (split < nl) break;
    split -= nl;
  }
  if (b == a.rows) return;  // uniform over the block
  const int qrow = decode_q_row(a.cu_q_lens, b);
  const int bs = a.bs;
  const int len = max(a.lengths[b], 0);
  const int npages = min((len + bs - 1) / bs, a.pages_per_seq);
  const int j0 = split * a.pages_per_split;
  const int j1 = min(npages, j0 + a.pages_per_split);
  const size_t head0 = (size_t)qrow * hq + (size_t)h * G;
  const size_t part0 = ((size_t)b * hq + (size_t)h * G) * a.num_splits + split;
  if (j0 >= j1) {
    // an empty row's one split: (-inf, 0), or with one split its zeros
    if (a.num_splits == 1) {
      T* ob = static_cast<T*>(a.out) + head0 * D;
      for (int i = threadIdx.x; i < G * D; i += blockDim.x)
        ob[i] = from_float<T>(0.f);
    } else if (threadIdx.x < G) {
      float* ml = a.ml_part + (part0 + (size_t)threadIdx.x * a.num_splits) * 2;
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
    return;
  }

  const int np = j1 - j0;                   // pages of the split
  const int ir = item_rows<P>(bs);          // rows of an item
  const int p0 = j0 * bs;                   // the split's first position
  const int n =  // items
      P::kScaled ? np : (min(len, j1 * bs) - p0 + ir - 1) / ir;
  const Ring<P> r(aligned_smem(), ir, D);
  float* qs = reinterpret_cast<float*>(r.extra);  // [G][D], scaled, rounded
  float* wsm = qs + G * D;                        // [warps][16][G] weights
  float* wm = wsm + kConsumerWarps * 16 * G;      // [warps][G]
  float* wl = wm + kConsumerWarps * G;
  float* ssc = wl + kConsumerWarps * G;           // int8: [np][K, V][bs]
  int* pages = reinterpret_cast<int*>(
      ssc + (P::kScaled ? 2 * (size_t)a.pages_per_split * bs : 0));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) ring_init(r, 1);
  for (int i = threadIdx.x; i < np; i += blockDim.x)
    pages[i] = a.page_indices[(size_t)b * a.pages_per_seq + j0 + i];
  __syncthreads();

  if (warp == kConsumerWarps) {
    if (lane == 0) produce(r, a.pool, pages, n, h, bs, ir);
    return;
  }
  // the consumers stage q (and an int8 pool's scale rows) while the first
  // items are in flight
  {
    const T* qb = static_cast<const T*>(a.q) + head0 * D;
    for (int i = threadIdx.x; i < G * D; i += kConsumerWarps * 32)
      qs[i] = round_to<T>(to_float(qb[i]) * a.scale);
    if constexpr (P::kScaled)
      load_scales(a.pool, pages, np, h, bs, ssc, threadIdx.x,
                  kConsumerWarps * 32);
  }
  named_barrier_sync(1, kConsumerWarps * 32);
  const int tok = lane / LPT;
  const int c = lane % LPT;
  // element e of a lane's 16: chunk c + (e / E16) LPT of the row, at e % E16
  const auto dim = [&](int e) { return E16 * (c + (e / E16) * LPT) + e % E16; };
  float qr[kQRegs ? G : 1][16];
  if constexpr (kQRegs) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 16; ++i) qr[g][i] = qs[g * D + dim(i)];
  }
  float* ws = wsm + warp * 16 * G;
  float m[G], lsum[G], o[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    lsum[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[g][i] = 0.f;
  }
  constexpr int kRowBytes = D * P::kBytes;
  for (int i = warp; i < n; i += kConsumerWarps) {
    const int pos = p0 + i * ir;  // the item's first position
    const int st = i % P::kStages;
    mbar_wait(&r.full[st], (i / P::kStages) & 1);
    const unsigned char* kt = r.k(st);
    const unsigned char* vt = r.v(st);
    const float* ksc = ssc + (size_t)(2 * i) * bs;  // int8: item i is page i
    const float* vsc = ksc + bs;
    const int ntok = min(ir, len - pos);
    for (int c0 = 0; c0 < ntok; c0 += 16) {
      float s[NP][G];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int t = c0 + p * TPP + tok;
        float kf[16];
#pragma unroll
        for (int k = 0; k < 16 / E16; ++k)
          P::cvt16(lds16(kt, t * kRowBytes + 16 * (c + k * LPT)),
                   kf + k * E16);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float acc[2] = {0.f, 0.f};  // two chains
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            if constexpr (kQRegs)
              acc[e & 1] = fmaf(qr[g][e], kf[e], acc[e & 1]);
            else
              acc[e & 1] = fmaf(qs[g * D + dim(e)], kf[e], acc[e & 1]);
          }
          s[p][g] = acc[0] + acc[1];
        }
      }
      // one sum over the token's lanes per score
#pragma unroll
      for (int off = 1; off < LPT; off <<= 1)
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[p][g] += __shfl_xor_sync(0xffffffffu, s[p][g], off);
      float vfac[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int t = c0 + p * TPP + tok;
        const bool live = t < ntok;
        float kfac;
        if constexpr (P::kScaled) {
          kfac = ksc[t] * P::kKeyFactor;
          vfac[p] = live ? vsc[t] * P::kValueFactor : 0.f;
        } else {
          kfac = kLog2e;
          vfac[p] = live ? 1.f : 0.f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[p][g] = live ? s[p][g] * kfac : -INFINITY;
      }
      // one max and one correction per block and head
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = s[0][g];
#pragma unroll
        for (int p = 1; p < NP; ++p) mx = fmaxf(mx, s[p][g]);
#pragma unroll
        for (int off = LPT; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);  // finite: token c0 is live
        const float corr = ex2(m[g] - m_new);
        m[g] = m_new;
        lsum[g] *= corr;
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[g][e] *= corr;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float pw = ex2(s[p][g] - m_new);
          lsum[g] += pw;
          s[p][g] = pw * vfac[p];  // the V weight (int8: v_scale / 127.5)
        }
      }
      if (c == 0) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int g = 0; g < G; ++g) ws[(p * TPP + tok) * G + g] = s[p][g];
      }
      __syncwarp();
#pragma unroll
      for (int tl = 0; tl < 16; ++tl) {
        const uint32_t off = ((c0 + tl) * D + lane * DPL) * P::kBytes;
        float vf[4];
        P::template vals<DPL>(vt + off, vf);
        float wv[G];
#pragma unroll
        for (int g = 0; g < G; ++g) wv[g] = ws[tl * G + g];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < DPL; ++e) o[g][e] = fmaf(wv[g], vf[e], o[g][e]);
      }
      __syncwarp();  // the weights are read before the next block's
    }
    release(r, st);
  }
  // the warp's sum of weights over its token lanes
#pragma unroll
  for (int off = LPT; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
      lsum[g] += __shfl_xor_sync(0xffffffffu, lsum[g], off);
  // every item is consumed once the warps pass the barrier below, so the
  // ring's tiles take the warps' partial outputs
  named_barrier_sync(1, kConsumerWarps * 32);
  float* wo = reinterpret_cast<float*>(r.tiles);  // [warps][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      wo[(warp * G + g) * D + lane * DPL + e] = o[g][e];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = lsum[g];
    }
  }
  named_barrier_sync(1, kConsumerWarps * 32);
  // merge the warps in order: the block's partial (or, with one split,
  // the output)
  for (int idx = threadIdx.x; idx < G * D; idx += kConsumerWarps * 32) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float l = 0.f;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) {
      // a warp that took no item holds (-inf, 0, 0): weight 0
      const float f = ex2(wm[w * G + g] - mx);
      l += wl[w * G + g] * f;
      acc += wo[(w * G + g) * D + d] * f;
    }
    if (a.num_splits == 1) {
      static_cast<T*>(a.out)[(head0 + g) * D + d] =
          from_float<T>(l > 0.f ? acc / l : 0.f);
    } else {
      const size_t pi = part0 + (size_t)g * a.num_splits;
      a.o_part[pi * D + d] = acc;
      if (d == 0) {
        a.ml_part[pi * 2] = mx;
        a.ml_part[pi * 2 + 1] = l;
      }
    }
  }
}

// Merge of the live splits of (row b, query head): grid (Hq, B), D
// threads; the splits in order. Every thread loads all the splits' (m, l)
// and its o values at once, then sums. The pool type P does not enter the
// arithmetic; it names the instance, so that a profile tells the pools'
// merges apart.
template <typename P, typename T, int D>
__global__ void __launch_bounds__(D) split_merge_kernel(const SplitArgs a) {
  constexpr int kBatch = 8;  // splits loaded together
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int num_splits = live_splits(a, b);
  if (num_splits == 0) return;
  const int qrow = decode_q_row(a.cu_q_lens, b);
  const int d = threadIdx.x;
  const size_t base = ((size_t)b * gridDim.x + hq) * a.num_splits;
  T* out = static_cast<T*>(a.out);
  const float2* ml = reinterpret_cast<const float2*>(a.ml_part) + base;
  const float* op = a.o_part + base * D + d;
  float mx = -INFINITY;
  float l = 0.f;
  float acc = 0.f;
  for (int s0 = 0; s0 < num_splits; s0 += kBatch) {
    float2 mls[kBatch];
    float os[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool in = s0 + i < num_splits;
      mls[i] = in ? ml[s0 + i] : make_float2(-INFINITY, 0.f);
      os[i] = in ? op[(size_t)(s0 + i) * D] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (mls[i].y > 0.f) {  // a split that held pages
        const float m_new = fmaxf(mx, mls[i].x);
        const float corr = ex2(mx - m_new);
        const float f = ex2(mls[i].x - m_new);
        l = l * corr + mls[i].y * f;
        acc = acc * corr + os[i] * f;
        mx = m_new;
      }
    }
  }
  out[((size_t)qrow * gridDim.x + hq) * D + d] =
      from_float<T>(l > 0.f ? acc / l : 0.f);
}

// Launch the split kernel over `rows` decode rows (and the merge when
// there is more than one split) on `stream`.
template <typename P, typename T, int D, int G>
cudaError_t launch_split(const SplitArgs& a, int num_kv_heads,
                         cudaStream_t stream) {
  const size_t smem = ring_smem<P>(
      item_rows<P>(a.bs), D, split_extra<P, D, G>(a.bs, a.pages_per_split));
  cudaError_t err = allow_smem(paged_split_kernel<P, T, D, G>, smem);
  if (err != cudaSuccess) return err;
  // work items: at most rows * num_splits live splits
  paged_split_kernel<P, T, D, G>
      <<<dim3(num_kv_heads, a.rows * a.num_splits), kThreads, smem,
         stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.num_splits == 1) return err;
  split_merge_kernel<P, T, D>
      <<<dim3(num_kv_heads * G, a.rows), D, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename P, typename T, int D>
cudaError_t launch_split_any(int group, const SplitArgs& a, int num_kv_heads,
                             cudaStream_t stream) {
  switch (group) {
    case 1: return launch_split<P, T, D, 1>(a, num_kv_heads, stream);
    case 2: return launch_split<P, T, D, 2>(a, num_kv_heads, stream);
    case 4: return launch_split<P, T, D, 4>(a, num_kv_heads, stream);
    case 8: return launch_split<P, T, D, 8>(a, num_kv_heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename P, typename T>
cudaError_t launch_split_dim(int head_dim, int group, const SplitArgs& a,
                             int num_kv_heads, cudaStream_t stream) {
  if (head_dim == 64)
    return launch_split_any<P, T, 64>(group, a, num_kv_heads, stream);
  if (head_dim == 128)
    return launch_split_any<P, T, 128>(group, a, num_kv_heads, stream);
  return cudaErrorInvalidValue;
}

// The split kernel (and merge) for q type `dtype` and `head_dim` over an
// int8 pool (`quant`: q bf16 or f32) or a float pool of q's type (f32,
// bf16 or fp16).
inline cudaError_t decode_splits(const SplitArgs& a, bool quant,
                                 int num_kv_heads, int group, int head_dim,
                                 int dtype, cudaStream_t stream) {
  if (quant && dtype == kFloat32)
    return launch_split_dim<PoolInt8, float>(head_dim, group, a,
                                             num_kv_heads, stream);
  if (quant && dtype == kBFloat16)
    return launch_split_dim<PoolInt8, __nv_bfloat16>(head_dim, group, a,
                                                     num_kv_heads, stream);
  if (quant) return cudaErrorInvalidValue;  // an fp16 q over int8 codes
  if (dtype == kFloat32)
    return launch_split_dim<PoolF32, float>(head_dim, group, a, num_kv_heads,
                                            stream);
  if (dtype == kBFloat16)
    return launch_split_dim<PoolBf16, __nv_bfloat16>(head_dim, group, a,
                                                     num_kv_heads, stream);
  if (dtype == kFloat16)
    return launch_split_dim<PoolF16, __half>(head_dim, group, a,
                                             num_kv_heads, stream);
  return cudaErrorInvalidValue;
}

}  // namespace paged
}  // namespace ptt
