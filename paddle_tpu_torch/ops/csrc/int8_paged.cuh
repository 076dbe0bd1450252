// Device code of the int8-pool attention kernels, shared by the paged
// decode (K5-int8, paged_attention.cu) and ragged paged (K4-int8,
// ragged_paged_attention.cu) entries: the code conversion, the hoisted
// scales, the page ring and the split-KV decode kernel with its merge.
//
// Pool layout (the reference's QuantizedTensor): codes [Hkv, P, bs, D]
// int8 and one f32 scale per row, [Hkv, P, bs, 1]; a value is
// code * scale / 127.5.
//
// What bounds both kernels on the H100 is bytes: a K/V row costs D + 4
// bytes and is used for a handful of products per byte. The design keeps
// many pages in flight and does little per code byte:
// - hoisted scales: no element is dequantized. A score is
//   (q . codes) * (k_scale / 127.5), one multiply per key, and the softmax
//   weight of a key takes v_scale / 127.5 before the V sum;
// - code conversion: a code becomes a float by a byte permute into the
//   mantissa of 2^23 and one subtract (code + 128 is the mantissa's low
//   byte), not by an I2F per element; exact for every code;
// - split-KV decode: a decode row's pages are cut into splits of
//   pages_per_split; each block (kv head, one of the rows' live splits)
//   writes an unnormalised f32 partial (o, m, l per query head), and a
//   second launch merges a row's splits in a fixed order. No atomics, no
//   counters: two calls give the same bits;
// - page ring (split kernel): one producer thread copies each page's K and
//   V codes (2 KB each at bs 16, D 128) by 1-D bulk copies
//   (cp.async.bulk) into a ring of kStages stages, completion counted in
//   bytes on an mbarrier. The block's page-table slice and its pages'
//   scale rows are read once, at the start, into shared memory.
//
// Scores and the running max live in base 2 (log2(e) is folded into the
// key factor), as in the flash kernels.
#pragma once

#include <math.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace ptt {
namespace int8p {

using namespace hopper;

constexpr int kStages = 8;           // pages in flight per block
constexpr int kConsumerWarps = 4;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr float kKeyFactor = 1.4426950408889634f / 127.5f;  // log2(e) / 127.5
constexpr float kValueFactor = 1.f / 127.5f;

// -- codes -------------------------------------------------------------------

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

// -- pools -------------------------------------------------------------------

// An int8 pool pair: codes [Hkv, P, bs, D], scales [Hkv, P, bs].
struct PoolArgs {
  const int8_t* k_codes;
  const int8_t* v_codes;
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

// Shared-memory layout of a ring of kStages pages of bs rows of D codes:
// [stage][K, V] code tiles (bs * D bytes each), then the full and empty
// barriers, then `extra` bytes for the kernel.
struct Ring {
  unsigned char* codes;
  uint64_t* full;
  uint64_t* empty;
  unsigned char* extra;
  int page;  // bytes of one page tile: bs * D

  __device__ __forceinline__ Ring(unsigned char* base, int bs, int d) {
    page = bs * d;
    codes = base;
    full = reinterpret_cast<uint64_t*>(base + 2 * kStages * page);
    empty = full + kStages;
    extra = reinterpret_cast<unsigned char*>(empty + kStages);
  }
  __device__ __forceinline__ const unsigned char* k(int st) const {
    return codes + (2 * st) * page;
  }
  __device__ __forceinline__ const unsigned char* v(int st) const {
    return codes + (2 * st + 1) * page;
  }
};

// Dynamic shared memory of a ring plus `extra` bytes (with the slack that
// aligned_smem() may skip to reach a 1024-byte boundary).
inline size_t ring_smem(int bs, int d, size_t extra) {
  return 1024 + 2 * (size_t)kStages * bs * d +
         2 * (size_t)kStages * sizeof(uint64_t) + extra;
}

// One thread: barriers for `consumers` releasing warps per stage.
__device__ __forceinline__ void ring_init(const Ring& r, int consumers) {
  for (int s = 0; s < kStages; ++s) {
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

// The producer (one thread): the K and V codes of pages[0 .. n) of kv
// head h into the ring in order (the i-th into stage i % kStages), each
// stage reused once its consumers have released it.
__device__ __forceinline__ void produce(const Ring& r, const PoolArgs& pool,
                                        const int* pages, int n, int h) {
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    mbar_wait(&r.empty[st], ((i / kStages) & 1) ^ 1);
    const size_t off = ((size_t)h * pool.num_pages + pages[i]) * r.page;
    mbar_arrive_expect_tx(&r.full[st], 2 * r.page);
    bulk_load(r.k(st), pool.k_codes + off, r.page, &r.full[st]);
    bulk_load(r.v(st), pool.v_codes + off, r.page, &r.full[st]);
  }
}

// A consumer warp is done with stage st (count: one arrival per warp).
__device__ __forceinline__ void release(const Ring& r, int st) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[st]);
}

// 16 bytes of a page tile at byte `off`.
__device__ __forceinline__ uint4 lds16(const unsigned char* tile,
                                       uint32_t off) {
  return *reinterpret_cast<const uint4*>(tile + off);
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
// the split's scale rows [pages][K, V][bs]; then its page list.
template <int D, int G>
__host__ __device__ inline size_t split_extra(int bs, int pages) {
  return (G * D + kConsumerWarps * 16 * G + 2 * kConsumerWarps * G +
          2 * (size_t)pages * bs) * sizeof(float) +
         pages * sizeof(int);
}

// Block (kv head h, work item): the split's pages through the ring,
// consumer warp w taking pages w, w + 4, ... The work items are the rows'
// splits that hold pages, numbered compactly, so that the SMs take them
// evenly and no block is launched for a split past its row's length (the
// merge reads a row's live splits only). A page is worked in blocks of 16
// tokens.
// Scores: lane l holds the 16 codes [16 c, 16 c + 16) of token l / (D /
// 16) of each of D / 32 passes, c = l % (D / 16), so a score's partial
// sums are added over D / 16 lanes once per block. Values: the block's
// weights go through shared memory, and lane l owns the D / 32 outputs
// [l D / 32, (l + 1) D / 32) of each query head, reading those codes of
// all 16 tokens (one 4-byte read a token at D = 128): no output is held
// twice in a warp, and none is summed across lanes. The `G` query heads
// of the kv head share every page.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads, 3)
    paged_int8_split_kernel(const SplitArgs a) {
  constexpr int LPT = D / 16;       // lanes per token (scores)
  constexpr int TPP = 32 / LPT;     // tokens per pass
  constexpr int NP = 16 / TPP;      // passes per 16-token block
  constexpr int DPL = D / 32;       // outputs per lane (values)
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

  const int n = j1 - j0;
  const Ring r(aligned_smem(), bs, D);
  float* qs = reinterpret_cast<float*>(r.extra);  // [G][D], scaled, rounded
  float* wsm = qs + G * D;                        // [warps][16][G] weights
  float* wm = wsm + kConsumerWarps * 16 * G;      // [warps][G]
  float* wl = wm + kConsumerWarps * G;
  float* ssc = wl + kConsumerWarps * G;           // [n][K, V][bs]
  int* pages = reinterpret_cast<int*>(ssc + 2 * (size_t)a.pages_per_split * bs);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) ring_init(r, 1);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    pages[i] = a.page_indices[(size_t)b * a.pages_per_seq + j0 + i];
  __syncthreads();

  if (warp == kConsumerWarps) {
    if (lane == 0) produce(r, a.pool, pages, n, h);
    return;
  }
  // the consumers stage q and the scale rows while the first pages are in
  // flight
  {
    const T* qb = static_cast<const T*>(a.q) + head0 * D;
    for (int i = threadIdx.x; i < G * D; i += kConsumerWarps * 32)
      qs[i] = round_to<T>(to_float(qb[i]) * a.scale);
    load_scales(a.pool, pages, n, h, bs, ssc, threadIdx.x,
                kConsumerWarps * 32);
  }
  named_barrier_sync(1, kConsumerWarps * 32);
  const int tok = lane / LPT;
  const int c = lane % LPT;
  float qr[kQRegs ? G : 1][16];
  if constexpr (kQRegs) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 16; ++i) qr[g][i] = qs[g * D + 16 * c + i];
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
  for (int i = warp; i < n; i += kConsumerWarps) {
    const int j = j0 + i;
    const int st = i % kStages;
    mbar_wait(&r.full[st], (i / kStages) & 1);
    const unsigned char* kt = r.k(st);
    const unsigned char* vt = r.v(st);
    const float* ksc = ssc + (size_t)(2 * i) * bs;
    const float* vsc = ksc + bs;
    const int ntok = min(bs, len - j * bs);
    for (int c0 = 0; c0 < ntok; c0 += 16) {
      float s[NP][G];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int t = c0 + p * TPP + tok;
        const uint4 w = lds16(kt, t * D + 16 * c);
        float kf[16];
        codes_to_f32<16>(reinterpret_cast<const uint32_t*>(&w), kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float acc[2] = {0.f, 0.f};  // two chains
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            if constexpr (kQRegs)
              acc[e & 1] = fmaf(qr[g][e], kf[e], acc[e & 1]);
            else
              acc[e & 1] = fmaf(qs[g * D + 16 * c + e], kf[e], acc[e & 1]);
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
        const float kfac = ksc[t] * kKeyFactor;
        vfac[p] = live ? vsc[t] * kValueFactor : 0.f;
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
          s[p][g] = pw * vfac[p];  // the V weight, v_scale / 127.5 taken
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
        const uint32_t off = (c0 + tl) * D + lane * DPL;
        float vf[4];
        if constexpr (DPL == 4) {
          codes4(*reinterpret_cast<const uint32_t*>(vt + off), vf);
        } else {
          codes4(*reinterpret_cast<const uint16_t*>(vt + off), vf);
        }
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
  // every page is consumed once the warps pass the barrier below, so the
  // ring's code tiles take the warps' partial outputs
  named_barrier_sync(1, kConsumerWarps * 32);
  float* wo = reinterpret_cast<float*>(r.codes);  // [warps][G][D]
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
      // a warp that took no page holds (-inf, 0, 0): weight 0
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
// and its o values at once, then sums.
template <typename T, int D>
__global__ void __launch_bounds__(D)
    int8_split_merge_kernel(const SplitArgs a) {
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
template <typename T, int D, int G>
cudaError_t launch_split(const SplitArgs& a, int num_kv_heads,
                         cudaStream_t stream) {
  const size_t smem =
      ring_smem(a.bs, D, split_extra<D, G>(a.bs, a.pages_per_split));
  cudaError_t err = allow_smem(paged_int8_split_kernel<T, D, G>, smem);
  if (err != cudaSuccess) return err;
  // work items: at most rows * num_splits live splits
  paged_int8_split_kernel<T, D, G>
      <<<dim3(num_kv_heads, a.rows * a.num_splits), kThreads, smem,
         stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.num_splits == 1) return err;
  int8_split_merge_kernel<T, D>
      <<<dim3(num_kv_heads * G, a.rows), D, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_split_any(int group, const SplitArgs& a, int num_kv_heads,
                             cudaStream_t stream) {
  switch (group) {
    case 1: return launch_split<T, D, 1>(a, num_kv_heads, stream);
    case 2: return launch_split<T, D, 2>(a, num_kv_heads, stream);
    case 4: return launch_split<T, D, 4>(a, num_kv_heads, stream);
    case 8: return launch_split<T, D, 8>(a, num_kv_heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The split kernel (and merge) for q type `dtype` and `head_dim`.
inline cudaError_t decode_int8(const SplitArgs& a, int num_kv_heads,
                               int group, int head_dim, int dtype,
                               cudaStream_t stream) {
#define PTT_SPLIT(T_, D_) \
  return launch_split_any<T_, D_>(group, a, num_kv_heads, stream);
  if (dtype == kFloat32 && head_dim == 64) PTT_SPLIT(float, 64)
  if (dtype == kFloat32 && head_dim == 128) PTT_SPLIT(float, 128)
  if (dtype == kBFloat16 && head_dim == 64) PTT_SPLIT(__nv_bfloat16, 64)
  if (dtype == kBFloat16 && head_dim == 128) PTT_SPLIT(__nv_bfloat16, 128)
#undef PTT_SPLIT
  return cudaErrorInvalidValue;
}

}  // namespace int8p
}  // namespace ptt
