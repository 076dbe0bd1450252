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
//
// The TPU kernel walks rows one after another through a sequential grid
// into one shared VMEM accumulator. Blocks on Hopper run in no order, so
// here every block owns its output outright:
// - one block per (row b, query tile of b, kv head): the tile is 16
//   (token, query head) pairs, i.e. 16 / group consecutive tokens with all
//   `group` query heads of the kv head; each block loads its own cu_q_lens,
//   kv_lens and page-table row;
// - it loops over the row's pages up to the causal extent of its last
//   token, staging each K and V page once in shared memory for all 16 pairs
//   (the GQA heads share every page load);
// - four warps, four pairs per warp; a lane owns D/32 contiguous elements;
//   f32 online softmax per pair, score by a warp-wide sum;
// - empty rows launch nothing useful (their tiles exit at once), and an
//   extra block row b = num_seqs writes zeros for the pad tokens past
//   cu_q_lens[num_seqs], so every output element is finite.
//
// What bounds it on the H100: bytes for the decode rows (one query token
// per K/V element read), and at a 256-token prefill chunk still the K/V
// bytes at this design's CUDA-core arithmetic. The floor is the live K/V
// pages over 3.35 TB/s or the products over the bf16 tensor-core peak,
// whichever is larger; wgmma tiles, TMA page loads and double buffering
// are later work.
//
// The int8 variant (ragged_paged_attention_int8_launch, K4-int8) is its
// own design, in ragged_int8_tile_kernel below and int8_paged.cuh:
// - bound: bytes, as above; a live row costs D + 4 bytes (codes and a
//   scale) instead of 2D in bf16;
// - tiles of 64 (token, head) pairs (64 / group tokens with the group's
//   heads together): a 256-token chunk's K/V is read 4 times per head at
//   MHA, not 16; the grid numbers the rows' tiles compactly, so that the
//   live ones are dispatched first;
// - three groups of four warps take every third step of two pages of the
//   tile's walk, and merge at the end in a fixed order. A group's threads
//   copy their share of the group's coming steps (int8 codes and f32
//   scales, one 16-byte chunk a thread, tensor and page at bs 16, D 128)
//   by cp.async into staging slots, two steps ahead, while the group works
//   the current one (the split kernel's producer thread and bulk-copy ring
//   were built here first and timed slower on the card);
// - bf16 q: S = Q.K^T and O += P.V on tensor cores, mma.sync m16n8k16 in
//   bf16 with f32 accumulation. A group converts each page once into bf16
//   rows in shared memory (exactly: |code| <= 128 has 8 significant
//   bits), which its warps read by ldmatrix; the products are those of the
//   plain version and only the order of the sums differs. k_scale / 127.5
//   multiplies S's columns, v_scale / 127.5 P's columns before P rounds to
//   bf16 (as the flash kernels round P). mma.sync and not wgmma: wgmma
//   would need whole 64-key tiles of one kv head in its swizzled layout,
//   and at the mixed dispatch's shapes the products (4.2 GFLOP, 4.2 us at
//   the bf16 peak) sit under the bytes (76 MB, 23 us) even at mma.sync's
//   lower rate;
// - f32 q: the same tiles and staging, with the products as f32 FMAs on
//   CUDA cores in the same register layout, on the int8 rows;
// - decode rows (one query token) never walk their pages alone in a tile:
//   the tile kernel skips them, and K5-int8's split-KV kernel (with its
//   merge) takes them, reading q and writing the output at cu_q_lens[b].

#include "attention_common.cuh"
#include "int8_paged.cuh"

namespace {

using namespace ptt;

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (token, head) pairs a block

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
    ragged_paged_kernel(const T* __restrict__ q,
                        const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ kv_lens,
                        const int* __restrict__ page_indices,
                        const int* __restrict__ cu_q_lens,
                        T* __restrict__ out, int num_tokens, int num_seqs,
                        int group, int num_pages, int page_size,
                        int pages_per_seq, float scale) {
  constexpr int EPL = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + (size_t)page_size * D;

  const int b = blockIdx.x;
  const int tile = blockIdx.y;
  const int h = blockIdx.z;
  const int num_q_heads = gridDim.z * group;
  const int tokens_per_tile = kRows / group;
  const bool pad_span = (b == num_seqs);
  const int start = cu_q_lens[b];
  const int end = pad_span ? num_tokens : cu_q_lens[b + 1];
  const int t0 = start + tile * tokens_per_tile;
  if (t0 >= end) return;  // uniform over the block
  const int t1 = min(t0 + tokens_per_tile, end);

  if (pad_span) {
    const int span = group * D;
    for (int idx = threadIdx.x; idx < (t1 - t0) * span; idx += blockDim.x) {
      const int tt = idx / span;
      out[((size_t)(t0 + tt) * num_q_heads + (size_t)h * group) * D +
          idx % span] = from_float<T>(0.f);
    }
    return;
  }

  const int q_len = end - start;
  // token t of this row sees kv positions < base_lim + t
  const int base_lim = kv_lens[b] - q_len - start + 1;
  const int block_lim =
      min(base_lim + t1 - 1, pages_per_seq * page_size);  // last token's
  const int npages = block_lim > 0 ? (block_lim + page_size - 1) / page_size
                                   : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float qr[kRowsPerWarp][EPL];
  float acc[kRowsPerWarp][EPL];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  int lim[kRowsPerWarp];  // 0 for pairs past the tile's last token
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int t = t0 + r / group;
    const int g = r % group;
    const bool active = t < t1;
    lim[i] = active ? base_lim + t : 0;
    if (active) {
      load_row<T, EPL>(
          q + ((size_t)t * num_q_heads + (size_t)h * group + g) * D +
              lane * EPL,
          qr[i]);
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[i][e] = active ? round_to<T>(qr[i][e] * scale) : 0.f;
      acc[i][e] = 0.f;
    }
    m[i] = -1e30f;
    l[i] = 0.f;
  }

  const int* pt = page_indices + (size_t)b * pages_per_seq;
  const size_t page_elems = (size_t)page_size * D;
  const T* kh = k_pages + (size_t)h * num_pages * page_elems;
  const T* vh = v_pages + (size_t)h * num_pages * page_elems;
  const int vec_per_page = (int)(page_elems * sizeof(T) / 16);
  for (int j = 0; j < npages; ++j) {
    __syncthreads();  // the previous page is consumed by every warp
    const size_t base = (size_t)pt[j] * page_elems;
    const uint4* ksrc = reinterpret_cast<const uint4*>(kh + base);
    const uint4* vsrc = reinterpret_cast<const uint4*>(vh + base);
    for (int idx = threadIdx.x; idx < vec_per_page; idx += blockDim.x) {
      reinterpret_cast<uint4*>(ks)[idx] = ksrc[idx];
      reinterpret_cast<uint4*>(vs)[idx] = vsrc[idx];
    }
    __syncthreads();
    const int p0 = j * page_size;
    int n[kRowsPerWarp];
    int nmax = 0;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      n[i] = min(page_size, lim[i] - p0);
      nmax = max(nmax, n[i]);
    }
    for (int t = 0; t < nmax; ++t) {
      float kr[EPL];
      float vr[EPL];
      load_row<T, EPL>(ks + (size_t)t * D + lane * EPL, kr);
      load_row<T, EPL>(vs + (size_t)t * D + lane * EPL, vr);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (t < n[i]) {  // uniform over the warp
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s += qr[i][e] * kr[e];
          s = warp_sum(s);
          online_update<EPL>(s, vr, m[i], l[i], acc[i]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int t = t0 + r / group;
    if (t >= t1) continue;
    const int g = r % group;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float o[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = acc[i][e] * inv;
    store_row<T, EPL>(
        out + ((size_t)t * num_q_heads + (size_t)h * group + g) * D +
            lane * EPL,
        o);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* kv_lens, const void* page_indices,
                   const void* cu_q_lens, void* out, int num_tokens,
                   int num_seqs, int num_kv_heads, int group, int num_pages,
                   int page_size, int pages_per_seq, float scale,
                   cudaStream_t stream) {
  const int tokens_per_tile = kRows / group;
  dim3 grid(num_seqs + 1, (num_tokens + tokens_per_tile - 1) / tokens_per_tile,
            num_kv_heads);
  const size_t smem = 2 * (size_t)page_size * D * sizeof(T);  // two pages
  ragged_paged_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(kv_lens),
      static_cast<const int*>(page_indices),
      static_cast<const int*>(cu_q_lens), static_cast<T*>(out), num_tokens,
      num_seqs, group, num_pages, page_size, pages_per_seq, scale);
  return cudaGetLastError();
}

// One dispatch over head_dim for a float q type.
template <typename T>
cudaError_t launch_any(int head_dim, const void* q, const void* k_pages,
                       const void* v_pages, const void* kv_lens,
                       const void* page_indices, const void* cu_q_lens,
                       void* out, int num_tokens, int num_seqs,
                       int num_kv_heads, int group, int num_pages,
                       int page_size, int pages_per_seq, float scale,
                       cudaStream_t stream) {
  if (group < 1 || kRows % group != 0) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, kv_lens, page_indices,
                           cu_q_lens, out, num_tokens, num_seqs, num_kv_heads,
                           group, num_pages, page_size, pages_per_seq, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, kv_lens, page_indices,
                            cu_q_lens, out, num_tokens, num_seqs,
                            num_kv_heads, group, num_pages, page_size,
                            pages_per_seq, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// -- K4-int8 -----------------------------------------------------------------

using namespace ptt::hopper;
namespace i8 = ptt::int8p;

constexpr int kTilePairs = 16 * i8::kConsumerWarps;  // 64 (token, head) pairs

struct TileArgs {
  i8::PoolArgs pool;
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

constexpr int kGroups = 3;  // warp groups, each taking every third page
constexpr int kGroupThreads = 32 * 4;
constexpr int kTileThreads = kGroups * kGroupThreads;
constexpr int kMaxChunks = 1;  // 16-byte code chunks a thread loads a page

constexpr int kStepPages = 2;   // pages a group takes per step
constexpr int kTileStages = 3;  // staging slots (steps in flight) a group

// The tile kernel's shared memory: a region per group, then for an f32 q
// the tile's q, then the row's page list. A group's region holds its two
// step buffers (a step's kStepPages pages: for a bf16 q, bf16 K rows and
// then V rows with 16-byte chunk c of row r at chunk c ^ (r % 8); for an
// f32 q, the int8 K rows and then V rows; then the step's key factors and
// value factors, or raw scales) and its kTileStages staging slots, into
// which a thread copies its chunks of the group's coming steps (per page:
// int8 K and V rows, then the scales). After its last step, group gi > 0
// hands its accumulators to group 0 in its own region.
template <typename T, int D>
struct TileSmem {
  static constexpr bool kTC = std::is_same_v<T, __nv_bfloat16>;
  __host__ __device__ static size_t buffer(int bs) {
    return kStepPages * (4 * (size_t)bs * D + 8 * (size_t)bs);
  }
  __host__ __device__ static size_t stage(int bs) {  // one page
    return 2 * (size_t)bs * D + 8 * (size_t)bs;
  }
  // >= the exchange's kGroupThreads * (D / 2 + 4) floats for bs >= 16
  __host__ __device__ static size_t group(int bs) {
    return 2 * buffer(bs) + kTileStages * kStepPages * stage(bs);
  }
  __host__ __device__ static size_t qs(int bs) { return kGroups * group(bs); }
  __host__ __device__ static size_t pages(int bs) {
    return qs(bs) + (kTC ? 0 : (size_t)kTilePairs * D * sizeof(float));
  }
  __host__ __device__ static size_t bytes(int bs, int pages_per_seq) {
    return pages(bs) + (size_t)pages_per_seq * sizeof(int);
  }
};

// A group thread's share of a page: its 16-byte chunks tg, tg + 128 of
// the K and V codes and its element tg of [K scales, V scales], copied
// asynchronously (cp.async) into the staging buffer `st` and committed as
// one group of copies.
__device__ __forceinline__ void stage_page(const i8::PoolArgs& pool, int h,
                                           int page, int bs, int chunks,
                                           int tg, unsigned char* st) {
  const size_t prow = (size_t)h * pool.num_pages + page;
  const unsigned char* kc =
      reinterpret_cast<const unsigned char*>(pool.k_codes) + prow * chunks * 16;
  const unsigned char* vc =
      reinterpret_cast<const unsigned char*>(pool.v_codes) + prow * chunks * 16;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int idx = tg + kGroupThreads * c;
    if (idx < chunks) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(st + 16 * idx)),
                   "l"(kc + 16 * idx)
                   : "memory");
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(st + 16 * (chunks + idx))),
                   "l"(vc + 16 * idx)
                   : "memory");
    }
  }
  if (tg < 2 * bs) {
    const float* src = tg < bs ? pool.k_scales + prow * bs + tg
                               : pool.v_scales + prow * bs + tg - bs;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(st + 32 * chunks + 4 * tg)),
                 "l"(src)
                 : "memory");
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
// pages up to its last token's causal extent, in steps of kStepPages
// pages. Group gi of four warps takes steps gi, gi + 3, ...: its threads
// copy their chunks of the group's coming steps into staging slots
// (cp.async, kTileStages - 1 steps ahead), store each step once to a step
// buffer (bf16 rows for a bf16 q, read back by ldmatrix), and the group's
// warps work it 32 keys at a time (16 for an f32 q). Warp w of a group
// owns pairs 16 w .. 16 w + 15, and lane l (quad g = l / 4, t = l % 4)
// holds, as the m16n8k16 accumulator lays it out, pairs 16 w + g and + 8
// against keys 2t, 2t + 1 of each 8-key n-tile. At the end groups 1 and 2
// hand their (o, m, l) to group 0, which merges and writes. The work tile
// after the rows' tiles zeroes the pad tokens past cu_q_lens[num_seqs];
// rows of one query token are the split kernel's and have no tiles here.
template <typename T, int D>
__global__ void __launch_bounds__(kTileThreads)
    ragged_int8_tile_kernel(const TileArgs a) {
  using L = TileSmem<T, D>;
  constexpr bool kTC = L::kTC;  // tensor cores
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
  // token t of this row sees kv positions < base_lim + t
  const int base_lim = pad ? 0 : a.kv_lens[b] - q_len - start + 1;
  const int block_lim = min(base_lim + t1 - 1, a.pages_per_seq * a.bs);
  const int npages =
      pad || block_lim <= 0 ? 0 : (block_lim + a.bs - 1) / a.bs;
  if (npages == 0) {  // pad tokens (or tokens that see no key): zeros
    const int span = G * D;
    for (int i = threadIdx.x; i < (t1 - t0) * span; i += blockDim.x)
      out[((size_t)(t0 + i / span) * hq + (size_t)h * G) * D + i % span] =
          from_float<T>(0.f);
    return;
  }

  const int bs = a.bs;
  const int chunks = bs * D / 16;  // a page's 16-byte chunks per tensor
  extern __shared__ __align__(16) unsigned char tile_smem[];
  float* qs = reinterpret_cast<float*>(tile_smem + L::qs(bs));  // f32 q
  int* pages = reinterpret_cast<int*>(tile_smem + L::pages(bs));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gi = warp / 4;                  // group
  const int wr = warp % 4;                  // pairs 16 wr .. 16 wr + 15
  const int tg = threadIdx.x % kGroupThreads;
  const int* pt = a.page_indices + (size_t)b * a.pages_per_seq;
  unsigned char* grp = tile_smem + gi * L::group(bs);
  const auto slot = [&](int k) {
    return grp + 2 * L::buffer(bs) +
           (k % kTileStages) * kStepPages * L::stage(bs);
  };
  // step u takes pages kStepPages u .. + kStepPages - 1; a page past the
  // row's last is loaded as its step's first again (its keys lie past every
  // limit, so the mask drops them)
  const auto stage_step = [&](int u, unsigned char* dst) {
#pragma unroll
    for (int p = 0; p < kStepPages; ++p) {
      const int j = kStepPages * u + p;
      stage_page(a.pool, h, pt[j < npages ? j : kStepPages * u], bs, chunks,
                 tg, dst + p * L::stage(bs));
    }
  };
  // the group's first kTileStages - 1 steps in flight first
  for (int k = 0; k < kTileStages - 1; ++k) {
    const int uk = gi + kGroups * k;
    if (kStepPages * uk < npages) stage_step(uk, slot(k));
    commit_copies();
  }
  const T* qg = static_cast<const T*>(a.q);
  for (int i = threadIdx.x; i < npages; i += kTileThreads) pages[i] = pt[i];
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
  const int step_keys = kStepPages * bs;
  for (int u = gi, it = 0; kStepPages * u < npages; u += kGroups, ++it) {
    const int un = u + kGroups * (kTileStages - 1);
    if (kStepPages * un < npages) stage_step(un, slot(it + kTileStages - 1));
    commit_copies();
    wait_copies<kTileStages - 1>();  // this thread's copies of step u
    // the group stores the step: bf16 rows and factors, or int8 rows and
    // raw scales; a thread reads only the staging bytes it copied
    unsigned char* buf = grp + (it & 1) * L::buffer(bs);
    float* fk = reinterpret_cast<float*>(buf + 4 * (size_t)step_keys * D);
#pragma unroll
    for (int p = 0; p < kStepPages; ++p) {
      const unsigned char* cur = slot(it) + p * L::stage(bs);
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int idx = tg + kGroupThreads * c;
        if (idx >= chunks) continue;
        const uint4 kw = reinterpret_cast<const uint4*>(cur)[idx];
        const uint4 vw = reinterpret_cast<const uint4*>(cur)[chunks + idx];
        if constexpr (kTC) {
          const int row = p * bs + idx / (D / 16);
          const int cc = idx % (D / 16);
#pragma unroll
          for (int kv = 0; kv < 2; ++kv) {
            float f[16];
            i8::codes_to_f32<16>(
                reinterpret_cast<const uint32_t*>(kv ? &vw : &kw), f);
            unsigned char* dst = buf + (kv ? 2 * (size_t)step_keys * D : 0) +
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
          reinterpret_cast<uint4*>(buf + (size_t)p * bs * D)[idx] = kw;
          reinterpret_cast<uint4*>(buf + (size_t)(step_keys + p * bs) * D)
              [idx] = vw;
        }
      }
      for (int e = tg; e < 2 * bs; e += kGroupThreads) {
        const float sc =
            reinterpret_cast<const float*>(cur + 32 * (size_t)chunks)[e];
        if (e < bs)
          fk[p * bs + e] = kTC ? sc * i8::kKeyFactor : sc;
        else
          fk[step_keys + p * bs + e - bs] = kTC ? sc * i8::kValueFactor : sc;
      }
    }
    i8::named_barrier_sync(1 + gi, kGroupThreads);
    const unsigned char* kt = buf;  // f32 q: int8 rows
    const unsigned char* vt = buf + (size_t)step_keys * D;
    const float* kfac = fk;
    const float* vfac = fk + step_keys;
    const float kmul = kTC ? 1.f : i8::kKeyFactor;
    const float vmul = kTC ? 1.f : i8::kValueFactor;
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
          // the quad's lanes start at different 16-code chunks: no two
          // read one bank
          const int c = (c0 + t) % (D / 16);
          float kf[4][16];  // keys kb + 8n + 2t + e, as [2n + e]
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int key = kb + 8 * (k >> 1) + 2 * t + (k & 1);
            const uint4 w = i8::lds16(kt, key * D + 16 * c);
            i8::codes_to_f32<16>(reinterpret_cast<const uint32_t*>(&w),
                                 kf[k]);
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
      // hoisted K scales, the causal mask, one max and correction per row
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kb + 8 * n + 2 * t + (i & 1);
          const float s = p0 + 8 * n + 2 * t + (i & 1) < lim[i >> 1]
                              ? sc[n][i] * (kfac[key] * kmul)
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
          sc[n][i] = p * (vfac[key] * vmul);  // hoisted V scale
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
#pragma unroll
          for (int c = 0; c < DQ / 16; ++c) {
            const uint4 w = i8::lds16(vt, (kb + k) * D + DQ * t + 16 * c);
            i8::codes_to_f32<16>(reinterpret_cast<const uint32_t*>(&w),
                                 vf + 16 * c);
          }
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
    i8::named_barrier_sync(1 + gi, kGroupThreads);  // the group's region
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
                         tile_smem + gx * L::group(bs)) +
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

template <typename T, int D>
cudaError_t launch_tile(const TileArgs& a, int num_kv_heads,
                        cudaStream_t stream) {
  const int tpt = kTilePairs / a.group;
  const size_t smem = TileSmem<T, D>::bytes(a.bs, a.pages_per_seq);
  cudaError_t err = i8::allow_smem(ragged_int8_tile_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  // work tiles: at most ceil(T / tpt) + num_seqs for the rows and one
  // more for the pad span's remainder
  dim3 grid(num_kv_heads, (a.num_tokens + tpt - 1) / tpt + a.num_seqs + 1);
  ragged_int8_tile_kernel<T, D><<<grid, kTileThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers of contiguous
// tensors: q/out [num_tokens, num_kv_heads * group, head_dim], pools
// [num_kv_heads, num_pages, page_size, head_dim] (same dtype as q), kv_lens
// [num_seqs] int32, page_indices [num_seqs, pages_per_seq] int32, cu_q_lens
// [num_seqs + 1] int32. group must divide 16, and the two staged pages
// (2 * page_size * head_dim elements) must fit 48 KB of shared memory.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* kv_lens, const void* page_indices, const void* cu_q_lens,
    void* out, int num_tokens, int num_seqs, int num_kv_heads, int group,
    int head_dim, int num_pages, int page_size, int pages_per_seq, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_any<float>(head_dim, q, k_pages, v_pages, kv_lens,
                             page_indices, cu_q_lens, out, num_tokens,
                             num_seqs, num_kv_heads, group, num_pages,
                             page_size, pages_per_seq, scale, s);
  if (dtype == ptt::kBFloat16)
    return launch_any<__nv_bfloat16>(head_dim, q, k_pages, v_pages, kv_lens,
                                     page_indices, cu_q_lens, out, num_tokens,
                                     num_seqs, num_kv_heads, group, num_pages,
                                     page_size, pages_per_seq, scale, s);
  return cudaErrorInvalidValue;
}

// K4-int8: the same operands, each pool given as int8 codes [num_kv_heads,
// num_pages, page_size, head_dim] and f32 scales [num_kv_heads, num_pages,
// page_size, 1]; q/out f32 or bf16 (dtype); group 1, 2, 4 or 8; page_size
// a multiple of 16; every pointer 16-byte aligned. Two or three launches
// on `stream`: the tile kernel (rows of other than one query token, and
// the pad tokens), the split kernel over the decode rows (num_splits
// splits of pages_per_split pages), and, with more than one split, their
// merge. o_part [num_seqs, Hq, num_splits, head_dim] and ml_part
// [num_seqs, Hq, num_splits, 2] are f32 scratch. Allocates nothing.
extern "C" int ragged_paged_attention_int8_launch(
    const void* q, const void* k_codes, const void* k_scales,
    const void* v_codes, const void* v_scales, const void* kv_lens,
    const void* page_indices, const void* cu_q_lens, void* out, void* o_part,
    void* ml_part, int num_tokens, int num_seqs, int num_kv_heads, int group,
    int head_dim, int num_pages, int page_size, int pages_per_seq,
    int num_splits, int pages_per_split, float scale, int dtype,
    void* stream) {
  if (page_size % 16 != 0 || (head_dim != 64 && head_dim != 128) ||
      page_size * head_dim > 16 * kMaxChunks * kGroupThreads ||
      (group != 1 && group != 2 && group != 4 && group != 8))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i8::PoolArgs pool{static_cast<const int8_t*>(k_codes),
                          static_cast<const int8_t*>(v_codes),
                          static_cast<const float*>(k_scales),
                          static_cast<const float*>(v_scales), num_pages};
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
  if (dtype == ptt::kFloat32)
    err = head_dim == 64 ? launch_tile<float, 64>(ta, num_kv_heads, s)
                         : launch_tile<float, 128>(ta, num_kv_heads, s);
  else if (dtype == ptt::kBFloat16)
    err = head_dim == 64
              ? launch_tile<__nv_bfloat16, 64>(ta, num_kv_heads, s)
              : launch_tile<__nv_bfloat16, 128>(ta, num_kv_heads, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const i8::SplitArgs sa{pool,
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
  return i8::decode_int8(sa, num_kv_heads, group, head_dim, dtype, s);
}
