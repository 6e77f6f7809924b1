// K3: the exact top-n of every row, in (key desc, position asc) order.
//
// Replaces the fast tiers' selection on the TPU: the JAX package's
// ops/ranking.py:approx_top_indices (:156-292) calls lax.approx_max_k
// (:235, :246, :263, :274), which lowers to the TPU's PartialReduce unit,
// selection done by hardware with no pallas_call and no portable
// counterpart; and HIGHEST's top_indices (:306, lax.top_k). The port selects
// exactly, with the reference's tie rule: key descending, then position
// ascending. Three entry points share the core:
//
//   mode 0, top_by_key: int32 keys (rows, L), positions along the row or
//     int64 `pos` (L,) or (rows, L), unique within a row, in [0, 2^31);
//   modes 1-3, top_of_plane: generation 2's whole selection over the fast
//     tiers' bf16 plane (rows, H*W). The 16-bit keys (ENERGY,
//     ENERGY_ORTHOGONAL, LEGACY; DC below every key) are built in
//     registers, bit for bit as ops/ranking.py builds them, and never
//     stored. The set is chosen by the full key; the last stage orders it
//     by the re-sort's key (the key with its sign bit masked for ENERGY and
//     ENERGY_ORTHOGONAL, the key for LEGACY, DC last) and writes the flat
//     indices with the f32 estimates rebuilt from the keys (__fdiv_rn by
//     the ortho scale: the plain ops' arithmetic, no fast math);
//   modes 4-5, top_of_coeffs: HIGHEST's f32 coefficient plane (rows, H*W),
//     ENERGY and ENERGY_ORTHOGONAL. The key _f32_key(ranking_metric(v)) is
//     built in registers (v*v; or t = v*s, s the f32 product of the row and
//     column factors, then t*t; each product rounded alone, no FMA; DC the
//     key of -inf), so neither the metric plane nor the key plane exists.
//
// Every element carries a 32-bit key u, mapped to unsigned in its order
// (mode 0 and 4-5: the int32 total-order key with its sign bit flipped;
// modes 1-3: DC 0, else key + 0x8000, 16 bits), and a tie position t (its
// position along the row, or pos). Where two keys tie, the composite
// (u << pbits) | (2^pbits - 1 - t), pbits the bit length of the largest t,
// orders them; the composites of a row are unique.
//
// Bound on the H100: one read of the input. Modes 1-3 read 2 bytes an
// element (the 48 x 1080 x 1920 plane, 199 MB: 0.060 ms at 3.35 TB/s),
// modes 0 and 4-5 read 4 (398 MB, 0.119 ms), plus 8 where `pos` is given.
//
// Design for n <= kCap (4096): two launches, each element read from HBM
// once.
//   1. chunk_kernel, grid (chunks, rows), 512 threads, two blocks an SM
//      (one with `pos`): a block streams its chunk of a row through a ring
//      of kRing 8 KB tiles in shared memory, loaded by the bulk-copy engine
//      (cp.async.bulk on an mbarrier) where the row is 16-byte aligned and
//      by plain loads otherwise. Each thread reads one 16-byte vector of a
//      tile, builds its keys and keeps those at or above the block's
//      running bound P: 32-bit compares on the key, the position only where
//      the key equals P's. A warp reserves buffer slots for its kept
//      elements with one shared atomic; the buffer has no order. The
//      tile's one barrier frees its ring slot and tells whether the buffer
//      (kBuf entries) could take another tile; if not, a cut: a radix
//      select over the buffer (8-bit digits of the composite from the top,
//      16-bit counts in 16 copies of the bins against crowded bins) finds
//      a bound with between n and n + kSlack entries at or above it, a
//      compaction drops the rest, and P rises to it. P never passes the
//      chunk's n-th largest, so the buffer always holds the chunk's top n;
//      at the chunk's end the block cuts once more if more than n + kSlack
//      are left and writes them, with their count, to global memory (they
//      stay in L2). An all-equal chunk keeps its first n + kSlack: its
//      composites differ by position.
//   2. final_kernel, one block a row: the same bounded buffer over the
//      row's candidates, read from L2, an exact cut to n, then a bitonic
//      sort of the n in the output order and the write.
//   The numbers: tiles of 8 KB (4,096 bf16 or 2,048 4-byte elements, one
//   16-byte vector a thread); kBuf = 8,192 entries; a tile adds at most
//   4,096, so n <= kCap = 4,096 and a cut keeps at most n + min(1024,
//   kCap - n). Chunks a row: about two waves of blocks (11 for 48 rows on
//   132 SMs), at least four tiles each, and at most 32,768 candidates a
//   row for the last stage; at 48 x 1080p and n = 1000, 11 chunks of
//   192,512 (bf16) or 190,464 (f32, int32) elements and at most 11 x 2,024
//   candidates a row (178 KB). Shared memory: the buffer's keys and tie
//   positions 64 KB (+32 KB of row positions with `pos`), the bins 8 KB
//   (the holes of a compaction reuse them), the ring 32 KB: 104 KB a
//   block, two an SM. The last stage: the buffer and bins, the sort's
//   4,096 composites and slots, 112 KB (144 KB with `pos`).
//
// n > kCap (the multi-pass path, n = 20,000 in chip_smoke's phase 4d):
// a dispatch by n, not a fallback. An MSB-first radix select over the row
// in global memory: passes of 11-bit digits, each reading the input and
// adding block histograms into the row's (integer atomics), the row's last
// block narrowing the prefix, until the candidates (composite >= prefix)
// fit the sort (cap: max(2048, 2n) up to 16,384, else exactly n); then a
// compaction and a bitonic sort of the candidates in shared memory (n <=
// 16,384) or over global memory, one launch a step; modes 1-3 sort the n
// selected again by the re-sort's key. Three reads of the input and up to
// seven launches, plus the sort's steps over global memory.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Mode : int {
  kKeys = 0,
  kEnergy = 1,
  kOrtho = 2,
  kLegacy = 3,
  kF32Energy = 4,
  kF32Ortho = 5
};

__host__ __device__ constexpr bool is_plane(int m) {
  return m >= kEnergy && m <= kLegacy;
}
__host__ __device__ constexpr int key_bits_of(int m) {
  return is_plane(m) ? 16 : 32;
}
__host__ __device__ constexpr int elt_bytes(int m) {
  return is_plane(m) ? 2 : 4;
}

// The mapped key of DC in modes 4-5: _f32_key(-inf) with its sign bit
// flipped (a negative NaN's metric ranks below it, as in the plain version).
constexpr uint32_t kF32DcKey = 0x007FFFFFu;

// The ortho scale's four f32 factors and the plane's width.
struct Scales {
  float k0_w, w, k0_h, h;  // row 0's, the other rows', column 0's, the rest
  int width;
};

__device__ __forceinline__ float ortho_scale(bool row0, int c,
                                             const Scales& s) {
  return __fmul_rn(row0 ? s.k0_w : s.w, c == 0 ? s.k0_h : s.h);
}

// Modes 1-3: the mapped 16-bit key of bf16 bits `b` in row 0 or not,
// column c, as ops/ranking.py builds the key k (DC aside): k + 0x8000.
//   ENERGY:            (bits(|v|) & 0xFFFE) | signbit(v)
//   ENERGY_ORTHOGONAL: the same of bf16(v * bf16(s)), s the f32 product of
//                      the row and column factors (one rounding each, as
//                      numpy and torch round them; the bf16 product is
//                      exact in f32, so one RNE matches torch's bf16 mul)
//   LEGACY:            the bf16 value's order key of bf16(v * bf16(s)):
//                      -(bits & 0x7FFF) when negative, else bits & 0x7FFF
template <int MODE>
__device__ __forceinline__ uint32_t plane_key(uint32_t b, bool row0, int c,
                                              const Scales& s) {
  uint32_t v16 = b;
  if (MODE != kEnergy) {
    const float scb =
        __bfloat162float(__float2bfloat16_rn(ortho_scale(row0, c, s)));
    const float v =
        __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(b)));
    v16 = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(v, scb)));
  }
  int key;
  if (MODE == kLegacy) {
    const int mag = static_cast<int>(v16 & 0x7FFFu);
    key = (v16 & 0x8000u) ? -mag : mag;
  } else {
    key = static_cast<int>((v16 & 0x7FFEu) | (v16 >> 15));
  }
  return static_cast<uint32_t>(key + 0x8000);
}

// Modes 4-5: _f32_key(ranking_metric(v)) with its sign bit flipped (DC
// aside).
template <int MODE>
__device__ __forceinline__ uint32_t f32_key(float v, bool row0, int c,
                                            const Scales& s) {
  float m;
  if (MODE == kF32Energy) {
    m = __fmul_rn(v, v);
  } else {
    const float t = __fmul_rn(v, ortho_scale(row0, c, s));
    m = __fmul_rn(t, t);
  }
  const int bits = __float_as_int(m);
  const int key = bits < 0 ? bits ^ 0x7FFFFFFF : bits;
  return static_cast<uint32_t>(key) ^ 0x80000000u;
}

// Mode 0: the int32 key mapped to unsigned in its order: its sign bit
// flipped.
__device__ __forceinline__ uint32_t int_key(int key) {
  return static_cast<uint32_t>(key) ^ 0x80000000u;
}

// The mapped key of DC (flat index 0) in modes 1-5, below every other:
// the plane modes' 0, the key of -inf in modes 4-5.
template <int MODE>
__host__ __device__ constexpr uint32_t dc_key() {
  return is_plane(MODE) ? 0u : kF32DcKey;
}

// The key of raw element bits `raw` (bf16 bits, f32 or int32 bits) in row
// 0 or not, column c, DC aside.
template <int MODE>
__device__ __forceinline__ uint32_t body_key(uint32_t raw, bool row0, int c,
                                             const Scales& s) {
  if (MODE == kKeys) return int_key(static_cast<int>(raw));
  if (is_plane(MODE)) return plane_key<MODE>(raw, row0, c, s);
  return f32_key<MODE>(__int_as_float(static_cast<int>(raw)), row0, c, s);
}

// The key of raw element bits at flat index j, column c.
template <int MODE>
__device__ __forceinline__ uint32_t key_of(uint32_t raw, long long j, int c,
                                           const Scales& s) {
  if (MODE != kKeys && j == 0) return dc_key<MODE>();
  return body_key<MODE>(raw, j < s.width, c, s);
}

// Generation 2's re-sort key of a selected mapped plane key u at j (DC 0,
// below every other), and the f32 estimate there: the signed bf16 value
// rebuilt from the key (ENERGY, ENERGY_ORTHOGONAL: the magnitude's bits
// with the sign from the LSB; LEGACY: the order key's bits), divided by
// the f32 ortho scale except at ENERGY, 0.0 at DC.
template <int MODE>
__device__ __forceinline__ uint32_t order_key(uint32_t u, long long j) {
  if (j == 0) return 0u;
  return MODE == kLegacy ? u : (u & 0xFFFEu);
}

template <int MODE>
__device__ __forceinline__ float estimate(uint32_t u, long long j, int c,
                                          const Scales& s) {
  float sval = 0.0f;
  if (j != 0) {
    const int kv = static_cast<int>(u) - 0x8000;
    if (MODE == kLegacy) {
      const int bits = kv < 0 ? ((-kv) | 0x8000) : kv;
      sval = __bfloat162float(
          __ushort_as_bfloat16(static_cast<unsigned short>(bits)));
    } else {
      const float mag = __bfloat162float(
          __ushort_as_bfloat16(static_cast<unsigned short>(kv & 0xFFFE)));
      sval = (kv & 1) ? -mag : mag;
    }
  }
  if (MODE == kEnergy) return sval;
  return __fdiv_rn(sval, ortho_scale(j < s.width, c, s));
}

int bit_length(long long x) {
  int b = 0;
  while (x > 0) {
    ++b;
    x >>= 1;
  }
  return b;
}

long long pow2_at_least(long long x) {
  long long v = 1;
  while (v < x) v <<= 1;
  return v;
}

// ---------------------------------------------------------------------------
// The two-stage path, n <= kCap.

constexpr int kThreads = 512;
constexpr int kTileBytes = 8192;  // one 16-byte vector a thread
constexpr int kRing = 4;
constexpr int kBuf = 8192;                 // buffer entries
constexpr int kMaxTile = kTileBytes / 2;   // elements a tile adds at most
constexpr int kCap = kBuf - kMaxTile;      // 4096
constexpr int kSlack = 1024;               // a cut keeps n to n + kSlack
constexpr int kFinalPer = 4;               // candidates a thread, last stage
constexpr int kFinalTile = kThreads * kFinalPer;
constexpr int kBins = 256;                 // 8-bit digits
constexpr int kCopies = 16;               // a histogram copy per lane pair
constexpr int kHistWords = kBins / 2 * kCopies;  // 16-bit counts
constexpr int kStage2Cands = 32768;        // candidates a row, at most
static_assert(kFinalTile <= kMaxTile, "a last-stage tile fits the buffer");

struct Fused {
  const void* src;
  const long long* pos;   // mode 0 with pos: (L,) or (rows, L)
  long long pos_stride;   // 0 or L
  long long rows, L;
  int chunk;              // elements of a row per block, whole tiles
  int chunks;
  int n;
  int keep;               // a cut keeps n to `keep` entries
  int stride;             // candidate slots a chunk: min(keep, chunk)
  int pbits;              // tie-position bits
  uint32_t pmax;          // 2^pbits - 1
  int tma;                // rows 16-byte aligned: bulk copies
  Scales sc;
  uint32_t* cand_k;       // (rows, chunks, stride)
  uint32_t* cand_t;
  uint32_t* cand_j;       // with pos only: the position along the row
  int* cand_n;            // (rows, chunks): candidates a chunk wrote
  long long* out_idx;     // (rows, n)
  float* out_est;         // modes 1-3: (rows, n)
};

// What a block select decides, shared by the block.
struct Ctl {
  unsigned long long prefix;
  int lo, above, done, kept;
  int nholes, nmoved;
  int fill;  // buffer entries
  uint32_t wsum[kBins / 32];
};

// The buffer: keys, tie positions, row positions (with pos); the
// histogram's words, whose space the holes of a compaction reuse.
struct Buf {
  uint32_t* k;
  uint32_t* t;
  uint32_t* j;  // == t without pos
  uint32_t* hist;
  unsigned short* holes;
};

__device__ __forceinline__ unsigned long long composite(uint32_t k, uint32_t t,
                                                        int pbits,
                                                        uint32_t pmax) {
  return (static_cast<unsigned long long>(k) << pbits) | (pmax - t);
}

// Is (k, t) at or above the bound P = (pk, plo)? 32-bit compares on the
// key; the position only where the key equals P's.
__device__ __forceinline__ bool at_or_above(uint32_t k, uint32_t t,
                                            uint32_t pk, uint32_t plo,
                                            uint32_t pmax) {
  return k > pk || (k == pk && pmax - t >= plo);
}

// The bound P of a cut of the buffer's `count` entries (count > m_hi): at
// least m and at most m_hi of them at or above it; *kept gets how many.
// An MSB-first radix select, 8-bit digits of the composite from bit lo0,
// over shared memory, that stops once the bucket of the m-th largest fits
// under m_hi (m_hi == m: exact). Each pair of lanes counts into its own
// 16-bit copies of the bins, so keys that crowd a few bins (a magnitude's
// exponent byte) cost at most two-way serialized atomics. Every thread of
// the block calls it.
__device__ unsigned long long select_bound(const Buf& b, int count, int m,
                                           int m_hi, int lo0, int pbits,
                                           uint32_t pmax, Ctl& ctl,
                                           int* kept) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long prefix = 0;
  int lo = lo0, above = 0;
  while (true) {
    const int d = lo < 8 ? lo : 8;
    const int sh = lo - d;
    const unsigned long long want = prefix >> lo;
    const uint32_t mask = (1u << d) - 1;
    for (int i = threadIdx.x; i < kHistWords; i += kThreads) b.hist[i] = 0u;
    __syncthreads();
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const unsigned long long u = composite(b.k[i], b.t[i], pbits, pmax);
      if ((u >> lo) == want) {
        const uint32_t bin = static_cast<uint32_t>(u >> sh) & mask;
        atomicAdd(b.hist + (bin >> 1) * kCopies + (lane & (kCopies - 1)),
                  1u << (16 * (bin & 1)));
      }
    }
    __syncthreads();
    // Thread i sums bin 255 - i over the lanes' copies (rotated by its lane:
    // no bank conflicts), then an inclusive scan from the top bin down.
    uint32_t h = 0, incl = 0;
    if (threadIdx.x < kBins) {
      const uint32_t bin = kBins - 1 - threadIdx.x;
      const uint32_t* row = b.hist + (bin >> 1) * kCopies;
      const int half = 16 * (bin & 1);
#pragma unroll
      for (int l = 0; l < kCopies; ++l)
        h += (row[(l + lane) & (kCopies - 1)] >> half) & 0xFFFFu;
      incl = h;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      if (lane == 31) ctl.wsum[warp] = incl;
    }
    __syncthreads();
    if (threadIdx.x < kBins) {
      for (int w = 0; w < warp; ++w) incl += ctl.wsum[w];
      const uint32_t excl = incl - h;
      const uint32_t need = static_cast<uint32_t>(m - above);
      if (excl < need && need <= incl) {
        const uint32_t bin = kBins - 1 - threadIdx.x;
        ctl.prefix = prefix | (static_cast<unsigned long long>(bin) << sh);
        ctl.lo = sh;
        ctl.above = above + static_cast<int>(excl);
        ctl.kept = above + static_cast<int>(incl);
        ctl.done = ctl.kept <= m_hi || sh == 0;
      }
    }
    __syncthreads();
    prefix = ctl.prefix;
    lo = ctl.lo;
    above = ctl.above;
    if (ctl.done) {
      *kept = ctl.kept;
      return prefix;
    }
  }
}

// Reserves `mine` consecutive slots for this thread from the counter *c:
// one atomic a warp. Returns the first; every lane of the warp calls it.
__device__ __forceinline__ int reserve(int mine, int* c) {
  const int lane = threadIdx.x & 31;
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  int base = 0;
  if (lane == 31 && incl) base = atomicAdd(c, incl);
  return __shfl_sync(0xffffffffu, base, 31) + incl - mine;
}

// Keeps the K entries at or above P in [0, K): the dropped entries of
// [0, K) leave holes, which the kept entries of [K, count) fill.
template <bool POS>
__device__ void compact(const Buf& b, int count, int K, unsigned long long P,
                        int pbits, uint32_t pmax, Ctl& ctl) {
  if (threadIdx.x == 0) {
    ctl.nholes = 0;
    ctl.nmoved = 0;
  }
  __syncthreads();
  for (int i0 = 0; i0 < K; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool drop = i < K && composite(b.k[i], b.t[i], pbits, pmax) < P;
    const int slot = reserve(drop, &ctl.nholes);
    if (drop) b.holes[slot] = static_cast<unsigned short>(i);
  }
  __syncthreads();
  for (int i0 = K; i0 < count; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool move =
        i < count && composite(b.k[i], b.t[i], pbits, pmax) >= P;
    const int slot = reserve(move, &ctl.nmoved);
    if (move) {
      const int dst = b.holes[slot];
      b.k[dst] = b.k[i];
      b.t[dst] = b.t[i];
      if (POS) b.j[dst] = b.j[i];
    }
  }
  __syncthreads();
}

// Cuts the buffer (ctl.fill entries, all written) to between m and m_hi of
// its best entries and sets ctl.fill to what is left; returns the new bound.
// Every thread of the block calls it.
template <bool POS>
__device__ unsigned long long cut(const Buf& b, int m, int m_hi, int lo0,
                                  int pbits, uint32_t pmax, Ctl& ctl) {
  const int count = ctl.fill;
  int kept;
  const unsigned long long P =
      select_bound(b, count, m, m_hi, lo0, pbits, pmax, ctl, &kept);
  compact<POS>(b, count, kept, P, pbits, pmax, ctl);
  if (threadIdx.x == 0) ctl.fill = kept;
  __syncthreads();
  return P;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, by the bulk-copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Dynamic shared memory: the buffer's arrays, then the histogram (and the
// holes), then the stage's own part (the ring; the sort's arrays).
template <bool POS>
__host__ __device__ constexpr size_t buf_smem() {
  return (POS ? 3 : 2) * 4 * size_t(kBuf) + 4 * size_t(kHistWords);
}

template <bool POS>
__host__ __device__ constexpr size_t chunk_smem() {
  return buf_smem<POS>() + size_t(kRing) * kTileBytes;
}

template <bool POS>
__host__ __device__ constexpr size_t final_smem() {
  return buf_smem<POS>() + 8 * size_t(kCap) + 2 * size_t(kCap);
}

template <bool POS>
__device__ __forceinline__ Buf buf_at(unsigned char* base) {
  Buf b;
  b.k = reinterpret_cast<uint32_t*>(base);
  b.t = b.k + kBuf;
  b.j = POS ? b.t + kBuf : b.t;
  b.hist = b.t + (POS ? 2 : 1) * kBuf;
  b.holes = reinterpret_cast<unsigned short*>(b.hist);
  return b;
}

// Stage 1: this block's chunk of each of its rows, down to between
// min(n, chunk) and `keep` candidates that hold the chunk's top n. Each
// thread builds the keys of its 16-byte vector of a tile and holds them
// against P; a warp reserves slots for its kept elements with one atomic
// (the buffer needs no order: the last stage sorts). The tile's one
// barrier frees its ring slot and says whether the buffer must be cut
// before the next tile.
template <int MODE, bool POS, bool TMA>
__global__ void __launch_bounds__(kThreads, POS ? 1 : 2)
chunk_kernel(Fused p) {
  constexpr int EB = elt_bytes(MODE);
  constexpr int V = 16 / EB;           // elements a thread reads a tile
  constexpr int T = kTileBytes / EB;   // elements a tile
  constexpr bool kCol = MODE == kOrtho || MODE == kLegacy || MODE == kF32Ortho;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Ctl ctl;
  __shared__ __align__(8) uint64_t full[kRing];
  const Buf b = buf_at<POS>(smem);
  unsigned char* ring = smem + buf_smem<POS>();
  const int lo0 = key_bits_of(MODE) + p.pbits;
  const uint32_t pmask = p.pbits ? (0xFFFFFFFFu >> (32 - p.pbits)) : 0u;

  if (TMA && threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Row positions fit 32 bits (L < 2^31).
  const uint32_t c0 = blockIdx.x * static_cast<uint32_t>(p.chunk);
  const uint32_t c1 = c0 + p.chunk < p.L ? c0 + p.chunk
                                         : static_cast<uint32_t>(p.L);
  const int len = static_cast<int>(c1 - c0);
  const int ntiles = (len + T - 1) / T;
  const uint32_t width = static_cast<uint32_t>(p.sc.width);
  uint32_t seq = 0;  // tiles this block has loaded through the ring

  for (long long row = blockIdx.y; row < p.rows; row += gridDim.y) {
    const char* rsrc = static_cast<const char*>(p.src) + row * p.L * EB;
    auto issue = [&](int q) {
      const uint32_t t0 = c0 + q * T;
      const uint32_t t1 = t0 + T < c1 ? t0 + T : c1;
      const int s = (seq + q) % kRing;
      bulk_load(ring + s * kTileBytes, rsrc + static_cast<size_t>(t0) * EB,
                (t1 - t0) * EB, &full[s]);
    };
    if (threadIdx.x == 0) ctl.fill = 0;
    __syncthreads();  // the barriers' init; the last row's writes are done
    if (TMA && threadIdx.x == 0)
      for (int q = 0; q < kRing && q < ntiles; ++q) issue(q);

    uint32_t pk = 0, plo = 0;  // the bound P, split at pbits
    for (int q = 0; q < ntiles; ++q) {
      const uint32_t j0 = c0 + q * T + threadIdx.x * V;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (TMA) {
        const int s = (seq + q) % kRing;
        mbar_wait(&full[s], ((seq + q) / kRing) & 1);
        const uint4 v = *reinterpret_cast<const uint4*>(
            ring + s * kTileBytes + threadIdx.x * 16);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (j0 + e >= c1) continue;
          if (EB == 2)
            w[e / 2] |= static_cast<uint32_t>(
                            reinterpret_cast<const unsigned short*>(rsrc)[j0 + e])
                        << (16 * (e % 2));
          else
            w[e] = reinterpret_cast<const uint32_t*>(rsrc)[j0 + e];
        }
      }
      uint32_t kk[V], tt[V];
      uint32_t bits = 0;
      int c = kCol ? static_cast<int>(j0 % width) : 0;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const uint32_t j = j0 + e;
        const uint32_t raw =
            EB == 2 ? (w[e / 2] >> (16 * (e % 2))) & 0xFFFFu : w[e];
        kk[e] = body_key<MODE>(raw, j < width, c, p.sc);
        if (kCol && ++c == static_cast<int>(width)) c = 0;
        if (MODE != kKeys && j == 0) kk[e] = dc_key<MODE>();
        tt[e] = j;
        if (j < c1) {
          if (POS) tt[e] = static_cast<uint32_t>(p.pos[row * p.pos_stride + j]);
          if (at_or_above(kk[e], tt[e], pk, plo, p.pmax)) bits |= 1u << e;
        }
      }
      const int mine = __popc(bits);
      int end = 0;
      if (__any_sync(0xffffffffu, mine)) {
        int at = reserve(mine, &ctl.fill);
        end = at + mine;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (!(bits >> e & 1u)) continue;
          b.k[at] = kk[e];
          b.t[at] = tt[e];
          if (POS) b.j[at] = j0 + e;
          ++at;
        }
      }
      // Every thread has read its vector: the slot is free. A buffer that
      // could not take another tile is cut.
      const bool full_up = __syncthreads_or(end >= kBuf - kMaxTile);
      if (TMA && threadIdx.x == 0 && q + kRing < ntiles) issue(q + kRing);
      if (full_up) {
        const unsigned long long P =
            cut<POS>(b, p.n, p.keep, lo0, p.pbits, p.pmax, ctl);
        pk = static_cast<uint32_t>(P >> p.pbits);
        plo = static_cast<uint32_t>(P) & pmask;
      }
    }
    seq += ntiles;
    if (ctl.fill > p.keep)  // the same in every thread: no append since
      cut<POS>(b, p.n, p.keep, lo0, p.pbits, p.pmax, ctl);
    const int count = ctl.fill;
    const long long chunk_id = row * p.chunks + blockIdx.x;
    const long long base = chunk_id * p.stride;
    for (int i = threadIdx.x; i < count; i += kThreads) {
      p.cand_k[base + i] = b.k[i];
      p.cand_t[base + i] = b.t[i];
      if (POS) p.cand_j[base + i] = b.j[i];
    }
    if (threadIdx.x == 0) p.cand_n[chunk_id] = count;
    __syncthreads();
  }
}

// Stage 2: one block a row: the row's candidates down to its n, sorted in
// the output order (bitonic, descending, in shared memory) and written.
template <int MODE, bool POS>
__global__ void __launch_bounds__(kThreads, 1) final_kernel(Fused p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Ctl ctl;
  const Buf b = buf_at<POS>(smem);
  unsigned long long* sk =
      reinterpret_cast<unsigned long long*>(smem + buf_smem<POS>());
  unsigned short* sv = reinterpret_cast<unsigned short*>(sk + kCap);
  const int lo0 = key_bits_of(MODE) + p.pbits;
  const uint32_t pmask = p.pbits ? (0xFFFFFFFFu >> (32 - p.pbits)) : 0u;
  const int slots = p.chunks * p.stride;
  const int tiles = (slots + kFinalTile - 1) / kFinalTile;
  const int n = p.n;
  int len2 = 1;
  while (len2 < n) len2 <<= 1;

  for (long long row = blockIdx.x; row < p.rows; row += gridDim.x) {
    const long long base = row * slots;
    const int* counts = p.cand_n + row * p.chunks;
    if (threadIdx.x == 0) ctl.fill = 0;
    __syncthreads();
    uint32_t pk = 0, plo = 0;
    for (int q = 0; q < tiles; ++q) {
      uint32_t kk[kFinalPer], tt[kFinalPer], jv[kFinalPer];
      uint32_t bits = 0;
#pragma unroll
      for (int e = 0; e < kFinalPer; ++e) {
        const int s = q * kFinalTile + e * kThreads + threadIdx.x;
        const int chunk = s / p.stride;
        const bool valid =
            s < slots && s - chunk * p.stride < __ldg(counts + chunk);
        kk[e] = valid ? p.cand_k[base + s] : 0u;
        tt[e] = valid ? p.cand_t[base + s] : 0u;
        jv[e] = POS && valid ? p.cand_j[base + s] : tt[e];
        if (valid && at_or_above(kk[e], tt[e], pk, plo, p.pmax))
          bits |= 1u << e;
      }
      const int mine = __popc(bits);
      int end = 0;
      if (__any_sync(0xffffffffu, mine)) {
        int at = reserve(mine, &ctl.fill);
        end = at + mine;
#pragma unroll
        for (int e = 0; e < kFinalPer; ++e) {
          if (!(bits >> e & 1u)) continue;
          b.k[at] = kk[e];
          b.t[at] = tt[e];
          if (POS) b.j[at] = jv[e];
          ++at;
        }
      }
      if (__syncthreads_or(end >= kBuf - kMaxTile)) {
        const unsigned long long P =
            cut<POS>(b, n, p.keep, lo0, p.pbits, p.pmax, ctl);
        pk = static_cast<uint32_t>(P >> p.pbits);
        plo = static_cast<uint32_t>(P) & pmask;
      }
    }
    __syncthreads();
    if (ctl.fill > n) cut<POS>(b, n, n, lo0, p.pbits, p.pmax, ctl);

    // The output order: (key desc, tie position asc); modes 1-3 the
    // re-sort's (order key desc, index asc). Composites + 1, so that the
    // padding's 0 sorts last.
    for (int i = threadIdx.x; i < len2; i += kThreads) {
      unsigned long long v = 0ull;
      if (i < n) {
        uint32_t k = b.k[i];
        if (is_plane(MODE)) k = order_key<MODE>(k, b.t[i]);
        v = composite(k, b.t[i], p.pbits, p.pmax) + 1;
      }
      sk[i] = v;
      sv[i] = static_cast<unsigned short>(i);
    }
    __syncthreads();
    for (int k = 2; k <= len2; k <<= 1) {
      for (int h = k >> 1; h > 0; h >>= 1) {
        for (int t = threadIdx.x; t < len2 / 2; t += kThreads) {
          const int i = ((t & ~(h - 1)) << 1) | (t & (h - 1));
          const bool desc = (i & k) == 0;
          const unsigned long long x = sk[i], y = sk[i + h];
          if ((x < y) == desc) {
            sk[i] = y;
            sk[i + h] = x;
            const unsigned short vx = sv[i];
            sv[i] = sv[i + h];
            sv[i + h] = vx;
          }
        }
        // For h <= 32 a warp's pairs stay inside its own 64 elements.
        const int next = h > 1 ? h >> 1 : k;
        if (h > 32 || next > 32)
          __syncthreads();
        else
          __syncwarp();
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int slot = sv[i];
      const uint32_t jrow = b.j[slot];
      p.out_idx[row * n + i] = jrow;
      if (is_plane(MODE))
        p.out_est[row * n + i] = estimate<MODE>(
            b.k[slot], jrow, static_cast<int>(jrow % p.sc.width), p.sc);
    }
    __syncthreads();
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The two-stage path's split of a row: chunks of whole tiles, about two
// waves of blocks, at least four tiles each, at most kStage2Cands / keep
// chunks; and what a cut keeps.
struct Geometry {
  int chunks, chunk, keep, stride;
};

Geometry fused_geometry(long long rows, long long L, int n, int mode,
                        bool pos) {
  const long long T = kTileBytes / (is_plane(mode) ? 2 : 4);
  const long long slots = static_cast<long long>(sm_count()) * (pos ? 1 : 2);
  Geometry g;
  g.keep = n + (kSlack < kCap - n ? kSlack : kCap - n);
  long long c = (L + 4 * T - 1) / (4 * T);
  const long long by_grid = 2 * slots / (rows > 0 ? rows : 1);
  const long long by_final = kStage2Cands / g.keep;
  if (c > by_grid) c = by_grid;
  if (c > by_final) c = by_final;
  if (c < 1) c = 1;
  const long long per = (L + c - 1) / c;
  const long long chunk = (per + T - 1) / T * T;
  g.chunk = static_cast<int>(chunk);
  g.chunks = static_cast<int>((L + chunk - 1) / chunk);
  g.stride = g.keep < g.chunk ? g.keep : g.chunk;
  return g;
}

long long fused_workspace(long long rows, long long L, int n, int mode,
                          bool pos) {
  const Geometry g = fused_geometry(rows, L, n, mode, pos);
  return rows * g.chunks * (static_cast<long long>(g.stride) * (pos ? 12 : 8) +
                            4);
}

// Sets a kernel's dynamic shared memory once per device.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int MODE, bool POS>
int run_fused(Fused p, cudaStream_t stream, int* launches) {
  static bool set1[2][64], set2[64];
  const int rows_y = static_cast<int>(p.rows < 65535 ? p.rows : 65535);
  const dim3 grid(static_cast<unsigned int>(p.chunks), rows_y);
  cudaError_t err;
  if (p.tma) {
    auto k1 = chunk_kernel<MODE, POS, true>;
    if ((err = allow_smem(k1, chunk_smem<POS>(), set1[1])) != cudaSuccess)
      return int(err);
    k1<<<grid, kThreads, chunk_smem<POS>(), stream>>>(p);
  } else {
    auto k1 = chunk_kernel<MODE, POS, false>;
    if ((err = allow_smem(k1, chunk_smem<POS>(), set1[0])) != cudaSuccess)
      return int(err);
    k1<<<grid, kThreads, chunk_smem<POS>(), stream>>>(p);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  *launches += 1;
  auto k2 = final_kernel<MODE, POS>;
  if ((err = allow_smem(k2, final_smem<POS>(), set2)) != cudaSuccess)
    return int(err);
  k2<<<rows_y, kThreads, final_smem<POS>(), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  *launches += 1;
  return int(cudaSuccess);
}

// ---------------------------------------------------------------------------
// The multi-pass path, n > kCap.

constexpr int kDigit = 11;
constexpr int kPassBins = 1 << kDigit;
constexpr int kSortThreads = 1024;
constexpr int kSmemCap = 16384;  // candidates sorted in shared memory
constexpr int kSlotBytes = 12;   // an 8-byte composite and a 4-byte slot

// One row's select: written by the last block of each pass, read by every
// block of the next launch.
struct RowState {
  unsigned long long prefix;  // the determined high bits, the rest zero
  int lo;                     // bits >= lo of a composite are determined
  int above;                  // elements above the prefix's bucket
  int done;                   // the candidates (composite >= prefix) fit
  unsigned int arrived;       // blocks of this pass that have merged
  int count;                  // candidates the compaction wrote
  int pad;
};
static_assert(sizeof(RowState) == 32, "RowState layout");

struct Params {
  int mode;
  const void* src;             // int32 keys, the bf16 or the f32 plane
  const long long* pos;        // mode 0: nullptr (positions), (L,) or (rows, L)
  long long pos_stride;        // 0 for (L,), L for (rows, L)
  long long rows, L;
  long long chunk;             // elements of a row per block, whole vectors
  long long stride;            // candidate slots per row
  Scales sc;
  int pbits, bits;             // position bits, composite bits
  int n, cap;
  int vec;                     // rows start 16-byte aligned: vector loads
  RowState* state;
  unsigned int* hist;          // (rows, kPassBins)
  unsigned long long* cand_u;  // (rows, stride): composite + 1
  unsigned int* cand_j;        // (rows, stride): position along the row
};

__device__ __forceinline__ unsigned long long compose(unsigned int k,
                                                      long long pos,
                                                      const Params& p) {
  const unsigned long long pmax = (1ull << p.pbits) - 1;
  return (static_cast<unsigned long long>(k) << p.pbits) |
         (pmax - static_cast<unsigned long long>(pos));
}

template <int MODE>
__device__ __forceinline__ unsigned long long composite_at(const Params& p,
                                                           long long row,
                                                           long long j) {
  if (MODE == kKeys) {
    const int key = static_cast<const int*>(p.src)[row * p.L + j];
    const long long pos = p.pos ? p.pos[row * p.pos_stride + j] : j;
    return compose(int_key(key), pos, p);
  }
  const int c = static_cast<int>(j % p.sc.width);
  uint32_t raw;
  if (is_plane(MODE))
    raw = static_cast<const unsigned short*>(p.src)[row * p.L + j];
  else
    raw = static_cast<const uint32_t*>(p.src)[row * p.L + j];
  return compose(key_of<MODE>(raw, j, c, p.sc), j, p);
}

// Calls f(composite, j) for every element of this block's chunk of `row`:
// 16-byte vector loads where p.vec, one at a time for the rest.
template <int MODE, typename F>
__device__ __forceinline__ void visit(const Params& p, long long row, F&& f) {
  constexpr int EB = elt_bytes(MODE);
  constexpr int V = 16 / EB;
  const long long c0 = static_cast<long long>(blockIdx.x) * p.chunk;
  const long long c1 = c0 + p.chunk < p.L ? c0 + p.chunk : p.L;
  long long tail = c0;
  if (p.vec) {
    const long long vend = c0 + (c1 - c0) / V * V;
    const char* rsrc = static_cast<const char*>(p.src) + row * p.L * EB;
    for (long long j0 = c0 + static_cast<long long>(threadIdx.x) * V;
         j0 < vend; j0 += static_cast<long long>(blockDim.x) * V) {
      const uint4 raw4 = *reinterpret_cast<const uint4*>(rsrc + j0 * EB);
      const uint32_t w[4] = {raw4.x, raw4.y, raw4.z, raw4.w};
      int c = MODE == kKeys ? 0 : static_cast<int>(j0 % p.sc.width);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const long long j = j0 + i;
        const uint32_t raw =
            EB == 2 ? (w[i / 2] >> (16 * (i % 2))) & 0xFFFFu : w[i];
        if (MODE == kKeys) {
          const long long pos = p.pos ? p.pos[row * p.pos_stride + j] : j;
          f(compose(int_key(static_cast<int>(raw)), pos, p), j);
        } else {
          f(compose(key_of<MODE>(raw, j, c, p.sc), j, p), j);
          if (++c == p.sc.width) c = 0;
        }
      }
    }
    tail = vend;
  }
  for (long long j = tail + threadIdx.x; j < c1; j += blockDim.x)
    f(composite_at<MODE>(p, row, j), j);
}

// The last block of a pass: finds the bucket of the n-th composite among
// the 2^d digits of the current bucket and narrows the row's state, then
// clears the histogram for the next pass. `above0` is read before any
// thread writes the state.
__device__ void decide(const Params& p, RowState* st, unsigned int* gh,
                       int above0, unsigned long long prefix, int d, int sh) {
  __shared__ unsigned int part[kThreads];
  const int nb = 1 << d;
  const int per = (nb + kThreads - 1) / kThreads;
  // Thread t owns `per` bins, the highest bins to thread 0.
  const int top = nb - 1 - per * static_cast<int>(threadIdx.x);
  unsigned int sum = 0;
  for (int k = 0; k < per; ++k)
    if (top - k >= 0) sum += __ldcg(gh + top - k);
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const unsigned int v = threadIdx.x >= off ? part[threadIdx.x - off] : 0u;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  const unsigned int incl = part[threadIdx.x];
  const unsigned int excl = incl - sum;
  const unsigned int need = static_cast<unsigned int>(p.n - above0);
  if (excl < need && need <= incl) {
    unsigned int acc = excl;
    for (int k = 0; k < per; ++k) {
      const int b = top - k;
      const unsigned int h = __ldcg(gh + b);
      if (acc + h >= need) {
        const int above = above0 + static_cast<int>(acc);
        st->prefix = prefix | (static_cast<unsigned long long>(b) << sh);
        st->lo = sh;
        st->above = above;
        st->done = (static_cast<long long>(above) + h <= p.cap) || sh == 0;
        break;
      }
      acc += h;
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += kThreads) gh[b] = 0u;
  if (threadIdx.x == 0) st->arrived = 0u;
}

__global__ void init_kernel(Params p) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = first; r < p.rows; r += step) {
    RowState s = {};
    s.lo = p.bits;
    s.done = p.L <= p.cap;
    p.state[r] = s;
  }
  for (long long i = first; i < p.rows * kPassBins; i += step) p.hist[i] = 0u;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) pass_kernel(Params p) {
  __shared__ unsigned int hist[kPassBins];
  __shared__ bool last;
  for (long long row = blockIdx.y; row < p.rows; row += gridDim.y) {
    RowState* st = p.state + row;
    if (st->done) continue;  // the same for every thread of the block
    const int lo = st->lo;
    const int above0 = st->above;
    const unsigned long long prefix = st->prefix;
    const int d = lo < kDigit ? lo : kDigit;
    const int sh = lo - d;
    const unsigned long long mask = (1ull << d) - 1;
    const unsigned long long want = prefix >> lo;
    for (int b = threadIdx.x; b < kPassBins; b += kThreads) hist[b] = 0u;
    __syncthreads();
    visit<MODE>(p, row, [&](unsigned long long u, long long) {
      if ((u >> lo) == want)
        atomicAdd(hist + ((u >> sh) & mask), 1u);
    });
    __syncthreads();
    unsigned int* gh = p.hist + row * kPassBins;
    for (int b = threadIdx.x; b <= static_cast<int>(mask); b += kThreads)
      if (hist[b]) atomicAdd(gh + b, hist[b]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(&st->arrived, 1u) == gridDim.x - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      decide(p, st, gh, above0, prefix, d, sh);
    }
    __syncthreads();
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) compact_kernel(Params p) {
  for (long long row = blockIdx.y; row < p.rows; row += gridDim.y) {
    RowState* st = p.state + row;
    const unsigned long long t = st->prefix;
    unsigned long long* cu = p.cand_u + row * p.stride;
    unsigned int* cj = p.cand_j + row * p.stride;
    visit<MODE>(p, row, [&](unsigned long long u, long long j) {
      if (u >= t) {
        const int slot = atomicAdd(&st->count, 1);
        if (slot < p.stride) {  // always, for positions unique in a row
          cu[slot] = u + 1;      // 0 stays below every candidate: padding
          cj[slot] = static_cast<unsigned int>(j);
        }
      }
    });
  }
}

// Modes 1-3: a selected composite + 1 turned into the re-sort's composite
// + 1; its mapped key goes to the slot beside it.
__device__ __forceinline__ unsigned long long to_order(const Params& p,
                                                       unsigned long long c1,
                                                       unsigned int* key) {
  const unsigned long long v = c1 - 1;
  const unsigned long long pmax = (1ull << p.pbits) - 1;
  const unsigned int u = static_cast<unsigned int>(v >> p.pbits);
  const long long j = static_cast<long long>(pmax - (v & pmax));
  *key = u;
  const unsigned int ok = p.mode == kLegacy ? order_key<kLegacy>(u, j)
                                            : order_key<kEnergy>(u, j);
  return compose(ok, j, p) + 1;
}

// Writes output i of `row` from a sorted composite + 1 and its slot: the
// position (mode 0: the slot; modes 4-5 and 1-3: from the composite) and,
// in modes 1-3, the estimate of the key in the slot.
__device__ __forceinline__ void write_out(const Params& p, long long row,
                                          int i, unsigned long long c1,
                                          unsigned int slot, long long* out_idx,
                                          float* out_est) {
  const unsigned long long pmax = (1ull << p.pbits) - 1;
  const long long j = p.mode == kKeys
                          ? static_cast<long long>(slot)
                          : static_cast<long long>(pmax - ((c1 - 1) & pmax));
  out_idx[row * p.n + i] = j;
  if (is_plane(p.mode)) {
    const int c = static_cast<int>(j % p.sc.width);
    float e;
    if (p.mode == kEnergy) e = estimate<kEnergy>(slot, j, c, p.sc);
    else if (p.mode == kOrtho) e = estimate<kOrtho>(slot, j, c, p.sc);
    else e = estimate<kLegacy>(slot, j, c, p.sc);
    out_est[row * p.n + i] = e;
  }
}

__device__ __forceinline__ int candidates(const Params& p, long long row) {
  const int c = p.state[row].count;
  return c < p.stride ? c : static_cast<int>(p.stride);
}

__device__ void bitonic_smem(unsigned long long* sk, unsigned int* sv,
                             int len) {
  for (int k = 2; k <= len; k <<= 1) {
    for (int h = k >> 1; h > 0; h >>= 1) {
      for (int t = threadIdx.x; t < len / 2; t += kSortThreads) {
        const int i = ((t & ~(h - 1)) << 1) | (t & (h - 1));
        const bool desc = (i & k) == 0;
        const unsigned long long a = sk[i], b = sk[i + h];
        if ((a < b) == desc) {
          sk[i] = b;
          sk[i + h] = a;
          const unsigned int va = sv[i];
          sv[i] = sv[i + h];
          sv[i + h] = va;
        }
      }
      __syncthreads();
    }
  }
}

// One block per row: the row's candidates, bitonic-sorted descending in
// shared memory (padded with 0 to a power of two), the first n written;
// modes 1-3 sort those n again by the re-sort's key first.
__global__ void __launch_bounds__(kSortThreads)
sort_kernel(Params p, int slots, long long* out_idx, float* out_est) {
  extern __shared__ unsigned long long sk[];
  unsigned int* sv = reinterpret_cast<unsigned int*>(sk + slots);
  for (long long row = blockIdx.x; row < p.rows; row += gridDim.x) {
    const int c = candidates(p, row);
    int len = 1;
    while (len < c) len <<= 1;
    const unsigned long long* cu = p.cand_u + row * p.stride;
    const unsigned int* cj = p.cand_j + row * p.stride;
    for (int i = threadIdx.x; i < len; i += kSortThreads) {
      sk[i] = i < c ? cu[i] : 0ull;
      sv[i] = i < c ? cj[i] : 0u;
    }
    __syncthreads();
    bitonic_smem(sk, sv, len);
    if (is_plane(p.mode)) {
      int len2 = 1;
      while (len2 < p.n) len2 <<= 1;
      for (int i = threadIdx.x; i < len2; i += kSortThreads) {
        if (i < p.n) {
          unsigned int key;
          sk[i] = to_order(p, sk[i], &key);
          sv[i] = key;
        } else {
          sk[i] = 0ull;
        }
      }
      __syncthreads();
      bitonic_smem(sk, sv, len2);
    }
    for (int i = threadIdx.x; i < p.n; i += kSortThreads)
      write_out(p, row, i, sk[i], sv[i], out_idx, out_est);
    __syncthreads();
  }
}

// n above kSmemCap: every row holds exactly n candidates in `stride` (a
// power of two) slots; pad (modes 1-3: and turn each into its re-sort
// composite), then one bitonic step over global memory per launch.
__global__ void global_pad_kernel(Params p) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = first; i < p.rows * p.stride; i += step) {
    const long long row = i / p.stride;
    if (i - row * p.stride >= candidates(p, row)) {
      p.cand_u[i] = 0ull;
      p.cand_j[i] = 0u;
    } else if (is_plane(p.mode)) {
      unsigned int key;
      p.cand_u[i] = to_order(p, p.cand_u[i], &key);
      p.cand_j[i] = key;
    }
  }
}

__global__ void global_step_kernel(Params p, long long k, long long h) {
  const long long half = p.stride / 2;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = first; q < p.rows * half; q += step) {
    const long long row = q / half, t = q - row * half;
    const long long i = ((t & ~(h - 1)) << 1) | (t & (h - 1));
    const bool desc = (i & k) == 0;
    unsigned long long* cu = p.cand_u + row * p.stride;
    unsigned int* cj = p.cand_j + row * p.stride;
    const unsigned long long a = cu[i], b = cu[i + h];
    if ((a < b) == desc) {
      cu[i] = b;
      cu[i + h] = a;
      const unsigned int va = cj[i];
      cj[i] = cj[i + h];
      cj[i + h] = va;
    }
  }
}

__global__ void global_out_kernel(Params p, long long* out_idx,
                                  float* out_est) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = first; q < p.rows * p.n; q += step) {
    const long long row = q / p.n;
    const int i = static_cast<int>(q - row * p.n);
    write_out(p, row, i, p.cand_u[row * p.stride + i],
              p.cand_j[row * p.stride + i], out_idx, out_est);
  }
}

// The stopping size and the candidate slots per row (see the header).
void sizes(long long L, int n, int* cap, long long* stride) {
  if (n <= kSmemCap) {
    long long c = 2LL * n > 2048 ? 2LL * n : 2048;
    *cap = static_cast<int>(c < kSmemCap ? c : kSmemCap);
    *stride = L < *cap ? L : *cap;
  } else {
    *cap = n;
    *stride = pow2_at_least(n);
  }
}

template <int MODE>
int run_passes(Params p, long long* out_idx, float* out_est,
               cudaStream_t stream, int* launches) {
  const int rows_y = static_cast<int>(p.rows < 65535 ? p.rows : 65535);
  const long long blocks_wanted = 132LL * 4;
  long long per_row = blocks_wanted / rows_y;
  const long long by_size =
      (p.L + static_cast<long long>(kThreads) * 32 - 1) / (kThreads * 32LL);
  if (per_row > by_size) per_row = by_size;
  if (per_row < 1) per_row = 1;
  p.chunk = ((p.L + per_row - 1) / per_row + 7) / 8 * 8;
  const long long chunks = (p.L + p.chunk - 1) / p.chunk;
  const dim3 grid(static_cast<unsigned int>(chunks), rows_y);
  cudaError_t err;

  const long long init_threads = p.rows * kPassBins;
  const int init_blocks = static_cast<int>(
      (init_threads + 255) / 256 < 1024 ? (init_threads + 255) / 256 : 1024);
  init_kernel<<<init_blocks, 256, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  *launches += 1;
  if (p.L > p.cap) {
    for (int lo = p.bits; lo > 0; lo -= kDigit) {
      pass_kernel<MODE><<<grid, kThreads, 0, stream>>>(p);
      if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
      *launches += 1;
    }
  }
  compact_kernel<MODE><<<grid, kThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  *launches += 1;

  if (p.stride <= kSmemCap && p.n <= kSmemCap) {
    const int slots = static_cast<int>(pow2_at_least(p.stride));
    const size_t smem = static_cast<size_t>(slots) * kSlotBytes;
    err = cudaFuncSetAttribute(sort_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return int(err);
    const int blocks = static_cast<int>(p.rows < 65535 ? p.rows : 65535);
    sort_kernel<<<blocks, kSortThreads, smem, stream>>>(p, slots, out_idx,
                                                        out_est);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    *launches += 1;
    return int(cudaSuccess);
  }
  const int blocks = 132 * 8;
  global_pad_kernel<<<blocks, 256, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  *launches += 1;
  for (long long k = 2; k <= p.stride; k <<= 1)
    for (long long h = k >> 1; h > 0; h >>= 1) {
      global_step_kernel<<<blocks, 256, 0, stream>>>(p, k, h);
      if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
      *launches += 1;
    }
  global_out_kernel<<<blocks, 256, 0, stream>>>(p, out_idx, out_est);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  *launches += 1;
  return int(cudaSuccess);
}

long long passes_workspace(long long rows, long long L, int n) {
  int cap;
  long long stride;
  sizes(L, n, &cap, &stride);
  return rows * (static_cast<long long>(sizeof(RowState)) + 4LL * kPassBins +
                 kSlotBytes * stride);
}

template <int MODE>
int dispatch(const void* src, const long long* pos, int pos_per_row,
             long long rows, long long L, const Scales& sc, int n,
             void* workspace, long long* out_idx, float* out_est,
             cudaStream_t stream, int* launches) {
  const bool has_pos = MODE == kKeys && pos != nullptr;
  const int pbits = has_pos ? 31 : bit_length(L - 1);
  const int eb = elt_bytes(MODE);
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                       (L * eb) % 16 == 0;
  if (n <= kCap) {
    Fused f = {};
    f.src = src;
    f.pos = has_pos ? pos : nullptr;
    f.pos_stride = pos_per_row ? L : 0;
    f.rows = rows;
    f.L = L;
    f.n = n;
    f.pbits = pbits;
    f.pmax = pbits ? (0xFFFFFFFFu >> (32 - pbits)) : 0u;
    f.tma = aligned;
    f.sc = sc;
    const Geometry g = fused_geometry(rows, L, n, MODE, has_pos);
    f.chunks = g.chunks;
    f.chunk = g.chunk;
    f.keep = g.keep;
    f.stride = g.stride;
    const long long cands = rows * f.chunks * static_cast<long long>(f.stride);
    f.cand_k = static_cast<uint32_t*>(workspace);
    f.cand_t = f.cand_k + cands;
    f.cand_j = has_pos ? f.cand_t + cands : f.cand_t;
    f.cand_n = reinterpret_cast<int*>((has_pos ? f.cand_j : f.cand_t) + cands);
    f.out_idx = out_idx;
    f.out_est = out_est;
    return has_pos ? run_fused<MODE, true>(f, stream, launches)
                   : run_fused<MODE, false>(f, stream, launches);
  }
  Params p = {};
  p.mode = MODE;
  p.src = src;
  p.pos = has_pos ? pos : nullptr;
  p.pos_stride = pos_per_row ? L : 0;
  p.rows = rows;
  p.L = L;
  p.sc = sc;
  p.pbits = pbits;
  p.bits = key_bits_of(MODE) + pbits;
  p.n = n;
  sizes(L, n, &p.cap, &p.stride);
  p.vec = aligned;
  char* ws = static_cast<char*>(workspace);
  p.state = reinterpret_cast<RowState*>(ws);
  ws += rows * sizeof(RowState);
  p.hist = reinterpret_cast<unsigned int*>(ws);
  ws += rows * 4LL * kPassBins;
  p.cand_u = reinterpret_cast<unsigned long long*>(ws);
  ws += rows * 8LL * p.stride;
  p.cand_j = reinterpret_cast<unsigned int*>(ws);
  return run_passes<MODE>(p, out_idx, out_est, stream, launches);
}

}  // namespace

// Bytes of scratch ssw_topk_select needs: for n <= 4096 the candidates of
// the two-stage path, else the row states, histograms and candidate slots
// of the multi-pass path. Depends on the current device's SM count.
extern "C" long long ssw_topk_select_workspace(int mode, int has_pos,
                                               long long rows, long long L,
                                               int n) {
  if (n <= kCap)
    return fused_workspace(rows, L, n, mode, mode == kKeys && has_pos);
  return passes_workspace(rows, L, n);
}

// mode 0: src int32 keys (rows, L), pos nullptr (the positions along the
// row) or int64 (L,) (pos_per_row 0) or (rows, L) (pos_per_row 1). Modes
// 1-3 (ENERGY, ENERGY_ORTHOGONAL, LEGACY): src the bf16 plane (rows, L =
// H * width), out_est f32 (rows, n); modes 4-5 (ENERGY, ENERGY_ORTHOGONAL):
// src the f32 plane. out_idx: int64 (rows, n), positions along the row in
// (key desc, pos asc) order; modes 1-3 in the re-sort's order. All
// contiguous; 1 <= n <= L; `workspace` holds ssw_topk_select_workspace
// bytes, 16-byte aligned. *launches gets the device launches made. Returns
// the first launch error (0 when every launch was accepted).
extern "C" int ssw_topk_select(int mode, const void* src, const long long* pos,
                               int pos_per_row, long long rows, long long L,
                               int width, int n, float s_k0_w, float s_w,
                               float s_k0_h, float s_h, void* workspace,
                               long long* out_idx, float* out_est,
                               int* launches, cudaStream_t stream) {
  *launches = 0;
  if (rows == 0 || n == 0) return int(cudaSuccess);
  const Scales sc = {s_k0_w, s_w, s_k0_h, s_h, width > 0 ? width : 1};
  switch (mode) {
    case kKeys:
      return dispatch<kKeys>(src, pos, pos_per_row, rows, L, sc, n, workspace,
                             out_idx, nullptr, stream, launches);
    case kEnergy:
      return dispatch<kEnergy>(src, nullptr, 0, rows, L, sc, n, workspace,
                               out_idx, out_est, stream, launches);
    case kOrtho:
      return dispatch<kOrtho>(src, nullptr, 0, rows, L, sc, n, workspace,
                              out_idx, out_est, stream, launches);
    case kLegacy:
      return dispatch<kLegacy>(src, nullptr, 0, rows, L, sc, n, workspace,
                               out_idx, out_est, stream, launches);
    case kF32Energy:
      return dispatch<kF32Energy>(src, nullptr, 0, rows, L, sc, n, workspace,
                                  out_idx, nullptr, stream, launches);
    case kF32Ortho:
      return dispatch<kF32Ortho>(src, nullptr, 0, rows, L, sc, n, workspace,
                                 out_idx, nullptr, stream, launches);
    default:
      return int(cudaErrorInvalidValue);
  }
}
