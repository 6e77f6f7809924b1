// K3: the exact top-n of every row, by an MSB-first radix select over
// unique 64-bit composites, then a sort of the few candidates left.
//
// Replaces the fast tiers' selection on the TPU: the JAX package's
// ops/ranking.py:approx_top_indices (:156-292) calls lax.approx_max_k
// (:235, :246, :263, :274), which lowers to the TPU's PartialReduce unit,
// selection done by hardware with no pallas_call and no portable
// counterpart. The port selects exactly, with the reference's tie rule:
// key descending, then position ascending. Two entry points share the core:
//
//   mode 0, top_by_key: int32 keys (rows, L), positions along the row or
//     int64 `pos` (L,) or (rows, L), unique within a row, in [0, 2^31);
//   modes 1-3, top_of_plane: the bf16 plane (rows, H*W) of the fast tiers,
//     whose 16-bit keys (ENERGY, ENERGY_ORTHOGONAL, LEGACY; DC below every
//     key) are built in registers, bit for bit as ops/ranking.py builds
//     them, and never stored. It returns the keys at the selected
//     positions beside them.
//
// Each element's composite is (k << pbits) | (2^pbits - 1 - pos): k is the
// key mapped to unsigned in its order (mode 0: the int32 with its sign bit
// flipped, 32 bits; modes 1-3: key + 0x8001, 17 bits), pbits is 31 for a
// given `pos` and the bit length of L - 1 for positions along the row. The
// composites of a row are unique, and their descending order is (key desc,
// pos asc) for any n.
//
// Bound on the H100: one read of the input. Mode 1-3 reads 2 bytes an
// element (the 48 x 1080 x 1920 plane, 199 MB: 0.06 ms at 3.35 TB/s);
// mode 0 reads 4, plus 8 where `pos` is given per row. What the design does
// about it:
//   1. Passes over the row, one 11-bit digit each, from the top: each block
//      histograms the digit of the elements still in the candidate bucket
//      in shared memory and adds its counts into the row's global
//      histogram with integer atomics (order-free, so the result is
//      deterministic). The row's last block to arrive finds the bucket
//      that holds the n-th composite and narrows the prefix.
//   2. A row stops as soon as the elements above its bucket plus the
//      bucket's own count fit the sort (cap: at least n, and for n up to
//      16,384 up to max(2048, 2n), 16,384 at most); for 16-bit keys that is
//      usually two passes. Rows that stopped skip the remaining passes,
//      which the host launches up to the composite's width, since it does
//      not wait to see. By the last digit a bucket holds one element, so
//      every row stops.
//   3. A compaction pass writes the candidates (composite >= the prefix)
//      to a per-row buffer; the slot order depends on atomics.
//   4. One block per row sorts its candidates (bitonic, descending, in
//      dynamic shared memory: 12 bytes each, 192 KB for 16,384) and writes
//      the first n. The composites are unique, so the output does not
//      depend on the slot order. For n above 16,384 the sort runs as
//      bitonic steps over global memory, one launch each: right, not fast.
// So the input is read once per pass plus once to compact: three reads on
// the main path. A one-pass fused select (histogram and candidates in one
// read, TMA loads) is later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDigit = 11;
constexpr int kBins = 1 << kDigit;
constexpr int kThreads = 512;
constexpr int kSortThreads = 1024;
constexpr int kSmemCap = 16384;  // candidates sorted in shared memory
constexpr int kSlotBytes = 12;   // an 8-byte composite and a 4-byte position

enum Mode : int { kKeys = 0, kEnergy = 1, kOrtho = 2, kLegacy = 3 };

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
  const void* src;             // int32 keys (mode 0) or the bf16 plane
  const long long* pos;        // mode 0: nullptr (positions), (L,) or (rows, L)
  long long pos_stride;        // 0 for (L,), L for (rows, L)
  long long rows, L;
  long long chunk;             // elements of a row per block, whole vectors
  long long stride;            // candidate slots per row
  int width;                   // the plane's width (modes 1-3)
  int pbits, bits;             // position bits, composite bits
  int n, cap;
  int vec;                     // rows start 16-byte aligned: vector loads
  float s_k0_w, s_w, s_k0_h, s_h;  // the ortho scale's factors
  RowState* state;
  unsigned int* hist;          // (rows, kBins)
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

// Mode 0: the int32 key mapped to unsigned in its order (negative f32
// total-order keys included): its sign bit flipped.
__device__ __forceinline__ unsigned int key_bits(int key) {
  return static_cast<unsigned int>(key) ^ 0x80000000u;
}

// Modes 1-3: the 16-bit key of bf16 bits `b` at flat index j, column c, as
// ops/ranking.py builds it, plus 0x8001 (17 bits; DC, forced below every
// key as -0x8001, maps to 0).
//   ENERGY:            (bits(|v|) & 0xFFFE) | signbit(v)
//   ENERGY_ORTHOGONAL: the same of bf16(v * bf16(s)), s the f32 product of
//                      the row and column factors (one rounding each, as
//                      numpy and torch round them; the bf16 product is
//                      exact in f32, so one RNE matches torch's bf16 mul)
//   LEGACY:            the bf16 value's order key of bf16(v * bf16(s)):
//                      -(bits & 0x7FFF) when negative, else bits & 0x7FFF
template <int MODE>
__device__ __forceinline__ unsigned int plane_key(unsigned short b,
                                                  long long j, int c,
                                                  const Params& p) {
  if (j == 0) return 0u;
  unsigned short s = b;
  if (MODE != kEnergy) {
    const float sc = __fmul_rn(j < p.width ? p.s_k0_w : p.s_w,
                               c == 0 ? p.s_k0_h : p.s_h);
    const float scb = __bfloat162float(__float2bfloat16_rn(sc));
    const float v = __bfloat162float(__ushort_as_bfloat16(b));
    s = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(v, scb)));
  }
  int key;
  if (MODE == kLegacy) {
    const int mag = s & 0x7FFF;
    key = (s & 0x8000) ? -mag : mag;
  } else {
    key = (s & 0x7FFE) | (s >> 15);
  }
  return static_cast<unsigned int>(key + 0x8001);
}

template <int MODE>
__device__ __forceinline__ unsigned long long composite_at(const Params& p,
                                                           long long row,
                                                           long long j) {
  if (MODE == kKeys) {
    const int key = static_cast<const int*>(p.src)[row * p.L + j];
    const long long pos = p.pos ? p.pos[row * p.pos_stride + j] : j;
    return compose(key_bits(key), pos, p);
  } else {
    const unsigned short b =
        static_cast<const unsigned short*>(p.src)[row * p.L + j];
    const int c = MODE == kEnergy ? 0 : static_cast<int>(j % p.width);
    return compose(plane_key<MODE>(b, j, c, p), j, p);
  }
}

// Calls f(composite, j) for every element of this block's chunk of `row`:
// 16-byte vector loads (4 keys or 8 bf16) where p.vec, one at a time for
// the rest.
template <int MODE, typename F>
__device__ __forceinline__ void visit(const Params& p, long long row, F&& f) {
  constexpr int V = MODE == kKeys ? 4 : 8;
  const long long c0 = static_cast<long long>(blockIdx.x) * p.chunk;
  const long long c1 = c0 + p.chunk < p.L ? c0 + p.chunk : p.L;
  long long tail = c0;
  if (p.vec) {
    const long long vend = c0 + (c1 - c0) / V * V;
    for (long long j0 = c0 + static_cast<long long>(threadIdx.x) * V;
         j0 < vend; j0 += static_cast<long long>(blockDim.x) * V) {
      if (MODE == kKeys) {
        const int4 k4 = *reinterpret_cast<const int4*>(
            static_cast<const int*>(p.src) + row * p.L + j0);
        const int k[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long long j = j0 + i;
          const long long pos = p.pos ? p.pos[row * p.pos_stride + j] : j;
          f(compose(key_bits(k[i]), pos, p), j);
        }
      } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            static_cast<const unsigned short*>(p.src) + row * p.L + j0);
        const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
        int c = MODE == kEnergy ? 0 : static_cast<int>(j0 % p.width);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const long long j = j0 + i;
          const unsigned short b =
              static_cast<unsigned short>(w[i / 2] >> (16 * (i % 2)));
          f(compose(plane_key<MODE>(b, j, c, p), j, p), j);
          if (MODE != kEnergy && ++c == p.width) c = 0;
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
  for (long long i = first; i < p.rows * kBins; i += step) p.hist[i] = 0u;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) pass_kernel(Params p) {
  __shared__ unsigned int hist[kBins];
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
    for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0u;
    __syncthreads();
    visit<MODE>(p, row, [&](unsigned long long u, long long) {
      if ((u >> lo) == want)
        atomicAdd(hist + ((u >> sh) & mask), 1u);
    });
    __syncthreads();
    unsigned int* gh = p.hist + row * kBins;
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

__device__ __forceinline__ void write_out(const Params& p, long long row,
                                          int i, unsigned long long v,
                                          unsigned int j, long long* out_idx,
                                          int* out_key) {
  out_idx[row * p.n + i] = j;
  if (out_key)
    out_key[row * p.n + i] =
        static_cast<int>((v - 1) >> p.pbits) - 0x8001;
}

__device__ __forceinline__ int candidates(const Params& p, long long row) {
  const int c = p.state[row].count;
  return c < p.stride ? c : static_cast<int>(p.stride);
}

// One block per row: the row's candidates, bitonic-sorted descending in
// shared memory (padded with 0 to a power of two), the first n written.
__global__ void __launch_bounds__(kSortThreads)
sort_kernel(Params p, int slots, long long* out_idx, int* out_key) {
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
    for (int i = threadIdx.x; i < p.n; i += kSortThreads)
      write_out(p, row, i, sk[i], sv[i], out_idx, out_key);
    __syncthreads();
  }
}

// n above kSmemCap: every row holds exactly n candidates in `stride` (a
// power of two) slots; pad, then one bitonic step over global memory per
// launch.
__global__ void global_pad_kernel(Params p) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = first; i < p.rows * p.stride; i += step) {
    const long long row = i / p.stride;
    if (i - row * p.stride >= candidates(p, row)) {
      p.cand_u[i] = 0ull;
      p.cand_j[i] = 0u;
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
                                  int* out_key) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = first; q < p.rows * p.n; q += step) {
    const long long row = q / p.n;
    const int i = static_cast<int>(q - row * p.n);
    write_out(p, row, i, p.cand_u[row * p.stride + i],
              p.cand_j[row * p.stride + i], out_idx, out_key);
  }
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
int run(Params p, long long* out_idx, int* out_key, cudaStream_t stream) {
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

  const long long init_threads = p.rows * kBins;
  const int init_blocks = static_cast<int>(
      (init_threads + 255) / 256 < 1024 ? (init_threads + 255) / 256 : 1024);
  init_kernel<<<init_blocks, 256, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  if (p.L > p.cap) {
    for (int lo = p.bits; lo > 0; lo -= kDigit) {
      pass_kernel<MODE><<<grid, kThreads, 0, stream>>>(p);
      if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    }
  }
  compact_kernel<MODE><<<grid, kThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);

  if (p.stride <= kSmemCap && p.n <= kSmemCap) {
    const int slots = static_cast<int>(pow2_at_least(p.stride));
    const size_t smem = static_cast<size_t>(slots) * kSlotBytes;
    err = cudaFuncSetAttribute(sort_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return int(err);
    const int blocks = static_cast<int>(p.rows < 65535 ? p.rows : 65535);
    sort_kernel<<<blocks, kSortThreads, smem, stream>>>(p, slots, out_idx,
                                                        out_key);
    return int(cudaGetLastError());
  }
  const int blocks = 132 * 8;
  global_pad_kernel<<<blocks, 256, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  for (long long k = 2; k <= p.stride; k <<= 1)
    for (long long h = k >> 1; h > 0; h >>= 1) {
      global_step_kernel<<<blocks, 256, 0, stream>>>(p, k, h);
      if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    }
  global_out_kernel<<<blocks, 256, 0, stream>>>(p, out_idx, out_key);
  return int(cudaGetLastError());
}

}  // namespace

// Bytes of scratch ssw_topk_select needs for `rows` rows of length L and n:
// the row states, the histograms and the candidate slots.
extern "C" long long ssw_topk_select_workspace(long long rows, long long L,
                                               int n) {
  int cap;
  long long stride;
  sizes(L, n, &cap, &stride);
  return rows * (static_cast<long long>(sizeof(RowState)) + 4LL * kBins +
                 kSlotBytes * stride);
}

// mode 0: src int32 keys (rows, L), pos nullptr (the positions along the
// row) or int64 (L,) (pos_per_row 0) or (rows, L) (pos_per_row 1); out_key
// unused. Modes 1-3 (ENERGY, ENERGY_ORTHOGONAL, LEGACY): src the bf16 plane
// (rows, L = H * width), out_key int32 (rows, n), the keys at the selected
// positions. out_idx: int64 (rows, n), positions along the row in (key
// desc, pos asc) order. All contiguous; 1 <= n <= L; `workspace` holds
// ssw_topk_select_workspace(rows, L, n) bytes, 16-byte aligned. Returns the
// first launch error (0 when every launch was accepted).
extern "C" int ssw_topk_select(int mode, const void* src, const long long* pos,
                               int pos_per_row, long long rows, long long L,
                               int width, int n, float s_k0_w, float s_w,
                               float s_k0_h, float s_h, void* workspace,
                               long long* out_idx, int* out_key,
                               cudaStream_t stream) {
  Params p = {};
  p.src = src;
  p.pos = mode == kKeys ? pos : nullptr;
  p.pos_stride = pos_per_row ? L : 0;
  p.rows = rows;
  p.L = L;
  p.width = width;
  p.pbits = p.pos ? 31 : bit_length(L - 1);
  p.bits = (mode == kKeys ? 32 : 17) + p.pbits;
  p.n = n;
  sizes(L, n, &p.cap, &p.stride);
  const int elt = mode == kKeys ? 4 : 2;
  p.vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 && (L * elt) % 16 == 0;
  p.s_k0_w = s_k0_w;
  p.s_w = s_w;
  p.s_k0_h = s_k0_h;
  p.s_h = s_h;
  char* ws = static_cast<char*>(workspace);
  p.state = reinterpret_cast<RowState*>(ws);
  ws += rows * sizeof(RowState);
  p.hist = reinterpret_cast<unsigned int*>(ws);
  ws += rows * 4LL * kBins;
  p.cand_u = reinterpret_cast<unsigned long long*>(ws);
  ws += rows * 8LL * p.stride;
  p.cand_j = reinterpret_cast<unsigned int*>(ws);
  if (rows == 0 || n == 0) return int(cudaSuccess);
  switch (mode) {
    case kKeys: return run<kKeys>(p, out_idx, nullptr, stream);
    case kEnergy: return run<kEnergy>(p, out_idx, out_key, stream);
    case kOrtho: return run<kOrtho>(p, out_idx, out_key, stream);
    case kLegacy: return run<kLegacy>(p, out_idx, out_key, stream);
    default: return int(cudaErrorInvalidValue);
  }
}
