// K10: HIGHEST's sparse inverse. The luma delta dY of n changed DCT
// coefficients an image, added to the u8 image and quantized in the same
// kernel, or written as f32 dY.
//
// Replaces no pallas_call: the JAX package leaves this stage to XLA
// (spread_spectrum_watermarking_tpu/models/pipeline.py:41-92,
// _sparse_idct_delta, an (H, n) @ (n, W) product of gathered basis columns;
// :433-435, the add and clip; :443, the quantize). In the port it replaces
// models/pipeline.py's HIGHEST product (ops/dct.sparse_factors_f32, then an
// f32 cuBLAS product, TF32 off) and kernel K7 after it: its plain version
// is that route (kernels/highest_inverse.py, highest_inverse_reference).
// In landscape (H <= W), with S = H, L = W, a_i = idx_i / W the index's
// coordinate along S and b_i = idx_i % W along L (portrait is the mirror:
// S = W, L = H, a_i = idx_i % W, b_i = idx_i / W, and dY[s', l] lands at
// pixel (l, s')), D_S and D_L the f32 inverse bases (DCT-III, the
// reference's scaling) and s = f32(4 / (W H)):
//   A          = the image's distinct a_i, ascending (slot j holds A[j])
//   M[j][l]    = sum over i with a_i = A[j], i ascending, of delta_i D_L[l, b_i]
//   dY[s'][l]  = s * sum_j D_S[s', A[j]] M[j][l]
//   out        = K7's u8 rounding of (rgb, dY)   (csrc/u8_round.cuh)
// The plain route contracts over all n indices; this one over the image's
// |A| distinct rows (about 643 of n = 1000 on random u8 at 1080p, 57 on
// 1/f textures).
//
// Arithmetic: M's products and sums are f32 __fmul_rn and __fadd_rn in
// ascending i, from zero. The product is 3xTF32 on the tensor cores as K9's
// first pass (csrc/tf32x3.cuh): M split in registers, D_S's parts split
// once on the host; for each k-step of 8 slots the products lo_M hi_D,
// hi_M lo_D, hi_M hi_D summed on the tensor cores from zero, that sum added
// to the f32 total with __fadd_rn, k-steps ascending (summed over a whole
// stage, as K6a does, K9's read lay further from an f64 result than
// cuBLAS's f32 product); then one __fmul_rn by s. No float atomics, one
// fixed order for every sum, one tile for every output: two calls give the
// same bits, and an image's result does not depend on its batch.
// kernels/highest_inverse.py, k10_bound, is the tolerance against the
// plain version; gates() holds the kernel to it and to an f64 error no
// larger than the plain version's.
//
// Bound on the H100: the product is 2 S L |A| multiply-adds an image, three
// tensor-core products each; the u8 image is read and written once. At
// 48x1080x1920, n = 1000: random u8 about 30,900 rows (384 GFLOP of TF32,
// 0.78 ms at 495 TFLOP/s: operations bound it), textures about 2,700 (34
// GFLOP, 0.07 ms, against 597 MB of u8 in and out, 0.18 ms: bytes bound it).
//
// Design: five launches.
//   1. compact_kernel (csrc/compact_rows.cuh, K5's and K9's), one block an
//      image: its count |A|, the ascending list A and each index's slot. An
//      index outside [0, H W) fails an assert.
//   2. order_kernel, one warp an image: a stable counting sort of the
//      positions i by slot (__match_any_sync over 32 positions at a time),
//      written as each index's coordinate along L and update, so that slot
//      j's are entries start[j] .. start[j + 1] - 1, i ascending.
//   3. mbuild_kernel: M, one warp eight slots, each lane four positions
//      along L (16-byte loads of D_L^T's row b_i, 16-byte stores), rows
//      past |A| up to the next multiple of 32 written as zeros. M is min(n,
//      S) rows (rounded up to 32) of L floats an image: at most 377 MB at
//      48x1080x1920, n = 1000, of which random u8 writes about 260 MB and
//      textures about 24 MB; the plain route writes 207 + 369 MB of factors
//      and the 398 MB dY plane.
//   4. gather_kernel: G, D_S at each image's listed rows in the product's
//      K-major layout (G[s'][j] = D_S[s', A[j]], both TF32 parts, zeros
//      past |A|), read from D_S^T's rows and turned in shared memory, so
//      that the product loads it by TMA: at most 425 MB at 48x1080x1920.
//      (4-byte cp.async gathers of D_S^T in the producer took the pass
//      2.66 ms against 1.59 there on random u8, H100 SXM at 700 W,
//      scripts/k10_profile.py.)
//   5. pass_kernel: dY and the epilogue. Its output tiles are 192 positions
//      along L (three consumer warpgroups of wgmma's m64) by 64 along S
//      (wgmma's n); K = the image's slots, walked only as far as its count
//      (k-tiles of 32, padded with zero slots). One block per SM walks the
//      tiles, image by image, L tile by L tile, S tile fastest (so blocks at
//      work at the same time share M's tile). One producer thread fills a
//      ring of four 40 KB stages (three in <16>, below) on mbarriers, all by TMA (3-D tensor maps,
//      128-byte swizzle): M's 32 slot rows by 192 positions, as K9 loads the
//      luma, and G's 64 positions by 32 slots, both parts. setmaxnreg gives
//      the producer warpgroup 40 registers and each consumer thread
//      152. Each consumer warpgroup splits its A fragment (64 positions of
//      M, read from shared memory with K9's bank-spreading map) and keeps two
//      k-steps in flight, each stage drained before its slot is freed (a
//      k-step in flight across the stage loop's back edge made ptxas
//      serialize every wgmma in K9). The epilogue: each warpgroup scales its
//      64 x 64 sums and stages them in shared memory as image rows of
//      pixels (pitch 68), so that four pixels' dY are one 16-byte load, and
//      rounds each byte with K7's rounding without a conversion instruction
//      (csrc/u8_round.cuh: I2F, F2I and floorf's FRND run at 16 a clock per
//      SM, and three of them a byte bound such an epilogue to 6,912 clocks
//      a 36,864-byte tile), four pixels (12 bytes, three words) a unit. Its
//      u8 forms, by the views' alignment:
//      <16> where rgb's rows, planes and base and out's rows lie on 16
//      bytes (1920- and 3840-wide images): a second producer thread fetches
//      each warpgroup's 64 x 192-byte sub-tile of pixels by TMA while the
//      tile's products run, the epilogue reads it from shared memory,
//      writes the bytes over its staged dY and stores them by TMA; the ring
//      is three stages, so that the three boxes (36,864 B) fit beside the
//      staged dY (52,224 B). Adding straight from the accumulators would
//      drop the staging, but a thread's fragment holds two pixels of a row,
//      not next to each other, so its 96 bytes a tile would be byte-wide
//      shared-memory reads and writes: four times the word form's
//      accesses.
//      <4> where every image row of rgb and of out starts on a word
//      (1080-wide rows, views off 16 bytes): each thread loads all of its
//      units' words from device memory before it rounds any (one wait a
//      sub-tile).
//      <1> for any other view's strides, one byte at a time; <0>, the f32
//      mode, writes dY.
//      (Spreading each tile's epilogue under the next tile's products, with
//      the words copied into shared memory by cp.async and a ring of three
//      stages, was no faster on random u8, and building M and D_S's listed
//      rows in the producer instead of mbuild_kernel and gather_kernel took
//      the pass 6.8 ms against 1.5, bit for bit: PERF.md, section 6, on
//      NVIDIA H100 80GB HBM3 at 700 W.)
#include <cstring>

#include "compact_rows.cuh"
#include "tf32x3.cuh"
#include "tma_ring.cuh"
#include "u8_round.cuh"
#include "wgmma_tile.cuh"

namespace {

using ssw::ring::chunk_of;
using ssw::ring::fence_async_smem;
using ssw::ring::fence_sums;
using ssw::ring::regs_dec;
using ssw::ring::regs_inc;
using ssw::ring::tma_load;
using ssw::ring::tma_store;
using ssw::ring::tma_store_wait;
using ssw::rows::compact_kernel;
using ssw::rows::kCompactSmem;
using ssw::rows::kCompactThreads;
using ssw::tf32::kRowFloats;
using ssw::tf32::split;
using ssw::tf32::sw128;
using ssw::tf32::sw128_desc;
using ssw::tf32::wgmma_commit;
using ssw::tf32::wgmma_fence;
using ssw::tf32::wgmma_n64;
using ssw::tf32::wgmma_wait;
using ssw::u8::pack4;
using ssw::u8::round_byte;
using ssw::wg::mbar_arrive;
using ssw::wg::mbar_expect_tx;
using ssw::wg::mbar_init;
using ssw::wg::mbar_wait;

constexpr int kSPos = 64;                     // a tile's positions along S
constexpr int kWgCols = 64;                   // a warpgroup's along L
constexpr int kConsumers = 3;                 // consumer warpgroups
constexpr int kCols = kWgCols * kConsumers;   // a tile's positions along L
constexpr int kDepth = kRowFloats;            // slots a stage
constexpr int kStages = 4;                    // the ring (<16>: 3)
constexpr int kPassThreads = 128 * (1 + kConsumers);
constexpr int kBoxes = kCols / 32;            // TMA boxes of 32 x 32 a stage
constexpr uint32_t kXBytes = kCols * kDepth * sizeof(float);
constexpr int kProducerRegs = 40, kConsumerRegs = 152;
constexpr int kEpPitch = kWgCols + 4;         // the staged dY's pitch
constexpr int kBuildThreads = 256;            // mbuild: 8 warps
constexpr int kBuildSlots = 8;                // mbuild: slots a warp
constexpr int kBuildRows = kBuildSlots * kBuildThreads / 32;  // a block's
constexpr int kBuildCols = 128;               // mbuild: positions a warp
constexpr int kGatherThreads = 256;
constexpr uint32_t kBBytes = kSPos * kDepth * sizeof(float);  // a G part
static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
              "the warpgroups' registers exceed the SM's");

// A stage: M's tile (kCols 128-byte rows: slot rows of 32 positions, box by
// box) and D_S's 64 positions at the stage's 32 slots, both parts, all in
// wgmma's 128-byte swizzle (sw128).
struct Stage {
  float x[kCols * kDepth];
  float b_hi[kSPos * kDepth];
  float b_lo[kSPos * kDepth];
};
static_assert(sizeof(Stage) % 1024 == 0, "stages keep tiles aligned");
constexpr size_t kEpBytes = kConsumers * kSPos * kEpPitch * sizeof(float);
// <16>: a warpgroup's sub-tile of u8 pixels, one TMA box (64 image rows of
// 64 pixels), fetched while the products run.
constexpr int kBoxRowBytes = 3 * kWgCols;
constexpr uint32_t kBoxBytes = kSPos * kBoxRowBytes;
static_assert(kBoxRowBytes % 16 == 0 && kBoxRowBytes <= 256,
              "a TMA box's rows are 16-byte multiples of at most 256");
static_assert(kSPos * kEpPitch * sizeof(float) % 128 == 0,
              "each warpgroup's staged dY is a TMA store's source");
__host__ __device__ constexpr int ring_of(int out) {
  return out == 16 ? 3 : kStages;
}
constexpr size_t pass_smem(int out) {
  return ring_of(out) * sizeof(Stage) + kEpBytes +
         (out == 16 ? kConsumers * kBoxBytes : 0) + 1024;
}
static_assert(pass_smem(4) + 2 * kStages * sizeof(uint64_t) <= 232448 &&
                  pass_smem(16) + 4 * (kStages + kConsumers) *
                                          sizeof(uint64_t) <= 232448,
              "the ring exceeds a block's shared memory");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The 128 threads of consumer warpgroup `wg` meet (barrier 0 is
// __syncthreads').
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// One warp an image: start[j] (count + 1 entries, start[count] = n), and
// the positions i sorted by slot, i ascending within a slot, as their
// coordinates along L (ob) and updates (od): slot j's are ob[k], od[k] for
// k in start[j] .. start[j + 1]. Dynamic shared memory: cap ints, each
// slot's count, then its cursor.
__global__ void __launch_bounds__(32)
order_kernel(const long long* __restrict__ idx, long long idx_stride,
             const float* __restrict__ delta, const int* __restrict__ count,
             const int* __restrict__ slots, int n, int cap, int h, int w,
             int* __restrict__ start, int* __restrict__ order_b,
             float* __restrict__ order_d) {
  extern __shared__ int cursor[];
  const int image = blockIdx.x, lane = threadIdx.x;
  const int rows = count[image];
  const int* sl = slots + (long long)image * n;
  int* st = start + (long long)image * (cap + 1);
  int* ob = order_b + (long long)image * n;
  float* od = order_d + (long long)image * n;
  for (int j = lane; j < rows; j += 32) cursor[j] = 0;
  __syncwarp();
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const unsigned active = __ballot_sync(0xffffffffu, i < n);
    if (i < n) {
      const unsigned peers = __match_any_sync(active, sl[i]);
      if (lane == __ffs(peers) - 1) cursor[sl[i]] += __popc(peers);
    }
    __syncwarp();
  }
  int carry = 0;  // exclusive scan of the counts, 32 slots at a time
  for (int j0 = 0; j0 < rows; j0 += 32) {
    const int j = j0 + lane;
    const int v = j < rows ? cursor[j] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    if (j < rows) st[j] = cursor[j] = carry + incl - v;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) st[rows] = carry;
  __syncwarp();
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const unsigned active = __ballot_sync(0xffffffffu, i < n);
    if (i < n) {
      const int s = sl[i];
      const unsigned peers = __match_any_sync(active, s);
      const int k = cursor[s] + __popc(peers & ((1u << lane) - 1));
      // In range: compact_kernel's assert stops the call at any other index.
      const long long id = idx[image * idx_stride + i];
      ob[k] = h <= w ? int(id % w) : int(id / w);
      od[k] = delta[(long long)image * n + i];
      __syncwarp(active);
      if (lane == __ffs(peers) - 1) cursor[s] += __popc(peers);
    }
    __syncwarp();
  }
}

// M: block (x, y, image), warp q of it slots j = 64 y + q + 8 t (t < 8),
// lane e positions l = kBuildCols x + 4 e .. + 3. Rows j < count: sum over
// slot j's indices of delta_i D_L^T[b_i][l], i ascending; rows count .. the
// next multiple of kDepth: zeros; rows past them are never read and not
// written.
__global__ void __launch_bounds__(kBuildThreads)
mbuild_kernel(const int* __restrict__ count, const int* __restrict__ start,
              const int* __restrict__ order_b,
              const float* __restrict__ order_d,
              const float* __restrict__ basis_lt, int l_pitch,
              float* __restrict__ m, int m_rows, int cap, int n, int l) {
  const int image = blockIdx.z, rows = count[image];
  const int l0 = blockIdx.x * kBuildCols + 4 * (threadIdx.x % 32);
  const int* st = start + (long long)image * (cap + 1);
  const int* ob = order_b + (long long)image * n;
  const float* od = order_d + (long long)image * n;
  for (int t = 0; t < kBuildSlots; ++t) {
    const int j = blockIdx.y * kBuildRows + threadIdx.x / 32 +
                  t * (kBuildThreads / 32);
    if (j >= cdiv(rows, kDepth) * kDepth || l0 >= l) return;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int k1 = j < rows ? st[j + 1] : 0;
#pragma unroll 4
    for (int k = j < rows ? st[j] : 0; k < k1; ++k) {
      const float d = od[k];
      const float4 c = *reinterpret_cast<const float4*>(
          basis_lt + (long long)ob[k] * l_pitch + l0);
      acc.x = __fadd_rn(acc.x, __fmul_rn(d, c.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(d, c.y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(d, c.z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(d, c.w));
    }
    *reinterpret_cast<float4*>(m + ((long long)image * m_rows + j) * l_pitch +
                               l0) = acc;
  }
}

// G: block (x, y, image) turns D_S^T's rows A[j] (j = 32 y .. 32 y + 31)
// at positions s' = 64 x .. 64 x + 63 into G's rows s', slots j
// contiguous, both parts (hi: plane image, lo: plane batch + image of g);
// zeros past the count, up to the next multiple of kDepth.
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const float* __restrict__ b_hi, const float* __restrict__ b_lo,
              int s_pitch, const int* __restrict__ count,
              const int* __restrict__ list, int cap, float* __restrict__ g,
              int m_rows, int s, int batch) {
  __shared__ float t_hi[kDepth][kSPos + 1], t_lo[kDepth][kSPos + 1];
  const int image = blockIdx.z, rows = count[image];
  const int j0 = blockIdx.y * kDepth, s0 = blockIdx.x * kSPos;
  if (j0 >= cdiv(rows, kDepth) * kDepth) return;
  const int* li = list + (long long)image * cap;
  for (int e = threadIdx.x; e < kDepth * kSPos; e += kGatherThreads) {
    const int k = e / kSPos, r = e % kSPos;
    const bool in = j0 + k < rows && s0 + r < s;
    const long long at = in ? (long long)li[j0 + k] * s_pitch + s0 + r : 0;
    t_hi[k][r] = in ? b_hi[at] : 0.0f;
    t_lo[k][r] = in ? b_lo[at] : 0.0f;
  }
  __syncthreads();
  float* gh = g + ((long long)image * s + s0) * m_rows + j0;
  float* gl = gh + (long long)batch * s * m_rows;
  for (int e = threadIdx.x; e < kSPos * kDepth; e += kGatherThreads) {
    const int r = e / kDepth, k = e % kDepth;
    if (s0 + r < s) {
      gh[(long long)r * m_rows + k] = t_hi[k][r];
      gl[(long long)r * m_rows + k] = t_lo[k][r];
    }
  }
}

// Four pixels' 12 bytes (words w0, w1, w2) plus their dY (d) with K7's
// rounding, as three words.
__device__ __forceinline__ uint3 round_pixels(uint32_t w0, uint32_t w1,
                                              uint32_t w2, float4 d) {
  return make_uint3(
      pack4(round_byte(w0, 0, d.x), round_byte(w0, 1, d.x),
            round_byte(w0, 2, d.x), round_byte(w0, 3, d.y)),
      pack4(round_byte(w1, 0, d.y), round_byte(w1, 1, d.y),
            round_byte(w1, 2, d.z), round_byte(w1, 3, d.z)),
      pack4(round_byte(w2, 0, d.z), round_byte(w2, 1, d.w),
            round_byte(w2, 2, d.w), round_byte(w2, 3, d.w)));
}

// A sub-tile's u8 epilogue where its image rows are runs of pixel-
// contiguous bytes that start on words: `rows` rows of `npx` pixels (npx
// a multiple of 4, since W is), row r's bytes at src + r * src_row and
// dst + r * dst_row, pixel p's dY at dy[r * kEpPitch + p] (the staged
// tile). A unit is four pixels, three words; thread tid takes units tid,
// tid + 128, ... (at most kUnits), loads all their words before it rounds
// any, so that the sub-tile waits on device memory once, and stores them.
constexpr int kUnits = kSPos * kWgCols / 4 / 128;
__device__ __forceinline__ void epilogue_units(
    const uint8_t* __restrict__ src, long long src_row,
    uint8_t* __restrict__ dst, long long dst_row, const float* dy, int rows,
    int npx, int tid) {
  const int q = npx / 4, units = rows * q;
  // Unit u's row: a shift in a whole sub-tile's rows of 16 units.
  auto row_of = [q](int u) { return q == 16 ? u >> 4 : u / q; };
  uint32_t wd[kUnits][3];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = tid + 128 * k;
    if (u < units) {
      const int r = row_of(u);
      const uint32_t* at = reinterpret_cast<const uint32_t*>(
          src + r * src_row + 12 * (u - r * q));
#pragma unroll
      for (int i = 0; i < 3; ++i) wd[k][i] = at[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = tid + 128 * k;
    if (u < units) {
      const int r = row_of(u), p0 = 4 * (u - r * q);
      const uint3 res = round_pixels(
          wd[k][0], wd[k][1], wd[k][2],
          *reinterpret_cast<const float4*>(dy + r * kEpPitch + p0));
      uint32_t* out = reinterpret_cast<uint32_t*>(dst + r * dst_row + 3 * p0);
      out[0] = res.x;
      out[1] = res.y;
      out[2] = res.z;
    }
  }
}

// A sub-tile's u8 epilogue from the TMA box `px` (64 image rows of
// kBoxRowBytes) and the staged dY, written over the staged dY as a box of
// the same layout (the TMA store's source): thread tid takes units tid,
// tid + 128, ... of four pixels (unit u: row u / 16, three words), reads
// all its words and dY first, frees `px` (each warp arrives on `freed`)
// and, once every thread of the warpgroup has read its dY, writes.
// Neither read nor write has a bank conflict: a warp's 32 units cover two
// rows, words 3 q + i and 48 + 3 q + i, 32 banks.
__device__ __forceinline__ void epilogue_box(const uint8_t* px, float* dy,
                                             uint64_t* freed, int wg,
                                             int tid) {
  const uint32_t* in = reinterpret_cast<const uint32_t*>(px);
  uint32_t wd[kUnits][3];
  float4 d[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = tid + 128 * k, r = u / 16, q = u % 16;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      wd[k][i] = in[r * kBoxRowBytes / 4 + 3 * q + i];
    d[k] = *reinterpret_cast<const float4*>(dy + r * kEpPitch + 4 * q);
  }
  __syncwarp();
  if (tid % 32 == 0) mbar_arrive(freed);
  wg_sync(wg);  // every dY of the sub-tile is read
  uint32_t* res = reinterpret_cast<uint32_t*>(dy);
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = tid + 128 * k, r = u / 16, q = u % 16;
    const uint3 o = round_pixels(wd[k][0], wd[k][1], wd[k][2], d[k]);
    uint32_t* at = res + r * kBoxRowBytes / 4 + 3 * q;
    at[0] = o.x;
    at[1] = o.y;
    at[2] = o.z;
  }
}

// The pass's output: kOut 0 f32 dY; 1 u8, one byte at a time (any view);
// 4 u8, four pixels (three words) at a time (every image row of rgb and of
// out starts on a word); 16 u8 by TMA boxes (rgb's rows, planes and base
// and out's rows 16-byte aligned, its pixels contiguous).
//
// dY = s D_S[:, A] M for every image, then the epilogue: u8 `out` (batch,
// h, w, 3) contiguous from `rgb` at element strides (sb, sh, sw, sc), or
// f32 dY `out` (batch, h, w). mmap: M (3-D: l_pitch-strided rows of L
// floats, m_rows rows an image, batch images); gmap: G (3-D: rows of m_rows
// slots, S rows an image, the batch's hi parts, then its lo parts); imap,
// omap (<16> only): rgb and out as planes of h rows of 3 w bytes.
//
// <16>: the producer warpgroup's thread 32 fetches each warpgroup's u8
// sub-tile of the next tile by TMA while the products run, into one box a
// warpgroup (`pix`, on mbarriers pix_full / pix_empty), which is freed as
// soon as the epilogue has its words in registers; the epilogue writes its
// bytes over its staged dY and one thread stores them by TMA, whose reads
// of that dY are waited for before the next tile stages there. The ring is
// three stages, so that the boxes fit beside the staged dY.
template <int kOut>
__global__ void __launch_bounds__(kPassThreads, 1)
pass_kernel(const __grid_constant__ CUtensorMap mmap,
            const __grid_constant__ CUtensorMap gmap,
            const __grid_constant__ CUtensorMap imap,
            const __grid_constant__ CUtensorMap omap,
            const int* __restrict__ count, float scale,
            const uint8_t* __restrict__ rgb, long long sb, long long sh,
            long long sw, long long sc, void* __restrict__ out, int batch,
            int h, int w) {
  constexpr int kRing = ring_of(kOut);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Stage* st = reinterpret_cast<Stage*>(
      smem_raw + ((1024 - (ssw::tf32::smem_addr(smem_raw) & 1023)) & 1023));
  float* ep = reinterpret_cast<float*>(st + kRing);
  uint8_t* pix = reinterpret_cast<uint8_t*>(ep + kEpBytes / sizeof(float));
  __shared__ __align__(8) uint64_t full[kRing];
  __shared__ __align__(8) uint64_t empty[kRing];
  __shared__ __align__(8) uint64_t pix_full[kConsumers];
  __shared__ __align__(8) uint64_t pix_empty[kConsumers];
  const bool land = h <= w;
  const int s = land ? h : w, l = land ? w : h;
  const int s_tiles = cdiv(s, kSPos), per_image = s_tiles * cdiv(l, kCols);
  const long long tiles = (long long)batch * per_image;
  // Warpgroup wg's sub-tile of the tile at (m0, n0): image rows y0 .. y0 +
  // rows - 1, pixels x0 .. x0 + npx - 1 (along L in landscape, along S in
  // portrait); empty past the image's edge.
  auto sub_tile = [&](int m0, int n0, int wg, int& y0, int& x0, int& rows,
                      int& npx) {
    const int l0 = m0 + kWgCols * wg;
    y0 = land ? n0 : l0;
    x0 = land ? l0 : n0;
    rows = max(0, min(kSPos, (land ? s : l) - y0));
    npx = max(0, min(kWgCols, (land ? l : s) - x0));
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&full[i], 1);                // the producer's expect_tx
      mbar_init(&empty[i], kConsumers * 4);  // each consumer warp
    }
#pragma unroll
    for (int i = 0; i < kConsumers; ++i) {
      mbar_init(&pix_full[i], 1);   // thread 32's expect_tx
      mbar_init(&pix_empty[i], 4);  // each warp of warpgroup i
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // The producer: thread 0 issues every stage's TMA boxes, M's six and
    // G's two; in <16> thread 32 each warpgroup's box of pixels.
    regs_dec<kProducerRegs>();
    if constexpr (kOut == 16) {
      if (threadIdx.x == 32) {
        int boxes[kConsumers] = {};
        for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int image = int(tile / per_image);
          const int rest = int(tile % per_image);
          const int m0 = rest / s_tiles * kCols, n0 = rest % s_tiles * kSPos;
#pragma unroll
          for (int wg = 0; wg < kConsumers; ++wg) {
            int y0, x0, rows, npx;
            sub_tile(m0, n0, wg, y0, x0, rows, npx);
            if (rows == 0 || npx == 0) continue;
            mbar_wait(&pix_empty[wg], (boxes[wg]++ & 1) ^ 1);
            mbar_expect_tx(&pix_full[wg], kBoxBytes);
            tma_load(pix + wg * kBoxBytes, &imap, 3 * x0, y0, image,
                     &pix_full[wg]);
          }
        }
      }
    }
    if (threadIdx.x != 0) return;
    int it = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int image = int(tile / per_image), rest = int(tile % per_image);
      const int m0 = rest / s_tiles * kCols, n0 = rest % s_tiles * kSPos;
      for (int kt = 0; kt < cdiv(count[image], kDepth); ++kt, ++it) {
        const int si = it % kRing;
        mbar_wait(&empty[si], ((it / kRing) & 1) ^ 1);
        Stage& sg = st[si];
        const int k0 = kt * kDepth;
        mbar_expect_tx(&full[si], kXBytes + 2 * kBBytes);
#pragma unroll
        for (int j = 0; j < kBoxes; ++j)
          tma_load(sg.x + j * 32 * kDepth, &mmap, m0 + 32 * j, k0, image,
                   &full[si]);
        tma_load(sg.b_hi, &gmap, k0, n0, image, &full[si]);
        tma_load(sg.b_lo, &gmap, k0, n0, batch + image, &full[si]);
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns positions 64 wg .. 64 wg + 63 of the
  // tile along L; warp `warp` of it 16 of them, fragment rows g and g + 8,
  // placed as K9's landscape pass places them (chunk_of).
  regs_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int tid = threadIdx.x % 128;
  int pos[2];  // the positions of fragment rows g and g + 8 in the tile
  int off[4];  // k-step 0's four fragment values in a stage's X
  const int box = 2 * wg + warp / 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rho = g + 8 * hh;
    pos[hh] = 32 * box + 4 * chunk_of(warp % 2, rho) + rho % 4;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    off[e] = 32 * kDepth * box + sw128(t + 4 * (e / 2), pos[e % 2] % 32);
  float* tile_ep = ep + wg * kSPos * kEpPitch;

  float acc[32], p0[32], p1[32];
  uint32_t ah[4][4], al[4][4];
  int it = 0;     // stages consumed so far
  int boxes = 0;  // <16>: pixel boxes consumed so far
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int image = int(tile / per_image), rest = int(tile % per_image);
    const int m0 = rest / s_tiles * kCols, n0 = rest % s_tiles * kSPos;
    const int ktiles = cdiv(count[image], kDepth);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int si = it % kRing;
      mbar_wait(&full[si], (it / kRing) & 1);
      const Stage& sg = st[si];
      const uint64_t dh = sw128_desc(sg.b_hi), dl = sw128_desc(sg.b_lo);
      // The stage's four k-steps as K9's pass runs them: step q + 1's
      // products issued before step q is waited for and added; the last
      // step drained with the stage.
#pragma unroll
      for (int q = 0; q < kDepth / 8; ++q) {
        float(&p)[32] = q % 2 ? p1 : p0;
        float(&prev)[32] = q % 2 ? p0 : p1;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(sg.x[off[e] + 8 * q * kDepth], ah[q][e], al[q][e]);
        fence_sums(p);
        wgmma_fence();
        wgmma_n64(p, al[q], dh + 2 * q, 0);
        wgmma_n64(p, ah[q], dl + 2 * q, 1);
        wgmma_n64(p, ah[q], dh + 2 * q, 1);
        wgmma_commit();
        fence_sums(p);
        if (q > 0) {  // step q - 1 is done: added while step q runs
          wgmma_wait<1>();
          fence_sums(prev);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], prev[i]);
        }
      }
      wgmma_wait<0>();
      fence_sums(p1);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], p1[i]);
      if (lane == 0) mbar_arrive(&empty[si]);  // the stage is free
    }

    // acc[4 j + 2 hh + e]: position pos[hh] along L, 8 j + 2 t + e along S;
    // staged as image rows of pixels.
    if (kOut == 16 && tid == 0) tma_store_wait<true>();  // the last store's
    wg_sync(wg);  // the warpgroup's reads of the last tile are done
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < kSPos / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int a = pos[hh] - kWgCols * wg, b = 8 * j + 2 * t + e;
          tile_ep[land ? b * kEpPitch + a : a * kEpPitch + b] =
              __fmul_rn(acc[4 * j + 2 * hh + e], scale);
        }
    wg_sync(wg);
    // The tile's pixels, image row by image row: along L in landscape,
    // along S in portrait.
    int y0, x0, rows, npx;
    sub_tile(m0, n0, wg, y0, x0, rows, npx);
    if constexpr (kOut == 16) {
      if (rows > 0 && npx > 0) {
        mbar_wait(&pix_full[wg], boxes++ & 1);
        epilogue_box(pix + wg * kBoxBytes, tile_ep, &pix_empty[wg], wg, tid);
        fence_async_smem();
        wg_sync(wg);
        if (tid == 0) tma_store(&omap, tile_ep, 3 * x0, y0, image);
      }
    } else if constexpr (kOut == 4) {
      epilogue_units(rgb + image * sb + y0 * sh + 3LL * x0, sh,
                     static_cast<uint8_t*>(out) +
                         3 * (((long long)image * h + y0) * w + x0),
                     3LL * w, tile_ep, rows, npx, tid);
    } else {
      // Any view (u8), or dY (f32): one pixel at a time.
#pragma unroll 4
      for (int q = tid; q < kSPos * kWgCols; q += 128) {
        const int r = q / kWgCols, p = q % kWgCols;
        if (r >= rows || p >= npx) continue;
        const float dy = tile_ep[r * kEpPitch + p];
        const long long at = ((long long)image * h + y0 + r) * w + x0 + p;
        if constexpr (kOut == 1) {
          const uint8_t* src =
              rgb + image * sb + (y0 + r) * sh + (x0 + p) * sw;
          uint8_t* dst = static_cast<uint8_t*>(out) + 3 * at;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            dst[c] = uint8_t(round_byte(src[c * sc], 0, dy));
        } else {
          static_cast<float*>(out)[at] = dy;
        }
      }
    }
  }
  if (kOut == 16 && tid == 0) tma_store_wait<false>();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// idx: int64, n flat indices an image, image i's at idx + i * idx_stride
// (idx_stride 0: one set for every image); delta: (batch, n) f32,
// contiguous; b_hi, b_lo: the TF32 parts of D_S^T, the transposed f32
// inverse basis of S = min(h, w), (S, s_pitch) row-major; basis_lt: D_L^T,
// (L, l_pitch) row-major, zeros past L; both pitches multiples of 4, those
// three pointers and m 16-byte aligned; scale: f32(4 / (w h)); rgb: the u8
// (batch, h, w, 3) image at element strides (sb, sh, sw, sc), read when
// `u8_out`; out: u8 (batch, h, w, 3) when `u8_out`, else f32 dY (batch, h,
// w), contiguous; m: scratch of m_elems f32, at least batch * m_rows *
// l_pitch with m_rows = max(32, min(n, S) rounded up to 32); g: scratch of
// g_elems f32, at least 2 batch S m_rows, 16-byte aligned; meta: scratch
// of meta_elems int32, at least batch * (2 + 2 min(n, S) + 3 n) (each
// image's count, the lists, the slots, the starts, the sorted coordinates
// along L, the sorted updates as f32); rows_total: an int64 on the device
// that the images' counts of rows are added to, or null. Five launches on
// `stream` (two without indices); returns the first CUDA error code (0 when
// all were accepted).
extern "C" int ssw_highest_inverse(
    const long long* idx, long long idx_stride, const float* delta,
    const float* b_hi, const float* b_lo, int s_pitch, const float* basis_lt,
    int l_pitch, float scale, const uint8_t* rgb, long long sb, long long sh,
    long long sw, long long sc, void* out, int u8_out, float* m,
    long long m_elems, float* g, long long g_elems, int* meta,
    long long meta_elems, int batch, int h, int w, int n,
    long long* rows_total, cudaStream_t stream) {
  const int s = h <= w ? h : w, l = h <= w ? w : h;
  const int cap = n < s ? n : s;
  const int m_rows = cap > kDepth ? cdiv(cap, kDepth) * kDepth : kDepth;
  if (m_elems < (long long)batch * m_rows * l_pitch ||
      g_elems < 2LL * batch * s * m_rows || !aligned16(g) ||
      meta_elems < (long long)batch * (2 + 2LL * cap + 3LL * n) ||
      l_pitch < l || l_pitch % 4 != 0 || s_pitch < s || s_pitch % 4 != 0 ||
      !aligned16(b_hi) || !aligned16(b_lo) || !aligned16(basis_lt) ||
      !aligned16(m) || (u8_out && rgb == nullptr))
    return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  int* count = meta;
  int* list = count + batch;
  int* slots = list + (long long)batch * cap;
  int* start = slots + (long long)batch * n;
  int* order_b = start + (long long)batch * (cap + 1);
  float* order_d = reinterpret_cast<float*>(order_b + (long long)batch * n);
  cudaError_t err;

  if (n == 0) {
    err = cudaMemsetAsync(count, 0, batch * sizeof(int), stream);
    if (err != cudaSuccess) return int(err);
  } else {
    const size_t csmem = ssw::rows::compact_smem(s);
    if (csmem > kCompactSmem) return int(cudaErrorInvalidValue);
    compact_kernel<<<batch, kCompactThreads, csmem, stream>>>(
        idx, idx_stride, n, h, w, s, cap, count, list, slots,
        reinterpret_cast<unsigned long long*>(rows_total));
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);

    const int osmem = cap * int(sizeof(int));
    if (osmem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, osmem);
      if (err != cudaSuccess) return int(err);
    }
    order_kernel<<<batch, 32, osmem, stream>>>(idx, idx_stride, delta, count,
                                               slots, n, cap, h, w, start,
                                               order_b, order_d);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);

    const dim3 grid(cdiv(l, kBuildCols), cdiv(m_rows, kBuildRows), batch);
    mbuild_kernel<<<grid, kBuildThreads, 0, stream>>>(
        count, start, order_b, order_d, basis_lt, l_pitch, m, m_rows, cap, n,
        l);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);

    gather_kernel<<<dim3(cdiv(s, kSPos), m_rows / kDepth, batch),
                    kGatherThreads, 0, stream>>>(
        b_hi, b_lo, s_pitch, count, list, cap, g, m_rows, s, batch);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }

  CUtensorMap mmap, gmap, imap, omap;
  std::memset(&mmap, 0, sizeof(mmap));
  std::memset(&gmap, 0, sizeof(gmap));
  std::memset(&imap, 0, sizeof(imap));
  std::memset(&omap, 0, sizeof(omap));
  err = ssw::ring::map_3d(&mmap, m, l, m_rows, batch,
                          (long long)l_pitch * sizeof(float),
                          (long long)m_rows * l_pitch * sizeof(float));
  if (err != cudaSuccess) return int(err);
  err = ssw::ring::map_3d(&gmap, g, m_rows, s, 2 * batch,
                          (long long)m_rows * sizeof(float),
                          (long long)s * m_rows * sizeof(float), kSPos);
  if (err != cudaSuccess) return int(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const long long tiles =
      (long long)batch * cdiv(s, kSPos) * cdiv(l, kCols);
  // Words where every image row of rgb and of out starts on a 4-byte word
  // (pixel-contiguous rows; out is contiguous), bytes for any other view.
  // TMA boxes where rgb's rows and planes, its base and out's rows all lie
  // on 16 bytes (1920 and 3840 wide; not 1080).
  const bool words = sc == 1 && sw == 3 &&
                     reinterpret_cast<uintptr_t>(rgb) % 4 == 0 &&
                     sb % 4 == 0 && sh % 4 == 0 && (3LL * w) % 4 == 0;
  const bool boxes = words && aligned16(rgb) && aligned16(out) &&
                     sb % 16 == 0 && sh % 16 == 0 && (3LL * w) % 16 == 0;
  const int form = !u8_out ? 0 : boxes ? 16 : words ? 4 : 1;
  if (form == 16) {
    err = ssw::ring::map_u8(&imap, rgb, 3LL * w, h, batch, sh, sb,
                            kBoxRowBytes, kSPos);
    if (err != cudaSuccess) return int(err);
    err = ssw::ring::map_u8(&omap, out, 3LL * w, h, batch, 3LL * w,
                            3LL * w * h, kBoxRowBytes, kSPos);
    if (err != cudaSuccess) return int(err);
  }
  auto kernel = form == 0    ? pass_kernel<0>
                : form == 16 ? pass_kernel<16>
                : form == 4  ? pass_kernel<4>
                             : pass_kernel<1>;
  const size_t smem = form == 16 ? pass_smem(16) : pass_smem(0);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<int(tiles < sms ? tiles : sms), kPassThreads, smem, stream>>>(
      mmap, gmap, imap, omap, count, scale, rgb, sb, sh, sw, sc, out, batch,
      h, w);
  return int(cudaGetLastError());
}
