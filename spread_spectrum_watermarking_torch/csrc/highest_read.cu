// K9: the HIGHEST read. The 2-D DCT-II of an f32 luma plane at n flat
// indices an image, without the full first pass.
//
// Replaces no pallas_call: the JAX package leaves this stage to XLA
// (spread_spectrum_watermarking_tpu/ops/dct.py:256-302, dct2_coeffs_at,
// called at models/pipeline.py:513 and :700: one f32 pass over the shorter
// axis, then a gather-dot). Its plain version is the port's
// ops/dct.dct2_coeffs_at (kernels/highest_read.py, highest_read_reference).
// In landscape (H <= W), with r_i = idx_i / W and c_i = idx_i % W:
//   D[a][w]  = sum_h C_h[a, h] y[h, w]        (for the listed rows a only)
//   num[i]   = sum_w D[r_i][w] C_w[c_i, w]
// portrait (H > W) is the mirror: D[a][h] = sum_w y[h, w] C_w[a, w] and
// num[i] = sum_h C_h[r_i, h] D[c_i][h]. Both are one form here, with S the
// shorter side, L the longer, a_i the index's coordinate along S and b_i
// along L: D[a][l] = sum_s C_S[a, s] y(s, l), num[i] = sum_l D[a_i][l]
// C_L[b_i, l].
//
// Arithmetic: the first pass is 3xTF32 on the tensor cores, K6a's split
// (csrc/tf32x3.cuh): both operands split into TF32 parts, and for each
// k-step of 8 the products lo_C hi_y, hi_C lo_y, hi_C hi_y summed on the
// tensor cores from zero, that sum then added to the output's f32 total
// with __fadd_rn, k-steps ascending. It stands for the TPU's multi-pass
// HIGHEST products in the port and lies closer to an f64 product than
// cuBLAS's f32 pass (its rows D: 13-18 against 33-51 units of 2^-24
// sum_s |C_S y|; the read: 0.25-0.47 against 0.61-1.51 units;
// scripts/k9_errors.py): the tensor cores' own accumulation rounds toward
// zero, so summed over a whole stage (four k-steps, K6a's choice) the read
// erred by up to 1.15 units where the plain route erred by 0.65. The dots
// are f32: __fmaf_rn products and sums in one fixed order.
// kernels/highest_read.py, k9_bound, is the tolerance against the plain
// version.
//
// Bound on the H100: one row of the first pass per distinct (image, a_i),
// 2 S L multiply-adds, three tensor-core products each, and 2 L per index
// for the dots; it must read the f32 luma. At 48x1080x1920, n = 1000 the
// harness's random u8 needs about 30,800 rows (383 GFLOP of TF32, 0.77 ms
// at 495 TFLOP/s: operations bound it), 1/f textures about 2,700 (34
// GFLOP, 0.07 ms, against 398 MB of luma in, 0.12 ms: bytes bound it);
// chip_smoke.py's K9 phase counts the rows of its run.
//
// Design: three launches.
//   1. compact_kernel (csrc/compact_rows.cuh, shared with K5), one block an
//      image: the image's count of distinct rows, their ascending list and
//      each index's slot. An index outside [0, H W) fails an assert.
//   2. pass_kernel: D[j] for the slots j of each image's list. Its output
//      tiles are 64 slots (wgmma's n) by 192 positions along L (three
//      consumer warpgroups of wgmma's m64), so an image computes at most 63
//      rows past its count, where K6a's 128 x 128 tiles computed up to 127
//      (random u8 at 48x1080p: about 704 rows an image for 643, against
//      768; textures 64 for 57, against 128). One block per SM walks the
//      live tiles only (SlotTiles: image by image, its column tiles, their
//      slot tiles below the image's count), so the host reads no count and
//      no block starts only to leave. A producer warpgroup fills a ring of
//      five 40 KB stages (k-depth 32): the X tile (the luma's 32 k-rows by
//      192 positions, or 192 rows by 32 k in portrait) by TMA in wgmma's
//      128-byte swizzle where W % 4 == 0 and the plane is 16-byte aligned,
//      by 4-byte cp.async copies into the same layout otherwise; the 64
//      listed basis rows' hi and lo parts by 16-byte cp.async copies (sm_90
//      has no TMA row gather); stages handed over on mbarriers, no
//      __syncthreads. setmaxnreg gives the producer 40 registers and each
//      consumer thread 152. Each consumer warpgroup splits its A fragment
//      (X's 64 positions, read from shared memory) into TF32 parts in
//      registers and keeps two k-steps in flight: it issues step q+1's
//      three wgmma.m64n64k8, waits for step q (wgmma.wait_group 1) and adds
//      step q's sum to the f32 total while step q+1 runs; a stage's last
//      step is waited for with the stage, which is then free. In landscape
//      the X tile's rows are k and its 128-byte rows hold 32 positions, so
//      the four threads of a fragment column (t = 0..3) would read one
//      bank; each warp's fragment rows stand for positions chosen so that
//      the swizzle spreads them over all 32 banks (chunk_of below). A
//      fragment row is one output row of its own, so which position it
//      stands for changes no bit of any output.
//   3. dot_kernel, one warp an index: num[i] = sum_l D[slot_i][l]
//      C_L[b_i, l], lane q over the 16-byte chunks l = 4 (q + 32 k) + e,
//      one f32 __fmaf_rn chain per e with k ascending, then (s0 + s1) +
//      (s2 + s3), then the lanes by the xor shuffles 16, 8, 4, 2, 1.
// Every f32 operation is an explicit _rn intrinsic or a tensor-core
// product, every sum has one fixed order and every output one tile, so a
// result repeats bit for bit and an image's result does not depend on the
// batch it sits in (Writer and Reader agree, models/pipeline.py). The pass
// computes each output with the same operations in the same order as the
// earlier form of it on K6a's pass_kernel (128 x 128 tiles): only the tile
// shapes, the walk and the overlap differ, so the read is bit for bit the
// same (scripts/k9_ab.py prints its digest). No float atomics. The
// largest store is D, min(n, S) rows of L floats an image: at 48x1080x1920
// 369 MB, where the plain route writes the 398 MB first pass and two
// 369 MB gathers.
#include <cstring>

#include "compact_rows.cuh"
#include "tf32x3.cuh"
#include "tma_ring.cuh"
#include "wgmma_tile.cuh"

namespace {

using ssw::ring::chunk_of;
using ssw::ring::cp_arrive_noinc;
using ssw::ring::fence_sums;
using ssw::ring::regs_dec;
using ssw::ring::regs_inc;
using ssw::ring::tma_load;
using ssw::rows::compact_kernel;
using ssw::rows::kCompactSmem;
using ssw::rows::kCompactThreads;
using ssw::tf32::cp16;
using ssw::tf32::cp4;
using ssw::tf32::cp_wait;
using ssw::tf32::fence_proxy_async;
using ssw::tf32::kRowFloats;
using ssw::tf32::smem_addr;
using ssw::tf32::split;
using ssw::tf32::sw128;
using ssw::tf32::sw128_desc;
using ssw::tf32::wgmma_commit;
using ssw::tf32::wgmma_fence;
using ssw::tf32::wgmma_n64;
using ssw::tf32::wgmma_wait;
using ssw::wg::mbar_arrive;
using ssw::wg::mbar_expect_tx;
using ssw::wg::mbar_init;
using ssw::wg::mbar_wait;

constexpr int kDotThreads = 256;  // 8 warps, one index each

constexpr int kSlots = 64;                    // a tile's slots: wgmma's n
constexpr int kConsumers = 3;                 // consumer warpgroups
constexpr int kCols = 64 * kConsumers;        // a tile's positions along L
constexpr int kDepth = kRowFloats;            // k-depth of a stage
constexpr int kStages = 5;                    // the ring
constexpr int kPassThreads = 128 * (1 + kConsumers);
constexpr int kBoxes = kCols / 32;            // TMA boxes of 32 x 32 a stage
constexpr uint32_t kXBytes = kCols * kDepth * sizeof(float);
constexpr int kProducerRegs = 40, kConsumerRegs = 152;
static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
              "the warpgroups' registers exceed the SM's");

// A stage: X's tile (kCols 128-byte rows: k-rows of 32 positions in
// landscape, box by box; positions of 32 k in portrait) and the listed
// basis rows' two parts, all in wgmma's 128-byte swizzle (sw128).
struct PassStage {
  float x[kCols * kDepth];
  float b_hi[kSlots * kDepth];
  float b_lo[kSlots * kDepth];
};
static_assert(sizeof(PassStage) % 1024 == 0, "stages keep tiles aligned");
constexpr size_t kPassSmem = kStages * sizeof(PassStage) + 1024;
static_assert(kPassSmem + 2 * kStages * sizeof(uint64_t) <= 232448,
              "the ring exceeds a block's shared memory");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The pass's walk: image by image, of each its column tiles, of each the
// slot tiles below the image's count (slot fastest, so blocks at work at
// the same time share X's column tile); the grid's tile t is the t-th of
// them. Calls come with t ascending, so the cursor moves forward only.
struct SlotTiles {
  const int* count;
  int batch, col_tiles;
  int image = 0, first = 0, live = -1;

  __device__ __forceinline__ bool at(int tile, int& img, int& col,
                                     int& slot) {
    while (image < batch) {
      if (live < 0) live = cdiv(count[image], kSlots);
      if (tile < first + live * col_tiles) {
        const int local = tile - first;
        slot = local % live;
        col = local / live;
        img = image;
        return true;
      }
      first += live * col_tiles;
      ++image;
      live = -1;
    }
    return false;
  }
};

// D's rows for the slots of each image's list: slot j of image i at d +
// (i * cap + j) * d_pitch, L positions (landscape: X(k, m) = y[k][m], k
// over H; portrait: X(k, m) = y[m][k], k over W). `tma`: X by the tensor
// map `xmap` (3-D: W, H, batch; boxes of 32 x 32 floats, 128-byte
// swizzle), else by 4-byte copies from y.
template <bool kLand>
__global__ void __launch_bounds__(kPassThreads, 1)
pass_kernel(const __grid_constant__ CUtensorMap xmap,
            const float* __restrict__ y, const float* __restrict__ s_hi,
            const float* __restrict__ s_lo, int s_pitch,
            const int* __restrict__ count, const int* __restrict__ list,
            int cap, float* __restrict__ d, int d_pitch, int batch, int h,
            int w, bool tma) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  PassStage* st = reinterpret_cast<PassStage*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  const int s = kLand ? h : w, l = kLand ? w : h;
  const int ktiles = cdiv(s, kDepth);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 128 + 1);  // each producer's copies, the TMA's
      mbar_init(&empty[i], kConsumers * 4);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  SlotTiles walk{count, batch, cdiv(l, kCols)};
  int image, col, slot;

  if (threadIdx.x < 128) {
    // The producer warpgroup: thread 0 the TMA boxes, every thread 8 of
    // the basis rows' 16-byte copies (and 48 of X's 4-byte ones without
    // TMA).
    regs_dec<kProducerRegs>();
    const int tid = threadIdx.x;
    int it = 0;
    for (int tile = blockIdx.x; walk.at(tile, image, col, slot);
         tile += gridDim.x) {
      const int n0 = slot * kSlots, m0 = col * kCols;
      const int rows = count[image];
      // The basis rows of tile rows r = tid / 8 + 16 i, -1 past the count.
      int src[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = n0 + tid / 8 + 16 * i;
        src[i] = j < rows ? list[(long long)image * cap + j] : -1;
      }
      const float* yi = y + (long long)image * h * w;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int si = it % kStages;
        mbar_wait(&empty[si], ((it / kStages) & 1) ^ 1);
        PassStage& sg = st[si];
        const int k0 = kt * kDepth;
        if (tid == 0) {
          mbar_expect_tx(&full[si], tma ? kXBytes : 0);
          if (tma) {
#pragma unroll
            for (int j = 0; j < kBoxes; ++j)
              tma_load(sg.x + j * 32 * kDepth, &xmap,
                       kLand ? m0 + 32 * j : k0, kLand ? k0 : m0 + 32 * j,
                       image, &full[si]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = tid + 128 * i;
          const int r = c / 8, k = 4 * (c % 8), gk = k0 + k;
          const bool in = src[i] >= 0 && gk < s;
          const long long at = in ? (long long)src[i] * s_pitch + gk : 0;
          cp16(sg.b_hi + sw128(r, k), s_hi + at, in ? 16 : 0);
          cp16(sg.b_lo + sw128(r, k), s_lo + at, in ? 16 : 0);
        }
        if (!tma) {
          // Row R of X's tile, position c of it: landscape k-row R % 32 of
          // box R / 32, portrait position R at k c.
#pragma unroll 4
          for (int i = 0; i < kCols * kDepth / 128; ++i) {
            const int e = tid + 128 * i, r = e / 32, c = e % 32;
            const int gr = kLand ? k0 + r % 32 : m0 + r;
            const int gc = kLand ? m0 + 32 * (r / 32) + c : k0 + c;
            const bool in = gr < h && gc < w;
            cp4(sg.x + sw128(r, c), yi + (in ? (long long)gr * w + gc : 0),
                in ? 4 : 0);
          }
        }
        cp_arrive_noinc(&full[si]);
      }
    }
    cp_wait<0>();
    return;
  }

  // The consumers: warpgroup wg owns positions 64 wg .. 64 wg + 63 of the
  // column tile; warp `warp` of it 16 of them, fragment rows g and g + 8.
  regs_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  int pos[2];  // the positions of fragment rows g and g + 8
  int off[4];  // landscape: k-step 0's four fragment values in a stage's X
  const int box = 2 * wg + warp / 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rho = g + 8 * hh;
    pos[hh] = kLand ? 32 * box + 4 * chunk_of(warp % 2, rho) + rho % 4
                    : 16 * (4 * wg + warp) + rho;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    off[e] = 32 * kDepth * box + sw128(t + 4 * (e / 2), pos[e % 2] % 32);
  // Value e of k-step q's fragment: (row g + 8 (e % 2), k 8 q + t + 4 (e /
  // 2)).
  auto frag = [&](const float* x, int q, int e) {
    if constexpr (kLand)
      return x[off[e] + 8 * q * kDepth];
    else
      return x[sw128(pos[e % 2], 8 * q + t + 4 * (e / 2))];
  };

  float acc[32], p0[32], p1[32];
  uint32_t ah[4][4], al[4][4];
  int it = 0;  // stages consumed so far
  for (int tile = blockIdx.x; walk.at(tile, image, col, slot);
       tile += gridDim.x) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int si = it % kStages;
      mbar_wait(&full[si], (it / kStages) & 1);
      fence_proxy_async();  // the basis rows came by cp.async
      const PassStage& sg = st[si];
      const uint64_t dh = sw128_desc(sg.b_hi), dl = sw128_desc(sg.b_lo);
      // The stage's four k-steps, each step's three products issued before
      // the step before it is waited for and added, so two steps are in
      // flight; the last one is drained with the stage. (With a step in
      // flight across the loop's back edge, ptxas serializes every wgmma:
      // 1.57 against 1.43 ms at 48x1080p on random u8, H100 SXM at 700 W,
      // scripts/k9_ab.py.)
#pragma unroll
      for (int q = 0; q < kDepth / 8; ++q) {
        float(&p)[32] = q % 2 ? p1 : p0;
        float(&prev)[32] = q % 2 ? p0 : p1;
#pragma unroll
        for (int e = 0; e < 4; ++e) split(frag(sg.x, q, e), ah[q][e], al[q][e]);
        // Step q's products, from zero; a k-step of 8 is 32 bytes along
        // the swizzled rows, 2 in the descriptor's units.
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

    // acc[4 j + 2 hh + e]: fragment row g + 8 hh, slot 8 j + 2 t + e.
    const int rows = count[image], n0 = slot * kSlots;
    float* di = d + (long long)image * cap * d_pitch;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = col * kCols + pos[hh];
      if (m >= l) continue;
#pragma unroll
      for (int j = 0; j < kSlots / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * j + 2 * t + e;
          if (n < rows)
            di[(long long)n * d_pitch + m] = acc[4 * j + 2 * hh + e];
        }
    }
  }
}

// Warp e = (image, i): out[e] = sum_l D[slot_e][l] C_L[b_i, l] over l < L,
// D's row and C_L's row `pitch` floats apart (pitch a multiple of 4, both
// 16-byte aligned). Lane q takes the chunks k = q, q + 32, ... of 4
// columns: s[e] = fma(D, C, s[e]) over k ascending for each column e of a
// chunk (columns at or past L skipped), then (s0 + s1) + (s2 + s3), then
// the lanes by xor shuffles 16, 8, 4, 2, 1.
__global__ void __launch_bounds__(kDotThreads)
dot_kernel(const long long* __restrict__ idx, long long idx_stride,
           const float* __restrict__ basis_l, const float* __restrict__ d,
           const int* __restrict__ slots, float* __restrict__ out, int n,
           int h, int w, int cap, int pitch, long long total) {
  const long long e =
      (long long)blockIdx.x * (kDotThreads / 32) + threadIdx.x / 32;
  if (e >= total) return;
  const int lane = threadIdx.x % 32;
  const int l = h <= w ? w : h;
  const long long image = e / n, i = e % n;
  // In range: compact_kernel's assert stops the call at any other index.
  const long long id = idx[image * idx_stride + i];
  const int b = h <= w ? int(id % w) : int(id / w);
  const float4* dr = reinterpret_cast<const float4*>(
      d + (image * cap + slots[e]) * (long long)pitch);
  const float4* cr =
      reinterpret_cast<const float4*>(basis_l + (long long)b * pitch);
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = lane; 4 * k < l; k += 32) {
    const float4 dv = dr[k], cv = cr[k];
    const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
    const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * k + j < l) s[j] = __fmaf_rn(dd[j], cc[j], s[j]);
  }
  float v = __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) out[e] = v;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The tensor map of the (batch, h, w) f32 plane y for the pass's X boxes:
// 32 x 32 floats, 128-byte swizzle, zeros outside the plane.
cudaError_t x_map(CUtensorMap* map, const float* y, int batch, int h, int w) {
  return ssw::ring::map_3d(map, y, w, h, batch, (long long)w * sizeof(float),
                           (long long)h * w * sizeof(float));
}

template <bool kLand>
cudaError_t launch_pass(const CUtensorMap& map, const float* y,
                        const float* s_hi, const float* s_lo, int s_pitch,
                        const int* count, const int* list, int cap, float* d,
                        int d_pitch, int batch, int h, int w, bool tma,
                        cudaStream_t stream) {
  auto kernel = pass_kernel<kLand>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kPassSmem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // At most this many tiles are live: every image at its cap.
  const long long tiles = (long long)batch * cdiv(cap, kSlots) *
                          cdiv(kLand ? w : h, kCols);
  kernel<<<int(tiles < sms ? tiles : sms), kPassThreads, kPassSmem, stream>>>(
      map, y, s_hi, s_lo, s_pitch, count, list, cap, d, d_pitch, batch, h, w,
      tma);
  return cudaGetLastError();
}

}  // namespace

// K9's first pass alone: the rows D[j] = sum_s C_S[list[j], s] y(s, :) of
// each image's listed rows. y: (batch, h, w) f32, contiguous; s_hi, s_lo:
// the TF32 parts of the DCT-II basis of S = min(h, w), (S, s_pitch)
// row-major, zeros past S, s_pitch a multiple of 4, 16-byte aligned;
// count, list: each image's count of rows and its rows (cap apart); d:
// slot j of image i at d + (i * cap + j) * d_pitch, L = max(h, w) floats.
// One launch on `stream`; returns its CUDA error code.
extern "C" int ssw_highest_read_pass(const float* y, const float* s_hi,
                                     const float* s_lo, int s_pitch,
                                     const int* count, const int* list,
                                     int cap, float* d, int d_pitch,
                                     int batch, int h, int w,
                                     cudaStream_t stream) {
  if (s_pitch % 4 != 0 || !aligned16(s_hi) || !aligned16(s_lo))
    return int(cudaErrorInvalidValue);
  if (batch == 0 || cap == 0) return int(cudaSuccess);
  // TMA needs 16-byte row strides and a 16-byte-aligned plane.
  const bool tma = w % 4 == 0 && aligned16(y);
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  if (tma) {
    const cudaError_t err = x_map(&map, y, batch, h, w);
    if (err != cudaSuccess) return int(err);
  }
  if (h <= w)
    return int(launch_pass<true>(map, y, s_hi, s_lo, s_pitch, count, list,
                                 cap, d, d_pitch, batch, h, w, tma, stream));
  return int(launch_pass<false>(map, y, s_hi, s_lo, s_pitch, count, list, cap,
                                d, d_pitch, batch, h, w, tma, stream));
}

// y: (batch, h, w) f32 luma, contiguous; idx: int64, n flat indices an
// image, image i's at idx + i * idx_stride (idx_stride 0: one set for
// every image); s_hi, s_lo: the TF32 parts of the f32 DCT-II basis of S =
// min(h, w), (S, s_pitch) row-major, zeros past S; basis_l: the f32 DCT-II
// basis of L = max(h, w), (L, l_pitch) row-major, zeros past L; both
// pitches multiples of 4, every pointer 16-byte aligned; d: scratch of
// d_elems f32, at least batch * min(n, S) * l_pitch; meta: scratch of
// meta_elems int32, at least batch * (1 + min(n, S) + n) (each image's
// count, then the lists, then the slots); out: (batch, n) f32;
// rows_total: an int64 on the device that the images' counts of rows are
// added to, or null. Three launches on `stream`; returns the first CUDA
// error code (0 when all were accepted).
extern "C" int ssw_highest_read(const float* y, const long long* idx,
                                long long idx_stride, const float* s_hi,
                                const float* s_lo, int s_pitch,
                                const float* basis_l, int l_pitch, float* d,
                                long long d_elems, int* meta,
                                long long meta_elems, float* out, int batch,
                                int h, int w, int n, long long* rows_total,
                                cudaStream_t stream) {
  const int s = h <= w ? h : w, l = h <= w ? w : h;
  const int cap = n < s ? n : s;
  if (d_elems < (long long)batch * cap * l_pitch ||
      meta_elems < (long long)batch * (1 + cap + n) || l_pitch < l ||
      l_pitch % 4 != 0 || s_pitch < s || s_pitch % 4 != 0 ||
      !aligned16(basis_l) || !aligned16(d))
    return int(cudaErrorInvalidValue);
  if (batch == 0 || n == 0) return int(cudaSuccess);
  int* count = meta;
  int* list = meta + batch;
  int* slots = list + (long long)batch * cap;

  const size_t smem = ssw::rows::compact_smem(s);
  if (smem > kCompactSmem) return int(cudaErrorInvalidValue);
  compact_kernel<<<batch, kCompactThreads, smem, stream>>>(
      idx, idx_stride, n, h, w, s, cap, count, list, slots,
      reinterpret_cast<unsigned long long*>(rows_total));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int code = ssw_highest_read_pass(y, s_hi, s_lo, s_pitch, count, list,
                                         cap, d, l_pitch, batch, h, w, stream);
  if (code != 0) return code;

  const long long total = (long long)batch * n;
  const long long blocks = (total + kDotThreads / 32 - 1) / (kDotThreads / 32);
  dot_kernel<<<unsigned(blocks), kDotThreads, 0, stream>>>(
      idx, idx_stride, basis_l, d, slots, out, n, h, w, cap, l_pitch, total);
  return int(cudaGetLastError());
}
