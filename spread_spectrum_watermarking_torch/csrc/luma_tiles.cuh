// The luma tile pass shared by K1 (csrc/luma_pass.cu) and K5
// (csrc/read_tail.cu): u8 RGB (or, in pair mode, the exact integer
// difference of two u8 images) -> luma -> bf16, written as one tile of the
// mainloop's operand tile image (csrc/wgmma_tile.cuh): rows r along the
// longer image axis, k along the contraction, the shorter (r = w, k = h in
// landscape; r = h, k = w in portrait).
//
// Rounding points follow the JAX package's XLA code as it compiles on the
// CPU under jit:
//   single, high: y = fma(b, 0.11f, fma(g, 0.59f, r * 0.30f)) with
//           c = u8 * f32(1/255) (the order XLA's CPU einsum sums in, and
//           the product XLA puts in place of u8 / 255; bit-equal over all
//           colours)
//   pair:   y = ((30 dR + 59 dG) + 11 dB) * f32(1/25500) (exact numerator;
//           XLA's product in place of the division)
// Single and pair mode round y to bf16 (RNE). High mode keeps y in f32 and
// splits it as the TPU's bf16x3 does: y_hi = bf16(y), y_lo = bf16(y - y_hi)
// (the subtraction is exact). Every f32 op is an explicit _rn intrinsic, so
// nvcc can neither fuse nor split it.
#pragma once

#include "wgmma_tile.cuh"

namespace ssw {
namespace luma {

constexpr float kInv255 = 0x1.010102p-8f;      // f32(1 / 255)
constexpr float kInv25500 = 0x1.48f70cp-15f;  // f32(1 / 25500)
constexpr int kTileThreads = 256;              // threads of a tile's block

enum class Mode { kSingle, kPair, kHigh };

template <Mode kMode>
constexpr int kParts = kMode == Mode::kHigh ? 2 : 1;

namespace {  // one copy per source that includes this header

// The luma of one pixel: p (and q, pair mode: the base) its three bytes.
template <Mode kMode>
__device__ __forceinline__ float luma_px(const uint8_t* p, const uint8_t* q) {
  if (kMode == Mode::kPair) {
    const int d0 = int(p[0]) - int(q[0]);
    const int d1 = int(p[1]) - int(q[1]);
    const int d2 = int(p[2]) - int(q[2]);
    return __fmul_rn(float((30 * d0 + 59 * d1) + 11 * d2), kInv25500);
  }
  const float r = __fmul_rn(float(p[0]), kInv255);
  const float g = __fmul_rn(float(p[1]), kInv255);
  const float b = __fmul_rn(float(p[2]), kInv255);
  return __fmaf_rn(b, 0.11f, __fmaf_rn(g, 0.59f, __fmul_rn(r, 0.30f)));
}

// Tile (rt, kt) of image `image`'s tile image from its luma region `ys`
// (see luma_tile), parts hi (and lo, high mode) part_stride apart, images
// kP * part_stride apart: ys is read across, 8 threads to each 128-byte row
// of the tile image, so the writes are whole segments in either
// orientation.
template <Mode kMode, bool kLandscape>
__device__ __forceinline__ void write_tile(const float* ys,
                                           __nv_bfloat16* __restrict__ tiles,
                                           int ktiles, long long part_stride,
                                           int rt, int kt, int image) {
  using wg::kDepth;
  using wg::kTile;
  constexpr int kP = kParts<kMode>;
  constexpr int kPitch = (kLandscape ? wg::kRows : kDepth) + 1;
  __nv_bfloat16* tile = tiles + image * (kP * part_stride) +
                        (size_t(rt) * ktiles + kt) * kTile;
#pragma unroll
  for (int i = 0; i < kTile / 8 / kTileThreads; ++i) {
    const int e = threadIdx.x + i * kTileThreads;
    const int r = e / (kDepth / 8), c = e % (kDepth / 8);
    __align__(16) __nv_bfloat16 hi[8];
    __align__(16) __nv_bfloat16 lo[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = 8 * c + j;
      const float y = kLandscape ? ys[k * kPitch + r] : ys[r * kPitch + k];
      hi[j] = __float2bfloat16_rn(y);
      if (kP == 2)
        lo[j] = __float2bfloat16_rn(__fsub_rn(y, __bfloat162float(hi[j])));
    }
    const int at = wg::swizzled(r, 8 * c);
    *reinterpret_cast<uint4*>(tile + at) = *reinterpret_cast<const uint4*>(hi);
    if (kP == 2)
      *reinterpret_cast<uint4*>(tile + part_stride + at) =
          *reinterpret_cast<const uint4*>(lo);
  }
}

// Tile (rt, kt) of image `image`'s luma tile image, written by a block of
// kTileThreads threads; parts hi (and lo, high mode) part_stride apart,
// images kP * part_stride apart. The tile's pixels are read with
// neighbouring threads on neighbouring w (the image's contiguous axis) into
// an f32 tile in shared memory, which write_tile then reads across.
// Pixels are read one byte at a time, so any u8 view (one byte into its
// storage) is read as it lies; each thread has eight pixels' loads in
// flight at once.
template <Mode kMode, bool kLandscape>
__device__ __forceinline__ void luma_tile(const uint8_t* __restrict__ rgb,
                                          const uint8_t* __restrict__ base,
                                          __nv_bfloat16* __restrict__ tiles,
                                          int h, int w, int ktiles,
                                          long long part_stride, int rt,
                                          int kt, int image) {
  using wg::kDepth;
  using wg::kRows;
  using wg::kTile;
  // The image region: kDepth rows h by kRows columns w in landscape, kRows
  // by kDepth in portrait; its luma at ys[row * pitch + col].
  constexpr int kCols = kLandscape ? kRows : kDepth;
  constexpr int kPitch = kCols + 1;
  __shared__ float ys[kRows * (kDepth + 1)];  // the larger of the two
  const int h0 = (kLandscape ? kt * kDepth : rt * kRows);
  const int w0 = (kLandscape ? rt * kRows : kt * kDepth);
  const size_t img = size_t(image) * h * w;
  // Batches of kBatch pixels a thread: every byte of a batch is loaded
  // before any is used, so the loads are in flight together. Pixels past
  // the image read as zeros, whose luma (and difference) is 0.
  constexpr int kBatch = 8;
  constexpr int kPx = kMode == Mode::kPair ? 6 : 3;
  for (int i0 = 0; i0 < kTile / kTileThreads; i0 += kBatch) {
    uint8_t px[kBatch][kPx];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = threadIdx.x + (i0 + u) * kTileThreads;
      const int gh = h0 + e / kCols, gw = w0 + e % kCols;
      const bool in = gh < h && gw < w;
      const size_t at = in ? 3 * (img + size_t(gh) * w + gw) : 0;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        px[u][b] = in ? rgb[at + b] : 0;
        if (kMode == Mode::kPair) px[u][3 + b] = in ? base[at + b] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = threadIdx.x + (i0 + u) * kTileThreads;
      ys[(e / kCols) * kPitch + e % kCols] =
          luma_px<kMode>(px[u], px[u] + (kPx - 3));
    }
  }
  __syncthreads();
  write_tile<kMode, kLandscape>(ys, tiles, ktiles, part_stride, rt, kt,
                                image);
}

// Pair mode's tile (rt, kt), as luma_tile<Mode::kPair> writes it, read 16
// bytes at a time: for u8 images whose rows are 16-byte aligned (both
// pointers 16-byte aligned and 3 w a multiple of 16, so every 16-byte chunk
// of a row lies wholly inside or wholly outside the image). The region's
// rows are read in kRounds bands: neighbouring threads load neighbouring
// chunks of a row (whole 128-byte lines), every band's loads issued before
// the first is used; each band goes to shared memory as bytes, from which
// each thread takes its pixels as luma_tile does (luma_px, so the luma is
// the same bit for bit) into the f32 tile ys, which write_tile reads.
template <bool kLandscape>
__device__ __forceinline__ void pair_tile_wide(
    const uint8_t* __restrict__ rgb, const uint8_t* __restrict__ base,
    __nv_bfloat16* __restrict__ tiles, int h, int w, int ktiles,
    long long part_stride, int rt, int kt, int image) {
  using wg::kDepth;
  using wg::kRows;
  constexpr int kCols = kLandscape ? kRows : kDepth;   // pixels along w
  constexpr int kLines = kLandscape ? kDepth : kRows;  // image rows
  constexpr int kPitch = kCols + 1;
  constexpr int kRounds = 4;
  constexpr int kBandLines = kLines / kRounds;
  constexpr int kRowBytes = 3 * kCols;
  constexpr int kBandChunks = kBandLines * kRowBytes / 16;  // an image's
  constexpr int kLoads = 2 * kBandChunks / kTileThreads;
  constexpr int kPx = kBandLines * kCols / kTileThreads;
  static_assert(2 * kBandChunks % kTileThreads == 0 &&
                    kBandLines * kCols % kTileThreads == 0,
                "a band's chunks and pixels per thread");
  __shared__ float ys[kRows * (kDepth + 1)];
  __shared__ __align__(16) uint8_t raw[2][kBandLines * kRowBytes];
  const int h0 = (kLandscape ? kt * kDepth : rt * kRows);
  const int w0 = (kLandscape ? rt * kRows : kt * kDepth);
  const size_t img = size_t(image) * h * w;
  uint4 v[kRounds][kLoads];
#pragma unroll
  for (int band = 0; band < kRounds; ++band) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int f = threadIdx.x + j * kTileThreads;
      const int chunk = f % kBandChunks;
      const int gh = h0 + band * kBandLines + chunk / (kRowBytes / 16);
      const int gx = 3 * w0 + 16 * (chunk % (kRowBytes / 16));  // byte in row
      const bool in = gh < h && gx < 3 * w;
      const size_t at = in ? 3 * (img + size_t(gh) * w) + gx : 0;
      const uint8_t* src = (f < kBandChunks ? rgb : base) + at;
      v[band][j] = in ? *reinterpret_cast<const uint4*>(src)
                      : make_uint4(0, 0, 0, 0);
    }
  }
#pragma unroll
  for (int band = 0; band < kRounds; ++band) {
    if (band > 0) __syncthreads();  // the last band's bytes have been read
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int f = threadIdx.x + j * kTileThreads;
      *reinterpret_cast<uint4*>(raw[f / kBandChunks] +
                                16 * (f % kBandChunks)) = v[band][j];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPx; ++u) {
      const int px = threadIdx.x + u * kTileThreads;
      const int line = px / kCols, col = px % kCols;
      const int at = line * kRowBytes + 3 * col;
      ys[(band * kBandLines + line) * kPitch + col] =
          luma_px<Mode::kPair>(raw[0] + at, raw[1] + at);
    }
  }
  __syncthreads();
  write_tile<Mode::kPair, kLandscape>(ys, tiles, ktiles, part_stride, rt, kt,
                                      image);
}

}  // namespace
}  // namespace luma
}  // namespace ssw
