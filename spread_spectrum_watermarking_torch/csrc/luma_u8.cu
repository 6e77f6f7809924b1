// K8: the luma of u8 RGB in f32, bit for bit the HIGHEST tier's
// rgb_to_luma(u8_to_f32(x)).
//
// Replaces no pallas_call: the JAX package leaves this stage to XLA
// (spread_spectrum_watermarking_tpu/ops/colorspace.py:64-75, rgb_to_luma,
// on u8_to_f32 at :121), which computes, per pixel,
//   c = u8 * f32(1/255)                      (XLA's product for u8 / 255)
//   y = fma(b, 0.11f, fma(g, 0.59f, r * 0.30f))
// (the order XLA's CPU einsum sums in; the port's ops/colorspace.py
// emulates it with _fma_f32, and csrc/luma_tiles.cuh computes the same for
// K1). Every f32 operation here is an explicit __fmul_rn or __fmaf_rn, so
// nvcc can neither contract nor split one: a single contracted
// multiply-add, or a constant taken as a double, changes the bits of some
// colours. Its plain version is the port's former route, a lookup in a
// 64 MB table of every colour's luma (kernels/luma_u8.py,
// luma_u8_reference), which the card test holds it to over all 2^24
// colours.
//
// Bound on the H100: 3 bytes in and 4 out a pixel, a few operations: at
// 48x1080x1920, 298.6 MB of u8 and 398.1 MB of f32, 0.208 ms at 3.35 TB/s.
// The table it replaces is larger than the card's 50 MB L2, so each
// lookup was a random 4-byte read from device memory.
//
// Design: where the image is one contiguous byte run starting 16-byte
// aligned, a warp takes tiles of 512 pixels: their 1536 bytes come in as
// three 16-byte loads a lane, each warp-wide load 512 contiguous bytes,
// into 1.5 KB of shared memory; lane q then reads pixels 4 (q + 32 j) to
// 4 (q + 32 j) + 3 as three 32-bit words (word stride 3 across the lanes:
// no bank conflicts) and writes their lumas as one 16-byte store, each
// warp-wide store 512 contiguous bytes. The last npix % 512 pixels, and
// every pixel of any other view (strided, or not 16-byte aligned), take
// one thread a pixel with byte loads at the view's strides. A grid-stride
// loop over a grid of a few waves.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInv255 = 0x1.010102p-8f;  // f32(1 / 255)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilePixels = 512;  // pixels a warp's tile on the 16-byte path
constexpr int kTileChunks = kTilePixels * 3 / 16;  // its 16-byte chunks
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ float luma_of(uint32_t r, uint32_t g, uint32_t b) {
  const float fr = __fmul_rn(float(r), kInv255);
  const float fg = __fmul_rn(float(g), kInv255);
  const float fb = __fmul_rn(float(b), kInv255);
  return __fmaf_rn(fb, 0.11f, __fmaf_rn(fg, 0.59f, __fmul_rn(fr, 0.30f)));
}

// Byte k (0..11) of four pixels held as three little-endian words.
__device__ __forceinline__ uint32_t byte_at(const uint32_t (&v)[3], int k) {
  return (v[k / 4] >> (8 * (k % 4))) & 0xffu;
}

// The image as (batch, h, w, 3) with strides sb, sh, sw, sc in bytes;
// out: batch * h * w f32, contiguous. `wide`: the image is contiguous and
// 16-byte aligned, and tiles of 512 pixels go through shared memory as
// 16-byte vectors.
__global__ void __launch_bounds__(kThreads)
luma_kernel(const uint8_t* __restrict__ x, long long sb, long long sh,
            long long sw, long long sc, int h, int w, long long npix,
            bool wide, float* __restrict__ out) {
  __shared__ uint4 tile[kWarps][kTileChunks];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long tiles = wide ? npix / kTilePixels : 0;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(tile[warp]);
  for (long long t = (long long)blockIdx.x * kWarps + warp; t < tiles;
       t += (long long)gridDim.x * kWarps) {
    const uint4* src = reinterpret_cast<const uint4*>(x) + t * kTileChunks;
#pragma unroll
    for (int c = 0; c < kTileChunks / 32; ++c)
      tile[warp][lane + 32 * c] = src[lane + 32 * c];
    __syncwarp();
    float4* dst = reinterpret_cast<float4*>(out) + t * (kTilePixels / 4);
#pragma unroll
    for (int j = 0; j < kTilePixels / 128; ++j) {
      const int g = lane + 32 * j;  // pixels 4 g .. 4 g + 3
      const uint32_t v[3] = {words[3 * g], words[3 * g + 1],
                             words[3 * g + 2]};
      dst[g] = make_float4(luma_of(byte_at(v, 0), byte_at(v, 1), byte_at(v, 2)),
                           luma_of(byte_at(v, 3), byte_at(v, 4), byte_at(v, 5)),
                           luma_of(byte_at(v, 6), byte_at(v, 7), byte_at(v, 8)),
                           luma_of(byte_at(v, 9), byte_at(v, 10),
                                   byte_at(v, 11)));
    }
    __syncwarp();
  }
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long hw = (long long)h * w;
  for (long long p = tiles * kTilePixels + first; p < npix; p += stride) {
    const long long b = p / hw, r = (p % hw) / w, c = p % w;
    const uint8_t* px = x + b * sb + r * sh + c * sw;
    out[p] = luma_of(px[0], px[sc], px[2 * sc]);
  }
}

}  // namespace

// x: (batch, h, w, 3) u8 at byte strides sb, sh, sw, sc (any view); out:
// (batch, h, w) f32, contiguous. One launch on `stream`; returns its CUDA
// error code.
extern "C" int ssw_luma_u8(const uint8_t* x, long long sb, long long sh,
                           long long sw, long long sc, int batch, int h, int w,
                           float* out, cudaStream_t stream) {
  const long long npix = (long long)batch * h * w;
  if (npix == 0) return int(cudaSuccess);
  const bool wide = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0 && sc == 1 &&
                    sw == 3 && sh == 3LL * w && sb == 3LL * h * w;
  const long long work =
      wide ? npix / kTilePixels * 32 + npix % kTilePixels : npix;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  luma_kernel<<<unsigned(blocks), kThreads, 0, stream>>>(
      x, sb, sh, sw, sc, h, w, npix, wide, out);
  return int(cudaGetLastError());
}
