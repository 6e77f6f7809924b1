// K7: the HIGHEST sparse embed's epilogue, fused. u8 RGB plus the luma
// delta dY, rounded once, clamped, and written as f32 or quantized to u8.
//
// Replaces no TPU kernel: on the TPU, as on the CPU, XLA fuses the JAX
// package's
//   out = clip(u8_to_f32(rgb) + dy[..., None], 0, 1)   (models/pipeline.py:435)
//   f32_to_u8(out) = floor(clip(out, 0, 1) * 255 + 0.5)   (:443, ops/colorspace.py:126)
// and contracts u8 * f32(1/255) + dY into one FMA. This kernel computes
// exactly that, per subpixel:
//   v = min(max(fma(float(u), f32(1/255), dy), 0), 1)
//   f32 out: v;  u8 out: floor((v * 255) + 0.5)
// with the quantize step's product and sum rounded apart (csrc/u8_round.cuh,
// shared with K10's u8 epilogue, says why every f32 operation there is an
// _rn intrinsic).
//
// Bound on the H100: at 48x1080x1920 it reads 298.6 MB of u8 and 398.1 MB
// of dY and writes 298.6 MB of u8 (or 1194 MB of f32), with a few
// operations a byte: memory bounds it at 0.30 ms (0.56 ms) at 3.35 TB/s.
// The design moves each byte once. u8 mode: a thread takes four pixels,
// their 12 bytes of u8 as three 4-byte words and their dY as one 16-byte
// vector, and writes three words back. f32 mode: one thread to each
// 16-byte output vector (four subpixels, of two pixels), so that each warp
// store covers 512 contiguous bytes of the f32 stream, two thirds of the
// bytes moved; it reads the vector's rgb word and the two dY values its
// subpixels touch, which neighbouring lanes share in L1. (Four pixels a
// thread, as in u8 mode, wrote three 16-byte vectors 48 bytes apart: each
// warp store spanned 1.5 KB at a third of its bytes, 35% of the bound.)
// Measured at 48x1080x1920 (NVIDIA H100 80GB HBM3, 700 W;
// scripts/k4_ab.py, the two mappings in one call): f32 mode 0.72 ms against
// 1.40 for four pixels a thread; u8 mode 0.38 in both.
#include <cstdint>
#include <cuda_runtime.h>

#include "u8_round.cuh"

namespace {

using ssw::u8::add_clamped;
using ssw::u8::pack4;
using ssw::u8::round_byte;

constexpr int kThreads = 256;

// u8 mode. rgb: npix * 3 u8; dy: npix f32; out: npix * 3 u8. `vec`: rgb
// 4-byte and dy and out 16-byte aligned, so groups of four pixels are read
// and written as vectors; the rest (and all, without `vec`) one subpixel at
// a time.
__global__ void __launch_bounds__(kThreads)
add_quantize_kernel(const uint8_t* __restrict__ rgb,
                    const float* __restrict__ dy, uint8_t* __restrict__ out,
                    long long npix, bool vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long groups = vec ? npix / 4 : 0;
  for (long long g = first; g < groups; g += stride) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(rgb) + 3 * g;
    const float4 d4 = reinterpret_cast<const float4*>(dy)[g];
    const float d[4] = {d4.x, d4.y, d4.z, d4.w};
    const uint32_t words[3] = {src[0], src[1], src[2]};
    uint32_t* dst = reinterpret_cast<uint32_t*>(out) + 3 * g;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dst[k] = pack4(round_byte(words[k], 0, d[4 * k / 3]),
                     round_byte(words[k], 1, d[(4 * k + 1) / 3]),
                     round_byte(words[k], 2, d[(4 * k + 2) / 3]),
                     round_byte(words[k], 3, d[(4 * k + 3) / 3]));
  }
  // The subpixels after the last whole group.
  for (long long i = 12 * groups + first; i < 3 * npix; i += stride)
    out[i] = uint8_t(round_byte(rgb[i], 0, dy[i / 3]));
}

// f32 mode. out: npix * 3 f32. `vec`: rgb 4-byte and out 16-byte aligned,
// so output vector q (subpixels 4q .. 4q + 3) is one rgb word in and one
// 16-byte store out, kUnroll vectors a thread in flight at once; the
// subpixels after the last whole vector (and all, without `vec`) one at a
// time.
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
add_f32_kernel(const uint8_t* __restrict__ rgb, const float* __restrict__ dy,
               float* __restrict__ out, long long npix, bool vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long vectors = vec ? 3 * npix / 4 : 0;
  for (long long q0 = first; q0 < vectors; q0 += kUnroll * stride) {
    uint32_t word[kUnroll];
    float d0[kUnroll], d1[kUnroll];
    int o[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * stride;
      if (q >= vectors) break;
      // Subpixel 4q is channel o of pixel p0; subpixel 4q + 3 lies in
      // pixel p0 + 1 (< npix, since 4q + 3 < 3 npix).
      const long long p0 = 4 * q / 3;
      o[u] = int(4 * q - 3 * p0);
      word[u] = reinterpret_cast<const uint32_t*>(rgb)[q];
      d0[u] = dy[p0];
      d1[u] = dy[p0 + 1];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * stride;
      if (q >= vectors) break;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = add_clamped((word[u] >> (8 * i)) & 255u,
                           o[u] + i >= 3 ? d1[u] : d0[u]);
      reinterpret_cast<float4*>(out)[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  for (long long i = 4 * vectors + first; i < 3 * npix; i += stride)
    out[i] = add_clamped(rgb[i], dy[i / 3]);
}

}  // namespace

// rgb: (npix, 3) u8, contiguous; dy: (npix,) f32, contiguous; out: (npix, 3)
// u8 when `u8_out`, else f32. Returns the launch's CUDA error code (0 when
// it was accepted).
extern "C" int ssw_add_quantize(const uint8_t* rgb, const float* dy, void* out,
                                long long npix, int u8_out,
                                cudaStream_t stream) {
  const bool rgb4 = reinterpret_cast<uintptr_t>(rgb) % 4 == 0;
  const bool out16 = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // Threads needed: one per group of four pixels (u8) or per output vector
  // (f32, kUnroll a thread), one per subpixel of the rest.
  long long work;
  bool vec;
  if (u8_out) {
    vec = rgb4 && out16 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
    work = vec ? npix / 4 + 3 * (npix % 4) : 3 * npix;
  } else {
    vec = rgb4 && out16;
    work = vec ? (3 * npix / 4 + kUnroll - 1) / kUnroll + 3 : 3 * npix;
  }
  const long long blocks_needed = (work + kThreads - 1) / kThreads;
  const int blocks = int(blocks_needed < 132 * 16 ? blocks_needed : 132 * 16);
  if (blocks == 0) return int(cudaSuccess);
  if (u8_out)
    add_quantize_kernel<<<blocks, kThreads, 0, stream>>>(
        rgb, dy, static_cast<uint8_t*>(out), npix, vec);
  else
    add_f32_kernel<<<blocks, kThreads, 0, stream>>>(
        rgb, dy, static_cast<float*>(out), npix, vec);
  return int(cudaGetLastError());
}
