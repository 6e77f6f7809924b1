// K7's rounding of a u8 subpixel plus the luma delta dY, shared by K7
// (csrc/add_quantize.cu) and K10's u8 epilogue (csrc/highest_inverse.cu),
// so that the two round bit for bit alike:
//   v = min(max(fma(float(u), f32(1/255), dy), 0), 1)   (add_clamped)
//   u8 = floor((v * 255) + 0.5)                          (quantize)
// the FMA rounded once, as XLA contracts u8 * f32(1/255) + dY, and the
// quantize step's product and sum rounded apart, as jitted JAX and the
// port's colorspace.f32_to_u8 round them. Every f32 operation is an _rn
// intrinsic: nvcc contracts a*b + c into an FMA by default (-fmad=true),
// which would silently change the quantize step.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ssw {
namespace u8 {

namespace {  // one copy per source that includes this header

constexpr float kInv255 = 0x1.010102p-8f;  // f32(1 / 255)

__device__ __forceinline__ float add_clamped(uint32_t u, float dy) {
  return fminf(fmaxf(__fmaf_rn(float(u), kInv255, dy), 0.0f), 1.0f);
}

__device__ __forceinline__ uint32_t quantize(float v) {
  return uint32_t(floorf(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f)));
}

}  // namespace
}  // namespace u8
}  // namespace ssw
