// K7's rounding of a u8 subpixel plus the luma delta dY, shared by K7
// (csrc/add_quantize.cu) and K10's u8 epilogue (csrc/highest_inverse.cu),
// so that the two round bit for bit alike:
//   v = min(max(fma(float(u), f32(1/255), dy), 0), 1)   (add_clamped)
//   u8 = floor((v * 255) + 0.5)                          (round_byte)
// the FMA rounded once, as XLA contracts u8 * f32(1/255) + dY, and the
// quantize step's product and sum rounded apart, as jitted JAX and the
// port's colorspace.f32_to_u8 round them. Every f32 operation is an _rn
// intrinsic: nvcc contracts a*b + c into an FMA by default (-fmad=true),
// which would silently change the quantize step. Also the byte pieces that
// K4's epilogue (csrc/embed_epilogue.cu) rounds with its own formula:
// byte_bits, to_f32 and pack4.
//
// No conversion instruction: on the H100 the conversions (I2F, F2I and
// floorf's FRND) run at 16 a clock per SM against 128 for f32 adds, so
// three of them a byte bounded K10's u8 epilogue (36,864 bytes a tile,
// 6,912 clocks). float(u) is the f32 whose bits are 2^23's with u in the
// mantissa, less 2^23 (exact for u < 2^23); floor(t) of 0 <= t < 2^23 is
// t + 2^23 rounded down, whose mantissa holds it (the sum lies in [2^23,
// 2^24), where the f32 values are the integers). Both give the
// conversions' bits exactly. The clamp is the FMA's saturation, which
// gives +0 where fmaxf(x, 0) gives +0: for x < 0 and for NaN (the FMA of
// a u8 never gives -0).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ssw {
namespace u8 {

namespace {  // one copy per source that includes this header

constexpr float kInv255 = 0x1.010102p-8f;  // f32(1 / 255)
constexpr float kTwo23 = 0x1p23f;
constexpr uint32_t kTwo23Bits = 0x4b000000u;

// The bits of 2^23 + u for byte b of `word` (u in 2^23's mantissa, one
// byte permute).
__device__ __forceinline__ uint32_t byte_bits(uint32_t word, int b) {
  return __byte_perm(word, kTwo23Bits, 0x7650 | b);
}

// float(u) from the bits of 2^23 + u, u < 2^23.
__device__ __forceinline__ float to_f32(uint32_t two23_plus_u) {
  return __fsub_rn(__uint_as_float(two23_plus_u), kTwo23);
}

// The low bytes of q0 .. q3, in order, as one word.
__device__ __forceinline__ uint32_t pack4(uint32_t q0, uint32_t q1,
                                          uint32_t q2, uint32_t q3) {
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040),
                     0x5410);
}

// min(max(fma(u, f32(1/255), dy), 0), 1) for the float u of a u8.
__device__ __forceinline__ float clamped(float u, float dy) {
  float v;
  asm("fma.rn.sat.f32 %0, %1, %2, %3;" : "=f"(v) : "f"(u), "f"(kInv255),
      "f"(dy));
  return v;
}

// add_clamped for the u8 value u (K7's f32 mode).
__device__ __forceinline__ float add_clamped(uint32_t u, float dy) {
  return clamped(to_f32(byte_bits(u, 0)), dy);
}

// floor((add_clamped(u, dy) * 255) + 0.5) for byte b of `word` (u), as the
// low byte of an f32's bits (the rest of them 2^23's).
__device__ __forceinline__ uint32_t round_byte(uint32_t word, int b,
                                               float dy) {
  const float v = clamped(to_f32(byte_bits(word, b)), dy);
  const float t = __fadd_rn(__fmul_rn(v, 255.0f), 0.5f);
  return __float_as_uint(__fadd_rd(t, kTwo23));
}

}  // namespace
}  // namespace u8
}  // namespace ssw
