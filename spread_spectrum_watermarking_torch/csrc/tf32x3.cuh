// The 3xTF32 building blocks shared by K6a/K6b (csrc/dct2d_fused.cu) and
// K9's first pass (csrc/highest_read.cu): the split of an f32 operand into
// TF32 parts, wgmma's 128-byte swizzled K-major layout of f32 tiles and its
// descriptor, the TF32 wgmma instructions (A from registers, B from shared
// memory), and the cp.async copies that fill the tiles. csrc/dct2d_fused.cu
// says why three products of TF32 parts stand for an f32 product and what
// the split costs in accuracy.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ssw {
namespace tf32 {

// The k-depth of a swizzled tile's row: 32 floats, 128 bytes.
constexpr int kRowFloats = 32;

namespace {  // one copy per source that includes this header

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; `bytes` (16 or 0) are read, the rest of
// the 16 zero-filled.
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes, or a zero when `bytes` is 0.
__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Where element (r, k) of a tile of 128-byte rows lies in wgmma's 128-byte
// swizzle, in floats from the tile's start (1024-byte aligned): the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8).
__device__ __forceinline__ int sw128(int r, int k) {
  return r * kRowFloats + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}

// rna(a): a rounded to TF32, ties away from zero, low 13 bits cleared: half
// an ulp of TF32 added to the magnitude's bits, then the 13 bits dropped.
// That is cvt.rna.tf32.f32 for finite values and infinities (a NaN's lo is
// NaN either way), in two integer operations: an mma.sync version of K6a
// took 10.8 ms with it against 11.4 with the cvt (48x1080x1920, H100 SXM
// at 700 W, scripts/k6_ab.py).
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(__fsub_rn(a, __uint_as_float(hi)));
}

// The wgmma descriptor of a swizzled K-major tile (sw128 above) that
// starts at `tile`, 1024-byte aligned: start address, no leading offset
// (one 128-byte row spans the k-depth), 1024 bytes between groups of 8
// rows, the 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(const float* tile) {
  return uint64_t((smem_addr(tile) & 0x3ffff) >> 4) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// d (+)= a @ b for the warpgroup's 64 x 128 tile, one k-step of 8: a from
// registers (the m16n8k8 A fragment of each warp's 16 rows), b from the
// swizzled tile `desc` describes; `accumulate` 0 starts d from zero.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t a[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The same for a 64 x 64 tile: b's first 64 rows.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t a[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most kPending of this warpgroup's committed groups are
// still running.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Makes this thread's view of shared memory and wgmma's (the async proxy)
// agree: after cp.async writes, before wgmma reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace
}  // namespace tf32
}  // namespace ssw
