// The pieces of a warp-specialised 3xTF32 pass shared by K9's first pass
// (csrc/highest_read.cu) and K10's product (csrc/highest_inverse.cu): a
// producer warpgroup fills a ring of shared-memory stages (an f32 X tile by
// TMA in wgmma's 128-byte swizzle, which three consumer warpgroups read as
// wgmma's A fragments, and the B operand: K9's basis rows by cp.async,
// K10's by TMA). Here: the 3-D tensor maps of an f32 array and of a u8
// image, their TMA loads and stores, the cp.async arrival on a stage's
// mbarrier, setmaxnreg, the fence that keeps a wgmma's sums in place, and
// the bank-spreading map of fragment rows to positions (chunk_of).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace ssw {
namespace ring {

namespace {  // one copy per source that includes this header

// In an X tile whose 128-byte rows are k-rows of 32 positions, warp p (0 or
// 1) of a pair that shares one 32-position box gives its fragment row rho
// (0..15) the position 4 chunk_of(p, rho) + rho % 4 of the box: over the
// warp's 32 threads (rows g or g + 8, k-rows t or t + 4) the swizzled chunk
// chunk_of ^ t then takes eight values and the 32 loads of a fragment value
// fall in 32 banks.
__host__ __device__ constexpr int chunk_of(int p, int rho) {
  return 4 * ((rho / 4) % 2) + rho / 8 + 2 * p;
}

// The completion of this thread's cp.async copies so far arrives on `bar`
// (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   tf32::smem_addr(bar))
               : "memory");
}

// Box (c0, c1, c2) of the 3-D tensor map `map` to `dst`; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          tf32::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(tf32::smem_addr(bar))
      : "memory");
}

// `src` to box (c0, c1, c2) of `map` (the parts outside the array are not
// written), in this thread's bulk group; `src` written through generic
// stores is fenced first (fence_async_smem) by every thread that wrote it.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(tf32::smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores have read their sources (kRead) or are done.
template <bool kRead>
__device__ __forceinline__ void tma_store_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// This thread's shared-memory writes so far become visible to TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Keeps the compiler from moving reads or writes of a wgmma's sums across
// this point (the sums change under it while the wgmma runs).
__device__ __forceinline__ void fence_sums(float (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(p[i])::"memory");
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that
// nothing links -lcuda; null where the driver lacks it.
inline PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), 12000,
        cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      encode = nullptr;
  }
  return encode;
}

// The tensor map of the f32 array `base` of d2 planes of d1 rows of d0
// floats, rows `row_bytes` and planes `plane_bytes` apart (multiples of
// 16), for boxes of `box_rows` rows of 32 floats of one plane in the
// 128-byte swizzle, zeros outside the array.
inline cudaError_t map_3d(CUtensorMap* map, const float* base, int d0, int d1,
                          int d2, long long row_bytes, long long plane_bytes,
                          int box_rows = 32) {
  const auto encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(d0), cuuint64_t(d1), cuuint64_t(d2)};
  const cuuint64_t strides[2] = {cuuint64_t(row_bytes),
                                 cuuint64_t(plane_bytes)};
  const cuuint32_t box[3] = {32, cuuint32_t(box_rows), 1},
                   steps[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of the u8 image `base`: d2 planes of d1 rows of d0 bytes,
// rows `row_bytes` and planes `plane_bytes` apart (multiples of 16, base
// 16-byte aligned), for unswizzled boxes of box_rows rows of box_bytes
// (a multiple of 16, at most 256) of one plane, zeros outside the image.
inline cudaError_t map_u8(CUtensorMap* map, const void* base, long long d0,
                          int d1, int d2, long long row_bytes,
                          long long plane_bytes, int box_bytes,
                          int box_rows) {
  const auto encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(d0), cuuint64_t(d1), cuuint64_t(d2)};
  const cuuint64_t strides[2] = {cuuint64_t(row_bytes),
                                 cuuint64_t(plane_bytes)};
  const cuuint32_t box[3] = {cuuint32_t(box_bytes), cuuint32_t(box_rows), 1},
                   steps[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ring
}  // namespace ssw
