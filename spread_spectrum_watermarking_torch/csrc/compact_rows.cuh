// The compaction shared by K5 (csrc/read_tail.cu) and K9
// (csrc/highest_read.cu): for each image of a batch, the distinct
// coordinates along the shorter side S of its n flat indices (the rows of
// the first pass that the dots at those indices need), as the image's
// count of them, their ascending list and each index's place (slot) in it.
// Its plain version is kernels/read_tail.py, compact_rows_reference.
//
// One block an image: the rows are marked in a bitmap over S in shared
// memory (integer atomicOr, which commutes), counted by a block-wide scan,
// and listed in ascending order, each thread over a run of consecutive
// words. An index outside [0, H W) fails an assert, as PyTorch's indexing
// kernels do; the launches after it never run.
#pragma once

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace ssw {
namespace rows {

constexpr int kCompactThreads = 512;
// The compaction's dynamic shared memory, beside its static warp sums.
constexpr size_t kCompactSmem =
    48 * 1024 - sizeof(int) * (kCompactThreads / 32);

namespace {  // one copy per source that includes this header

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The index's coordinates: along S (a) and along L (b); false for an index
// outside [0, h w).
__device__ __forceinline__ bool coords(long long id, int h, int w,
                                       bool landscape, int& a, int& b) {
  if (id < 0 || id >= (long long)h * w) return false;
  const int r = int(id / w), c = int(id % w);
  a = landscape ? r : c;
  b = landscape ? c : r;
  return true;
}

// The dynamic shared memory a compaction over S rows takes: the bitmap and
// each word's count of rows before it, 8 bytes a 32 rows. Within the 48 KB
// a launch gets without opting in up to S = 196,607, far past any image the
// card's memory holds.
inline size_t compact_smem(int s) {
  return 2 * sizeof(uint32_t) * size_t(cdiv(s, 32));
}

// Block `image`: the image's distinct rows. Dynamic shared memory: the
// bitmap over S (words of 32 rows), then each word's count of rows before
// it. Each thread scans a run of consecutive words, so the list comes out
// ascending.
__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const long long* __restrict__ idx, long long idx_stride,
               int n, int h, int w, int s, int cap, int* __restrict__ count,
               int* __restrict__ list, int* __restrict__ slots) {
  extern __shared__ uint32_t bits[];
  __shared__ int warp_sums[kCompactThreads / 32];
  const int words = cdiv(s, 32);
  int* before = reinterpret_cast<int*>(bits + words);
  const int image = blockIdx.x, lane = threadIdx.x % 32,
            warp = threadIdx.x / 32;
  const bool landscape = h <= w;
  const long long* ix = idx + image * idx_stride;
  for (int k = threadIdx.x; k < words; k += kCompactThreads) bits[k] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kCompactThreads) {
    int a = 0, b = 0;
    const bool in_range = coords(ix[i], h, w, landscape, a, b);
    assert(in_range && "an index outside [0, h w)");
    if (in_range) atomicOr(&bits[a >> 5], 1u << (a & 31));
  }
  __syncthreads();
  const int per = cdiv(words, kCompactThreads);
  const int k0 = min(int(threadIdx.x) * per, words),
            k1 = min(k0 + per, words);
  int mine = 0;
  for (int k = k0; k < k1; ++k) mine += __popc(bits[k]);
  int incl = mine;  // inclusive scan within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kCompactThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane < kCompactThreads / 32) warp_sums[lane] = v;
  }
  __syncthreads();
  int place = incl - mine + (warp > 0 ? warp_sums[warp - 1] : 0);
  if (threadIdx.x == kCompactThreads - 1) count[image] = place + mine;
  int* out = list + (long long)image * cap;
  for (int k = k0; k < k1; ++k) {
    before[k] = place;
    for (uint32_t m = bits[k]; m != 0; m &= m - 1)
      out[place++] = 32 * k + __ffs(m) - 1;
  }
  __syncthreads();
  int* slot = slots + (long long)image * n;
  for (int i = threadIdx.x; i < n; i += kCompactThreads) {
    int a = 0, b = 0;
    if (coords(ix[i], h, w, landscape, a, b))
      slot[i] = before[a >> 5] + __popc(bits[a >> 5] & ((1u << (a & 31)) - 1));
  }
}

}  // namespace
}  // namespace rows
}  // namespace ssw
