// Shared tile machinery of the port's Hopper kernels: one 128x128 output
// tile per block of 8 warps, accumulated in f32 from bf16 operands with
// nvcuda::wmma (tensor cores, m16n16k16). Operand tiles are staged through
// two shared-memory buffers, so the loads of k-step i+1 are issued before
// the products of k-step i.
//
// Each kernel supplies a loader that writes the A tiles (BM x BK, row-major)
// and the B tiles (BK x BN, row-major) of one k-step into a Stage, with
// zeros outside the matrix, so ragged edges need no other masking. A stage
// holds one part of each operand (one bf16 product), or two (kParts = 2:
// the hi and lo bf16 parts of the HIGH tier's bf16x3 split, whose products
// hi*hi + hi*lo + lo*hi go into the same accumulator; lo*lo is dropped).
// The accumulator lands in shared memory as f32 for the kernel's own
// epilogue. There are no atomics: every output element is summed by one
// warp in a fixed order, so results repeat bit for bit from run to run.
//
// A split stage (K1f's folded pass) holds a second A tile (kSplitA), read
// by the warps of the tile's right half (columns BN/2..BN), or a second B
// tile (kSplitB), read by the warps of its lower half (rows BM/2..BM): one
// block then computes two products of half the tile each, the even and the
// odd outputs of the same range.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace ssw {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;   // 8 warps, each owning a 32x64 slice
constexpr int LDA = BK + 8;    // bf16 pitches: multiples of 8 for wmma
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;    // f32 pitch: a multiple of 4

enum Split { kNoSplit = 0, kSplitA = 1, kSplitB = 2 };

template <int kParts, int kSplit = kNoSplit>
struct StageT {
  __nv_bfloat16 a[kParts][(kSplit == kSplitA ? 2 : 1) * BM * LDA];
  __nv_bfloat16 b[kParts][(kSplit == kSplitB ? 2 : 1) * BK * LDB];
};

// Above the 48 KB of static shared memory (103 KB with one part, 140 KB
// with two; 120-180 KB split), so kernels take it as dynamic shared memory
// (set_smem_limit).
template <int kParts, int kSplit = kNoSplit>
struct __align__(128) TileSmemT {
  StageT<kParts, kSplit> st[2];
  float c[BM * LDC];
};

using Stage = StageT<1>;
using TileSmem = TileSmemT<1>;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Allows `kernel` the dynamic shared memory it is launched with.
template <class Kernel>
cudaError_t set_smem_limit(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

__device__ __forceinline__ __nv_bfloat16 bf16_zero() {
  return __float2bfloat16_rn(0.0f);
}

// Eight consecutive bf16 of row `row` (length `len`) from column `col` into
// out[0..7], zero past the row's end. One 16-byte load when `vec` (rows are
// 16-byte aligned) and the whole run is inside the row.
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int col,
                                      int len, bool vec, __nv_bfloat16* out) {
  if (vec && col + 8 <= len) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + col);
    const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = p[j];
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[j] = (col + j < len) ? row[col + j] : bf16_zero();
  }
}

// Stores eight bf16 with one 16-byte store (dst 16-byte aligned).
__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* v) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// Runs the k loop over [0, kdim) and leaves the f32 tile in s.c.
// load(StageT<kParts, kSplit>& st, int k0) fills st with the tiles of
// k-step k0.
template <int kParts, int kSplit, class Loader>
__device__ __forceinline__ void tile_product(TileSmemT<kParts, kSplit>& s,
                                             int kdim, const Loader& load) {
  using namespace nvcuda;
  // Products per k-step: a*b, or hi*hi, hi*lo and lo*hi.
  constexpr int kProducts = kParts == 1 ? 1 : 3;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 64;
  // Where this warp's operands start in a split stage.
  const int a_off = kSplit == kSplitA && wn >= BN / 2 ? BM * LDA : 0;
  const int b_off = kSplit == kSplitB && wm >= BM / 2 ? BK * LDB : 0;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (kdim > 0) load(s.st[0], 0);
  __syncthreads();
  int cur = 0;
  for (int k0 = 0; k0 < kdim; k0 += BK) {
    // The buffer written here was last read before the previous barrier.
    if (k0 + BK < kdim) load(s.st[cur ^ 1], k0 + BK);
    const StageT<kParts, kSplit>& st = s.st[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
      for (int p = 0; p < kProducts; ++p) {
        const __nv_bfloat16* a = st.a[p == 2 ? 1 : 0] + a_off;
        const __nv_bfloat16* b = st.b[p == 1 ? 1 : 0] + b_off;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], a + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], b + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(s.c + (wm + 16 * i) * LDC + wn + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
}

}  // namespace ssw
