// K5: the fast tiers' read tail. The DCT coefficients of the difference of
// two u8 images at n ranked indices, without the (B, H, W) plane.
//
// Replaces no pallas_call: the JAX package leaves this stage to XLA
// (spread_spectrum_watermarking_tpu/models/pipeline.py:278-288, the
// masked matmul of ops/dct.py:dct2_dot_at). It computes what the port's
// plain read tail computes (kernels/read_tail.py, read_tail_reference: K1's
// pair mode, then dct2_dot_at at DEFAULT). In landscape (H <= W):
//   y[h, w]  = ((30 dR + 59 dG) + 11 dB) * f32(1/25500)  (d = derived - base)
//   td[r, w] = bf16( sum_h bf16(C_h)[r, h] bf16(y)[h, w] )  (f32 sums)
//   num[i]   = sum_w td[r_i, w] bf16(C_w)[c_i, w]           (f32 sums)
// with r_i = idx_i / W, c_i = idx_i % W. Portrait (H > W) is the mirror:
// td[h, l] contracts W, and num[i] = sum_h bf16(C_h)[r_i, h] td[h, c_i].
// Both are one form here, with S the shorter side (the first pass's
// contraction) and L the longer: a_i the index's coordinate along S (r_i in
// landscape, c_i in portrait), b_i its coordinate along L,
//   D[i][l] = sum_s C_S[a_i, s] y(s, l),  num[i] = sum_l bf16(D[i][l]) C_L[b_i, l]
// (D[i] is td's row r_i in landscape and its column c_i in portrait).
//
// Bound on the H100: the function needs one row of the first pass per
// distinct (image, a_i), 2 S L operations each, and 2 L per index for the
// dots; it must read both u8 images. The ranked indices of a natural image
// sit in a low-frequency corner, so at 48x1080x1920, n = 1000 the distinct
// rows are a few dozen an image, a few GFLOP, and the 597 MB of u8 in
// (0.178 ms at 3.35 TB/s) bound it: bound by bytes (chip_smoke.py's phase
// 3b counts the rows of its run). This kernel computes one row per index,
// distinct or not: 2 B n H W = 199 GFLOP there (0.201 ms at the 989
// TFLOP/s bf16 peak). The route it replaces (K1's pair pass, the whole (B,
// H, W) plane, then a gather-dot of plain ops that materialised two (B, n,
// W) gathers) took 2.39 ms.
//
// Design: three launches on the shared Hopper mainloop
// (csrc/wgmma_tile.cuh), M = n (the ranked index), N = L, K = S:
//   1. operands_kernel writes both bf16 operands as tile images: B, the
//      pair luma with rows along L and k along S, by K1's pair tile pass
//      (csrc/luma_tiles.cuh), and A, the basis rows C_S[a_i, :] of every
//      index, copied 16 bytes at a time from the cached tile image of C_S
//      (kernels/_tiles.py) with the swizzle of the row they land in (zero
//      rows past n; an index outside [0, H W) fails an assert). A is staged in
//      device memory as K4 stages its factors: ceil(n/128) 128-row tiles by
//      ceil(S/64) k tiles an image, about 107 MB at 48x1080p and n = 1000
//      (B: 200 MB).
//   2. gemm_kernel with the ReadTail epilogue: each 128 x 128 output tile
//      (128 indices by 128 positions l) rounds its f32 sums to bf16 (td, the
//      plain route's rounding point), multiplies each by bf16(C_L)[b_i, l]
//      in f32 (an exact product of two bf16 values), and sums them along
//      the tile's l: each thread its 32 columns in order, then the four
//      threads of a row by two shuffles. One f32 partial per (image, l
//      tile, index), no atomics.
//   3. sum_kernel adds each index's partials in l-tile order.
// Every f32 operation is an explicit _rn intrinsic and every sum has one
// fixed order, so a result repeats bit for bit and an image's result does
// not depend on the batch it sits in (Writer and Reader agree bit for bit,
// models/pipeline.py). No (B, H, W) plane is written: the largest store is
// the B operand, one bf16 per pixel, which K1's pair mode writes too.
#include <cassert>

#include "luma_tiles.cuh"

namespace {

using ssw::luma::kTileThreads;
using ssw::luma::Mode;
using ssw::wg::cdiv;
using ssw::wg::kDepth;
using ssw::wg::kRows;
using ssw::wg::kTile;
using ssw::wg::TileAt;

constexpr int kSumThreads = 256;

// The scratch's two tile images for `batch` images: B (the luma, rows
// along L) then A (the basis rows, rows the n indices), both ktiles deep.
struct Layout {
  int l_tiles, m_tiles, ktiles;
  long long b_image, a_image;  // bf16 elements of one image's B and A
  Layout(int s, int l, int n)
      : l_tiles(cdiv(l, kRows)), m_tiles(cdiv(n, kRows)),
        ktiles(cdiv(s, kDepth)),
        b_image((long long)l_tiles * ktiles * kTile),
        a_image((long long)m_tiles * ktiles * kTile) {}
  long long elems(int batch) const { return batch * (b_image + a_image); }
};

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

// Tile (mt, kt) of image `image`'s A: row i is the basis row C_S[a_i, :]
// (k tile kt of it), from the tile image of C_S (`basis`, ktiles deep),
// 16-byte chunk c of source row a at chunk c ^ (a % 8), of row i at c ^ (i
// % 8). 8 threads to a row: reads and writes are whole 128-byte rows. An
// index outside [0, h w) fails a device-side assert, as PyTorch's indexing
// kernels do; the launches after it then never run.
__device__ __forceinline__ void gather_tile(
    const __nv_bfloat16* __restrict__ basis, const long long* __restrict__ idx,
    long long idx_stride, __nv_bfloat16* __restrict__ a_tiles, int n, int h,
    int w, bool landscape, int ktiles, int m_tiles, int mt, int kt,
    int image) {
  __nv_bfloat16* tile =
      a_tiles + ((long long)image * m_tiles + mt) * ktiles * kTile +
      (long long)kt * kTile;
#pragma unroll
  for (int u = 0; u < kTile / 8 / kTileThreads; ++u) {
    const int e = threadIdx.x + u * kTileThreads;
    const int r = e / (kDepth / 8), c = e % (kDepth / 8);
    const int i = mt * kRows + r;
    int a = 0, b = 0;  // b unused: A needs the coordinate along S only
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i < n) {
      const bool in_range =
          coords(idx[image * idx_stride + i], h, w, landscape, a, b);
      assert(in_range && "read_tail: an index outside [0, h w)");
      if (in_range)
        v = *reinterpret_cast<const uint4*>(
            basis + ((long long)(a / kRows) * ktiles + kt) * kTile +
            ssw::wg::swizzled(a % kRows, 8 * c));
    }
    *reinterpret_cast<uint4*>(tile + ssw::wg::swizzled(r, 8 * c)) = v;
  }
}

// Block (kt, y, image): for y < l_tiles, tile (y, kt) of B, the pair luma
// (K1's pair tile pass); else tile (y - l_tiles, kt) of A.
template <bool kLandscape>
__global__ void __launch_bounds__(kTileThreads)
operands_kernel(const uint8_t* __restrict__ derived,
                const uint8_t* __restrict__ base,
                const __nv_bfloat16* __restrict__ basis,
                const long long* __restrict__ idx, long long idx_stride,
                __nv_bfloat16* __restrict__ work, int h, int w, int n,
                Layout lay, int batch) {
  if (int(blockIdx.y) < lay.l_tiles) {
    ssw::luma::luma_tile<Mode::kPair, kLandscape>(
        derived, base, work, h, w, lay.ktiles, lay.b_image, blockIdx.y,
        blockIdx.x, blockIdx.z);
  } else {
    gather_tile(basis, idx, idx_stride, work + batch * lay.b_image, n, h, w,
                kLandscape, lay.ktiles, lay.m_tiles, blockIdx.y - lay.l_tiles,
                blockIdx.x, blockIdx.z);
  }
}

// gemm_kernel's epilogue for K5: the tile's sums D[i][l] (wgmma's
// accumulator layout: acc[4j + 2hh + e] is row 8hh + lane / 4 of the warp's
// 16, column 8j + 2 (lane % 4) + e) become one partial per row,
//   sum over the tile's l of bf16(D[i][l]) * C_L[b_i, l],
// each thread summing its 32 columns (j ascending, then e), then the row's
// four threads q = lane % 4 as (s_0 + s_1) + (s_2 + s_3). basis_l is
// bf16(C_L) row-major with a pitch of l_tiles * 128, zero past L, so a
// tile's columns never leave a row and every pair of them is one aligned
// 4-byte load. An index outside [0, h w) has failed the operand pass's
// assert; its row here reads no basis and gets a NaN partial.
struct ReadTail {
  static constexpr size_t kSmemBytes = 0;
  const long long* idx;
  long long idx_stride;
  const __nv_bfloat16* basis_l;
  float* partials;  // (batch, l_tiles, n)
  int n, h, w, l_tiles;
  bool landscape;

  __device__ __forceinline__ void operator()(const TileAt& t,
                                             const float (&acc)[64],
                                             unsigned char*) const {
    const int half = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int m_base = t.m * kRows + half * 64 + warp * 16 + lane / 4;
    const long long pitch = (long long)l_tiles * kRows;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = m_base + 8 * hh;
      int a = 0, b = 0;
      const bool ok = i < n && coords(idx[t.image * idx_stride + i], h, w,
                                      landscape, a, b);
      const __nv_bfloat16* row =
          basis_l + b * pitch + t.n * kRows + 2 * (lane % 4);
      __nv_bfloat162 c[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        c[j] = *reinterpret_cast<const __nv_bfloat162*>(row + 8 * j);
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 cf = __bfloat1622float2(c[j]);
        const float t0 = __bfloat162float(__float2bfloat16_rn(acc[4 * j + 2 * hh]));
        const float t1 =
            __bfloat162float(__float2bfloat16_rn(acc[4 * j + 2 * hh + 1]));
        s = __fadd_rn(s, __fmul_rn(t0, cf.x));
        s = __fadd_rn(s, __fmul_rn(t1, cf.y));
      }
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
      if (i < n && lane % 4 == 0)
        partials[((long long)t.image * l_tiles + t.n) * n + i] =
            ok ? s : __int_as_float(0x7fc00000);
    }
  }
};

// out[image][i] = the sum of partials[image][lt][i] over lt ascending.
__global__ void __launch_bounds__(kSumThreads)
sum_kernel(const float* __restrict__ partials, float* __restrict__ out,
           int n, int l_tiles, long long total) {
  const long long e = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (e >= total) return;
  const long long image = e / n, i = e % n;
  const float* p = partials + image * l_tiles * n + i;
  float s = 0.0f;
  for (int lt = 0; lt < l_tiles; ++lt) s = __fadd_rn(s, p[(long long)lt * n]);
  out[e] = s;
}

int launch_operands(const uint8_t* derived, const uint8_t* base,
                    const long long* idx, long long idx_stride,
                    const __nv_bfloat16* basis_s, __nv_bfloat16* work,
                    long long work_elems, int batch, int h, int w, int n,
                    cudaStream_t stream) {
  const bool landscape = h <= w;
  const Layout lay(landscape ? h : w, landscape ? w : h, n);
  if (work_elems < lay.elems(batch)) return int(cudaErrorInvalidValue);
  if (batch == 0 || n == 0) return int(cudaSuccess);
  const dim3 grid(lay.ktiles, lay.l_tiles + lay.m_tiles, batch);
  if (landscape)
    operands_kernel<true><<<grid, kTileThreads, 0, stream>>>(
        derived, base, basis_s, idx, idx_stride, work, h, w, n, lay, batch);
  else
    operands_kernel<false><<<grid, kTileThreads, 0, stream>>>(
        derived, base, basis_s, idx, idx_stride, work, h, w, n, lay, batch);
  return int(cudaGetLastError());
}

}  // namespace

// derived, base: (batch, h, w, 3) u8, contiguous (any byte offset); idx:
// int64, n flat indices an image, image i's at idx + i * idx_stride
// (idx_stride 0: one set for every image); basis_s: the tile image of the
// bf16 DCT-II basis of S = min(h, w) (kernels/_tiles.py); basis_l: the
// bf16 DCT-II basis of L = max(h, w), (L, pitch) row-major, pitch =
// ceil(L / 128) * 128, zeros past L; work: `work_elems` bf16 of scratch,
// which receives the two operands' tile images (B of every image, then A
// of every image; kernels/read_tail.py); partials: batch * ceil(L / 128)
// * n f32 of scratch; out: (batch, n) f32.
// Three launches on `stream`; returns the first CUDA error code (0 when
// all were accepted).
extern "C" int ssw_read_tail(const uint8_t* derived, const uint8_t* base,
                             const long long* idx, long long idx_stride,
                             const __nv_bfloat16* basis_s,
                             const __nv_bfloat16* basis_l,
                             __nv_bfloat16* work, long long work_elems,
                             float* partials, float* out, int batch, int h,
                             int w, int n, cudaStream_t stream) {
  int code = launch_operands(derived, base, idx, idx_stride, basis_s, work,
                             work_elems, batch, h, w, n, stream);
  if (code != 0 || batch == 0 || n == 0) return code;
  const bool landscape = h <= w;
  const Layout lay(landscape ? h : w, landscape ? w : h, n);
  const ssw::wg::Operand a{work + batch * lay.b_image, lay.a_image, 0, 0};
  const ssw::wg::Operand b{work, lay.b_image, 0, 0};
  const ReadTail epi{idx, idx_stride, basis_l, partials, n, h, w,
                     lay.l_tiles, landscape};
  cudaError_t err = ssw::wg::launch_gemm<1>(a, b, epi, lay.m_tiles,
                                            lay.l_tiles, lay.ktiles, batch, 1,
                                            stream);
  if (err != cudaSuccess) return int(err);
  const long long total = (long long)batch * n;
  const unsigned blocks = unsigned((total + kSumThreads - 1) / kSumThreads);
  sum_kernel<<<blocks, kSumThreads, 0, stream>>>(partials, out, n,
                                                 lay.l_tiles, total);
  return int(cudaGetLastError());
}
