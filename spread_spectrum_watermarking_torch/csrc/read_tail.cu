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
//   D[a][l] = sum_s C_S[a, s] y(s, l),  num[i] = sum_l bf16(D[a_i][l]) C_L[b_i, l]
// (D[a] is td's row a in landscape and its column a in portrait).
//
// Bound on the H100: the function needs one row of the first pass per
// distinct (image, a_i), 2 S L operations each, and 2 L per index for the
// dots; it must read both u8 images. At 48x1080x1920, n = 1000 that is a
// few dozen rows an image on natural images and about 640 on random u8, at
// most 66 GFLOP, against 597 MB of u8 in (0.178 ms at 3.35 TB/s): bound by
// bytes (chip_smoke.py's phase 3b counts the rows of its run).
//
// Design: four launches, the product on the shared Hopper mainloop
// (csrc/wgmma_tile.cuh) with M = the image's distinct rows, N = L, K = S:
//   1. compact_kernel (csrc/compact_rows.cuh, shared with K9), one block
//      an image: marks the rows {a_i} in a bitmap over S in shared memory,
//      counts them by a block-wide scan, and writes the image's count of
//      distinct rows, their ascending list and each index's place (slot) in
//      it. An index outside [0, H W) fails an assert, as PyTorch's indexing
//      kernels do; the launches after it never run.
//   2. operands_kernel writes both bf16 operands as tile images: B, the pair
//      luma with rows along L and k along S (csrc/luma_tiles.cuh; 16-byte
//      loads where the images' rows are 16-byte aligned, as at 1080p and
//      4K, byte loads for any other view), and A, the basis rows C_S[a, :]
//      of the list only, copied 16 bytes at a time from the cached tile image
//      of C_S (kernels/_tiles.py) with the swizzle of the row they land in:
//      ceil(rows / 128) m tiles an image, zero rows past the count. Scratch
//      holds ceil(min(n, S) / 128) m tiles an image, so the host never waits
//      to read a count.
//   3. gemm_kernel with the plain bf16 store (StoreOut) and the LiveTiles
//      walk: only the m tiles that hold rows, the m tiles of one (image, n)
//      column one after another (each B tile comes from device memory once,
//      from L2 after that), dealt round the persistent blocks in turn. Its
//      output is bf16(D), the plain route's rounding point, a row per slot.
//   4. dot_kernel, one warp an index: num[i] = sum_l D[slot_i][l] *
//      C_L[b_i, l], each lane over its 16-byte chunks l = 8 (lane + 32 k) +
//      e, one f32 sum per e in k order, the eight added as a tree, then the
//      lanes by a shuffle tree. Indices that share a row read it from L2.
// Every f32 operation is an explicit _rn intrinsic and every sum has one
// fixed order, so a result repeats bit for bit and an image's result does
// not depend on the batch it sits in (Writer and Reader agree bit for bit,
// models/pipeline.py). No float atomics; the bitmap's integer atomicOr
// commutes. No (B, H, W) plane is written: the largest store is the B
// operand, one bf16 per pixel, which K1's pair mode writes too.
#include "compact_rows.cuh"
#include "luma_tiles.cuh"

namespace {

using ssw::luma::kTileThreads;
using ssw::luma::Mode;
using ssw::rows::compact_kernel;
using ssw::rows::kCompactSmem;
using ssw::rows::kCompactThreads;
using ssw::wg::cdiv;
using ssw::wg::kDepth;
using ssw::wg::kRows;
using ssw::wg::kTile;
using ssw::wg::TileAt;

constexpr int kDotThreads = 256;  // 8 warps, one index each

// The scratch for `batch` images. work (bf16): B, the luma (rows along L),
// of every image, then A, the basis rows of the list (cap = min(n, S) rows
// at most), both ktiles deep. drows (bf16): bf16(D), m_tiles * 128 rows of
// `pitch` an image. meta (int32): each image's count of rows, then its list
// (cap each), then each index's slot (n each).
struct Layout {
  int cap, l_tiles, m_tiles, ktiles, pitch;
  long long b_image, a_image, d_image;
  Layout(int s, int l, int n)
      : cap(n < s ? n : s), l_tiles(cdiv(l, kRows)), m_tiles(cdiv(cap, kRows)),
        ktiles(cdiv(s, kDepth)), pitch(l_tiles * kRows),
        b_image((long long)l_tiles * ktiles * kTile),
        a_image((long long)m_tiles * ktiles * kTile),
        d_image((long long)m_tiles * kRows * pitch) {}
  long long work(int batch) const { return batch * (b_image + a_image); }
  long long drows(int batch) const { return batch * d_image; }
  long long meta(int batch, int n) const {
    return (long long)batch * (1 + cap + n);
  }
};

// Tile (mt, kt) of image `image`'s A: row r is the basis row C_S[list[j], :]
// (k tile kt of it) for j = 128 mt + r < rows, zero past it, from the tile
// image of C_S (`basis`, ktiles deep), 16-byte chunk c of source row a at
// chunk c ^ (a % 8), of row r at c ^ (r % 8). 8 threads to a row: reads and
// writes are whole 128-byte rows.
__device__ __forceinline__ void gather_tile(
    const __nv_bfloat16* __restrict__ basis, const int* __restrict__ list,
    int rows, __nv_bfloat16* __restrict__ a_tiles, int ktiles, int m_tiles,
    int mt, int kt, int image) {
  __nv_bfloat16* tile =
      a_tiles + ((long long)image * m_tiles + mt) * ktiles * kTile +
      (long long)kt * kTile;
#pragma unroll
  for (int u = 0; u < kTile / 8 / kTileThreads; ++u) {
    const int e = threadIdx.x + u * kTileThreads;
    const int r = e / (kDepth / 8), c = e % (kDepth / 8);
    const int j = mt * kRows + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (j < rows) {
      const int a = list[j];
      v = *reinterpret_cast<const uint4*>(
          basis + ((long long)(a / kRows) * ktiles + kt) * kTile +
          ssw::wg::swizzled(a % kRows, 8 * c));
    }
    *reinterpret_cast<uint4*>(tile + ssw::wg::swizzled(r, 8 * c)) = v;
  }
}

// Block (kt, y, image): for y < l_tiles, tile (y, kt) of B, the pair luma
// (16-byte loads if kWide); else tile (y - l_tiles, kt) of A, if it holds
// rows (the product never reads the others).
template <bool kLandscape, bool kWide>
__global__ void __launch_bounds__(kTileThreads)
operands_kernel(const uint8_t* __restrict__ derived,
                const uint8_t* __restrict__ base,
                const __nv_bfloat16* __restrict__ basis,
                const int* __restrict__ count, const int* __restrict__ list,
                __nv_bfloat16* __restrict__ work, int h, int w, Layout lay,
                int batch) {
  if (int(blockIdx.y) < lay.l_tiles) {
    if constexpr (kWide)
      ssw::luma::pair_tile_wide<kLandscape>(derived, base, work, h, w,
                                            lay.ktiles, lay.b_image,
                                            blockIdx.y, blockIdx.x,
                                            blockIdx.z);
    else
      ssw::luma::luma_tile<Mode::kPair, kLandscape>(
          derived, base, work, h, w, lay.ktiles, lay.b_image, blockIdx.y,
          blockIdx.x, blockIdx.z);
    return;
  }
  const int mt = blockIdx.y - lay.l_tiles, image = blockIdx.z;
  const int rows = count[image];
  if (mt * kRows >= rows) return;
  gather_tile(basis, list + (long long)image * lay.cap, rows,
              work + batch * lay.b_image, lay.ktiles, lay.m_tiles, mt,
              blockIdx.x, image);
}

// gemm_kernel's walk for K5: image by image, the n tiles of each, and of
// each n tile the m tiles that hold rows (m < ceil(count[image] / 128)),
// m fastest; the grid's tile t is the t-th of them. A thread's calls come
// with t ascending, so a cursor (the image, and the tiles before it) moves
// forward only.
struct LiveTiles {
  const int* count;
  int batch;
  int image = 0, first = 0, live = -1;

  __device__ __forceinline__ bool at(int tile, int, int n_tiles, int, int,
                                     TileAt& t) {
    while (image < batch) {
      if (live < 0) live = cdiv(count[image], kRows);
      if (tile < first + live * n_tiles) {
        const int local = tile - first;
        t.m = local % live;
        t.n = local / live;
        t.image = image;
        t.parity = 0;
        return true;
      }
      first += live * n_tiles;
      ++image;
      live = -1;
    }
    return false;
  }
};

__device__ __forceinline__ float lo_bf16(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Warp e = (image, i): out[e] = sum_l D[slot_e][l] C_L[b_i, l] over the
// padded row (`pitch` columns, zeros past L in both). Lane q sums the
// chunks c = q, q + 32, ... of 8 columns: s[e] over c ascending for each
// column e of a chunk, then ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 +
// s7)), then the lanes by xor shuffles 16, 8, 4, 2, 1. Each product of two
// bf16 values is exact in f32.
__global__ void __launch_bounds__(kDotThreads)
dot_kernel(const long long* __restrict__ idx, long long idx_stride,
           const __nv_bfloat16* __restrict__ basis_l,
           const __nv_bfloat16* __restrict__ drows,
           const int* __restrict__ slots, float* __restrict__ out, int n,
           int h, int w, Layout lay, long long total) {
  const long long e =
      (long long)blockIdx.x * (kDotThreads / 32) + threadIdx.x / 32;
  if (e >= total) return;
  const int lane = threadIdx.x % 32;
  const long long image = e / n, i = e % n;
  // In range: compact_kernel's assert stops the call at any other index.
  const long long id = idx[image * idx_stride + i];
  const int b = h <= w ? int(id % w) : int(id / w);
  const uint4* d = reinterpret_cast<const uint4*>(
      drows + image * lay.d_image + (long long)slots[e] * lay.pitch);
  const uint4* c =
      reinterpret_cast<const uint4*>(basis_l + (long long)b * lay.pitch);
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0.0f;
  for (int k = lane; k < lay.pitch / 8; k += 32) {
    const uint4 dv = d[k], cv = c[k];
    const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
    const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[2 * j] = __fadd_rn(s[2 * j], __fmul_rn(lo_bf16(dw[j]), lo_bf16(cw[j])));
      s[2 * j + 1] =
          __fadd_rn(s[2 * j + 1], __fmul_rn(hi_bf16(dw[j]), hi_bf16(cw[j])));
    }
  }
  float v = __fadd_rn(__fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3])),
                      __fadd_rn(__fadd_rn(s[4], s[5]), __fadd_rn(s[6], s[7])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) out[e] = v;
}

template <bool kLandscape>
void launch_operands(bool wide, dim3 grid, cudaStream_t stream,
                     const uint8_t* derived, const uint8_t* base,
                     const __nv_bfloat16* basis_s, const int* count,
                     const int* list, __nv_bfloat16* work, int h, int w,
                     const Layout& lay, int batch) {
  if (wide)
    operands_kernel<kLandscape, true><<<grid, kTileThreads, 0, stream>>>(
        derived, base, basis_s, count, list, work, h, w, lay, batch);
  else
    operands_kernel<kLandscape, false><<<grid, kTileThreads, 0, stream>>>(
        derived, base, basis_s, count, list, work, h, w, lay, batch);
}

}  // namespace

// derived, base: (batch, h, w, 3) u8, contiguous (any byte offset); idx:
// int64, n flat indices an image, image i's at idx + i * idx_stride
// (idx_stride 0: one set for every image); basis_s: the tile image of the
// bf16 DCT-II basis of S = min(h, w) (kernels/_tiles.py); basis_l: the
// bf16 DCT-II basis of L = max(h, w), (L, pitch) row-major, pitch =
// ceil(L / 128) * 128, zeros past L; work, drows, meta: scratch of
// `work_elems` bf16, `drows_elems` bf16 and `meta_elems` int32 (Layout;
// kernels/read_tail.py sizes them); out: (batch, n) f32; rows_total: an
// int64 on the device that the images' counts of rows are added to, or
// null. Four launches on `stream`; returns the first CUDA error code (0 when
// all were accepted).
extern "C" int ssw_read_tail(const uint8_t* derived, const uint8_t* base,
                             const long long* idx, long long idx_stride,
                             const __nv_bfloat16* basis_s,
                             const __nv_bfloat16* basis_l,
                             __nv_bfloat16* work, long long work_elems,
                             __nv_bfloat16* drows, long long drows_elems,
                             int* meta, long long meta_elems, float* out,
                             int batch, int h, int w, int n,
                             long long* rows_total, cudaStream_t stream) {
  const bool landscape = h <= w;
  const int s = landscape ? h : w;
  const Layout lay(s, landscape ? w : h, n);
  if (work_elems < lay.work(batch) || drows_elems < lay.drows(batch) ||
      meta_elems < lay.meta(batch, n))
    return int(cudaErrorInvalidValue);
  if (batch == 0 || n == 0) return int(cudaSuccess);
  int* count = meta;
  int* list = meta + batch;
  int* slots = list + (long long)batch * lay.cap;

  const size_t smem = ssw::rows::compact_smem(s);
  if (smem > kCompactSmem) return int(cudaErrorInvalidValue);
  compact_kernel<<<batch, kCompactThreads, smem, stream>>>(
      idx, idx_stride, n, h, w, s, lay.cap, count, list, slots,
      reinterpret_cast<unsigned long long*>(rows_total));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  // 16-byte loads where every row of both images starts 16-byte aligned.
  const bool wide = reinterpret_cast<uintptr_t>(derived) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
                    (3LL * w) % 16 == 0;
  const dim3 grid(lay.ktiles, lay.l_tiles + lay.m_tiles, batch);
  if (landscape)
    launch_operands<true>(wide, grid, stream, derived, base, basis_s, count,
                          list, work, h, w, lay, batch);
  else
    launch_operands<false>(wide, grid, stream, derived, base, basis_s, count,
                           list, work, h, w, lay, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const ssw::wg::Operand a{work + batch * lay.b_image, lay.a_image, 0, 0};
  const ssw::wg::Operand b{work, lay.b_image, 0, 0};
  const ssw::wg::Output o{drows, lay.d_image, 0, lay.pitch, 1,
                          lay.m_tiles * kRows, lay.pitch, true};
  err = ssw::wg::launch_gemm<1>(a, b, ssw::wg::StoreOut<__nv_bfloat16>{o},
                                lay.m_tiles, lay.l_tiles, lay.ktiles, batch,
                                1, stream, LiveTiles{count, batch});
  if (err != cudaSuccess) return int(err);

  const long long total = (long long)batch * n;
  const long long blocks = (total + kDotThreads / 32 - 1) / (kDotThreads / 32);
  dot_kernel<<<unsigned(blocks), kDotThreads, 0, stream>>>(
      idx, idx_stride, basis_l, drows, slots, out, n, h, w, lay, total);
  return int(cudaGetLastError());
}
