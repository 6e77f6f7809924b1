// K1f: one folded DCT-II pass of an f32 plane, at DEFAULT or HIGH.
//
// Replaces the TPU kernel luma_fold_row_pass (spread_spectrum_watermarking_tpu/
// ops/fused_dct.py at 257c497, pallas_call at :277), but computes what the
// JAX package's XLA code computes today behind dct2_2d(fold=True):
// dct._fold_pass_rows (contracting H) and dct._fold_pass_cols (contracting
// W) on an f32 plane. The TPU kernel's u8 luma prologue is not carried over
// (no path folds from u8 now), nor its even/odd stacked layout, KP padding
// and index map, which worked around Mosaic's lack of a sublane flip.
//
// With N the contracted length and the basis symmetry
// C[k, N-1-m] = (-1)^k C[k, m], output 2q contracts s = x[m] + x[N-1-m] and
// output 2q+1 contracts d = x[m] - x[N-1-m] (m < N/2) against the halves
// ce = C[0::2, :N/2] and co = C[1::2, :N/2]: two products N/2 deep, half
// the dense pass's operations. s and d are formed in f32 (__fadd_rn,
// __fsub_rn) as the JAX code forms them, and only then rounded to the tier:
// one bf16 rounding (RNE) at DEFAULT; at HIGH the exact split
// v_hi = bf16(v), v_lo = bf16(v - v_hi), with the halves split the same way
// on the host, and C_hi v_hi + C_hi v_lo + C_lo v_hi summed in f32 (lo*lo
// dropped, as the TPU drops it). The output is f32 in true row and column
// order: the second pass folds the f32 intermediate.
//
// Rows (contract H): out[2q+p, w] = sum_m c_p[q, m] v_p[m, w]
// Cols (contract W): out[h, 2l+p] = sum_m c_p[l, m] v_p[h, m]
// In both, A = the basis half c_p and B = v_p, K-major (v_p transposed in
// the rows orientation).
//
// Bound on the H100: at 48x1080x1920 the rows pass does 2*48*2*540*540*1920
// = 1.07e11 operations at DEFAULT (3.2e11 at HIGH), the cols pass 1.91e11
// (5.7e11), against 398 MB of f32 read and 398 MB written a pass: memory
// bounds both passes at DEFAULT (0.24 ms each), the tensor cores both at
// HIGH (0.33 ms and 0.58 ms).
//
// Design: two launches a pass on the shared Hopper mainloop
// (csrc/wgmma_tile.cuh). The first reads the plane once (each element and
// its mirror, in f32, by scalar loads: any float-aligned view), forms s
// and d, and writes them as bf16 (two parts at HIGH) in the mainloop's
// tile image, the even products' operand and the odd products'. The
// second runs both parities of each image as the mainloop's two parities;
// its tile walk puts them side by side, since in the cols orientation
// they share the output's 32-byte sectors. Bytes a pass at DEFAULT: 4 B an
// element read and 2 B written by the first launch, 2 B read and 4 B
// written by the second: 12 B an element against the function's 8 (0.36
// ms against 0.24 at 48x1080x1920), the price of this design against a
// prologue that folds inside the mainloop; at HIGH, 16 against 8, where
// the products bound it.
#include "wgmma_tile.cuh"

namespace {

using ssw::wg::cdiv;
using ssw::wg::kDepth;
using ssw::wg::kRows;
using ssw::wg::kTile;

constexpr int kTileThreads = 256;
// Floats of one f32 region of fold_tiles_kernel, the larger orientation's.
constexpr int kFoldSmemFloats = kRows * (kDepth + 1);
constexpr size_t kFoldSmem = 2 * kFoldSmemFloats * sizeof(float);

// s and d of one plane as the mainloop's operand tile images: rows r, k the
// folded index m < half (kAlongH, the rows orientation: r = w, transposed;
// the cols orientation: r = h), tile (blockIdx.y, blockIdx.x) of image
// blockIdx.z. Layout per image: [parity][part][tile]; parts part_stride
// apart. The plane is read with neighbouring threads on neighbouring w
// (the mirrored half of the cols orientation as the same whole segments,
// in reverse thread order), s and d kept in f32 in shared memory, then
// read across, 8 threads to each 128-byte row of the tile image.
template <int kP, bool kAlongH>
__global__ void __launch_bounds__(kTileThreads)
fold_tiles_kernel(const float* __restrict__ x,
                  __nv_bfloat16* __restrict__ tiles, int h, int w, int ktiles,
                  long long part_stride) {
  // The region: kDepth rows m by kRows columns w (rows orientation), or
  // kRows rows h by kDepth columns m (cols); s and d at [row * pitch + col].
  constexpr int kCols = kAlongH ? kRows : kDepth;
  constexpr int kPitch = kCols + 1;
  extern __shared__ float sd[];  // s, then d: 2 * kFoldSmemFloats
  const int half = (kAlongH ? h : w) / 2;
  const float* plane = x + size_t(blockIdx.z) * h * w;
  const int m0 = blockIdx.x * kDepth, r0 = blockIdx.y * kRows;
  // Batches of kBatch elements a thread, all loaded before any is used, so
  // the loads are in flight together; zeros past the plane.
  constexpr int kBatch = 8;
  for (int i0 = 0; i0 < kTile / kTileThreads; i0 += kBatch) {
    float a[kBatch], b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = threadIdx.x + (i0 + u) * kTileThreads;
      const int row = e / kCols, col = e % kCols;
      const int m = m0 + (kAlongH ? row : col);
      const int gr = r0 + (kAlongH ? col : row);
      const bool in = m < half && gr < (kAlongH ? w : h);
      const size_t ia = kAlongH ? size_t(m) * w + gr : size_t(gr) * w + m;
      const size_t ib = kAlongH ? size_t(h - 1 - m) * w + gr
                                : size_t(gr) * w + (w - 1 - m);
      a[u] = in ? plane[ia] : 0.0f;
      b[u] = in ? plane[ib] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = threadIdx.x + (i0 + u) * kTileThreads;
      const int at = (e / kCols) * kPitch + e % kCols;
      sd[at] = __fadd_rn(a[u], b[u]);
      sd[kFoldSmemFloats + at] = __fsub_rn(a[u], b[u]);
    }
  }
  __syncthreads();
  __nv_bfloat16* tile = tiles + blockIdx.z * (2 * kP * part_stride) +
                        (size_t(blockIdx.y) * ktiles + blockIdx.x) * kTile;
#pragma unroll
  for (int i = 0; i < kTile / 8 / kTileThreads; ++i) {
    const int e = threadIdx.x + i * kTileThreads;
    const int r = e / (kDepth / 8), c = e % (kDepth / 8);
    __align__(16) __nv_bfloat16 v[2][kP][8];  // [s, d][part]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = 8 * c + j;
      const int at = kAlongH ? k * kPitch + r : r * kPitch + k;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float f = sd[p * kFoldSmemFloats + at];
        v[p][0][j] = __float2bfloat16_rn(f);
        if (kP == 2)
          v[p][kP - 1][j] =
              __float2bfloat16_rn(__fsub_rn(f, __bfloat162float(v[p][0][j])));
      }
    }
    const int at = ssw::wg::swizzled(r, 8 * c);
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < kP; ++q)
        *reinterpret_cast<uint4*>(tile + (p * kP + q) * part_stride + at) =
            *reinterpret_cast<const uint4*>(v[p][q]);
  }
}

// x, out: (batch, h, w) f32; basis: the tile image of the halves (ce, co)
// of the DCT-II basis of the contracted length n, [parity][part][tile];
// work: room for the fold's tile image, `work_elems` bf16.
template <int kP>
int launch(const float* x, const __nv_bfloat16* basis, __nv_bfloat16* work,
           long long work_elems, float* out, int batch, int h, int w,
           bool rows, cudaStream_t stream) {
  const int half = (rows ? h : w) / 2;
  const int other = rows ? w : h;  // the fold tiles' rows
  const int ktiles = cdiv(half, kDepth);
  const long long part = (long long)cdiv(other, kRows) * ktiles * kTile;
  if (work_elems < batch * 2LL * kP * part) return int(cudaErrorInvalidValue);
  const dim3 grid(ktiles, cdiv(other, kRows), batch);
  auto tiles_kernel = rows ? fold_tiles_kernel<kP, true>
                           : fold_tiles_kernel<kP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kFoldSmem));
  if (err != cudaSuccess) return int(err);
  tiles_kernel<<<grid, kTileThreads, kFoldSmem, stream>>>(x, work, h, w,
                                                          ktiles, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const long long basis_part = (long long)cdiv(half, kRows) * ktiles * kTile;
  const ssw::wg::Operand fold{work, 2 * kP * part, kP * part, part};
  const ssw::wg::Operand halves{basis, 0, kP * basis_part, basis_part};
  // D[q][r] of parity p, r along the other axis, is out[2q + p][r] in the
  // rows orientation (stored in pairs where aligned) and out[r][2q + p] in
  // the cols orientation.
  const long long plane = (long long)h * w;
  const bool pairs = w % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  const ssw::wg::Output o =
      rows ? ssw::wg::Output{out, plane, w, 2LL * w, 1, half, w, pairs}
           : ssw::wg::Output{out, plane, 1, 2, w, half, h, false};
  err = ssw::wg::launch_gemm<kP, float>(halves, fold, o, cdiv(half, kRows),
                                        cdiv(other, kRows), ktiles, batch, 2,
                                        stream);
  return int(err);
}

}  // namespace

// x, out: (batch, h, w) f32, contiguous; the contracted length (h when
// `rows`, else w) is even. basis: the tile image (kernels/_tiles.py) of the
// halves ce, co of its DCT-II basis, [parity][part]: bf16(.) at DEFAULT
// (`high` 0), the hi and lo parts of the split at HIGH. work: `work_elems`
// bf16 of scratch for the fold's tile image. Two launches on `stream`;
// returns the first CUDA error code (0 when both were accepted).
extern "C" int ssw_fold_pass(const float* x, const __nv_bfloat16* basis,
                             __nv_bfloat16* work, long long work_elems,
                             float* out, int batch, int h, int w, int rows,
                             int high, cudaStream_t stream) {
  return high ? launch<2>(x, basis, work, work_elems, out, batch, h, w,
                          rows != 0, stream)
              : launch<1>(x, basis, work, work_elems, out, batch, h, w,
                          rows != 0, stream);
}
