// K1: u8 RGB -> luma -> one DCT-II pass over the shorter image axis.
//
// Replaces the TPU kernel luma_pass (spread_spectrum_watermarking_tpu/ops/
// fused_dct.py, pallas_call at :295, removed in b5b6c44) in its DEFAULT and
// HIGH (n_dots=3) modes, but computes what the JAX package's XLA code
// computes today: pipeline._half_pass at DEFAULT (single mode) and at HIGH
// (high mode), and dct2_pass(luma_diff(base, derived)) in the read tail
// (pair mode). Rounding points follow that code as XLA compiles it on the
// CPU under jit, not the old kernel's folded integer-luma scale:
//   single, high: y = fma(b, 0.11f, fma(g, 0.59f, r * 0.30f)) with
//           c = u8 * f32(1/255) (the order XLA's CPU einsum sums in, and
//           the product XLA puts in place of u8 / 255; bit-equal over all
//           colours)
//   pair:   y = ((30 dR + 59 dG) + 11 dB) * f32(1/25500) (exact numerator;
//           XLA's product in place of the division)
// Single and pair mode round y to bf16 (RNE) and contract it with the bf16
// DCT-II basis. High mode keeps y in f32 and splits it as the TPU's bf16x3
// does: y_hi = bf16(y), y_lo = bf16(y - y_hi) (the subtraction is exact),
// with the basis split the same way on the host (C_hi, C_lo), and sums
// C_hi y_hi + C_hi y_lo + C_lo y_hi in f32. Every mode accumulates in f32
// and rounds the sum once to bf16: at HIGH the pipeline's only consumers
// (the second pass, rank_plane) cast the pass to bf16 first, so this is the
// same value at half the store. Every f32 op above is an explicit _rn
// intrinsic, so nvcc can neither fuse nor split it.
//
// Landscape (H <= W): out[k, w] = sum_h C[k, h] y[h, w]   (A = C, B = y^T)
// Portrait  (H >  W): out[h, l] = sum_w y[h, w] C[l, w]   (A = y, B = C)
//
// Bound on the H100: at 1080p one image is 2*1080*1080*1920 = 4.5 GFLOP
// (three times that at HIGH) against ~6 MB of u8 in and 4 MB of bf16 out,
// so the tensor-core rate is the roof (0.22 ms for 48 images at 989
// TFLOP/s; 0.65 ms at HIGH).
//
// Design: two launches a call on the shared Hopper mainloop
// (csrc/wgmma_tile.cuh). The first builds the luma once per pixel from the
// u8 image (recompute factor 1; the wmma design before it built it once
// per 128-row output tile, 9 times at 1080p, and that prologue, not the
// tensor cores, was its limit) and writes it as bf16 in the mainloop's tile
// image: transposed in landscape, where the contraction runs along H, so
// that both operands are K-major. Its price is one write and one read of
// the bf16 plane, 2 x 4.1 MB an image at 1080p (0.12 ms of device-memory
// time for 48 images; twice that at HIGH, with the lo part). The second is
// the bulk-copy-fed wgmma product against the basis's cached tile image.
// The tile pass (csrc/luma_tiles.cuh, shared with K5's read tail) reads
// pixels one byte at a time, so any u8 view (one byte into its storage) is
// read as it lies; each thread has eight pixels' loads in flight at once.
// Measured at 48x1080x1920 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py,
// scripts/k1_ab.py --profile): single 0.74 ms, pair 0.90, high 1.32, of
// which the tile pass takes 0.24, 0.39 and 0.31.
#include "luma_tiles.cuh"

namespace {

using ssw::luma::kTileThreads;
using ssw::luma::Mode;
using ssw::wg::cdiv;
using ssw::wg::kDepth;
using ssw::wg::kRows;
using ssw::wg::kTile;

// The luma of one image as the mainloop's operand tile image
// (csrc/luma_tiles.cuh): tile (blockIdx.y, blockIdx.x) of image blockIdx.z.
template <Mode kMode, bool kLandscape>
__global__ void __launch_bounds__(kTileThreads)
luma_tiles_kernel(const uint8_t* __restrict__ rgb,
                  const uint8_t* __restrict__ base,
                  __nv_bfloat16* __restrict__ tiles, int h, int w,
                  int ktiles, long long part_stride) {
  ssw::luma::luma_tile<kMode, kLandscape>(rgb, base, tiles, h, w, ktiles,
                                          part_stride, blockIdx.y, blockIdx.x,
                                          blockIdx.z);
}

// rgb (base): (batch, h, w, 3) u8; basis: the tile image of the bf16 DCT-II
// basis of n = min(h, w) (its hi and lo parts at HIGH); work: room for the
// luma's tile image, `work_elems` bf16; out: (batch, h, w) bf16.
template <Mode kMode>
int launch(const uint8_t* rgb, const uint8_t* base,
           const __nv_bfloat16* basis, __nv_bfloat16* work,
           long long work_elems, __nv_bfloat16* out, int batch, int h, int w,
           cudaStream_t stream) {
  constexpr int kP = ssw::luma::kParts<kMode>;
  const bool landscape = h <= w;
  const int n = landscape ? h : w;                   // the contraction
  const int rows = landscape ? w : h;                // the luma tiles' rows
  const int ktiles = cdiv(n, kDepth);
  const long long part = (long long)cdiv(rows, kRows) * ktiles * kTile;
  if (work_elems < batch * kP * part) return int(cudaErrorInvalidValue);
  const dim3 grid(ktiles, cdiv(rows, kRows), batch);
  if (landscape)
    luma_tiles_kernel<kMode, true><<<grid, kTileThreads, 0, stream>>>(
        rgb, base, work, h, w, ktiles, part);
  else
    luma_tiles_kernel<kMode, false><<<grid, kTileThreads, 0, stream>>>(
        rgb, base, work, h, w, ktiles, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const long long basis_part = (long long)cdiv(n, kRows) * ktiles * kTile;
  const ssw::wg::Operand luma{work, kP * part, 0, part};
  const ssw::wg::Operand basis_op{basis, 0, 0, basis_part};
  // out (batch, h, w) row-major: D[m][n] = out[m][n] in both orientations,
  // with A = C in landscape and A = y in portrait.
  const bool pairs = w % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const ssw::wg::Output o{out, (long long)h * w, 0, w, 1, h, w, pairs};
  err = ssw::wg::launch_gemm<kP>(
      landscape ? basis_op : luma, landscape ? luma : basis_op,
      ssw::wg::StoreOut<__nv_bfloat16>{o}, cdiv(h, kRows), cdiv(w, kRows),
      ktiles, batch, 1, stream);
  return int(err);
}

}  // namespace

// rgb, base: (batch, h, w, 3) u8, contiguous; base may be null (single
// mode). basis: the tile image of the bf16 DCT-II basis of min(h, w)
// (kernels/_tiles.py). work: `work_elems` bf16 of scratch for the luma's
// tile image. out: (batch, h, w) bf16. Two launches on `stream`; returns
// the first CUDA error code (0 when both were accepted).
extern "C" int ssw_luma_pass(const uint8_t* rgb, const uint8_t* base,
                             const __nv_bfloat16* basis, __nv_bfloat16* work,
                             long long work_elems, __nv_bfloat16* out,
                             int batch, int h, int w, cudaStream_t stream) {
  if (base != nullptr)
    return launch<Mode::kPair>(rgb, base, basis, work, work_elems, out, batch,
                               h, w, stream);
  return launch<Mode::kSingle>(rgb, nullptr, basis, work, work_elems, out,
                               batch, h, w, stream);
}

// High mode: rgb as above; basis: the tile image of the bf16x3 split of the
// f32 DCT-II basis of min(h, w), its hi part then its lo part; work: room
// for both parts of the luma's. out: (batch, h, w) bf16.
extern "C" int ssw_luma_pass_high(const uint8_t* rgb,
                                  const __nv_bfloat16* basis,
                                  __nv_bfloat16* work, long long work_elems,
                                  __nv_bfloat16* out, int batch, int h, int w,
                                  cudaStream_t stream) {
  return launch<Mode::kHigh>(rgb, nullptr, basis, work, work_elems, out,
                             batch, h, w, stream);
}
