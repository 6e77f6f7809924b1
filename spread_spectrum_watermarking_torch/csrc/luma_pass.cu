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
//           colours; c comes from a 256-entry table)
//   pair:   y = ((30 dR + 59 dG) + 11 dB) * f32(1/25500) (exact numerator;
//           XLA's product in place of the division)
// Single and pair mode round y to bf16 (RNE) and contract it with the bf16
// DCT-II basis. High mode keeps y in f32 and splits it as the TPU's bf16x3
// does: y_hi = bf16(y), y_lo = bf16(y - y_hi) (the subtraction is exact),
// with the basis split the same way on the host (C_hi, C_lo), and sums
// C_hi y_hi + C_hi y_lo + C_lo y_hi in one f32 accumulator. Every mode
// accumulates in f32 on the tensor cores and rounds the sum once to bf16:
// at HIGH the pipeline's only consumers (the second pass, rank_plane) cast
// the pass to bf16 first, so this is the same value at half the store.
// Every f32 op above is an explicit _rn intrinsic, so nvcc can neither fuse
// nor split it.
//
// Landscape (H <= W): out[k, w] = sum_h C[k, h] y[h, w]   (A = C, B = y)
// Portrait  (H >  W): out[h, l] = sum_w y[h, w] C[l, w]   (A = y, B = C^T)
//
// Bound on the H100: at 1080p one image is 2*1080*1080*1920 = 4.5 GFLOP
// (three times that at HIGH) against ~6 MB of u8 in and 4 MB of bf16 out,
// far above the card's ~295 FLOP/byte ridge, so the tensor-core rate is the
// roof. The design builds the luma operand from u8 while staging it into
// shared memory, so no luma plane reaches HBM; the price is that each block
// recomputes the luma of its k-steps, once per output-row tile (9 times at
// 1080p with 128-row tiles), which makes the prologue's integer and f32
// work, not the tensor cores, the first limit of this version. High mode
// stages hi and lo tiles of both operands (two stages of 37 KB and the
// 66 KB f32 tile: one block per SM) and issues three products per k-step.
// Loads are 16-byte (basis) and 12-byte (4 pixels) where rows are aligned;
// wgmma, TMA and a strip-resident luma tile are later work.
#include "tile_gemm.cuh"

namespace {

using ssw::BK;
using ssw::BM;
using ssw::BN;
using ssw::LDA;
using ssw::LDB;
using ssw::THREADS;

constexpr float kInv255 = 0x1.010102p-8f;      // f32(1 / 255)
constexpr float kInv25500 = 0x1.48f70cp-15f;  // f32(1 / 25500)

enum class Mode { kSingle, kPair, kHigh };

// Operand parts a stage holds: the hi/lo split at HIGH, one bf16 part else.
template <Mode kMode>
constexpr int kParts = kMode == Mode::kHigh ? 2 : 1;

template <Mode kMode>
__device__ __forceinline__ float luma_px(const uint8_t* p, const uint8_t* q,
                                         const float* lut) {
  if (kMode == Mode::kPair) {
    const int d0 = int(p[0]) - int(q[0]);
    const int d1 = int(p[1]) - int(q[1]);
    const int d2 = int(p[2]) - int(q[2]);
    return __fmul_rn(float((30 * d0 + 59 * d1) + 11 * d2), kInv25500);
  }
  return __fmaf_rn(lut[p[2]], 0.11f,
                   __fmaf_rn(lut[p[1]], 0.59f, __fmul_rn(lut[p[0]], 0.30f)));
}

// The 12 bytes of four pixels starting at pixel px (px % 4 == 0).
__device__ __forceinline__ void load12(const uint8_t* img, size_t px,
                                       uint8_t* out) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(img + 3 * px);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint32_t v = src[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) out[4 * i + j] = uint8_t(v >> (8 * j));
  }
}

// Luma of pixels px .. px+3 of one row with `avail` pixels left in it (zero
// past the end), as bf16 `hi` and, in high mode, the bf16 residual `lo`.
// `vec`: rows are 4-pixel aligned and the images 4-byte aligned, so whole
// groups are read as three 4-byte words.
template <Mode kMode>
__device__ __forceinline__ void luma4(const uint8_t* rgb, const uint8_t* base,
                                      const float* lut, size_t px, int avail,
                                      bool vec, __nv_bfloat16* hi,
                                      __nv_bfloat16* lo) {
  constexpr bool kPair = kMode == Mode::kPair;
  float y[4];
  if (vec && avail >= 4) {
    uint8_t p[12], q[12];
    load12(rgb, px, p);
    if (kPair) load12(base, px, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = luma_px<kMode>(p + 3 * j, q + 3 * j, lut);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = j < avail ? luma_px<kMode>(rgb + 3 * (px + j),
                                        kPair ? base + 3 * (px + j) : nullptr,
                                        lut)
                       : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    hi[j] = __float2bfloat16_rn(y[j]);
    if (kMode == Mode::kHigh)
      lo[j] = __float2bfloat16_rn(__fsub_rn(y[j], __bfloat162float(hi[j])));
  }
}

__device__ __forceinline__ bool aligned4(const uint8_t* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const __nv_bfloat16* v) {
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(v);
}

__device__ __forceinline__ void zero8(__nv_bfloat16* v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = ssw::bf16_zero();
}

// basis (and basis_lo in high mode): the bf16 DCT-II basis of min(h, w),
// row-major; basis_lo is unused in the other modes.
template <Mode kMode, bool kLandscape>
__global__ void __launch_bounds__(THREADS)
luma_pass_kernel(const uint8_t* __restrict__ rgb,
                 const uint8_t* __restrict__ base,
                 const __nv_bfloat16* __restrict__ basis,
                 const __nv_bfloat16* __restrict__ basis_lo,
                 __nv_bfloat16* __restrict__ out, int h, int w) {
  constexpr int kP = kParts<kMode>;
  using Smem = ssw::TileSmemT<kP>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  float* lut = reinterpret_cast<float*>(smem + sizeof(Smem));
  if (kMode != Mode::kPair) {
    for (int i = threadIdx.x; i < 256; i += THREADS)
      lut[i] = __fmul_rn(float(i), kInv255);
    __syncthreads();
  }
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const size_t img = size_t(blockIdx.z) * h * w;
  const int kdim = kLandscape ? h : w;
  const bool vec8 = kdim % 8 == 0;  // basis rows 16-byte aligned
  // Image rows 4-pixel aligned and the images 4-byte aligned: a u8 view
  // may start at any byte.
  const bool vec4 = w % 4 == 0 && aligned4(rgb) &&
                    (base == nullptr || aligned4(base));
  const __nv_bfloat16* parts[2] = {basis, basis_lo};

  auto load = [&](ssw::StageT<kP>& st, int k0) {
    __align__(16) __nv_bfloat16 v[8];
    __align__(16) __nv_bfloat16 lo[8];
    if (kLandscape) {
      // A = C rows m0.., columns k0..: 8-wide runs along k.
      for (int e = threadIdx.x; e < BM * BK / 8; e += THREADS) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int gm = m0 + r;
#pragma unroll
        for (int part = 0; part < kP; ++part) {
          if (gm < h) ssw::load8(parts[part] + size_t(gm) * h, k0 + c, h, vec8, v);
          else zero8(v);
          ssw::store8(st.a[part] + r * LDA + c, v);
        }
      }
      // B = y rows k0.., columns n0..: 4-pixel groups along w.
      for (int e = threadIdx.x; e < BK * BN / 4; e += THREADS) {
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const int gh = k0 + r, gw = n0 + c;
        if (gh < h) {
          luma4<kMode>(rgb, base, lut, img + size_t(gh) * w + gw, w - gw,
                       vec4, v, lo);
        } else {
          zero8(v);
          zero8(lo);
        }
        store4(st.b[0] + r * LDB + c, v);
        if (kP == 2) store4(st.b[kP - 1] + r * LDB + c, lo);
      }
    } else {
      // A = y rows m0.., columns k0..: 4-pixel groups along w.
      for (int e = threadIdx.x; e < BM * BK / 4; e += THREADS) {
        const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
        const int gh = m0 + r, gw = k0 + c;
        if (gh < h) {
          luma4<kMode>(rgb, base, lut, img + size_t(gh) * w + gw, w - gw,
                       vec4, v, lo);
        } else {
          zero8(v);
          zero8(lo);
        }
        store4(st.a[0] + r * LDA + c, v);
        if (kP == 2) store4(st.a[kP - 1] + r * LDA + c, lo);
      }
      // B[kk][l] = C[n0 + l][k0 + kk]: 8-wide runs along k, transposed.
      for (int e = threadIdx.x; e < BN * BK / 8; e += THREADS) {
        const int l = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int gl = n0 + l;
#pragma unroll
        for (int part = 0; part < kP; ++part) {
          if (gl < w) ssw::load8(parts[part] + size_t(gl) * w, k0 + c, w, vec8, v);
          else zero8(v);
#pragma unroll
          for (int j = 0; j < 8; ++j) st.b[part][(c + j) * LDB + l] = v[j];
        }
      }
    }
  };
  ssw::tile_product(s, kdim, load);

  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < h && gn < w)
      out[img + size_t(gm) * w + gn] = __float2bfloat16_rn(s.c[r * ssw::LDC + c]);
  }
}

template <Mode kMode, bool kLandscape>
cudaError_t launch(const uint8_t* rgb, const uint8_t* base,
                   const __nv_bfloat16* basis, const __nv_bfloat16* basis_lo,
                   __nv_bfloat16* out, int batch, int h, int w,
                   cudaStream_t stream) {
  const size_t smem = sizeof(ssw::TileSmemT<kParts<kMode>>)
      + (kMode == Mode::kPair ? 0 : 256 * sizeof(float));
  auto kernel = luma_pass_kernel<kMode, kLandscape>;
  const cudaError_t err = ssw::set_smem_limit(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ssw::cdiv(w, BN), ssw::cdiv(h, BM), batch);
  kernel<<<grid, THREADS, smem, stream>>>(rgb, base, basis, basis_lo, out, h, w);
  return cudaGetLastError();
}

template <Mode kMode>
int launch_oriented(const uint8_t* rgb, const uint8_t* base,
                    const __nv_bfloat16* basis, const __nv_bfloat16* basis_lo,
                    __nv_bfloat16* out, int batch, int h, int w,
                    cudaStream_t stream) {
  const cudaError_t err =
      h <= w ? launch<kMode, true>(rgb, base, basis, basis_lo, out, batch, h, w, stream)
             : launch<kMode, false>(rgb, base, basis, basis_lo, out, batch, h, w, stream);
  return int(err);
}

}  // namespace

// rgb, base: (batch, h, w, 3) u8, contiguous; base may be null (single
// mode). basis: the bf16 DCT-II basis of min(h, w). out: (batch, h, w) bf16.
// Returns the launch's CUDA error code (0 when it was accepted).
extern "C" int ssw_luma_pass(const uint8_t* rgb, const uint8_t* base,
                             const __nv_bfloat16* basis, __nv_bfloat16* out,
                             int batch, int h, int w, cudaStream_t stream) {
  if (base != nullptr)
    return launch_oriented<Mode::kPair>(rgb, base, basis, nullptr, out, batch,
                                        h, w, stream);
  return launch_oriented<Mode::kSingle>(rgb, nullptr, basis, nullptr, out,
                                        batch, h, w, stream);
}

// High mode: rgb as above; basis_hi, basis_lo: the bf16x3 split of the f32
// DCT-II basis of min(h, w). out: (batch, h, w) bf16.
extern "C" int ssw_luma_pass_high(const uint8_t* rgb,
                                  const __nv_bfloat16* basis_hi,
                                  const __nv_bfloat16* basis_lo,
                                  __nv_bfloat16* out, int batch, int h, int w,
                                  cudaStream_t stream) {
  return launch_oriented<Mode::kHigh>(rgb, nullptr, basis_hi, basis_lo, out,
                                      batch, h, w, stream);
}
