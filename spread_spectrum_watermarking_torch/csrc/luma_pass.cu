// K1: u8 RGB -> luma -> one DCT-II pass over the shorter image axis.
//
// Replaces the TPU kernel luma_pass (spread_spectrum_watermarking_tpu/ops/
// fused_dct.py, pallas_call at :295, removed in b5b6c44), but computes what
// the JAX package's XLA code computes today: pipeline._half_pass at DEFAULT
// (single mode) and dct2_pass(luma_diff(base, derived)) in the read tail
// (pair mode). Rounding points follow that code as XLA compiles it on the
// CPU under jit, not the old kernel's folded integer-luma scale:
//   single: y = fma(b, 0.11f, fma(g, 0.59f, r * 0.30f)) with
//           c = u8 * f32(1/255) (the order XLA's CPU einsum sums in, and
//           the product XLA puts in place of u8 / 255; bit-equal over all
//           colours; c comes from a 256-entry table)
//   pair:   y = ((30 dR + 59 dG) + 11 dB) * f32(1/25500) (exact numerator;
//           XLA's product in place of the division)
// then y is rounded to bf16 (RNE), contracted with the bf16 DCT-II basis in
// f32 (tensor cores) and the sum is rounded to bf16. Every f32 op above is
// an explicit _rn intrinsic, so nvcc can neither fuse nor split it.
//
// Landscape (H <= W): out[k, w] = sum_h C[k, h] y[h, w]   (A = C, B = y)
// Portrait  (H >  W): out[h, l] = sum_w y[h, w] C[l, w]   (A = y, B = C^T)
//
// Bound on the H100: at 1080p one image is 2*1080*1080*1920 = 4.5 GFLOP
// against ~6 MB of u8 in and 4 MB of bf16 out, far above the card's
// ~295 FLOP/byte ridge, so the tensor-core rate is the roof. The design
// builds the luma operand from u8 while staging it into shared memory, so
// no luma plane reaches HBM; the price is that each block recomputes the
// luma of its k-steps, once per output-row tile (9 times at 1080p with
// 128-row tiles), which makes the prologue's integer and f32 work, not the
// tensor cores, the first limit of this version. Loads are 16-byte (basis)
// and 12-byte (4 pixels) where rows are aligned; wgmma, TMA and a
// strip-resident luma tile are later work.
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

template <bool kPair>
__device__ __forceinline__ __nv_bfloat16 luma_px(const uint8_t* p,
                                                 const uint8_t* q,
                                                 const float* lut) {
  float y;
  if (kPair) {
    const int d0 = int(p[0]) - int(q[0]);
    const int d1 = int(p[1]) - int(q[1]);
    const int d2 = int(p[2]) - int(q[2]);
    y = __fmul_rn(float((30 * d0 + 59 * d1) + 11 * d2), kInv25500);
  } else {
    y = __fmaf_rn(lut[p[2]], 0.11f,
                  __fmaf_rn(lut[p[1]], 0.59f, __fmul_rn(lut[p[0]], 0.30f)));
  }
  return __float2bfloat16_rn(y);
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

// bf16 luma of pixels px .. px+3 of one row with `avail` pixels left in it
// (zero past the end). `vec`: rows are 4-pixel aligned, so whole groups are
// read as three 4-byte words.
template <bool kPair>
__device__ __forceinline__ void luma4(const uint8_t* rgb, const uint8_t* base,
                                      const float* lut, size_t px, int avail,
                                      bool vec, __nv_bfloat16* out) {
  if (vec && avail >= 4) {
    uint8_t p[12], q[12];
    load12(rgb, px, p);
    if (kPair) load12(base, px, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = luma_px<kPair>(p + 3 * j, q + 3 * j, lut);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = j < avail
          ? luma_px<kPair>(rgb + 3 * (px + j),
                           kPair ? base + 3 * (px + j) : nullptr, lut)
          : ssw::bf16_zero();
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const __nv_bfloat16* v) {
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(v);
}

template <bool kPair, bool kLandscape>
__global__ void __launch_bounds__(THREADS)
luma_pass_kernel(const uint8_t* __restrict__ rgb,
                 const uint8_t* __restrict__ base,
                 const __nv_bfloat16* __restrict__ basis,
                 __nv_bfloat16* __restrict__ out, int h, int w) {
  extern __shared__ __align__(128) unsigned char smem[];
  ssw::TileSmem& s = *reinterpret_cast<ssw::TileSmem*>(smem);
  float* lut = reinterpret_cast<float*>(smem + sizeof(ssw::TileSmem));
  if (!kPair) {
    for (int i = threadIdx.x; i < 256; i += THREADS)
      lut[i] = __fmul_rn(float(i), kInv255);
    __syncthreads();
  }
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const size_t img = size_t(blockIdx.z) * h * w;
  const int kdim = kLandscape ? h : w;
  const bool vec8 = kdim % 8 == 0;  // basis rows 16-byte aligned
  const bool vec4 = w % 4 == 0;     // image rows 4-pixel aligned

  auto load = [&](__nv_bfloat16* a, __nv_bfloat16* b, int k0) {
    __align__(16) __nv_bfloat16 v[8];
    if (kLandscape) {
      // A = C rows m0.., columns k0..: 8-wide runs along k.
      for (int e = threadIdx.x; e < BM * BK / 8; e += THREADS) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int gm = m0 + r;
        if (gm < h) ssw::load8(basis + size_t(gm) * h, k0 + c, h, vec8, v);
        else for (int j = 0; j < 8; ++j) v[j] = ssw::bf16_zero();
        ssw::store8(a + r * LDA + c, v);
      }
      // B = y rows k0.., columns n0..: 4-pixel groups along w.
      for (int e = threadIdx.x; e < BK * BN / 4; e += THREADS) {
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const int gh = k0 + r, gw = n0 + c;
        if (gh < h)
          luma4<kPair>(rgb, base, lut, img + size_t(gh) * w + gw, w - gw,
                       vec4, v);
        else for (int j = 0; j < 4; ++j) v[j] = ssw::bf16_zero();
        store4(b + r * LDB + c, v);
      }
    } else {
      // A = y rows m0.., columns k0..: 4-pixel groups along w.
      for (int e = threadIdx.x; e < BM * BK / 4; e += THREADS) {
        const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
        const int gh = m0 + r, gw = k0 + c;
        if (gh < h)
          luma4<kPair>(rgb, base, lut, img + size_t(gh) * w + gw, w - gw,
                       vec4, v);
        else for (int j = 0; j < 4; ++j) v[j] = ssw::bf16_zero();
        store4(a + r * LDA + c, v);
      }
      // B[kk][l] = C[n0 + l][k0 + kk]: 8-wide runs along k, transposed.
      for (int e = threadIdx.x; e < BN * BK / 8; e += THREADS) {
        const int l = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int gl = n0 + l;
        if (gl < w) ssw::load8(basis + size_t(gl) * w, k0 + c, w, vec8, v);
        else for (int j = 0; j < 8; ++j) v[j] = ssw::bf16_zero();
#pragma unroll
        for (int j = 0; j < 8; ++j) b[(c + j) * LDB + l] = v[j];
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

template <bool kPair, bool kLandscape>
cudaError_t launch(const uint8_t* rgb, const uint8_t* base,
                   const __nv_bfloat16* basis, __nv_bfloat16* out, int batch,
                   int h, int w, cudaStream_t stream) {
  const size_t smem = sizeof(ssw::TileSmem) + (kPair ? 0 : 256 * sizeof(float));
  auto kernel = luma_pass_kernel<kPair, kLandscape>;
  const cudaError_t err = ssw::set_smem_limit(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ssw::cdiv(w, BN), ssw::cdiv(h, BM), batch);
  kernel<<<grid, THREADS, smem, stream>>>(rgb, base, basis, out, h, w);
  return cudaGetLastError();
}

}  // namespace

// rgb, base: (batch, h, w, 3) u8, contiguous; base may be null (single
// mode). basis: the bf16 DCT-II basis of min(h, w). out: (batch, h, w) bf16.
// Returns the launch's CUDA error code (0 when it was accepted).
extern "C" int ssw_luma_pass(const uint8_t* rgb, const uint8_t* base,
                             const __nv_bfloat16* basis, __nv_bfloat16* out,
                             int batch, int h, int w, cudaStream_t stream) {
  const bool landscape = h <= w;
  cudaError_t err;
  if (base != nullptr)
    err = landscape ? launch<true, true>(rgb, base, basis, out, batch, h, w, stream)
                    : launch<true, false>(rgb, base, basis, out, batch, h, w, stream);
  else
    err = landscape ? launch<false, true>(rgb, base, basis, out, batch, h, w, stream)
                    : launch<false, false>(rgb, base, basis, out, batch, h, w, stream);
  return int(err);
}
