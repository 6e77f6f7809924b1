// K4: the fused embed epilogue. Sparse inverse DCT of the coefficient
// update, added to the u8 image, quantized to u8; dY never reaches HBM.
//
// Replaces the TPU kernel embed_epilogue (spread_spectrum_watermarking_tpu/
// ops/fused_dct.py, pallas_call at :446, removed in 6b7c109) and computes
// what the JAX package's XLA code computes today:
//   dY = bf16( sum_k a[k, h] * b[k, w] )            (pipeline._sparse_idct_delta)
//   out[h, w, c] = clamp(floor((u8 + 255 * f32(dY)) + 0.5), 0, 255)
//                                                  (colorspace.add_luma_delta_u8)
// with a = bf16((4/(W*H)) * D_h[:, rows] * delta) and b = bf16(D_w[:, cols]),
// built by the Python wrapper and stored k-major: a is (n, H), b is (n, W)
// per image, so gathering basis rows writes them contiguously. The f32
// epilogue ops are explicit _rn intrinsics so nvcc cannot fuse them into
// FMAs, which would round differently from the reference.
//
// Bound on the H100: at 1080p and n = 1000 one image is 2*1080*1920*1000
// = 4.1 GFLOP against ~4 MB of factors and 12 MB of u8 in and out, so the
// tensor-core rate bounds it. The design keeps the (H, W) delta plane in
// shared memory and applies it to the three channels in the same block.
// This version double-buffers 128x128 wmma tiles with 16-byte loads;
// gathering the basis rows inside the kernel, TMA and wgmma are later work.
#include "tile_gemm.cuh"

namespace {

using ssw::BK;
using ssw::BM;
using ssw::BN;
using ssw::LDA;
using ssw::LDB;
using ssw::THREADS;

__global__ void __launch_bounds__(THREADS)
embed_epilogue_kernel(const uint8_t* __restrict__ rgb,
                      const __nv_bfloat16* __restrict__ fa,
                      const __nv_bfloat16* __restrict__ fb,
                      uint8_t* __restrict__ out, int h, int w, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  ssw::TileSmem& s = *reinterpret_cast<ssw::TileSmem*>(smem);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const size_t img = size_t(blockIdx.z) * h * w;
  const __nv_bfloat16* ga = fa + size_t(blockIdx.z) * n * h;
  const __nv_bfloat16* gb = fb + size_t(blockIdx.z) * n * w;
  const bool vec_h = h % 8 == 0;  // factor rows 16-byte aligned
  const bool vec_w = w % 8 == 0;

  auto load = [&](ssw::Stage& st, int k0) {
    __nv_bfloat16* a = st.a;
    __nv_bfloat16* b = st.b;
    __align__(16) __nv_bfloat16 v[8];
    // A[r][c] = a[k0 + c][m0 + r]: 8-wide runs along h, transposed.
    for (int e = threadIdx.x; e < BK * BM / 8; e += THREADS) {
      const int c = e / (BM / 8), r = (e % (BM / 8)) * 8;
      const int gk = k0 + c;
      if (gk < n) ssw::load8(ga + size_t(gk) * h, m0 + r, h, vec_h, v);
      else for (int j = 0; j < 8; ++j) v[j] = ssw::bf16_zero();
#pragma unroll
      for (int j = 0; j < 8; ++j) a[(r + j) * LDA + c] = v[j];
    }
    // B[r][c] = b[k0 + r][n0 + c]: 8-wide runs along w.
    for (int e = threadIdx.x; e < BK * BN / 8; e += THREADS) {
      const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
      const int gk = k0 + r;
      if (gk < n) ssw::load8(gb + size_t(gk) * w, n0 + c, w, vec_w, v);
      else for (int j = 0; j < 8; ++j) v[j] = ssw::bf16_zero();
      ssw::store8(b + r * LDB + c, v);
    }
  };
  ssw::tile_product(s, n, load);

  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= h || gn >= w) continue;
    const float dy = __bfloat162float(__float2bfloat16_rn(s.c[r * ssw::LDC + c]));
    const float df = __fmul_rn(dy, 255.0f);
    const size_t px = 3 * (img + size_t(gm) * w + gn);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float v = floorf(__fadd_rn(__fadd_rn(float(rgb[px + ch]), df), 0.5f));
      v = fminf(fmaxf(v, 0.0f), 255.0f);
      out[px + ch] = uint8_t(v);
    }
  }
}

}  // namespace

// rgb, out: (batch, h, w, 3) u8, contiguous. fa: (batch, n, h) bf16;
// fb: (batch, n, w) bf16. Returns the launch's CUDA error code (0 when it
// was accepted).
extern "C" int ssw_embed_epilogue(const uint8_t* rgb, const __nv_bfloat16* fa,
                                  const __nv_bfloat16* fb, uint8_t* out,
                                  int batch, int h, int w, int n,
                                  cudaStream_t stream) {
  const size_t smem = sizeof(ssw::TileSmem);
  cudaError_t err = ssw::set_smem_limit(embed_epilogue_kernel, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(ssw::cdiv(w, BN), ssw::cdiv(h, BM), batch);
  embed_epilogue_kernel<<<grid, THREADS, smem, stream>>>(rgb, fa, fb, out, h,
                                                         w, n);
  return int(cudaGetLastError());
}

// The message for a code the entry points above return.
extern "C" const char* ssw_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
