// K6a/K6b: the whole-image 2-D DCT-II and its inverse, in f32.
//
// Replaces the TPU kernels dct2_2d_fused and idct2_2d_fused
// (spread_spectrum_watermarking_tpu/ops/dct_pallas.py at fa94855,
// pallas_calls at :58 and :97). Both compute, per image of a batch,
//   Y = s * ((L @ X) @ R^T)
// with L the (H, H) and R the (W, W) basis (DCT-II for K6a, s = 1; the
// reference-scaled DCT-III for K6b, s = f32(4/(W*H))), in the association
// of the JAX package's dct2_2d/idct2_2d (ops/dct.py:139-140, :359-361), so
// the two roundings of T = L @ X and of Y fall where the JAX code puts
// them. Precision.HIGHEST is full f32: every product and sum is an f32
// __fmaf_rn on the CUDA cores; no TF32 and no tensor cores.
//
// Bound on the H100: at 1080x1920 an image is 2*(H^2 W + H W^2) = 12.4
// GFLOP against 16.6 MB of f32 in and out, so the f32 rate bounds it
// (67 TFLOP/s on the data sheet: about 9 ms for a batch of 48).
//
// Design: one block owns BM = 128 output rows of one image and computes
// both passes for them. Pass 1 writes its T strip (128 x W) to a global
// workspace the wrapper allocates (at 128 rows the strip does not fit in
// shared memory), pass 2 reads it back after a barrier; the strip is the
// block's own, so no other block waits on it, and its round trip is a few
// percent of the bytes of X and the bases that the passes stream. Each pass
// is a classic f32 tile product: 128x128 output tiles, k-steps of 8, two
// shared-memory stages (the next k-step's global loads are issued before
// this one's products), an 8x8 register tile per thread laid out as four
// 4x4 quads so that shared-memory reads are conflict-free 16-byte loads.
// Every output's sum runs over k in one fixed order, so results repeat bit
// for bit. Blocks are ordered image-major, so the blocks in flight share
// their images' X and the bases in L2. Loads zero-fill outside the
// matrices, so ragged edges (H = 1080, 37 x 59) need no other masking, and
// every offset is 64-bit. Later work: 3xTF32 on the tensor cores, TMA.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;   // output rows of a tile (and of a block)
constexpr int BN = 128;   // output columns of a tile
constexpr int BK = 8;     // k-step
constexpr int THREADS = 256;
constexpr int LDS = BM + 4;  // shared pitch in floats: 16-byte rows

struct __align__(16) Smem {
  float a[2][BK][LDS];  // k-major: a[k][row]
  float b[2][BK][LDS];  // k-major: b[k][col]
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A 128 x 8 tile of a matrix whose element (i, k) lies at p[i * ld + k],
// i < ni, k < nk: each thread fetches four consecutive k of one i.
struct KContig {
  const float* p;
  int ld, ni, nk, i, k, row;
  bool vec;
  __device__ KContig(const float* p_, int ld_, int ni_, int nk_, int i0)
      : p(p_), ld(ld_), ni(ni_), nk(nk_) {
    i = threadIdx.x / 2;
    k = (threadIdx.x % 2) * 4;
    row = i0 + i;
    vec = ld % 4 == 0 && aligned16(p);
  }
  __device__ __forceinline__ void fetch(int k0, float v[4]) const {
    const int gk = k0 + k;
    if (row >= ni) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = 0.0f;
      return;
    }
    const float* src = p + size_t(row) * ld + gk;
    if (vec && gk + 4 <= nk) {
      const float4 q = *reinterpret_cast<const float4*>(src);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = gk + j < nk ? src[j] : 0.0f;
    }
  }
  __device__ __forceinline__ void put(float (*s)[LDS], const float v[4]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[k + j][i] = v[j];
  }
};

// An 8 x 128 tile of a matrix whose element (k, j) lies at p[k * ld + j],
// k < nk, j < nj: each thread fetches four consecutive j of one k.
struct JContig {
  const float* p;
  int ld, nk, nj, k, j, col;
  bool vec;
  __device__ JContig(const float* p_, int ld_, int nk_, int nj_, int j0)
      : p(p_), ld(ld_), nk(nk_), nj(nj_) {
    k = threadIdx.x / 32;
    j = (threadIdx.x % 32) * 4;
    col = j0 + j;
    vec = ld % 4 == 0 && aligned16(p);
  }
  __device__ __forceinline__ void fetch(int k0, float v[4]) const {
    const int gk = k0 + k;
    if (gk >= nk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = 0.0f;
      return;
    }
    const float* src = p + size_t(gk) * ld + col;
    if (vec && col + 4 <= nj) {
      const float4 q = *reinterpret_cast<const float4*>(src);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = col + e < nj ? src[e] : 0.0f;
    }
  }
  __device__ __forceinline__ void put(float (*s)[LDS], const float v[4]) const {
    *reinterpret_cast<float4*>(&s[k][j]) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// acc += A (128 x kdim) @ B (kdim x 128) for this thread's 8x8 outputs:
// rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise with tx.
template <class LA, class LB>
__device__ __forceinline__ void tile_product(Smem& s, int kdim, const LA& la,
                                             const LB& lb, float acc[8][8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  float va[4], vb[4];
  la.fetch(0, va);
  lb.fetch(0, vb);
  la.put(s.a[0], va);
  lb.put(s.b[0], vb);
  __syncthreads();
  int cur = 0;
  for (int k0 = 0; k0 < kdim; k0 += BK) {
    const bool more = k0 + BK < kdim;
    if (more) {
      la.fetch(k0 + BK, va);
      lb.fetch(k0 + BK, vb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float fa[8], fb[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.a[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.b[cur][kk][64 + tx * 4]);
      fa[0] = a0.x; fa[1] = a0.y; fa[2] = a0.z; fa[3] = a0.w;
      fa[4] = a1.x; fa[5] = a1.y; fa[6] = a1.z; fa[7] = a1.w;
      fb[0] = b0.x; fb[1] = b0.y; fb[2] = b0.z; fb[3] = b0.w;
      fb[4] = b1.x; fb[5] = b1.y; fb[6] = b1.z; fb[7] = b1.w;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = __fmaf_rn(fa[r], fb[c], acc[r][c]);
    }
    if (more) {
      // The other stage was last read before the previous barrier.
      la.put(s.a[cur ^ 1], va);
      lb.put(s.b[cur ^ 1], vb);
    }
    __syncthreads();
    cur ^= 1;
  }
}

// out[r, c] = scale * acc for this thread's outputs of the tile at (r0, c0)
// of a (rows, cols) row-major matrix; nothing outside it is written.
__device__ __forceinline__ void store_tile(float* out, int rows, int cols,
                                           int r0, int c0, const float acc[8][8],
                                           float scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool vec = cols % 4 == 0 && aligned16(out);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gr = r0 + (r < 4 ? 0 : 64) + ty * 4 + (r % 4);
    if (gr >= rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gc = c0 + half * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(acc[r][half * 4 + j], scale);
      float* dst = out + size_t(gr) * cols + gc;
      if (vec && gc + 4 <= cols) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < cols) dst[j] = v[j];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
dct2d_kernel(const float* __restrict__ x, const float* __restrict__ left,
             const float* __restrict__ right, float* work, float* out, int h,
             int w, float scale) {
  __shared__ Smem s;
  const int r0 = blockIdx.x * BM;
  const size_t img = size_t(blockIdx.y) * h * w;
  float acc[8][8];
  // Pass 1: T[r0 : r0+BM, :] = L[r0 : r0+BM, :] @ X, contracting H.
  for (int n0 = 0; n0 < w; n0 += BN) {
    tile_product(s, h, KContig(left, h, h, h, r0),
                 JContig(x + img, w, h, w, n0), acc);
    store_tile(work + img, h, w, r0, n0, acc, 1.0f);
  }
  __syncthreads();  // the block's T strip is visible to all its threads
  // Pass 2: Y[r0 : r0+BM, :] = T[r0 : r0+BM, :] @ R^T, contracting W; the
  // B operand's element (k, l) is R[l, k].
  for (int l0 = 0; l0 < w; l0 += BN) {
    tile_product(s, w, KContig(work + img, w, h, w, r0),
                 KContig(right, w, w, w, l0), acc);
    store_tile(out + img, h, w, r0, l0, acc, scale);
  }
}

}  // namespace

// x, work, out: (batch, h, w) f32, contiguous; left: (h, h) and right:
// (w, w) f32 bases, row-major. out = scale * ((left @ x) @ right^T) per
// image; work receives left @ x. Returns the launch's CUDA error code (0
// when it was accepted).
extern "C" int ssw_dct2d_fused(const float* x, const float* left,
                               const float* right, float* work, float* out,
                               int batch, int h, int w, float scale,
                               cudaStream_t stream) {
  const dim3 grid(cdiv(h, BM), batch);
  dct2d_kernel<<<grid, THREADS, 0, stream>>>(x, left, right, work, out, h, w,
                                             scale);
  return int(cudaGetLastError());
}
