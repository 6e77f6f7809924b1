// K6a/K6b: the whole-image 2-D DCT-II and its inverse, f32 in and out.
//
// Replaces the TPU kernels dct2_2d_fused and idct2_2d_fused
// (spread_spectrum_watermarking_tpu/ops/dct_pallas.py at fa94855,
// pallas_calls at :58 and :97). Both compute, per image of a batch,
//   Y = s * ((L @ X) @ R^T)
// with L the (H, H) and R the (W, W) basis (DCT-II for K6a, s = 1; the
// reference-scaled DCT-III for K6b, s = f32(4/(W*H))), in the association
// of the JAX package's dct2_2d/idct2_2d (ops/dct.py:139-140, :359-361): the
// first pass T = L @ X is rounded to f32 in a global workspace, the second
// Y = T @ R^T is rounded once, then scaled with one __fmul_rn.
//
// Arithmetic: 3xTF32 on the tensor cores. The TPU kernel's f32 dots ran on
// the MXU as passes of lower precision; this card's counterpart splits each
// f32 operand a into two TF32 parts, hi = rna(a) and lo = rna(a - hi)
// (rna: round to 10 explicit mantissa bits, ties away from zero, the low 13
// bits cleared; a - hi is exact), and sums lo_a hi_b + hi_a lo_b, then
// hi_a hi_b, small terms first (CUTLASS's OpMultiplyAddFastF32 order);
// lo_a lo_b is dropped. The split's error, per product: with |a - hi| <=
// 2^-11 |a| and |(a - hi) - lo| <= 2^-22 |a|,
//   |ab - (hi_a hi_b + hi_a lo_b + lo_a hi_b)|
//     <= |lo_a lo_b| + |hi_a + lo_a| |e_b| + |e_a| |hi_b + lo_b|
//     <= 3 * 2^-22 (1 + 2^-10) |a| |b| = 12 (1 + 2^-10) u |a| |b|,
// u = 2^-24: at most 12.02 u per pass, 24.03 u for the two, rounded up to
// 25 u |L| |X| |R|^T. That is K6's split term (kernels/dct2d_fused.py,
// SPLIT_TERMS) beside the 2 (H + W) u of two f32 sums taken in another
// order than cuBLAS's. The products of TF32 parts are exact in the tensor
// cores, but their f32 accumulation does not round to nearest: summed
// there over the whole k range, K6a erred by 139 and K6b by 715 units of
// u |L| |X| |R|^T against an f64 product, where cuBLAS's f32 pair errs by
// 25 and 38 (48x1080x1920 planes in [0, 1), H100 SXM at 700 W,
// scripts/k6_ab.py and chip_smoke.py). So each stage's sum (k-depth 32,
// twelve tensor-core products) starts from zero and is added to the
// output's f32 sum with one __fadd_rn on the CUDA cores: 6.4 and 10.4
// units, for 2.5% of the time.
// The bases are split once on the host (kernels/dct2d_fused.py, cached);
// X (pass 1) and T (pass 2) are split in registers as they leave shared
// memory, so T makes one f32 round trip through device memory.
//
// Bound on the H100: an image of 1080x1920 is H^2 W + H W^2 = 6.2e9
// multiply-adds, three tensor-core products each: 3.73e10 TF32 operations,
// 3.62 ms for a batch of 48 at the 495 TFLOP/s dense TF32 peak, against
// 0.8 GB of f32 in and out (0.24 ms); the tensor-core rate is the roof.
//
// Design: two launches a call, one per pass, each a tiled product over
// (image, 128-row tile, 128-column tile) of its output, so a 2x2160x3840
// call has 1020 blocks a pass and 48x1080x1920 has 6480 for 132 SMs. Both
// passes are one kernel on wgmma (sm_90a): two warpgroups, 64 x 128
// outputs each, three wgmma.m64n128k8.tf32 per k-step of 8.
// wgmma.tf32 reads B from shared memory only K-major (the transpose bits
// are for 16-bit types), and A from registers or K-major shared memory.
// The split operand (X or T) goes from registers, split as its fragments
// leave shared memory, so its hi/lo parts never reach shared or device
// memory; the basis's two planes go as B, K-major in wgmma's 128-byte
// swizzled layout (R[n][k] is K-major for pass 2, L[n][k] for pass 1).
// Pass 2 (Y = T @ R^T): A(m, k) = T[m][k], B(k, n) = R[n][k].
// Pass 1 runs transposed, T^T = X^T @ L^T: A(m, k) = X[k][m], read by hand
// from X's tile as staged (n-contiguous: no layout rule for registers),
// B(k, n) = L[n][k]; its epilogue writes T[n][m].
// A ring of three shared-memory stages of k-depth 32 is fed by cp.async
// (fence.proxy.async before wgmma reads them): the copies of stage k+2 are
// issued while the tensor cores work on stage k, and each k-step's
// products are issued as soon as its fragment is split. Each stage's
// products are waited for before their sum is added (the per-stage sums
// above), so a warpgroup's wgmma run 12 at a time. One block per SM
// (151 KB of shared memory; 214 and 228 registers a thread, no spills).
// Measured on the H100 SXM at 700 W (scripts/k6_ab.py, 48x1080x1920):
// 6.9 ms a call, where an mma.sync.m16n8k8 version took 10.8 (that
// instruction peaks at 321 TFLOP/s of TF32, 65% of the card's peak,
// scripts/mma_peak.py) and splitting only after all four fragments 8.0.
// The split, the swizzle and the wgmma wrappers live in csrc/tf32x3.cuh,
// which K9's first pass (csrc/highest_read.cu) shares.
//
// Ragged edges: rows are 16-byte copies (cp.async.cg with a zero-fill size)
// where the contiguous length is a multiple of 4 floats and the matrix
// starts 16-byte aligned; otherwise (W = 59, a view one float in) the same
// stages are filled by 4-byte cp.async.ca copies, in the same layouts.
// Outside the matrices the copies zero-fill, so products need no other
// masking; stores are masked. Every offset is 64-bit. Each output's sum
// runs over k in one fixed order (stages and k-steps ascending, three
// products each in the order above, each stage's sum added in turn) with
// no split-K, so results repeat bit for bit.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using ssw::tf32::cp16;
using ssw::tf32::cp4;
using ssw::tf32::cp_commit;
using ssw::tf32::cp_wait;
using ssw::tf32::fence_proxy_async;
using ssw::tf32::kRowFloats;
using ssw::tf32::smem_addr;
using ssw::tf32::split;
using ssw::tf32::sw128;
using ssw::tf32::sw128_desc;
using ssw::tf32::wgmma_commit;
using ssw::tf32::wgmma_fence;
using ssw::tf32::wgmma_n128;
using ssw::tf32::wgmma_wait_all;

constexpr int BM = 128;       // output rows of a tile
constexpr int BN = 128;       // output columns of a tile
constexpr int BK = 32;        // k-depth of a stage (one 128-byte row)
constexpr int STAGES = 3;     // the cp.async ring
constexpr int THREADS = 256;  // 2 warpgroups
constexpr int LDT = BK + 4;   // pitch of a k-contiguous A tile, floats
constexpr int LDX = BM + 8;   // pitch of an m-contiguous A tile, floats
constexpr int SWIZZLED = 0;   // the pitch argument for wgmma's layout

// A stage: the basis's parts (rows n, columns k) in wgmma's swizzled
// K-major layout, each 1024-byte aligned, and the A operand's tile (T's
// rows m, columns k, pitch LDT; or X's rows k, columns m, pitch LDX).
struct Stage {
  float b_hi[BN * BK];
  float b_lo[BN * BK];
  float a[BM * LDT];
};
static_assert(sizeof(Stage) % 1024 == 0, "stages keep the B tiles aligned");
static_assert(BK * LDX <= BM * LDT, "X's tile fits the A tile");
static_assert(BK == kRowFloats, "a stage's k-depth is one swizzled row");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Where element (r, k) of a k-contiguous tile of BK columns lies, in
// floats: rows of kPitch floats, or (kPitch == SWIZZLED) wgmma's K-major
// layout with the 128-byte swizzle: rows of BK floats (128 bytes), the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8).
template <int kPitch>
__device__ __forceinline__ int at_k(int r, int k) {
  if constexpr (kPitch == SWIZZLED)
    return sw128(r, k);
  else
    return r * kPitch + k;
}

// Rows r0 .. r0+kRows, columns k0 .. k0+BK of a row-major (rows, cols)
// matrix into dst at at_k<kPitch>(r, k), zero outside it. `vec`: cols % 4
// == 0 and p is 16-byte aligned, so every 16-byte run lies wholly in or
// out.
template <int kRows, int kPitch>
__device__ __forceinline__ void load_k(float* dst, const float* p, int rows,
                                       int cols, int r0, int k0, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kRows * BK / 4 / THREADS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int r = c / (BK / 4), k = (c % (BK / 4)) * 4;
      const int gr = r0 + r, gk = k0 + k;
      const bool in = gr < rows && gk < cols;
      cp16(dst + at_k<kPitch>(r, k), in ? p + size_t(gr) * cols + gk : p,
           in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kRows * BK / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / BK, k = e % BK;
      const int gr = r0 + r, gk = k0 + k;
      const bool in = gr < rows && gk < cols;
      cp4(dst + at_k<kPitch>(r, k), in ? p + size_t(gr) * cols + gk : p,
          in ? 4 : 0);
    }
  }
}

// Rows k0 .. k0+BK, columns m0 .. m0+BM of a row-major (rows, cols) matrix
// into dst[k * LDX + m], zero outside it; `vec` as for load_k.
__device__ __forceinline__ void load_m(float* dst, const float* p, int rows,
                                       int cols, int k0, int m0, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < BK * BM / 4 / THREADS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int k = c / (BM / 4), m = (c % (BM / 4)) * 4;
      const int gk = k0 + k, gm = m0 + m;
      const bool in = gk < rows && gm < cols;
      cp16(dst + k * LDX + m, in ? p + size_t(gk) * cols + gm : p,
           in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < BK * BM / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int k = e / BM, m = e % BM;
      const int gk = k0 + k, gm = m0 + m;
      const bool in = gk < rows && gm < cols;
      cp4(dst + k * LDX + m, in ? p + size_t(gk) * cols + gm : p, in ? 4 : 0);
    }
  }
}

struct Flags {
  bool vec_a, vec_b, vec_out;
};

// One pass over one image: out = scale * (A @ B), B(k, n) = basis[n][k]
// from the basis's TF32 parts b_hi, b_lo. Pass 1 (kPass1): A(m, k) =
// x[k][m] with m over W, n and k over H, out[n][m] = T; pass 2: A(m, k) =
// x[m][k] (x = T) with m over H, n and k over W, out[m][n] = Y. x, out:
// (batch, h, w) f32.
template <bool kPass1>
__global__ void __launch_bounds__(THREADS, 1)
pass_kernel(const float* __restrict__ x, const float* __restrict__ b_hi,
            const float* __restrict__ b_lo, float* __restrict__ out, int h,
            int w, float scale, Flags f) {
  extern __shared__ __align__(128) unsigned char smem[];
  // The B tiles need 1024-byte alignment; the launch adds 1024 bytes for it.
  Stage* st = reinterpret_cast<Stage*>(
      smem + ((1024 - (smem_addr(smem) & 1023)) & 1023));
  const int m_dim = kPass1 ? w : h, n_dim = kPass1 ? h : w;
  const int k_dim = kPass1 ? h : w;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const size_t img = size_t(blockIdx.z) * h * w;
  const float* xi = x + img;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int wm = (threadIdx.x / 32) * 16;  // this warp's 16 rows

  auto load = [&](Stage& s, int k0) {
    load_k<BN, SWIZZLED>(s.b_hi, b_hi, n_dim, k_dim, n0, k0, f.vec_b);
    load_k<BN, SWIZZLED>(s.b_lo, b_lo, n_dim, k_dim, n0, k0, f.vec_b);
    if (kPass1)
      load_m(s.a, xi, h, w, k0, m0, f.vec_a);
    else
      load_k<BM, LDT>(s.a, xi, h, w, m0, k0, f.vec_a);
  };

  // The output's f32 sums and the stage's sum on the tensor cores, in
  // wgmma's layout: [4j .. 4j+3] at rows m0 + wm + g (+8), columns
  // n0 + 8j + 2t (+1).
  float acc[64] = {};
  float part[64];
  const int ktiles = cdiv(k_dim, BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(st[s], s * BK);
    cp_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // stage kt landed; stage kt-1 is free to refill
    const Stage& s = st[kt % STAGES];
    const uint64_t desc_hi = sw128_desc(s.b_hi), desc_lo = sw128_desc(s.b_lo);
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int q = 0; q < BK / 8; ++q) {
      // This warp's A fragment of k-step q, split: (g, t), (g+8, t),
      // (g, t+4), (g+8, t+4) of its 16 rows and the step's 8 columns.
      const int m = wm + g, k = 8 * q + t;
      float v[4];
      if (kPass1) {
        const float* a = s.a + k * LDX + m;
        v[0] = a[0], v[1] = a[8], v[2] = a[4 * LDX], v[3] = a[4 * LDX + 8];
      } else {
        const float* a = s.a + m * LDT + k;
        v[0] = a[0], v[1] = a[8 * LDT], v[2] = a[4], v[3] = a[8 * LDT + 4];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split(v[e], ah[q][e], al[q][e]);
      // The step's products start while the next fragment is split. A
      // k-step of 8 is 32 bytes along the swizzled rows: 2 in the
      // descriptor's 16-byte units.
      wgmma_fence();
      wgmma_n128(part, al[q], desc_hi + 2 * q, q > 0);
      wgmma_n128(part, ah[q], desc_lo + 2 * q, 1);
      wgmma_n128(part, ah[q], desc_hi + 2 * q, 1);
    }
    wgmma_commit();
    // The next stage's copies are issued while the products run.
    const int next = kt + STAGES - 1;
    if (next < ktiles) load(st[next % STAGES], next * BK);
    cp_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }
  cp_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gm = m0 + wm + g + 8 * half;
    if (gm >= m_dim) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int gn = n0 + 8 * j + 2 * t;
      const float v0 = __fmul_rn(acc[4 * j + 2 * half], scale);
      const float v1 = __fmul_rn(acc[4 * j + 2 * half + 1], scale);
      if (kPass1) {  // T[n][m]
        float* dst = out + img + size_t(gn) * w + gm;
        if (gn < n_dim) dst[0] = v0;
        if (gn + 1 < n_dim) dst[w] = v1;
      } else {
        float* dst = out + img + size_t(gm) * w + gn;
        if (f.vec_out && gn + 1 < n_dim) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (gn < n_dim) dst[0] = v0;
          if (gn + 1 < n_dim) dst[1] = v1;
        }
      }
    }
  }
}

template <bool kPass1>
int launch(const float* x, const float* b_hi, const float* b_lo, float* out,
           int batch, int h, int w, float scale, Flags f, cudaStream_t stream) {
  const size_t smem = STAGES * sizeof(Stage) + 1024;
  auto kernel = pass_kernel<kPass1>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int m = kPass1 ? w : h, n = kPass1 ? h : w;
  const dim3 grid(cdiv(n, BN), cdiv(m, BM), batch);
  kernel<<<grid, THREADS, smem, stream>>>(x, b_hi, b_lo, out, h, w, scale, f);
  return int(cudaGetLastError());
}

}  // namespace

// x, work, out: (batch, h, w) f32, contiguous; left_hi/left_lo: the TF32
// parts of the (h, h) basis, right_hi/right_lo those of the (w, w) basis,
// row-major. out = scale * ((left @ x) @ right^T) per image, 3xTF32; work
// receives left @ x. Two launches on `stream`. Returns the first CUDA
// error code (0 when both launches were accepted).
extern "C" int ssw_dct2d_fused(const float* x, const float* left_hi,
                               const float* left_lo, const float* right_hi,
                               const float* right_lo, float* work, float* out,
                               int batch, int h, int w, float scale,
                               cudaStream_t stream) {
  // Pass 1 stores T column by column (its epilogue is transposed).
  const Flags f1{w % 4 == 0 && aligned(x, 16),
                 h % 4 == 0 && aligned(left_hi, 16) && aligned(left_lo, 16),
                 false};
  const int err = launch<true>(x, left_hi, left_lo, work, batch, h, w, 1.0f,
                               f1, stream);
  if (err != 0) return err;
  const Flags f2{w % 4 == 0 && aligned(work, 16),
                 w % 4 == 0 && aligned(right_hi, 16) && aligned(right_lo, 16),
                 w % 2 == 0 && aligned(out, 8)};
  return launch<false>(work, right_hi, right_lo, out, batch, h, w, scale, f2,
                       stream);
}
