// K9: the HIGHEST read. The 2-D DCT-II of an f32 luma plane at n flat
// indices an image, without the full first pass.
//
// Replaces no pallas_call: the JAX package leaves this stage to XLA
// (spread_spectrum_watermarking_tpu/ops/dct.py:256-302, dct2_coeffs_at,
// called at models/pipeline.py:513 and :700: one f32 pass over the shorter
// axis, then a gather-dot). Its plain version is the port's
// ops/dct.dct2_coeffs_at (kernels/highest_read.py, highest_read_reference).
// In landscape (H <= W), with r_i = idx_i / W and c_i = idx_i % W:
//   D[a][w]  = sum_h C_h[a, h] y[h, w]        (for the listed rows a only)
//   num[i]   = sum_w D[r_i][w] C_w[c_i, w]
// portrait (H > W) is the mirror: D[a][h] = sum_w y[h, w] C_w[a, w] and
// num[i] = sum_h C_h[r_i, h] D[c_i][h]. Both are one form here, with S the
// shorter side, L the longer, a_i the index's coordinate along S and b_i
// along L: D[a][l] = sum_s C_S[a, s] y(s, l), num[i] = sum_l D[a_i][l]
// C_L[b_i, l].
//
// Arithmetic: the first pass is K6a's 3xTF32 (csrc/dct2d_fused.cu, the
// split of both operands, three tensor-core products, each k-step's sum
// added in f32 with __fadd_rn), which stands for the TPU's multi-pass
// HIGHEST products in the port and lies closer to an f64 product than
// cuBLAS's f32 pass (its rows D: 13-18 against 33-51 units of 2^-24
// sum_s |C_S y|; the read: 0.25-0.47 against 0.61-1.51 units). The dots
// are f32: __fmaf_rn products and sums in one fixed order.
// kernels/highest_read.py, k9_bound, is the tolerance against the plain
// version.
//
// Bound on the H100: one row of the first pass per distinct (image, a_i),
// 2 S L multiply-adds, three tensor-core products each, and 2 L per index
// for the dots; it must read the f32 luma. At 48x1080x1920, n = 1000 the
// harness's random u8 needs about 30,800 rows (383 GFLOP of TF32, 0.77 ms
// at 495 TFLOP/s: operations bound it), 1/f textures about 2,700 (34
// GFLOP, 0.07 ms, against 398 MB of luma in, 0.12 ms: bytes bound it);
// chip_smoke.py's K9 phase counts the rows of its run.
//
// Design: three launches.
//   1. compact_kernel (csrc/compact_rows.cuh, shared with K5), one block an
//      image: the image's count of distinct rows, their ascending list and
//      each index's slot. An index outside [0, H W) fails an assert.
//   2. K6a's pass_kernel in its row-list form (ssw_dct2d_pass_rows): the
//      basis rows come through the list, only the n tiles that hold listed
//      rows run, and slot j's row D[j] is stored L floats long. Scratch
//      holds min(n, S) rows an image, so the host never reads a count.
//   3. dot_kernel, one warp an index: num[i] = sum_l D[slot_i][l]
//      C_L[b_i, l], lane q over the 16-byte chunks l = 4 (q + 32 k) + e,
//      one f32 __fmaf_rn chain per e with k ascending, then (s0 + s1) +
//      (s2 + s3), then the lanes by the xor shuffles 16, 8, 4, 2, 1.
// Every f32 operation is an explicit _rn intrinsic or a tensor-core
// product of K6a's, and every sum has one fixed order, so a result repeats
// bit for bit and an image's result does not depend on the batch it sits
// in (Writer and Reader agree, models/pipeline.py). No float atomics. The
// largest store is D, min(n, S) rows of L floats an image: at 48x1080x1920
// 369 MB, where the plain route writes the 398 MB first pass and two
// 369 MB gathers.
#include "compact_rows.cuh"

// csrc/dct2d_fused.cu: K6a's pass in its row-list form.
extern "C" int ssw_dct2d_pass_rows(const float* y, const float* s_hi,
                                   const float* s_lo, int s_pitch,
                                   const int* count, const int* list, int cap,
                                   float* d, int d_pitch, int batch, int h,
                                   int w, cudaStream_t stream);

namespace {

using ssw::rows::compact_kernel;
using ssw::rows::kCompactSmem;
using ssw::rows::kCompactThreads;

constexpr int kDotThreads = 256;  // 8 warps, one index each

// Warp e = (image, i): out[e] = sum_l D[slot_e][l] C_L[b_i, l] over l < L,
// D's row and C_L's row `pitch` floats apart (pitch a multiple of 4, both
// 16-byte aligned). Lane q takes the chunks k = q, q + 32, ... of 4
// columns: s[e] = fma(D, C, s[e]) over k ascending for each column e of a
// chunk (columns at or past L skipped), then (s0 + s1) + (s2 + s3), then
// the lanes by xor shuffles 16, 8, 4, 2, 1.
__global__ void __launch_bounds__(kDotThreads)
dot_kernel(const long long* __restrict__ idx, long long idx_stride,
           const float* __restrict__ basis_l, const float* __restrict__ d,
           const int* __restrict__ slots, float* __restrict__ out, int n,
           int h, int w, int cap, int pitch, long long total) {
  const long long e =
      (long long)blockIdx.x * (kDotThreads / 32) + threadIdx.x / 32;
  if (e >= total) return;
  const int lane = threadIdx.x % 32;
  const int l = h <= w ? w : h;
  const long long image = e / n, i = e % n;
  // In range: compact_kernel's assert stops the call at any other index.
  const long long id = idx[image * idx_stride + i];
  const int b = h <= w ? int(id % w) : int(id / w);
  const float4* dr = reinterpret_cast<const float4*>(
      d + (image * cap + slots[e]) * (long long)pitch);
  const float4* cr =
      reinterpret_cast<const float4*>(basis_l + (long long)b * pitch);
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = lane; 4 * k < l; k += 32) {
    const float4 dv = dr[k], cv = cr[k];
    const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
    const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * k + j < l) s[j] = __fmaf_rn(dd[j], cc[j], s[j]);
  }
  float v = __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) out[e] = v;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// y: (batch, h, w) f32 luma, contiguous; idx: int64, n flat indices an
// image, image i's at idx + i * idx_stride (idx_stride 0: one set for
// every image); s_hi, s_lo: the TF32 parts of the f32 DCT-II basis of S =
// min(h, w), (S, s_pitch) row-major, zeros past S; basis_l: the f32 DCT-II
// basis of L = max(h, w), (L, l_pitch) row-major, zeros past L; both
// pitches multiples of 4, every pointer 16-byte aligned; d: scratch of
// d_elems f32, at least batch * min(n, S) * l_pitch; meta: scratch of
// meta_elems int32, at least batch * (1 + min(n, S) + n) (each image's
// count, then the lists, then the slots); out: (batch, n) f32. Three
// launches on `stream`; returns the first CUDA error code (0 when all
// were accepted).
extern "C" int ssw_highest_read(const float* y, const long long* idx,
                                long long idx_stride, const float* s_hi,
                                const float* s_lo, int s_pitch,
                                const float* basis_l, int l_pitch, float* d,
                                long long d_elems, int* meta,
                                long long meta_elems, float* out, int batch,
                                int h, int w, int n, cudaStream_t stream) {
  const int s = h <= w ? h : w, l = h <= w ? w : h;
  const int cap = n < s ? n : s;
  if (d_elems < (long long)batch * cap * l_pitch ||
      meta_elems < (long long)batch * (1 + cap + n) || l_pitch < l ||
      l_pitch % 4 != 0 || s_pitch < s || s_pitch % 4 != 0 ||
      !aligned16(basis_l) || !aligned16(d))
    return int(cudaErrorInvalidValue);
  if (batch == 0 || n == 0) return int(cudaSuccess);
  int* count = meta;
  int* list = meta + batch;
  int* slots = list + (long long)batch * cap;

  const size_t smem = ssw::rows::compact_smem(s);
  if (smem > kCompactSmem) return int(cudaErrorInvalidValue);
  compact_kernel<<<batch, kCompactThreads, smem, stream>>>(
      idx, idx_stride, n, h, w, s, cap, count, list, slots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int code = ssw_dct2d_pass_rows(y, s_hi, s_lo, s_pitch, count, list,
                                       cap, d, l_pitch, batch, h, w, stream);
  if (code != 0) return code;

  const long long total = (long long)batch * n;
  const long long blocks = (total + kDotThreads / 32 - 1) / (kDotThreads / 32);
  dot_kernel<<<unsigned(blocks), kDotThreads, 0, stream>>>(
      idx, idx_stride, basis_l, d, slots, out, n, h, w, cap, l_pitch, total);
  return int(cudaGetLastError());
}
