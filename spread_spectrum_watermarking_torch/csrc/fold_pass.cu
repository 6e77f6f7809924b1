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
// on the host, and C_hi v_hi + C_hi v_lo + C_lo v_hi summed in one f32
// accumulator (lo*lo dropped, as the TPU drops it). The output is f32 in
// true row and column order: the second pass folds the f32 intermediate.
//
// Rows (contract H): out[2q+p, w] = sum_m c_p[q, m] v_p[m, w]  (A = ce|co; B = s, d)
// Cols (contract W): out[h, 2l+p] = sum_m v_p[h, m] c_p[l, m]  (A = s, d; B = (ce|co)^T)
// One block computes both parities of the same q (or l) range
// (ssw::kSplitB, ssw::kSplitA): its 128-row (128-column) tile holds 64 even
// and 64 odd outputs, so the interleaved stores of the cols orientation
// write 128 contiguous floats a row. The mirrored operand of the cols
// orientation is read as 16-byte vectors and reversed in registers.
//
// Bound on the H100: at 48x1080x1920 the rows pass does 2*48*2*540*540*1920
// = 1.07e11 operations at DEFAULT (3.2e11 at HIGH), the cols pass 1.91e11
// (5.7e11), against 796 MB of f32 read and written: memory bounds both
// passes at DEFAULT (0.24 ms), the tensor cores both at HIGH (0.33 ms and
// 0.58 ms). This version stages wmma tiles through shared memory as K1
// does; with a second operand tile per stage it takes 120 to 180 KB of
// shared memory, one block per SM. wgmma, TMA and more blocks per SM are
// later work.
#include "tile_gemm.cuh"

namespace {

using ssw::BK;
using ssw::BM;
using ssw::BN;
using ssw::LDA;
using ssw::LDB;
using ssw::THREADS;

constexpr int kHalfM = BM / 2;  // outputs of one parity in a tile (rows)
constexpr int kHalfN = BN / 2;  // (cols)

__device__ __forceinline__ void zero8(__nv_bfloat16* v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = ssw::bf16_zero();
}

// row[col .. col+3], zero from column `len` on. One 16-byte load when `vec`
// (rows 16-byte aligned) and the four lie before `len`.
__device__ __forceinline__ void load4(const float* row, int col, int len,
                                      bool vec, float* out) {
  if (vec && col + 4 <= len) {
    const float4 v = *reinterpret_cast<const float4*>(row + col);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = col + j < len ? row[col + j] : 0.0f;
  }
}

// The mirror of load4 in a row of n: row[n-1-col-j] for j = 0..3, zero
// where col + j >= len; one 16-byte load, reversed in registers.
__device__ __forceinline__ void load4_mirrored(const float* row, int n,
                                               int col, int len, bool vec,
                                               float* out) {
  if (vec && col + 4 <= len) {
    const float4 v = *reinterpret_cast<const float4*>(row + n - 4 - col);
    out[0] = v.w;
    out[1] = v.z;
    out[2] = v.y;
    out[3] = v.x;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = col + j < len ? row[n - 1 - col - j] : 0.0f;
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const __nv_bfloat16* v) {
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(v);
}

// s = a + b and d = a - b of four elements, each in f32 and then rounded to
// the tier's bf16 parts, stored at dst[part] + at (the s tile) and
// dst[part] + at + d_off (the d tile).
template <int kP, class Parts>
__device__ __forceinline__ void store_fold(const float* a, const float* b,
                                           Parts& dst, int at, int d_off) {
  __align__(8) __nv_bfloat16 sv[2][4];
  __align__(8) __nv_bfloat16 dv[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float s = __fadd_rn(a[j], b[j]);
    const float d = __fsub_rn(a[j], b[j]);
    sv[0][j] = __float2bfloat16_rn(s);
    dv[0][j] = __float2bfloat16_rn(d);
    if (kP == 2) {
      sv[1][j] = __float2bfloat16_rn(__fsub_rn(s, __bfloat162float(sv[0][j])));
      dv[1][j] = __float2bfloat16_rn(__fsub_rn(d, __bfloat162float(dv[0][j])));
    }
  }
#pragma unroll
  for (int part = 0; part < kP; ++part) {
    store4(dst[part] + at, sv[part]);
    store4(dst[part] + at + d_off, dv[part]);
  }
}

// x, out: (batch, h, w) f32. basis_hi (and basis_lo at HIGH, kP = 2): the
// halves (ce, co) of the DCT-II basis of the contracted length n, as
// (2, n/2, kpitch) bf16, rows zero-padded to kpitch, a multiple of BK.
template <int kP, bool kRows>
__global__ void __launch_bounds__(THREADS)
fold_pass_kernel(const float* __restrict__ x,
                 const __nv_bfloat16* __restrict__ basis_hi,
                 const __nv_bfloat16* __restrict__ basis_lo,
                 float* __restrict__ out, int h, int w, int kpitch) {
  constexpr int kSplit = kRows ? ssw::kSplitB : ssw::kSplitA;
  using Smem = ssw::TileSmemT<kP, kSplit>;
  using Stage = ssw::StageT<kP, kSplit>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const size_t img = size_t(blockIdx.z) * h * w;
  const float* plane = x + img;
  const int half = (kRows ? h : w) / 2;
  // Plane rows 16-byte aligned: a row pitch of whole float4s from an
  // aligned start (a view may start at any float).
  const bool vec4 =
      w % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const __nv_bfloat16* parts[2] = {basis_hi, basis_lo};
  __align__(16) __nv_bfloat16 v[8];

  if constexpr (kRows) {
    const int n0 = blockIdx.x * BN;
    const int q0 = blockIdx.y * kHalfM;
    auto load = [&](Stage& st, int k0) {
      // A rows r < 64: ce[q0 + r]; r >= 64: co[q0 + r - 64]; 8-wide along m.
      for (int e = threadIdx.x; e < BM * BK / 8; e += THREADS) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int q = q0 + r % kHalfM;
        const size_t row = size_t((r / kHalfM) * half + q) * kpitch;
#pragma unroll
        for (int part = 0; part < kP; ++part) {
          if (q < half) ssw::load8(parts[part] + row, k0 + c, kpitch, true, v);
          else zero8(v);
          ssw::store8(st.a[part] + r * LDA + c, v);
        }
      }
      // B: s and d of rows m = k0.. and their mirrors, columns n0..; 4-wide.
      for (int e = threadIdx.x; e < BK * BN / 4; e += THREADS) {
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const int m = k0 + r, gw = n0 + c;
        float top[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float bot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (m < half) {
          load4(plane + size_t(m) * w, gw, w, vec4, top);
          load4(plane + size_t(h - 1 - m) * w, gw, w, vec4, bot);
        }
        store_fold<kP>(top, bot, st.b, r * LDB + c, BK * LDB);
      }
    };
    ssw::tile_product(s, half, load);
    for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int q = q0 + r % kHalfM, gw = n0 + c;
      if (q < half && gw < w)
        out[img + size_t(2 * q + r / kHalfM) * w + gw] = s.c[r * ssw::LDC + c];
    }
  } else {
    const int l0 = blockIdx.x * kHalfN;
    const int m0 = blockIdx.y * BM;
    auto load = [&](Stage& st, int k0) {
      // A: s and d of rows m0.., columns k0.. and their mirrors; 4-wide.
      for (int e = threadIdx.x; e < BM * BK / 4; e += THREADS) {
        const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
        const int gh = m0 + r, k = k0 + c;
        float front[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float back[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (gh < h) {
          const float* row = plane + size_t(gh) * w;
          load4(row, k, half, vec4, front);
          load4_mirrored(row, w, k, half, vec4, back);
        }
        store_fold<kP>(front, back, st.a, r * LDA + c, BM * LDA);
      }
      // B[kk][c] = ce[l0 + c][k0 + kk] (c < 64), co[l0 + c - 64][k0 + kk]
      // (c >= 64): 8-wide runs along k, transposed.
      for (int e = threadIdx.x; e < BN * BK / 8; e += THREADS) {
        const int c = e / (BK / 8), kk = (e % (BK / 8)) * 8;
        const int l = l0 + c % kHalfN;
        const size_t row = size_t((c / kHalfN) * half + l) * kpitch;
#pragma unroll
        for (int part = 0; part < kP; ++part) {
          if (l < half) ssw::load8(parts[part] + row, k0 + kk, kpitch, true, v);
          else zero8(v);
#pragma unroll
          for (int j = 0; j < 8; ++j) st.b[part][(kk + j) * LDB + c] = v[j];
        }
      }
    };
    ssw::tile_product(s, half, load);
    // Output column 2 * l0 + j is tile column (j % 2) * 64 + j / 2.
    for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
      const int r = e / BN, j = e % BN;
      const int gh = m0 + r, col = 2 * l0 + j;
      if (gh < h && col < w)
        out[img + size_t(gh) * w + col] =
            s.c[r * ssw::LDC + (j % 2) * kHalfN + j / 2];
    }
  }
}

template <int kP, bool kRows>
cudaError_t launch(const float* x, const __nv_bfloat16* basis_hi,
                   const __nv_bfloat16* basis_lo, float* out, int batch,
                   int h, int w, int kpitch, cudaStream_t stream) {
  constexpr int kSplit = kRows ? ssw::kSplitB : ssw::kSplitA;
  const size_t smem = sizeof(ssw::TileSmemT<kP, kSplit>);
  auto kernel = fold_pass_kernel<kP, kRows>;
  const cudaError_t err = ssw::set_smem_limit(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = kRows ? dim3(ssw::cdiv(w, BN), ssw::cdiv(h / 2, kHalfM), batch)
                          : dim3(ssw::cdiv(w / 2, kHalfN), ssw::cdiv(h, BM), batch);
  kernel<<<grid, THREADS, smem, stream>>>(x, basis_hi, basis_lo, out, h, w,
                                          kpitch);
  return cudaGetLastError();
}

}  // namespace

// x, out: (batch, h, w) f32, contiguous; the contracted length (h when
// `rows`, else w) is even. basis_hi, basis_lo: the halves of its DCT-II
// basis as (2, n/2, kpitch) bf16, kpitch a multiple of 32 and at least n/2,
// zero past n/2: bf16(.) at DEFAULT with basis_lo null, the hi and lo parts
// of the split at HIGH. Returns the launch's CUDA error code (0 when it was
// accepted).
extern "C" int ssw_fold_pass(const float* x, const __nv_bfloat16* basis_hi,
                             const __nv_bfloat16* basis_lo, float* out,
                             int batch, int h, int w, int kpitch, int rows,
                             cudaStream_t stream) {
  cudaError_t err;
  if (basis_lo == nullptr)
    err = rows ? launch<1, true>(x, basis_hi, nullptr, out, batch, h, w, kpitch, stream)
               : launch<1, false>(x, basis_hi, nullptr, out, batch, h, w, kpitch, stream);
  else
    err = rows ? launch<2, true>(x, basis_hi, basis_lo, out, batch, h, w, kpitch, stream)
               : launch<2, false>(x, basis_hi, basis_lo, out, batch, h, w, kpitch, stream);
  return int(err);
}
