// K4: the fused embed epilogue. Sparse inverse DCT of the coefficient
// update, added to the u8 image, quantized to u8; dY never reaches HBM.
//
// Replaces the TPU kernel embed_epilogue (spread_spectrum_watermarking_tpu/
// ops/fused_dct.py, embed_epilogue at :406-470, pallas_call at :446,
// removed in 6b7c109) and takes what it took: the u8 image, the n
// coefficient updates delta and their flat indices idx. It computes what
// the JAX package's XLA code computes today at DEFAULT:
//   a[h][k] = bf16((D_h[h, rows[k]] * delta[k]) * f32(4/(W*H)))
//   b[w][k] = bf16(D_w[w, cols[k]])             (pipeline._sparse_idct_delta)
//   dY[h, w] = bf16( sum_k a[h][k] b[w][k] )    (f32 sums)
//   out[h, w, c] = clamp(floor((u8 + f32(dY) * 255) + 0.5), 0, 255)
//                                              (colorspace.add_luma_delta_u8)
// with rows = idx / W, cols = idx % W and D the f32 inverse (DCT-III)
// basis. Every f32 op is an explicit _rn intrinsic, so nvcc can neither
// fuse nor split it: the factors are bit-equal to the plain version's.
//
// Bound on the H100: at 48x1080x1920 and n = 1000 the product is 2 B H W n
// = 0.199 PFLOP (0.20 ms at the bf16 peak) against 597 MB of u8 in and out
// (0.18 ms at 3.35 TB/s), so the tensor-core rate is the roof.
//
// Design: two launches on the shared Hopper mainloop (csrc/wgmma_tile.cuh),
// as K1. The first, factor_tiles_kernel, gathers the factors once: a block
// per (row tile, k tile, image) loads its 64 indices and updates, reads for
// each k the contiguous basis row D^T[rows[k]] (512 bytes of the transposed
// basis, which the wrapper caches per size), and writes both operands as
// bf16 tile images, a with rows h and b with rows w, k the ranked position,
// zeros past H, W and n (about 300 MB at 48x1080p, where the plain gathers
// wrote 2.3 GB of f32 and bf16 factors). The second is gemm_kernel with
// M = H, N = W and k = n padded to 64, whose epilogue (EmbedU8) rounds each
// sum to bf16, stages the warpgroup's 64 rows of dY in shared memory, and
// adds them to the image's rows, read and written as 16-byte vectors (a
// tile row is 384 contiguous bytes); one byte at a time only where the
// rows are not 16-byte aligned (W % 16 != 0, or a view of the image that
// starts off a 16-byte boundary). The quantize runs on the FP32 pipe
// (add_quantize, below), not on the conversion units, which issue int and
// float casts at a fraction of its rate.
// Measured at 48x1080x1920, n = 1000 (NVIDIA H100 80GB HBM3, 700 W;
// scripts/k4_ab.py --profile): 0.96 ms a call, the factor pass 0.26 and the
// product with its epilogue 0.68 (K1's product of the same padded size
// alone takes 0.49); the wmma kernel before this design took 3.89 ms from
// factors that plain gathers had built in another 1.8. Registers: factor
// pass 80, product 166, no spills.
#include "u8_round.cuh"
#include "wgmma_tile.cuh"

namespace {

using ssw::wg::cdiv;
using ssw::wg::kDepth;
using ssw::wg::kRows;
using ssw::wg::kTile;
using ssw::wg::TileAt;

constexpr int kFactorThreads = 256;
constexpr int kVecPerRow = kRows * 3 / 16;  // 16-byte vectors in a tile row
constexpr int kVecPerThread = 64 * kVecPerRow / 128;  // a warpgroup's rows

// The operands of the product as tile images, for `batch` images: a (rows
// h) in rt_a x ktiles tiles an image, then b (rows w) in rt_b x ktiles.
struct FactorLayout {
  int rt_a, rt_b, ktiles;
  long long a_image, b_image;  // bf16 elements of one image's a and b
  FactorLayout(int h, int w, int n)
      : rt_a(cdiv(h, kRows)), rt_b(cdiv(w, kRows)), ktiles(cdiv(n, kDepth)),
        a_image((long long)rt_a * ktiles * kTile),
        b_image((long long)rt_b * ktiles * kTile) {}
  long long elems(int batch) const { return batch * (a_image + b_image); }
};

// Tile (blockIdx.y, blockIdx.x) of image blockIdx.z: of a where blockIdx.y
// < rt_a, else tile blockIdx.y - rt_a of b. dht, dwt: the f32 inverse
// bases of H and W, transposed (row u is basis column u). An index outside
// [0, H W) contributes nothing.
__global__ void __launch_bounds__(kFactorThreads)
factor_tiles_kernel(const float* __restrict__ delta,
                    const long long* __restrict__ idx,
                    const float* __restrict__ dht,
                    const float* __restrict__ dwt, float scale,
                    __nv_bfloat16* __restrict__ tiles, int h, int w, int n,
                    FactorLayout lay, int batch) {
  __shared__ float vals[kDepth][kRows + 1];  // [k][r], before the rounding
  __shared__ int src[kDepth];                // basis row of k, or -1
  __shared__ float upd[kDepth];
  const bool is_a = blockIdx.y < lay.rt_a;
  const int rt = is_a ? blockIdx.y : blockIdx.y - lay.rt_a;
  const int len = is_a ? h : w;
  const float* basis = is_a ? dht : dwt;
  const long long k0 = (long long)blockIdx.z * n + blockIdx.x * kDepth;
  if (threadIdx.x < kDepth) {
    int s = -1;
    float d = 0.0f;
    if (blockIdx.x * kDepth + threadIdx.x < n) {
      const long long i = idx[k0 + threadIdx.x];
      if (i >= 0 && i < (long long)h * w) {
        s = int(is_a ? i / w : i % w);
        d = delta[k0 + threadIdx.x];
      }
    }
    src[threadIdx.x] = s;
    upd[threadIdx.x] = d;
  }
  __syncthreads();
  // Each k's basis row, neighbouring threads on neighbouring r: thread t
  // takes column r = t % 128 of rows k = 2 i + t / 128, all 32 loads in
  // flight at once (an index out of range reads row 0, a column past the
  // basis its last column, and both keep a zero).
  const int tr = threadIdx.x % kRows, kq = threadIdx.x / kRows;
  const int col = rt * kRows + tr;
  const float* at = basis + min(col, len - 1);
  float got[kDepth / 2];
#pragma unroll
  for (int i = 0; i < kDepth / 2; ++i)
    got[i] = at[size_t(max(src[2 * i + kq], 0)) * len];
#pragma unroll
  for (int i = 0; i < kDepth / 2; ++i) {
    const int k = 2 * i + kq;
    const float x = is_a ? __fmul_rn(__fmul_rn(got[i], upd[k]), scale) : got[i];
    vals[k][tr] = src[k] >= 0 && col < len ? x : 0.0f;
  }
  __syncthreads();
  // Then across: 8 threads to each 128-byte row of the tile.
  __nv_bfloat16* tile =
      tiles + (is_a ? blockIdx.z * lay.a_image
                    : batch * lay.a_image + blockIdx.z * lay.b_image) +
      ((long long)rt * lay.ktiles + blockIdx.x) * kTile;
#pragma unroll
  for (int i = 0; i < kTile / 8 / kFactorThreads; ++i) {
    const int e = threadIdx.x + i * kFactorThreads;
    const int r = e / (kDepth / 8), c = e % (kDepth / 8);
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16_rn(vals[8 * c + j][r]);
    *reinterpret_cast<uint4*>(tile + ssw::wg::swizzled(r, 8 * c)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

constexpr float kFloorMagic = 12582912.0f;    // 1.5 * 2^23

// u + df quantized as colorspace.add_luma_delta_u8 quantizes it,
// clamp(floor((u + df) + 0.5), 0, 255), bit for bit, on the FP32 pipe
// rather than the conversion units: u arrives as the bits of 2^23 + u
// (csrc/u8_round.cuh's byte_bits, shared with K7 and K10), an exact float; floor commutes with the clamp to [0, 255]; and x + 1.5 * 2^23
// rounded down is 1.5 * 2^23 + floor(x) for x in [0, 255] (the unit there
// is 1), so the low byte of its bits is the result.
__device__ __forceinline__ uint32_t add_quantize(uint32_t two23_plus_u,
                                                 float df) {
  const float u = ssw::u8::to_f32(two23_plus_u);
  const float x = __fadd_rn(__fadd_rn(u, df), 0.5f);
  return __float_as_uint(__fadd_rd(fminf(fmaxf(x, 0.0f), 255.0f),
                                   kFloorMagic));
}

// Where element (r, c) of the 128 x 128 bf16 dY tile lies: rows of 256
// bytes, 16-byte chunk j of row r at chunk j ^ (r % 8), so that the 8 rows
// one accumulator store of a warp touches fall in distinct banks.
__device__ __forceinline__ int dy_at(int r, int c) {
  return r * kRows + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}

// The dY of subpixel s of a 16-byte vector that starts at channel o of
// the pixel of df[0]: pixel (o + s) / 3 of df. (s = 15 stays at df[5].)
__device__ __forceinline__ float pixel_dy(const float (&df)[6], int s, int o) {
  const int q = s / 3;
  return s % 3 + o >= 3 ? df[q < 5 ? q + 1 : 5] : df[q];
}

__device__ __forceinline__ void warpgroup_sync(int half) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + half) : "memory");
}

// gemm_kernel's epilogue for K4: each warpgroup adds its 64 rows of the
// tile's dY to the image. Only the warpgroup's own 128 threads wait for
// one another (named barrier 1 + half), never the producer.
struct EmbedU8 {
  static constexpr size_t kSmemBytes = kRows * kRows * sizeof(__nv_bfloat16);
  const uint8_t* rgb;
  uint8_t* out;
  int h, w;
  bool vec;  // rgb and out 16-byte aligned and W % 16 == 0

  __device__ __forceinline__ void operator()(const TileAt& t,
                                             const float (&acc)[64],
                                             unsigned char* smem) const {
    __nv_bfloat16* dy = reinterpret_cast<__nv_bfloat16*>(smem);
    const int half = threadIdx.x / 128, tid = threadIdx.x % 128;
    // dY rounded to bf16 (the accumulator layout of store_tile).
    const int warp = tid / 32, lane = tid % 32;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = half * 64 + warp * 16 + lane / 4 + 8 * hh;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dy + dy_at(r, 8 * j + 2 * (lane % 4))) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
    warpgroup_sync(half);
    const int row0 = t.m * kRows + half * 64;  // the warpgroup's first row
    const int rows = min(64, h - row0);        // of the image
    const int row_bytes = 3 * min(kRows, w - t.n * kRows);
    const size_t first = 3 * ((size_t(t.image) * h + row0) * w +
                              size_t(t.n) * kRows);
    const size_t pitch = size_t(3) * w;
    if (vec) {
      // 16-byte vectors (W % 16 == 0, so a row's bytes are whole vectors),
      // in batches of kBatch a thread, each batch's loads all in flight
      // before the first is used. (Batches of 2 with the next batch's loads
      // in flight during this one's arithmetic took 0.76 ms against 0.68;
      // batches of 4 so pipelined made ptxas spill the mainloop's hoisted
      // invariants at the 168-register cap.)
      constexpr int kBatch = 4;
      auto load = [&](uint4 (&px)[kBatch], int i0) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = tid + (i0 + u) * 128;
          const int rr = e / kVecPerRow, v = e % kVecPerRow;
          if (rr < rows && 16 * v < row_bytes)
            px[u] = __ldg(reinterpret_cast<const uint4*>(
                rgb + first + rr * pitch + 16 * v));
        }
      };
#pragma unroll 1
      for (int i0 = 0; i0 < kVecPerThread; i0 += kBatch) {
        uint4 cur[kBatch];
        load(cur, i0);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = tid + (i0 + u) * 128;
          const int rr = e / kVecPerRow, v = e % kVecPerRow;
          if (rr >= rows || 16 * v >= row_bytes) continue;
          // Byte s of the vector is byte 16 v + s of the row: pixel p0 +
          // (o + s) / 3, with 16 v = 3 p0 + o.
          const int r = half * 64 + rr, p0 = 16 * v / 3, o = v % 3;
          float df[6];
#pragma unroll
          for (int q = 0; q < 6; ++q)
            df[q] = __fmul_rn(
                __bfloat162float(dy[dy_at(r, min(p0 + q, kRows - 1))]),
                255.0f);
          const uint32_t in[4] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
          uint32_t res[4];
#pragma unroll
          for (int wd = 0; wd < 4; ++wd) {
            uint32_t b[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              b[j] = add_quantize(ssw::u8::byte_bits(in[wd], j),
                                  pixel_dy(df, 4 * wd + j, o));
            res[wd] = ssw::u8::pack4(b[0], b[1], b[2], b[3]);
          }
          *reinterpret_cast<uint4*>(out + first + rr * pitch + 16 * v) =
              make_uint4(res[0], res[1], res[2], res[3]);
        }
      }
    } else {
      // One byte a thread, neighbouring threads on neighbouring bytes.
      for (int e = tid; e < 64 * 3 * kRows; e += 128) {
        const int rr = e / (3 * kRows), b = e % (3 * kRows);
        if (rr >= rows || b >= row_bytes) continue;
        const float df = __fmul_rn(
            __bfloat162float(dy[dy_at(half * 64 + rr, b / 3)]), 255.0f);
        const size_t at = first + rr * pitch + b;
        out[at] = uint8_t(add_quantize(ssw::u8::byte_bits(rgb[at], 0), df));
      }
    }
    warpgroup_sync(half);  // dY is read before the next tile's is staged
  }
};

int launch_factors(const float* delta, const long long* idx, const float* dht,
                   const float* dwt, float scale, __nv_bfloat16* work,
                   long long work_elems, int batch, int h, int w, int n,
                   cudaStream_t stream) {
  const FactorLayout lay(h, w, n);
  if (work_elems < lay.elems(batch)) return int(cudaErrorInvalidValue);
  if (lay.ktiles == 0 || batch == 0) return int(cudaSuccess);
  const dim3 grid(lay.ktiles, lay.rt_a + lay.rt_b, batch);
  factor_tiles_kernel<<<grid, kFactorThreads, 0, stream>>>(
      delta, idx, dht, dwt, scale, work, h, w, n, lay, batch);
  return int(cudaGetLastError());
}

}  // namespace

// delta: (batch, n) f32; idx: (batch, n) int64 flat indices into (h, w);
// dht, dwt: the f32 inverse DCT bases of h and w, transposed, (h, h) and
// (w, w); scale: f32(4/(w h)); work: `work_elems` bf16 of scratch, which
// receives the factors' tile images (a of every image, then b of every
// image; kernels/embed_epilogue.py). All contiguous. One launch on
// `stream`; returns its CUDA error code (0 when it was accepted).
extern "C" int ssw_embed_factor_tiles(const float* delta, const long long* idx,
                                      const float* dht, const float* dwt,
                                      float scale, __nv_bfloat16* work,
                                      long long work_elems, int batch, int h,
                                      int w, int n, cudaStream_t stream) {
  return launch_factors(delta, idx, dht, dwt, scale, work, work_elems, batch,
                        h, w, n, stream);
}

// rgb, out: (batch, h, w, 3) u8, contiguous; the rest as above. Two
// launches on `stream` (the factor tiles, then the product and its u8
// epilogue); returns the first CUDA error code (0 when both were accepted).
extern "C" int ssw_embed_epilogue(const uint8_t* rgb, const float* delta,
                                  const long long* idx, const float* dht,
                                  const float* dwt, float scale,
                                  __nv_bfloat16* work, long long work_elems,
                                  uint8_t* out, int batch, int h, int w, int n,
                                  cudaStream_t stream) {
  int err = launch_factors(delta, idx, dht, dwt, scale, work, work_elems,
                           batch, h, w, n, stream);
  if (err != 0) return err;
  const FactorLayout lay(h, w, n);
  const ssw::wg::Operand a{work, lay.a_image, 0, 0};
  const ssw::wg::Operand b{work + batch * lay.a_image, lay.b_image, 0, 0};
  const bool vec = w % 16 == 0 && (reinterpret_cast<uintptr_t>(rgb) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const EmbedU8 epi{rgb, out, h, w, vec};
  return int(ssw::wg::launch_gemm<1>(a, b, epi, lay.rt_a, lay.rt_b,
                                     lay.ktiles, batch, 1, stream));
}

// The message for a code the entry points above return.
extern "C" const char* ssw_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
