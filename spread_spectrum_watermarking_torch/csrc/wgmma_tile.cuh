// The Hopper bf16 mainloop shared by K1 (csrc/luma_pass.cu) and K1f
// (csrc/fold_pass.cu): a batched product D = A B^T of two operands that are
// already laid out, tile by tile, as wgmma reads them from shared memory.
//
// Operands. Each operand is a matrix X[r][k] (r the output rows of A, or
// the output columns of B; k the contracted axis) stored in device memory as
// a "tile image": tiles of kRows x kDepth bf16 (128 x 64, 16 KB), tile
// (rt, kt) at ((rt * ktiles) + kt) * kTile, each tile in wgmma's K-major
// layout with the 128-byte swizzle: row r is 128 bytes, its 16-byte chunk c
// stored at chunk c ^ (r % 8) (swizzled(), below), zero outside X. So one
// stage of an operand is one contiguous 16 KB copy, which the Tensor Memory
// Accelerator's bulk engine makes (cp.async.bulk, completed on an mbarrier)
// without a tensor map and without touching a register. The bases are laid
// out so once on the host and cached (kernels/_tiles.py); the transformed
// operand (K1's luma, K1f's even/odd fold) is written so by the kernel's own
// first launch, which also reads the raw data once: the transform runs once
// per element (recompute factor 1, where the wmma design before it redid
// the luma once per 128-row output tile, 9 times at 1080p), for one write
// and one read of the bf16 operand in device memory.
//
// Block: 2 consumer warpgroups (64 output rows each) and one producer warp,
// one block per SM, persistent over the output tiles (gemm_kernel).
// The producer's one thread keeps a ring of kStages stages in flight: per
// stage it waits for the stage to be free (the `empty` mbarrier, one arrival
// per consumer warp), announces the bytes (`full`, arrive.expect_tx) and
// issues one bulk copy per operand part. Consumers wait on `full`, issue
// wgmma.m64n128k16 (bf16 in, f32 sums; A and B both from shared memory,
// K-major), and release the stage. No __syncthreads after the set-up.
//
// Parts: one bf16 part per operand (kParts = 1, one product a b per k), or
// the hi and lo parts of the HIGH tier's bf16x3 split (kParts = 2, products
// a_hi b_hi + a_hi b_lo + a_lo b_hi; lo*lo is dropped), summed together.
//
// Accumulation. The tensor cores' own f32 accumulation does not round to
// nearest, and over a long k its error grows (K6, csrc/dct2d_fused.cu). So
// each stage's products (k-depth 64) are summed on the tensor cores from
// zero and added to the output's f32 sums with one __fadd_rn each: every
// output is one fixed-order sum (stages ascending), no atomics, no split-K,
// so results repeat bit for bit. Each stage's products are waited for
// before the add; the other warpgroup's products run meanwhile.
//
// Where it stands (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and
// scripts/k1_ab.py --profile): K1's single-mode product at 48x1080p takes
// about 0.49 ms against 0.22 at the bf16 peak, its high mode (three
// products a k) about 0.98 against 0.65: at one product a k the waits and
// the tile's stores, not the tensor cores, are the limit.
//
// Batch: products image * parities + parity. K1f runs the even and the odd
// products of one image as two parities; each operand and the output step
// by their own strides for each.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssw {
namespace wg {

constexpr int kRows = 128;              // rows of an operand tile
constexpr int kDepth = 64;              // k of a tile: one 128-byte bf16 row
constexpr int kTile = kRows * kDepth;   // bf16 elements of a tile (16 KB)
constexpr int kConsumers = 256;         // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Where element (r, k) of a tile lies, in bf16 elements from its start.
__host__ __device__ inline int swizzled(int r, int k) {
  return r * kDepth + ((((k >> 3) ^ r) & 7) << 3) + (k & 7);
}

// A tile image (see above) for one batch of operands. Tile (rt, kt) of
// image i, parity p and part q starts at
//   ptr + i * image_stride + p * parity_stride + q * part_stride
//       + (rt * ktiles + kt) * kTile.
struct Operand {
  const __nv_bfloat16* ptr;
  long long image_stride;   // 0: one operand for every image (a basis)
  long long parity_stride;
  long long part_stride;
};

// Where output (m, n) of image i and parity p goes:
//   ptr + i * image_stride + p * parity_stride + m * m_stride + n * n_stride,
// for m < m_dim and n < n_dim. `pairs`: n_stride is 1 and every (n, n+1)
// pair with n even is aligned for one store of both.
struct Output {
  void* ptr;
  long long image_stride, parity_stride, m_stride, n_stride;
  int m_dim, n_dim;
  bool pairs;
};

namespace {  // one copy per source that includes this header

template <int kParts>
struct Stage {
  __nv_bfloat16 a[kParts][kTile];
  __nv_bfloat16 b[kParts][kTile];
};

// Six stages of 32 KB, or three of 64 KB at HIGH: one block per SM, and
// about 1.7 us of tensor-core work in flight ahead of the consumers.
template <int kParts>
constexpr int kStages = kParts == 1 ? 6 : 3;

template <int kParts>
constexpr size_t smem_bytes() {
  return kStages<kParts> * sizeof(Stage<kParts>) + 1024;  // + alignment
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, by the bulk-copy engine; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The wgmma descriptor of a swizzled K-major tile at `tile` (1024-byte
// aligned): start address, no leading offset (a 128-byte row spans the
// k-depth), 1024 bytes between groups of 8 rows, the 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return uint64_t((smem_addr(tile) & 0x3ffff) >> 4) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// d (+)= a @ b for the warpgroup's 64 x 128 tile, one k-step of 16, both
// operands K-major in shared memory; `accumulate` 0 starts d from zero.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t desc_a,
                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// Where tile `tile` of the grid lies: the parity fastest, then m tiles,
// then n tiles, then images. Blocks at work at the same time share B's row
// tile and image, and the two parities of an output tile (which K1f's cols
// orientation interleaves within the same 32-byte sectors) run side by
// side.
struct TileAt {
  int m, n, image, parity;
  __device__ TileAt(int tile, int m_tiles, int n_tiles, int parities) {
    parity = tile % parities;
    tile /= parities;
    m = tile % m_tiles;
    tile /= m_tiles;
    n = tile % n_tiles;
    image = tile / n_tiles;
  }
};

// Stores the consumers' sums of tile `t`. wgmma's accumulator layout:
// acc[4j + 2h + e] is row 8h + lane / 4 of the warp's 16, column
// 8j + 2 (lane % 4) + e.
template <typename Out>
__device__ __forceinline__ void store_tile(const Output& o, const TileAt& t,
                                           const float (&acc)[64]) {
  const int half = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int m_base = t.m * kRows + half * 64 + warp * 16 + lane / 4;
  const int n_base = t.n * kRows + 2 * (lane % 4);
  Out* out = static_cast<Out*>(o.ptr) + t.image * o.image_stride +
             t.parity * o.parity_stride;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m_base + 8 * h;
    if (m >= o.m_dim) continue;
    Out* row = out + m * o.m_stride;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n_base + 8 * j;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (o.pairs && n + 1 < o.n_dim) {
        store2(row + n, v0, v1);
      } else {
        if (n < o.n_dim) store1(row + n * o.n_stride, v0);
        if (n + 1 < o.n_dim) store1(row + (n + 1) * o.n_stride, v1);
      }
    }
  }
}

// Persistent: each block walks the 128 x 128 output tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... (`tiles` in all, m_tiles x n_tiles for each
// of the products), each over `ktiles` stages of k. The stage ring runs on
// across tiles, so the producer fills the next tile's first stages while
// the consumers store the last one's outputs.
template <int kParts, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(Operand a, Operand b, Output o, int m_tiles, int n_tiles,
            int tiles, int ktiles, int parities) {
  constexpr int S = kStages<kParts>;
  constexpr uint32_t kStageBytes = 2 * kParts * kTile * sizeof(__nv_bfloat16);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Stage<kParts>* st = reinterpret_cast<Stage<kParts>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t empty[S];

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer: one thread issues every copy.
    if (threadIdx.x == kConsumers) {
      int it = 0;  // stages issued so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const TileAt t(tile, m_tiles, n_tiles, parities);
        const __nv_bfloat16* pa = a.ptr + t.image * a.image_stride +
                                  t.parity * a.parity_stride +
                                  (long long)t.m * ktiles * kTile;
        const __nv_bfloat16* pb = b.ptr + t.image * b.image_stride +
                                  t.parity * b.parity_stride +
                                  (long long)t.n * ktiles * kTile;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], kStageBytes);
          const long long off = (long long)kt * kTile;
#pragma unroll
          for (int q = 0; q < kParts; ++q) {
            bulk_load(st[s].a[q], pa + q * a.part_stride + off,
                      kTile * sizeof(__nv_bfloat16), &full[s]);
            bulk_load(st[s].b[q], pb + q * b.part_stride + off,
                      kTile * sizeof(__nv_bfloat16), &full[s]);
          }
        }
      }
    }
    return;
  }

  // The consumers: warpgroup `half` owns output rows 64 * half .. + 63.
  const int half = threadIdx.x / 128, lane = threadIdx.x % 32;
  float acc[64], part[64];
  int it = 0;  // stages consumed so far
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt t(tile, m_tiles, n_tiles, parities);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      uint64_t da[kParts], db[kParts];
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        da[q] = sw128_desc(st[s].a[q] + half * 64 * kDepth);
        db[q] = sw128_desc(st[s].b[q]);
      }
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kDepth / 16; ++k) {
        // A k-step of 16 is 32 bytes along the swizzled rows: 2 in the
        // descriptor's 16-byte units.
        wgmma(part, da[0] + 2 * k, db[0] + 2 * k, k > 0);
        if (kParts == 2) {
          wgmma(part, da[0] + 2 * k, db[kParts - 1] + 2 * k, 1);
          wgmma(part, da[kParts - 1] + 2 * k, db[0] + 2 * k, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    store_tile<Out>(o, t, acc);
  }
}

// Launches gemm_kernel on `stream`: one block per SM (at most one per
// tile) over the m_tiles x n_tiles output tiles of each of the batch *
// parities products.
template <int kParts, typename Out>
cudaError_t launch_gemm(const Operand& a, const Operand& b, const Output& o,
                        int m_tiles, int n_tiles, int ktiles, int batch,
                        int parities, cudaStream_t stream) {
  auto kernel = gemm_kernel<kParts, Out>;
  constexpr size_t smem = smem_bytes<kParts>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles = m_tiles * n_tiles * batch * parities;
  kernel<<<tiles < sms ? tiles : sms, kThreads, smem, stream>>>(
      a, b, o, m_tiles, n_tiles, tiles, ktiles, parities);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wg
}  // namespace ssw
