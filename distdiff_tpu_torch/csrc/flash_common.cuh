// Shared pieces of the bf16 flash-attention kernels for Hopper (sm_90a).
//
// Layout: every tensor is a contiguous [BH, T, D] slab (BH = batch * heads),
// q/k/v/o/do in bf16, lse/delta/dq-scratch in fp32. The ragged head
// columns and sequence rows are zero-filled in shared memory only (device
// memory stays unpadded).
//
// Two shapes of kernel:
//   * narrow (D <= 128, the UNet's heads; flash_fwd and flash_bwd_fused):
//     warp-specialised, a producer warp that loads tiles by TMA (or stages
//     them where TMA cannot describe the slab) into a ring of shared-memory
//     stages with mbarriers, and two consumer warpgroups that run the
//     products on wgmma (hopper.cuh holds the primitives and the
//     shared-memory layout);
//   * wide (D up to 512, the VAE's single head; flash_fwd, flash_bwd_dq,
//     flash_bwd_dkv): eight warps, two 16-row groups by four column
//     quarters, on mma.sync m16n8k16. A warp forms a 16 x 16 block of the
//     score tile over the full head width, the tile goes through shared
//     memory, and each warp then owns 16 rows x a quarter of the head
//     width of the output (a 16 x 512 fp32 accumulator would not fit a
//     warp's registers).
//
// Fragment layouts of mma.sync (PTX ISA, m16n8k16): with g = lane / 4 and
// t = lane % 4, the accumulator c[0..3] holds rows g, g, g+8, g+8 and
// columns 2t, 2t+1, 2t, 2t+1 of its 16 x 8 tile; the A operand a[0..3]
// holds the 16 x 16 tile's (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows
// 0-7, k 8-15), (rows 8-15, k 8-15), two bf16 each; the B operand b[0..1]
// holds k 0-7 and k 8-15 of its 16 x 8 tile. Operands come from shared
// memory through ldmatrix; bf16 tiles there have a row stride of a
// multiple of 8 elements plus 8, so that the eight 16-byte rows one
// ldmatrix phase reads fall in distinct bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int WIDE_THREADS = 256;    // eight warps
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The narrow kernels' TMA route needs rows of a multiple of 16 bytes and
// 16-byte aligned bases (the caller chooses; this only refuses a wrong
// choice).
inline bool narrow_tma_ok(int d, int tma, const void* a, const void* b, const void* c,
                          const void* e) {
  if (!tma) return true;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(e);
  return d % 8 == 0 && bases % 16 == 0;
}

// Head width rounded up to a wide kernel's: a multiple of 64, so that a
// quarter of it is whole 16-column tiles (0: unsupported).
inline int wide_dmax(int d) {
  if (d <= 0) return 0;
  if (d <= 64) return 64;
  if (d <= 128) return 128;
  if (d <= 256) return 256;
  if (d <= 512) return 512;
  return 0;
}

template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8. Plain: thread t gets row t / 4, columns 2(t % 4) and 2(t % 4) + 1
// of each. Transposed: rows 2(t % 4) and 2(t % 4) + 1 of column t / 4.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Lane addresses (element offsets) of the x4 loads, for a tile at rows
// [0, 16) and columns [0, 16) of a row-major shared array of stride ld:
//   A operand from [m][k] storage, plain load            -> a[0..3]
__device__ __forceinline__ int lane_a(int lane, int ld) {
  return (lane % 16) * ld + (lane / 16) * 8;
}
//   two B operands (n 0-7, n 8-15) from [n][k] storage, plain load ->
//   {r0, r1} and {r2, r3}; also the A operand from [k][m] storage,
//   transposed load -> a[0..3]
__device__ __forceinline__ int lane_nk(int lane, int ld) {
  return ((lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
}
//   two B operands (n 0-7, n 8-15) from [k][n] storage, transposed load
//   -> {r0, r1} and {r2, r3}
__device__ __forceinline__ int lane_kn(int lane, int ld) {
  return ((lane % 8) + ((lane / 8) % 2) * 8) * ld + (lane / 16) * 8;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, the first in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// c (16 x 16, two 8-column tiles) = A[16 x K] . B[16 x K]^T, with A stored
// [m][k] and B stored [n][k] in shared memory.
template <int K>
__device__ __forceinline__ void warp_abt(float (&c)[2][4], const bf16* A, int lda,
                                         const bf16* B, int ldb, int lane) {
  zero(c);
#pragma unroll 8
  for (int kk = 0; kk < K / 16; ++kk) {
    unsigned a[4], b[4];
    ldsm_x4(a, A + kk * 16 + lane_a(lane, lda));
    ldsm_x4(b, B + kk * 16 + lane_nk(lane, ldb));
    mma_bf16(c[0], a, b[0], b[1]);
    mma_bf16(c[1], a, b[2], b[3]);
  }
}

// acc (16 x 8*NT) += A[16 x K] . X[K x 8*NT], with A stored [m][k] and X
// stored [k][n] in shared memory.
template <int K, int NT>
__device__ __forceinline__ void warp_ax(float (&acc)[NT][4], const bf16* A, int lda,
                                        const bf16* X, int ldx, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    unsigned a[4];
    ldsm_x4(a, A + kk * 16 + lane_a(lane, lda));
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      unsigned b[4];
      ldsm_x4_t(b, X + kk * 16 * ldx + n2 * 16 + lane_kn(lane, ldx));
      mma_bf16(acc[2 * n2], a, b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// Stage rows [row0, row0 + ROWS) of a [n_rows, d] bf16 slab into a bf16
// tile [ROWS][LD] of shared memory, zero past n_rows and past column d
// (up to DMAX, a multiple of 8). Sixteen-byte loads where the slab allows.
template <int ROWS, int DMAX, int LD, int NTHREADS>
__device__ __forceinline__ void stage_bf16(bf16* __restrict__ dst,
                                           const bf16* __restrict__ src,
                                           int row0, int n_rows, int d) {
  constexpr int C8 = DMAX / 8;
  const bool vec = (d % 8) == 0 && (reinterpret_cast<uintptr_t>(src) % 16) == 0;
  for (int idx = threadIdx.x; idx < ROWS * C8; idx += NTHREADS) {
    const int r = idx / C8;
    const int c = (idx - r * C8) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < n_rows && c < d) {
      const bf16* s = src + (size_t)gr * d + c;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(s);
      } else {
        __align__(16) bf16 tmp[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) tmp[i] = c + i < d ? s[i] : __float2bfloat16(0.f);
        val = *reinterpret_cast<const uint4*>(tmp);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Stage entries [row0, row0 + ROWS) of a per-row fp32 vector, times mul
// (0 past n_rows).
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void stage_vec(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int n_rows, float mul) {
  for (int r = threadIdx.x; r < ROWS; r += NTHREADS)
    dst[r] = row0 + r < n_rows ? src[row0 + r] * mul : 0.f;
}

}  // namespace flash
