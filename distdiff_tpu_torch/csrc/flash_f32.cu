// fp32 flash attention for Hopper (sm_90a): flash_fwd_f32,
// flash_bwd_fused_f32, flash_bwd_dq_f32 and flash_bwd_dkv_f32.
//
// The fp32 instances of the port's four attention kernels (the bf16 ones
// are in flash_fwd.cu and flash_bwd.cu). The reference's Pallas kernels
// (distdiff_tpu/ops/flash.py `_fwd_kernel_single`, `_fwd_kernel`,
// `_bwd_fused_kernel`, `_dq_kernel`, `_dkv_kernel`) are generic in the
// input type, so its fp32 `tiny()` configurations run them; these kernels
// let the port do the same on the card. They compute the same functions as
// the bf16 kernels, on fp32 q/k/v/do with fp32 outputs, and round nothing
// to bf16. Two kinds of arithmetic, both to fp32 accuracy:
//   * every kernel a path launches (the forward at every width: the narrow
//     kernel up to D = 128, the wide one past it; the fused backward up to
//     D = 128; the split backward pair past it) runs every product on the
//     TF32 tensor cores as 3xTF32: each operand x is split into a high part
//     (its top 19 bits, which is what the tensor cores read of a register)
//     and a low part x - hi (exact in fp32), and a b is formed as
//     lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) with fp32 accumulation. What
//     is left out, lo(a) lo(b) and the low part's own truncation, is
//     ~2^-20 of a term, where one TF32 product loses ~2^-11; with the
//     tensor cores' truncated sums the result stays within ~2e-5 of the
//     largest output of fp64 attention, where one TF32 product would be
//     ~5e-4 off;
//   * the split pair's narrow instances (dq_kernel, dkv_kernel, up to
//     D = 128), which only direct calls of flash_bwd_dq_f32 and
//     flash_bwd_dkv_f32 reach (flash_bwd takes the fused kernel there),
//     run fp32 fused multiply-adds on the CUDA cores, so they agree with
//     the plain fp32 version to summation order.
//
// What bounds them on this card: their products. The tensor-core kernels
// are held by the TF32 rate (495 TFLOP/s, three products for each fp32
// one) and by the instructions that feed mma.sync, the CUDA-core ones by
// the fp32 FMA rate (67 TFLOP/s on the H100 SXM). The CUDA-core kernels
// are simple, not fast: no path launches them.
//
// Design of the CUDA-core kernels (one warp = 32 lanes; DP = head width
// rounded up to 32, 64 or 128; NC = DP / 32 columns of an output row per
// lane):
//   * dq_kernel: a block of four warps takes 4 * RW q rows (RW per warp)
//     and loops over 32-row kv tiles in shared memory. Lane j forms s and
//     dp of kv row j against each of its warp's q rows, ds = p (dp -
//     delta) scale, and dq += ds k with ds broadcast from lane j and lane l
//     owning output columns l, l + 32, ...
//   * dkv_kernel: a block takes 4 * RW kv rows (RW per warp) and loops over
//     32-row q tiles; lane j takes q row j: dv += p^T do and dk += ds^T q
//     with lane l owning columns l, l + 32, ...
// Ragged rows and columns are zero-filled in shared memory and masked;
// nothing is padded in device memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace flash32 {

constexpr int THREADS = 128;  // four warps
constexpr int TILE = 32;      // rows of the tile a block loops over (one per lane)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

inline int pad_d(int d) {
  if (d <= 0) return 0;
  if (d <= 32) return 32;
  if (d <= 64) return 64;
  if (d <= 128) return 128;
  if (d <= 256) return 256;
  if (d <= 512) return 512;
  return 0;
}

// Rows [row0, row0 + ROWS) of an fp32 [n_rows, d] slab into shared [ROWS][LD],
// zero past n_rows and past column d (up to DP).
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void stage(float* __restrict__ dst, const float* __restrict__ src,
                                      int row0, int n_rows, int d) {
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += THREADS) {
    const int r = idx / DP, c = idx - (idx / DP) * DP;
    const int gr = row0 + r;
    dst[r * LD + c] = (gr < n_rows && c < d) ? src[(size_t)gr * d + c] : 0.f;
  }
}

template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ------------------------------------------- wide forward on 3xTF32 products
//
// flash_fwd_f32 for 128 < D <= 512 (instances DMAX = 256 and 512), in place
// of the Pallas `_fwd_kernel_single` / `_fwd_kernel` on fp32 slabs.
//
// What bounds it: three TF32 products for each fp32 one, 2 * 3 of them a
// (q row, kv row, column) at 495 TFLOP/s, on mma.sync (wgmma takes TF32
// operands only K-major, and v is MN-major for o += p v). Every fragment
// is read from shared memory and split in registers (two instructions an
// element), so the instructions that feed the products and shared
// memory's bandwidth stand beside the tensor cores.
//
// Design: one block of NW = DMAX / 32 warps takes 64 q rows of one slab;
// q stays resident in shared memory (132 KB at DMAX 512) and k and v
// stream through a ring of four 17 KB slots, loaded with cp.async (16-byte
// copies where d % 4 == 0 and the bases are 16-byte aligned, else 4-byte
// ones; zero past the slab), RING - 1 chunks ahead: for each 64-row kv
// tile, ceil(d / 64) chunks of k (64 rows x 64 columns) and then 64 / VR
// chunks of v (VR = 4096 / DMAX rows x DMAX columns). Each chunk is one
// __syncthreads: the stream never waits on a role, and a slot is refilled
// only after every warp left it.
//   * s = q k^T: the 64 x 64 score tile, warp w taking 16 rows (w & 3) and
//     256 / NW columns (w >> 2), fragments by ldmatrix (fp32 words moved as
//     b16 pairs; padded rows keep it free of bank conflicts).
//   * the online softmax on those fragments: row maxima over the four
//     lanes of a row and over the column groups through shared memory;
//     every column group forms the same new maximum; p = exp2(s - m) goes
//     to shared memory in fp32 with the rows' rescale factors; each thread
//     keeps its share of the row sums until the end.
//   * o += p v: warp w owns columns [32 w, 32 w + 32) of all 64 rows (64
//     fp32 accumulators a thread), so s is formed once and handed to the
//     column owners; p by ldmatrix, v by 32-bit loads (it is MN-major).
//     The tensor cores' sums round toward zero relative to what they add
//     to, so each v chunk's products are summed from zero and added to o
//     by fp32 adds: on o itself that rounding would bias o by ~1e-4 of its
//     size over 4096 kv rows, and more over longer ones.
// lse and the normalised o are written once at the end; ragged q rows are
// never written, ragged kv columns are masked to -inf. No atomics: the
// same bytes on every launch.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One arrival on `bar` once this thread's cp.async copies so far have
// landed (the barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Four 8 x 4 fp32 blocks (8 x 8 b16) from shared memory: lane l gives the
// address of row l & 7 of block l >> 3, and gets word (l & 3) of row l >> 2
// of each block
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The low part of x: x minus its top 19 bits, exact in fp32. x itself is
// the high part, since the tensor cores read only those bits of a TF32
// operand.
__device__ __forceinline__ uint32_t tf32_lo(uint32_t x) {
  return __float_as_uint(__uint_as_float(x) - __uint_as_float(x & 0xffffe000u));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b to fp32 accuracy: the two correction products first, then the
// high parts' product
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a)[4],
                                     const uint32_t (&al)[4], uint32_t b0, uint32_t b1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, b0, b1);
  mma_tf32(c, a, bl0, bl1);
  mma_tf32(c, a, b0, b1);
}

template <int DMAX>
struct WideCfg {
  static constexpr int NW = DMAX / 32;  // warps: one 32-column slice of o each
  static constexpr int THREADS = 32 * NW;
  static constexpr int BQ = 64, BK = 64;  // q rows a block, kv rows a tile
  static constexpr int KC = 64;           // head columns in a k chunk
  static constexpr int VR = 4096 / DMAX;  // kv rows in a v chunk
  // row strides in floats: 4 (mod 32) for the ldmatrix operands, 8 (mod
  // 32) for v's 32-bit loads (lanes t, t + 4 rows apart hit other banks)
  static constexpr int LDQ = DMAX + 4, LDP = BK + 4, LDK = KC + 4, LDV = DMAX + 8;
  static constexpr int SLOT = BK * LDK > VR * LDV ? BK * LDK : VR * LDV;
  static constexpr int RING = 4;
  static constexpr int SCG = NW / 4;     // column groups of the score tile
  static constexpr int SN = BK / SCG;    // score columns a warp
  static constexpr int NTS = SN / 8;     // its n-tiles
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BQ * LDQ + BQ * LDP + RING * SLOT + SCG * BQ + 2 * BQ);
};

// rows [r0, r0 + ROWS) and columns [c0, c0 + min(COLS, cmax - c0)) of an
// fp32 [n, d] slab into dst (row stride ld, column c0 at dst's column 0)
// by cp.async, zero past the slab's rows and columns; cmax is a multiple
// of 8, and with VEC d is a multiple of 4 and src 16-byte aligned
template <bool VEC, int THREADS, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          int r0, int n, int c0, int cmax, int d) {
  const uint32_t base = smem_u32(dst);
  const int cols = min(COLS, cmax - c0);
  if (VEC) {
    constexpr int CV = COLS / 4;
    for (int i = threadIdx.x; i < ROWS * CV; i += THREADS) {
      const int r = i / CV, c = 4 * (i % CV);
      if (c >= cols) continue;
      const bool in = r0 + r < n && c0 + c < d;
      cp_async16(base + 4 * (r * ld + c), in ? src + (size_t)(r0 + r) * d + c0 + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      if (c >= cols) continue;
      const bool in = r0 + r < n && c0 + c < d;
      cp_async4(base + 4 * (r * ld + c), in ? src + (size_t)(r0 + r) * d + c0 + c : src,
                in ? 4 : 0);
    }
  }
}

template <int DMAX, bool VEC>
__global__ void __launch_bounds__(WideCfg<DMAX>::THREADS, 1)
flash_fwd_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int tq, int tk, int d, float scale) {
  typedef WideCfg<DMAX> C;
  constexpr int BQ = C::BQ, BK = C::BK, RING = C::RING, NTS = C::NTS;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* Ps = Qs + BQ * C::LDQ;
  float* ring = Ps + BQ * C::LDP;
  float* red = ring + RING * C::SLOT;  // [SCG][BQ]: row maxima, at the end row sums
  float* alpha_s = red + C::SCG * BQ;  // [BQ]: this tile's rescale of o's rows
  float* m_s = alpha_s + BQ;           // [BQ]: the rows' final maxima
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;
  const float sl2 = scale * LOG2E;
  const int d8 = (d + 7) & ~7;             // columns the k-steps read (zero past d)
  const int nkc = (d8 + C::KC - 1) / C::KC;  // k chunks a kv tile
  constexpr int NVC = BK / C::VR;            // v chunks a kv tile
  const int ntile = (tk + BK - 1) / BK;

  // the stream's next chunk (k chunks, then v chunks, tile by tile) into
  // ring slot `slot`; one commit group a chunk, empty past the end
  int nj = 0, ns = 0;  // tile and chunk of the next load
  auto load_next = [&](int slot) {
    if (nj < ntile) {
      float* dst = ring + slot * C::SLOT;
      if (ns < nkc)
        load_tile<VEC, C::THREADS, BK, C::KC>(dst, C::LDK, kb, nj * BK, tk, ns * C::KC, d8, d);
      else
        load_tile<VEC, C::THREADS, C::VR, DMAX>(dst, C::LDV, vb, nj * BK + (ns - nkc) * C::VR,
                                                 tk, 0, d8, d);
      if (++ns == nkc + NVC) {
        ns = 0;
        ++nj;
      }
    }
    cp_commit();
  };

  load_tile<VEC, C::THREADS, BQ, DMAX>(Qs, C::LDQ, q + (size_t)bh * tq * d, q0, tq, 0, d8, d);
  cp_commit();
#pragma unroll
  for (int c = 0; c < RING - 1; ++c) load_next(c);

  // score phase: rows srow + g (+ 8), columns scol + 8 n + 2 t4 (+ 1)
  const int srow = 16 * (warp & 3), cg = warp >> 2, scol = cg * C::SN;
  // output phase: rows 16 i + g (+ 8), columns ocol + 8 n + 2 t4 (+ 1)
  const int ocol = 32 * warp;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  int c = 0;
  for (int j = 0; j < ntile; ++j) {
    float s_acc[NTS][4];
#pragma unroll
    for (int n = 0; n < NTS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[n][e] = 0.f;
    for (int kc = 0; kc < nkc; ++kc, ++c) {
      cp_wait<RING - 2>();
      __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
      load_next((c + RING - 1) % RING);
      const float* Ks = ring + (c % RING) * C::SLOT;
      const float* qa = Qs + (srow + (lane & 7) + 8 * ((lane >> 3) & 1)) * C::LDQ + kc * C::KC +
                        4 * (lane >> 4);
      const float* kbp =
          Ks + (scol + (lane & 7) + 8 * (lane >> 4)) * C::LDK + 4 * ((lane >> 3) & 1);
      const int nks = min(8, (d8 - kc * C::KC) >> 3);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if (ks < nks) {
          uint32_t a[4], al[4];
          ldsm4(a, qa + 8 * ks);
#pragma unroll
          for (int e = 0; e < 4; ++e) al[e] = tf32_lo(a[e]);
#pragma unroll
          for (int np = 0; np < NTS / 2; ++np) {
            uint32_t b[4], bl[4];
            ldsm4(b, kbp + 16 * np * C::LDK + 8 * ks);
#pragma unroll
            for (int e = 0; e < 4; ++e) bl[e] = tf32_lo(b[e]);
            mma3(s_acc[2 * np], a, al, b[0], b[1], bl[0], bl[1]);
            mma3(s_acc[2 * np + 1], a, al, b[2], b[3], bl[2], bl[3]);
          }
        }
      }
    }

    // online softmax on the score fragments
    const int nvalid = tk - j * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NTS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = scol + 8 * n + 2 * t4 + (e & 1);
        const float x = col < nvalid ? s_acc[n][e] * sl2 : -INFINITY;
        s_acc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t4 == 0) red[cg * BQ + srow + g + 8 * r] = mx[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mn = m_run[r];
#pragma unroll
      for (int i = 0; i < C::SCG; ++i) mn = fmaxf(mn, red[i * BQ + srow + g + 8 * r]);
      const float alpha = exp2f(m_run[r] - mn);  // 0 on the first tile (m = -inf)
      m_run[r] = mn;
      l_run[r] *= alpha;
      if (cg == 0 && t4 == 0) alpha_s[srow + g + 8 * r] = alpha;
    }
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s_acc[n][e] - m_run[e >> 1]);
        l_run[e >> 1] += p;
        s_acc[n][e] = p;
      }
      float* pr = Ps + (srow + g) * C::LDP + scol + 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(pr) = make_float2(s_acc[n][0], s_acc[n][1]);
      *reinterpret_cast<float2*>(pr + 8 * C::LDP) = make_float2(s_acc[n][2], s_acc[n][3]);
    }
    __syncthreads();  // p and the rescale factors are in

    // o += p v over this tile's v chunks
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a0 = alpha_s[16 * i + g], a1 = alpha_s[16 * i + g + 8];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        acc[i][n][0] *= a0;
        acc[i][n][1] *= a0;
        acc[i][n][2] *= a1;
        acc[i][n][3] *= a1;
      }
    }
    const float* pa = Ps + ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::LDP + 4 * (lane >> 4);
    for (int vc = 0; vc < NVC; ++vc, ++c) {
      cp_wait<RING - 2>();
      __syncthreads();
      load_next((c + RING - 1) % RING);
      if (ocol >= d) continue;  // no column of this warp's slice is in the slab
      const float* Vs = ring + (c % RING) * C::SLOT + t4 * C::LDV + ocol + g;
      constexpr int KS = C::VR / 8;  // k-steps in the chunk
      uint32_t b[KS][4][2], bl[KS][4][2];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          b[ks][n][0] = __float_as_uint(Vs[8 * ks * C::LDV + 8 * n]);
          b[ks][n][1] = __float_as_uint(Vs[(8 * ks + 4) * C::LDV + 8 * n]);
          bl[ks][n][0] = tf32_lo(b[ks][n][0]);
          bl[ks][n][1] = tf32_lo(b[ks][n][1]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[KS][4], al[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          ldsm4(a[ks], pa + 16 * i * C::LDP + vc * C::VR + 8 * ks);
#pragma unroll
          for (int e = 0; e < 4; ++e) al[ks][e] = tf32_lo(a[ks][e]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (ocol + 8 * n >= d) continue;
          // the chunk's products summed apart, then added to o in fp32
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            mma3(t, a[ks], al[ks], b[ks][n][0], b[ks][n][1], bl[ks][n][0], bl[ks][n][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] += t[e];
        }
      }
    }
  }

  // the row sums: over a row's four lanes, then over the column groups
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if (t4 == 0) {
      red[cg * BQ + srow + g + 8 * r] = l_run[r];  // red's last readers passed a barrier since
      if (cg == 0) m_s[srow + g + 8 * r] = m_run[r];
    }
  }
  __syncthreads();
  if (ocol < d) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * i + g + 8 * h;
        if (q0 + row >= tq) continue;
        float sum = 0.f;
#pragma unroll
        for (int x = 0; x < C::SCG; ++x) sum += red[x * BQ + row];
        const float inv = 1.f / sum;
        float* orow = o + ((size_t)bh * tq + q0 + row) * d;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = ocol + 8 * n + 2 * t4;
          if (col < d) orow[col] = acc[i][n][2 * h] * inv;
          if (col + 1 < d) orow[col + 1] = acc[i][n][2 * h + 1] * inv;
        }
      }
  }
  if (threadIdx.x < BQ && q0 + threadIdx.x < tq) {
    float sum = 0.f;
#pragma unroll
    for (int x = 0; x < C::SCG; ++x) sum += red[x * BQ + threadIdx.x];
    lse[(size_t)bh * tq + q0 + threadIdx.x] = m_s[threadIdx.x] * LN2 + logf(sum);
  }
}

// ----------------------------------------- narrow forward on 3xTF32 products
//
// flash_fwd_f32 for D <= 128 (instances DMAX = 32, 64 and 128), in place of
// the Pallas `_fwd_kernel_single` / `_fwd_kernel` on fp32 slabs.
//
// What bounds it: the same 3xTF32 products as the wide forward, 2 * 3 TF32
// products a (q row, kv row, column), on mma.sync (wgmma takes TF32 only
// K-major, and v is MN-major in o += p v): 0.52 ms at [32, 4096, 4096, 40]
// at 495 TFLOP/s, ~0.8 ms at the 325 TFLOP/s mma.sync reaches. What stands
// beside them is the work that feeds them (every k and v fragment is read
// from shared memory and split into its high and low parts) and latency:
// a warp's products, softmax and products again depend on each other, and
// the registers leave room for few warps an SM.
//
// Design: a block of four warps takes BQ = 128 q rows of one slab; warp w
// owns rows 32 w .. 32 w + 31 (two m-tiles of 16, so that every k and v
// fragment it loads and splits serves two products) and every column of
// o. Narrow widths let a warp keep what the wide kernel had to share
// through shared memory:
//   * q's tile is resident in shared memory (one TMA box, rows padded like
//     k's); its A fragments are read and split once a k-step of a kv tile;
//   * s = q k^T: the warp's 32 x BK score tile in registers, over the
//     k-steps of d8 = d rounded up to 8. A k-step's two columns of a lane
//     are 2t and 2t + 1 (the same permutation of k on both operands), so
//     each fragment half is one 64-bit load;
//   * the online softmax on those accumulators: the row maxima and sums
//     over the four lanes of a row by shuffles; no shared memory, no block
//     barrier;
//   * o += p v straight from the score accumulators: the m16n8 accumulator's
//     (row g, columns 2t, 2t + 1) are the m16n8k8 A fragment's (row g, k t)
//     and (row g, k t + 4) once v's B fragments read kv rows 2t and 2t + 1
//     (32-bit loads, v's row stride 4 (mod 8) floats: no bank conflicts).
//     The tensor cores' sums round toward zero relative to what they add
//     to, so each tile's products are summed from zero and added to o by
//     fp32 adds, as in the wide forward.
//   * the stream: k and v tiles of BK kv rows (64; 16 at DMAX 128) through
//     a ring of two slots, one k and one v tile a slot, each one TMA box
//     whose columns past d are zero and pad the rows (k's and q's rows to
//     8 (mod 32) floats for the 64-bit loads, v's to 4 (mod 8)); zero past
//     the slab's rows. Each slot has a full mbarrier (the TMA bytes) and an
//     empty one (one arrival a warp once it left the slot); thread 0 waits
//     on the empty one at the end of the tile and refills the slot two
//     tiles on. Where d % 4 != 0 or a base is off 16 bytes, every thread
//     copies its share of 4-byte words with cp.async after that wait, and
//     the copies complete on the full mbarrier
//     (cp.async.mbarrier.arrive.noinc).
// Blocks an SM (registers and shared memory): 2 (60 KB each at DMAX 32,
// 109 KB at 64, 104 KB at 128). Ragged q rows read zeros and are never
// written; ragged kv columns are masked to -inf. No atomics: the same
// bytes on every launch.

template <int DMAX>
struct NarrowCfg {
  static constexpr int NW = 4;  // warps
  static constexpr int THREADS = 32 * NW;
  static constexpr int MT = 2;                      // m-tiles of 16 q rows a warp
  static constexpr int BQ = 16 * MT * NW;           // q rows a block
  static constexpr int BK = DMAX == 128 ? 16 : 64;  // kv rows a tile
  // row strides in floats: 8 (mod 32) for q's and k's 64-bit fragment
  // loads, 4 (mod 8) for v's 32-bit loads of rows 2t, 2t + 1
  static constexpr int LDK = DMAX + 8, LDV = DMAX + 4;
  static constexpr int QT = BQ * LDK;                 // the q tile
  static constexpr int KT = BK * LDK, VT = BK * LDV;  // a slot: a k tile, then a v tile
  static constexpr int RING = 2;
  static constexpr int MINB = 2;  // blocks an SM
  // the q tile and the ring (128-byte aligned for TMA), a full and an
  // empty mbarrier a slot and q's, and 128 bytes of alignment
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)QT + RING * (KT + VT)) + 16 * RING + 8 + 128;
};

template <int DMAX, bool VEC>
__global__ void __launch_bounds__(NarrowCfg<DMAX>::THREADS, NarrowCfg<DMAX>::MINB)
flash_fwd_f32_narrow_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ lse, int tq, int tk, int d, float scale) {
  typedef NarrowCfg<DMAX> C;
  constexpr int BK = C::BK, LDK = C::LDK, LDV = C::LDV, RING = C::RING, MT = C::MT;
  constexpr int NKS = DMAX / 8;  // k-steps of s and n-tiles of o, at most
  constexpr int NT = BK / 8;     // n-tiles of s, k-steps of o += p v
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* Qs = reinterpret_cast<float*>(
      smem_raw + ((128u - (hopper::smem_addr(smem_raw) & 127u)) & 127u));
  float* ring = Qs + C::QT;                                                     // [RING][k, v tile]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING * (C::KT + C::VT));  // [RING]
  uint64_t* empty = full + RING;                                                // [RING]
  uint64_t* qfull = empty + RING;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * C::BQ;
  const float* qb = q + (size_t)bh * tq * d;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;
  const float sl2 = scale * LOG2E;
  const int d8 = (d + 7) & ~7;  // columns the k-steps read (zero past d)
  const int nks = d8 >> 3;      // k-steps of s, n-tiles of o
  const int ntile = (tk + BK - 1) / BK;

  // rows [r0, r0 + rows) of an fp32 [n, d] slab into dst (row stride
  // ld), columns up to d8, zero past the slab: every thread's share of
  // 4-byte cp.async copies
  auto copy4 = [&](float* dst, int ld, const float* src, int r0, int rows, int n) {
    for (int i = threadIdx.x; i < rows * d8; i += C::THREADS) {
      const int r = i / d8, c = i - r * d8;
      const bool in = r0 + r < n && c < d;
      cp_async4(smem_u32(dst + r * ld + c), src + (in ? (size_t)(r0 + r) * d + c : 0), in ? 4 : 0);
    }
  };
  // kv tile j into ring slot j % RING, completing on its full mbarrier: by
  // thread 0 (TMA), or by every thread (4-byte copies)
  auto load = [&](int j) {
    const int slot = j % RING;
    float* dst = ring + slot * (C::KT + C::VT);
    if (VEC) {
      hopper::mbar_arrive_tx(full + slot, (C::KT + C::VT) * 4);
      hopper::tma_load_3d(dst, &kmap, 0, j * BK, bh, full + slot);
      hopper::tma_load_3d(dst + C::KT, &vmap, 0, j * BK, bh, full + slot);
    } else {
      copy4(dst, LDK, kb, j * BK, BK, tk);
      copy4(dst + C::KT, LDV, vb, j * BK, BK, tk);
      cp_async_arrive(full + slot);
    }
  };

  if (threadIdx.x < RING) {
    hopper::mbar_init(full + threadIdx.x, VEC ? 1 : C::THREADS);
    hopper::mbar_init(empty + threadIdx.x, C::NW);
  }
  if (threadIdx.x == 0) hopper::mbar_init(qfull, VEC ? 1 : C::THREADS);
  hopper::mbar_init_fence();
  __syncthreads();
  if (VEC) {
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_tx(qfull, C::QT * 4);
      hopper::tma_load_3d(Qs, &qmap, 0, q0, bh, qfull);
      for (int j = 0; j < min(RING, ntile); ++j) load(j);
    }
  } else {
    copy4(Qs, LDK, qb, q0, C::BQ, tq);
    cp_async_arrive(qfull);
    for (int j = 0; j < min(RING, ntile); ++j) load(j);
  }

  float acc[MT][NKS][4];  // o: rows 16 m + g (+ 8) of the warp's, columns 8 n + 2 t4 (+ 1)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NKS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) m_run[m][h] = -INFINITY, l_run[m][h] = 0.f;
  const float* qp = Qs + (16 * MT * warp + g) * LDK + 2 * t4;  // the lane's base in q's tile
  const int koff = g * LDK + 2 * t4;                           // in a k tile
  const int voff = 2 * t4 * LDV + g;                           // in a v tile
  hopper::mbar_wait(qfull, 0);

#pragma unroll 1
  for (int j = 0; j < ntile; ++j) {
    const int slot = j % RING;
    hopper::mbar_wait(full + slot, (j / RING) & 1);  // tile j is in
    const float* kp = ring + slot * (C::KT + C::VT) + koff;
    const float* vp = ring + slot * (C::KT + C::VT) + C::KT + voff;

    // s = q k^T: kv columns 8 n + 2 t4 (+ 1) of the tile
    float s[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[m][n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if (ks < nks) {
        uint32_t a[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float2 x = *reinterpret_cast<const float2*>(qp + 16 * m * LDK + 8 * ks);
          const float2 y = *reinterpret_cast<const float2*>(qp + (16 * m + 8) * LDK + 8 * ks);
          a[m][0] = __float_as_uint(x.x);
          a[m][1] = __float_as_uint(y.x);
          a[m][2] = __float_as_uint(x.y);
          a[m][3] = __float_as_uint(y.y);
#pragma unroll
          for (int e = 0; e < 4; ++e) al[m][e] = tf32_lo(a[m][e]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 b = *reinterpret_cast<const float2*>(kp + 8 * n * LDK + 8 * ks);
          const uint32_t b0 = __float_as_uint(b.x), b1 = __float_as_uint(b.y);
          const uint32_t bl0 = tf32_lo(b0), bl1 = tf32_lo(b1);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma3(s[m][n], a[m], al[m], b0, b1, bl0, bl1);
        }
      }
    }

    // the online softmax on the accumulators (log2 units: m_run is the
    // rows' running maximum of s scale log2 e)
    const int nvalid = tk - j * BK;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (nvalid < BK && 8 * n + 2 * t4 + (e & 1) >= nvalid) s[m][n][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[m][n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float mn = fmaxf(m_run[m][h], mx[h] * sl2);
        alpha[h] = hopper::ex2(m_run[m][h] - mn);  // 0 on the first tile (m = -inf)
        m_run[m][h] = mn;
        l_run[m][h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = hopper::ex2(fmaf(s[m][n][e], sl2, -m_run[m][e >> 1]));
          l_run[m][e >> 1] += p;  // this lane's share of the row sum
          s[m][n][e] = p;
        }
#pragma unroll
      for (int n = 0; n < NKS; ++n) {
        if (n < nks) {
          acc[m][n][0] *= alpha[0];
          acc[m][n][1] *= alpha[0];
          acc[m][n][2] *= alpha[1];
          acc[m][n][3] *= alpha[1];
        }
      }
    }

    // o += p v: the tile's products summed from zero, then added to o in
    // fp32
    uint32_t pa[MT][NT][4], pl[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        // (row g, column 2t + 1) -> k t + 4
        pa[m][i][0] = __float_as_uint(s[m][i][0]);
        pa[m][i][1] = __float_as_uint(s[m][i][2]);
        pa[m][i][2] = __float_as_uint(s[m][i][1]);
        pa[m][i][3] = __float_as_uint(s[m][i][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) pl[m][i][e] = tf32_lo(pa[m][i][e]);
      }
#pragma unroll
    for (int n = 0; n < NKS; ++n) {
      if (n < nks) {
        float t[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[m][e] = 0.f;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const float* bp = vp + 8 * i * LDV + 8 * n;
          const uint32_t b0 = __float_as_uint(bp[0]), b1 = __float_as_uint(bp[LDV]);
          const uint32_t bl0 = tf32_lo(b0), bl1 = tf32_lo(b1);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma3(t[m], pa[m][i], pl[m][i], b0, b1, bl0, bl1);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] += t[m][e];
      }
    }

    // the warp leaves the slot; once all have, it takes tile j + RING
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + slot);
    if (j + RING < ntile && (!VEC || threadIdx.x == 0)) {
      hopper::mbar_wait(empty + slot, (j / RING) & 1);
      load(j + RING);
    }
    __syncwarp();
  }

  // the row sums over a row's four lanes; o and lse written once, ragged
  // rows and columns never
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l_run[m][h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = q0 + 16 * (MT * warp + m) + g + 8 * h;
      if (row >= tq) continue;
      const float inv = 1.f / sum;
      float* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
      for (int n = 0; n < NKS; ++n) {
        const int col = 8 * n + 2 * t4;
        if (col < d) orow[col] = acc[m][n][2 * h] * inv;
        if (col + 1 < d) orow[col + 1] = acc[m][n][2 * h + 1] * inv;
      }
      if (t4 == 0) lse[(size_t)bh * tq + row] = m_run[m][h] * LN2 + logf(sum);
    }
}

// ----------------------------------- fused backward on 3xTF32 products
//
// flash_bwd_fused_f32 (D <= 128), in place of the Pallas
// `_bwd_fused_kernel` on fp32 slabs: from the forward's lse and
// delta = rowsum(o do), p = exp(s scale - lse) with s = q k^T,
// dp = do v^T and ds = p (dp - delta) scale, then dv = p^T do,
// dk = ds^T q and dq = ds k, in one kv-major pass.
//
// What bounds it: five products of 2 BH Tq Tk D flops, each fp32 product
// as three TF32 ones at 495 TFLOP/s (1.30 ms at [32, 4096, 4096, 40]), on
// mma.sync (wgmma takes TF32 only K-major; the output products' operands
// q, do and, in dq = ds k, k are MN-major). Beside them: the work that
// feeds them (every fragment read from shared memory and split into its
// high and low parts), at two warps a scheduler, and dq's partial sums,
// which the blocks of the other kv rows add into the same rows of dq.
//
// Design: one instance a padded head width W (16, 32, 40, 48, 64, 80, 96,
// 128), so that every loop over k-steps and n-tiles has its bound at
// compile time (a runtime bound on each unrolled step cut the code into
// blocks ptxas scheduled one at a time: 6.1 against 3.9 ms at
// [32, 4096, 4096, 40]); columns past d are zero in shared memory. A block
// of eight warps keeps BK = 128 kv rows of k and v resident in shared
// memory, warp w owning rows 16 w .. 16 w + 15 (one m-tile: the warp holds
// dk and dv of its rows, 2 WH / 8 x 4 accumulators a thread), and streams
// tiles of BQ q rows of q and do (32; 16 at W = 128, where k and v take
// 135 KB) with their lse and delta. The block owns WH = W head columns of
// dk, dv and dq; at W = 128 two blocks split them (WH = 64), each forming
// the whole s^T and dp^T, since 128 accumulators of dk and dv left ptxas
// too few registers (the bf16 fused kernel does the same past D = 80):
//   * s^T = k q^T and dp^T = v do^T: the warp's 16 x BQ tiles in
//     registers, over W / 8 k-steps, both operands K-major, fragments by
//     ldmatrix (fp32 words moved as b16 pairs);
//   * p^T and ds^T on those accumulators (ex2.approx; q rows past tq carry
//     lse = +inf, so p = 0 there; p of kv rows past tk is set to 0);
//   * dv += p^T do and dk += ds^T q straight from the accumulators: the
//     m16n8 accumulator's (row g, columns 2t, 2t + 1) are the m16n8k8 A
//     fragment's (row g, k t) and (k t + 4) once the B operand's rows are
//     read as 2t, 2t + 1 (32-bit loads). Each q tile's products are summed
//     from zero and added to the fp32 accumulators (the tensor cores' sums
//     round toward zero relative to what they add to), four n-tiles at a
//     time (eight independent chains), one past WH = 64 (registers);
//   * dq = ds k: the registers hold ds^T, not ds as an A operand, so ds^T
//     goes to shared memory. After the tile's first block barrier warp w
//     forms the partial sum of m-tile w % (BQ / 16) of the q tile over a
//     quarter of the block's kv rows (4 k-steps, from zero), for its
//     n-tiles (all of them; every second one at W = 128), so that every
//     warp forms as many products as any other (an earlier split by
//     (m-tile, n-tile) over all 128 rows left two warps of eight with
//     twice the products at D = 40); the three other quarters' partial
//     sums meet the first's in shared memory behind a second barrier, are
//     added in a fixed order and staged unpadded and row-contiguous; after
//     the next tile's first barrier thread 0 sends the block's part out as
//     one bulk reduce-add (cp.reduce.async.bulk .add.f32) into the zeroed
//     fp32 dq (one a row at W = 128): BH Tq D 4 bytes x Tk / 128 of reduce
//     traffic (0.67 GB at [32, 4096, 4096, 40]). Blocks add in no order,
//     so dq is not bitwise reproducible; dk and dv are (no atomics);
//   * one row stride, W + 4 floats (an odd multiple of 4), for k, v, q and
//     do: the eight 16-byte rows of an ldmatrix and the 32-bit loads of
//     rows 2t, 2t + 1 (column g) are both free of bank conflicts; ds^T's
//     rows are BQ + 4 floats, 4 (mod 8), for its reads of rows 2t, 2t + 1;
//     the partial sums' 8 (mod 32), for their 64-bit accesses;
//   * the stream: q and do tiles through a ring of two slots, each tile
//     one TMA box of BQ rows x (W + 4) columns, zero past the slab's rows
//     and columns, completing on the slot's full mbarrier; thread 0
//     refills a slot after the tile's first barrier, which every warp
//     passes only once it has left the slot. lse and delta of the next
//     tile are read while this one runs and staged behind the same
//     barrier. Where d % 4 != 0 or a base is off 16 bytes, every thread
//     copies its share of 4-byte words with cp.async (completing on the
//     same mbarriers through cp.async.mbarrier.arrive.noinc) and the first
//     quarter's warps add dq with atomicAdd, since a bulk copy takes only
//     16-byte ranges.
// One block an SM (66 KB at W = 16 to 220 KB at 96, 193 KB at 128). Ragged
// kv rows are never written.

template <int W>
struct FusedCfg {
  static constexpr int NW = 8;  // warps
  static constexpr int THREADS = 32 * NW;
  static constexpr int NKS = W / 8;             // k-steps of s^T and dp^T
  static constexpr int BK = 16 * NW;            // kv rows a block: one m-tile a warp
  static constexpr int BQ = W == 128 ? 16 : 32;  // q rows a stream tile
  static constexpr int NT = BQ / 8;             // n-tiles of s^T, k-steps of dk and dv
  // blocks that split the head columns of dk, dv and dq, each forming the
  // whole s^T and dp^T (two at W = 128, where a warp's dk and dv of every
  // column, 128 accumulators a thread, left ptxas too few registers), and
  // the columns and n-tiles a block owns
  static constexpr int NH = W == 128 ? 2 : 1, WH = W / NH, NKO = WH / 8;
  static constexpr int NG2 = NKO > 8 ? 1 : 4;  // dk, dv: n-tiles formed at once
  // dq = ds k, warp w: m-tile w % MQ of the q tile, n-tiles w / MQ % NGR
  // (+ NGR, ..), kv rows (w / (MQ NGR)) BK / KH .. (a quarter)
  static constexpr int MQ = BQ / 16, KH = 4, NGR = NW / (MQ * KH);
  static constexpr int NPW = (NKO + NGR - 1) / NGR;  // dq: n-tiles a warp, at most
  static constexpr int KPW = BK / 8 / KH;            // dq: k-steps a warp
  // row strides in floats: an odd multiple of 4 for k, v, q and do
  // (ldmatrix rows and 32-bit loads of rows 2t, 2t + 1), 4 (mod 8) for
  // ds^T, 8 (mod 32) for the dq partial sums
  static constexpr int LD = W + 4, LDS = BQ + 4, LDR = (WH + 23) / 32 * 32 + 8;
  static constexpr int RING = 2;
  static constexpr int KT = BK * LD, ST = BQ * LD;  // a resident tile, a stream tile
  // ds^T, the dq staging buffer, the other quarters' dq partial sums
  static constexpr int DST = BK * LDS, DQT = BQ * WH, RED = (KH - 1) * BQ * LDR;
  // k and v, the ring (a q and a do tile a slot; 128-byte aligned for
  // TMA), dq's staging, ds^T, the other parts' dq partial sums, lse and
  // delta of two tiles; a full mbarrier a slot and k and v's; 128 bytes of
  // alignment
  static constexpr size_t SMEM =
      sizeof(float) * (2 * (size_t)KT + RING * 2 * ST + DQT + DST + RED + 4 * BQ) +
      8 * (RING + 1) + 128;
};

template <int W, bool VEC>
__global__ void __launch_bounds__(FusedCfg<W>::THREADS, 1)
flash_bwd_fused_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dq, float* __restrict__ dk,
                           float* __restrict__ dv, int tq, int tk, int d, float scale) {
  typedef FusedCfg<W> C;
  constexpr int BK = C::BK, BQ = C::BQ, NT = C::NT, LD = C::LD, LDS = C::LDS, RING = C::RING;
  constexpr int NKS = C::NKS, NKO = C::NKO, NG2 = C::NG2, NGR = C::NGR, NPW = C::NPW;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* Ks = reinterpret_cast<float*>(
      smem_raw + ((128u - (hopper::smem_addr(smem_raw) & 127u)) & 127u));
  float* Vs = Ks + C::KT;
  float* ring = Vs + C::KT;                   // [RING][q, do tile]
  float* dq_stage = ring + RING * 2 * C::ST;  // [BQ][d, or WH]: the block's part of dq
  float* dsT = dq_stage + C::DQT;             // [BK][LDS]
  float* red = dsT + C::DST;                  // [KH - 1][BQ][LDR]: dq partial sums
  float* stats = red + C::RED;                // [2][lse log2 e, delta][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 4 * BQ);  // [RING]
  uint64_t* kvfull = full + RING;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int c0 = C::NH > 1 ? blockIdx.z * C::WH : 0;  // the block's first column of dk, dv, dq
  const int sw = C::NH > 1 ? C::WH : d;                // dq_stage's row stride
  const size_t qoff = (size_t)bh * tq, koff = (size_t)bh * tk;
  const float sl2 = scale * LOG2E;
  const int ntile = (tq + BQ - 1) / BQ;

  // rows [r0, r0 + rows) of an fp32 [n, d] slab into dst (row stride LD),
  // columns up to W, zero past the slab: every thread's share of 4-byte
  // cp.async copies
  auto copy4 = [&](float* dst, const float* src, int r0, int rows, int n) {
    for (int i = threadIdx.x; i < rows * W; i += C::THREADS) {
      const int r = i / W, c = i % W;
      const bool in = r0 + r < n && c < d;
      cp_async4(smem_u32(dst + r * LD + c), src + (in ? (size_t)(r0 + r) * d + c : 0), in ? 4 : 0);
    }
  };
  // q tile j and do tile j into ring slot j % RING, completing on its full
  // mbarrier: by thread 0 (TMA), or by every thread (4-byte copies)
  auto load = [&](int j) {
    const int slot = j % RING;
    float* dst = ring + slot * 2 * C::ST;
    if (VEC) {
      hopper::mbar_arrive_tx(full + slot, 2 * C::ST * 4);
      hopper::tma_load_3d(dst, &qmap, 0, j * BQ, bh, full + slot);
      hopper::tma_load_3d(dst + C::ST, &domap, 0, j * BQ, bh, full + slot);
    } else {
      copy4(dst, q + qoff * d, j * BQ, BQ, tq);
      copy4(dst + C::ST, dout + qoff * d, j * BQ, BQ, tq);
      cp_async_arrive(full + slot);
    }
  };
  // lse log2 e and delta of row threadIdx.x of q tile j (threads < BQ);
  // +inf and 0 past tq, so that p = ds = 0 there
  auto row_stats = [&](int j, float& l2, float& dl) {
    const int r = j * BQ + threadIdx.x;
    l2 = r < tq ? __ldg(lse + qoff + r) * LOG2E : INFINITY;
    dl = r < tq ? __ldg(delta + qoff + r) : 0.f;
  };
  // the block's part of q tile j's dq, staged in dq_stage, into dq: one
  // bulk reduce-add of its rows (a contiguous range of [BH, Tq, D]), or one
  // a row where the block owns part of the columns
  auto reduce_tile = [&](int j) {
    const int r0 = j * BQ, rows = min(BQ, tq - r0);
    for (int r = 0; r < (C::NH > 1 ? rows : 1); ++r)
      hopper::bulk_reduce_add_f32(dq + (qoff + r0 + r) * d + c0, dq_stage + r * sw,
                                  (uint32_t)((C::NH > 1 ? min(C::WH, d - c0) : rows * d) * 4));
    hopper::bulk_commit();
  };

  if (threadIdx.x < RING) hopper::mbar_init(full + threadIdx.x, VEC ? 1 : C::THREADS);
  if (threadIdx.x == 0) hopper::mbar_init(kvfull, VEC ? 1 : C::THREADS);
  hopper::mbar_init_fence();
  if (threadIdx.x < BQ) row_stats(0, stats[threadIdx.x], stats[BQ + threadIdx.x]);
  __syncthreads();
  if (VEC) {
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_tx(kvfull, 2 * C::KT * 4);
      hopper::tma_load_3d(Ks, &kmap, 0, k0, bh, kvfull);
      hopper::tma_load_3d(Vs, &vmap, 0, k0, bh, kvfull);
      for (int j = 0; j < min(RING, ntile); ++j) load(j);
    }
  } else {
    copy4(Ks, k + koff * d, k0, BK, tk);
    copy4(Vs, v + koff * d, k0, BK, tk);
    cp_async_arrive(kvfull);
    for (int j = 0; j < min(RING, ntile); ++j) load(j);
  }

  // s^T, dp^T: A fragments of the warp's kv rows, B fragments of the
  // tile's rows, by ldmatrix
  const int a_off = (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 4 * (lane >> 4);
  const int b_off = ((lane & 7) + 8 * (lane >> 4)) * LD + 4 * ((lane >> 3) & 1);
  // dk, dv (and dq's k): rows 2t, 2t + 1 of a k-step, column g
  const int m_off = 2 * t4 * LD + g;
  // dq: m-tile mq, n-tiles ng, ng + NGR, .., k-steps KPW kh ..; ds^T rows
  // 2t, 2t + 1 of a k-step
  const int mq = warp % C::MQ, ng = warp / C::MQ % NGR, kh = warp / (C::MQ * NGR);
  const int ds_off = 2 * t4 * LDS + 16 * mq + g;
  // the partial sums' rows 16 mq + g (+ 8), columns 8 n + 2 t4 (+ 1)
  const int red_off = (16 * mq + g) * C::LDR + 2 * t4;
  // the lane's kv rows 16 w + g (+ 8); p there is 0 past tk
  const bool kv_ragged = k0 + BK > tk;
  const bool row_in0 = k0 + 16 * warp + g < tk, row_in1 = k0 + 16 * warp + g + 8 < tk;
  // rows g (+ 8) of the warp's, columns c0 + 8 n + 2 t4 (+ 1)
  float dk_acc[NKO][4], dv_acc[NKO][4];
#pragma unroll
  for (int n = 0; n < NKO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  hopper::mbar_wait(kvfull, 0);

#pragma unroll 1
  for (int j = 0; j < ntile; ++j) {
    const int slot = j % RING, b = j & 1;
    float nl2 = 0.f, ndl = 0.f;  // the next tile's statistics, read while this one runs
    if (threadIdx.x < BQ && j + 1 < ntile) row_stats(j + 1, nl2, ndl);
    hopper::mbar_wait(full + slot, (j / RING) & 1);  // tile j is in
    const float* Qt = ring + slot * 2 * C::ST;
    const float* Dt = Qt + C::ST;

    // s^T = k q^T and dp^T = v do^T: the tile's q rows 8 n + 2 t4 (+ 1)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      uint32_t ka[4], kl[4], va[4], vl[4];
      ldsm4(ka, Ks + a_off + 8 * ks);
      ldsm4(va, Vs + a_off + 8 * ks);
#pragma unroll
      for (int e = 0; e < 4; ++e) kl[e] = tf32_lo(ka[e]), vl[e] = tf32_lo(va[e]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t qb[4], ql[4], db[4], dl[4];
        ldsm4(qb, Qt + b_off + 16 * np * LD + 8 * ks);
        ldsm4(db, Dt + b_off + 16 * np * LD + 8 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e) ql[e] = tf32_lo(qb[e]), dl[e] = tf32_lo(db[e]);
        mma3(s[2 * np], ka, kl, qb[0], qb[1], ql[0], ql[1]);
        mma3(s[2 * np + 1], ka, kl, qb[2], qb[3], ql[2], ql[3]);
        mma3(dp[2 * np], va, vl, db[0], db[1], dl[0], dl[1]);
        mma3(dp[2 * np + 1], va, vl, db[2], db[3], dl[2], dl[3]);
      }
    }

    // p^T and ds^T on the accumulators; ds^T to shared memory for dq; both
    // as the A fragments of dv and dk: (row g, column 2t + 1) -> k t + 4
    const float* st = stats + b * 2 * BQ;
    float* dsw = dsT + (16 * warp + g) * LDS + 2 * t4;
    uint32_t pa[NT][4], pl[NT][4], da[NT][4], dal[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 L = *reinterpret_cast<const float2*>(st + 8 * n + 2 * t4);
      const float2 D = *reinterpret_cast<const float2*>(st + BQ + 8 * n + 2 * t4);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = hopper::ex2(fmaf(s[n][e], sl2, -((e & 1) ? L.y : L.x)));
        if (kv_ragged && !((e >> 1) ? row_in1 : row_in0)) p[e] = 0.f;
        ds[e] = p[e] * (dp[n][e] - ((e & 1) ? D.y : D.x)) * scale;
      }
      *reinterpret_cast<float2*>(dsw + 8 * n) = make_float2(ds[0], ds[1]);
      *reinterpret_cast<float2*>(dsw + 8 * LDS + 8 * n) = make_float2(ds[2], ds[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ((e & 1) << 1) | (e >> 1);
        pa[n][i] = __float_as_uint(p[e]);
        da[n][i] = __float_as_uint(ds[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) pl[n][e] = tf32_lo(pa[n][e]), dal[n][e] = tf32_lo(da[n][e]);
    }

    // dv += p^T do and dk += ds^T q, NG2 n-tiles at a time (2 NG2
    // independent chains): the tile's products summed from zero, then
    // added in fp32
#pragma unroll
    for (int n0 = 0; n0 < NKO; n0 += NG2) {
      float tv[NG2][4], tkk[NG2][4];
#pragma unroll
      for (int u = 0; u < NG2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) tv[u][e] = tkk[u][e] = 0.f;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int u = 0; u < NG2; ++u) {
          if (n0 + u < NKO) {
            const float* dop = Dt + m_off + 8 * i * LD + c0 + 8 * (n0 + u);
            const float* qp = Qt + m_off + 8 * i * LD + c0 + 8 * (n0 + u);
            const uint32_t d0 = __float_as_uint(dop[0]), d1 = __float_as_uint(dop[LD]);
            const uint32_t q0 = __float_as_uint(qp[0]), q1 = __float_as_uint(qp[LD]);
            mma3(tv[u], pa[i], pl[i], d0, d1, tf32_lo(d0), tf32_lo(d1));
            mma3(tkk[u], da[i], dal[i], q0, q1, tf32_lo(q0), tf32_lo(q1));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < NG2; ++u) {
        if (n0 + u < NKO) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dv_acc[n0 + u][e] += tv[u][e], dk_acc[n0 + u][e] += tkk[u][e];
        }
      }
    }

    if (threadIdx.x < BQ && j + 1 < ntile) {
      stats[(b ^ 1) * 2 * BQ + threadIdx.x] = nl2;
      stats[(b ^ 1) * 2 * BQ + BQ + threadIdx.x] = ndl;
    }
    // ds^T of tile j is in; every warp has left the slot, and tile j - 1's
    // part of dq is staged (and fenced)
    __syncthreads();
    if (j + RING < ntile && (!VEC || threadIdx.x == 0)) load(j + RING);
    if (VEC && threadIdx.x == 0 && j > 0) reduce_tile(j - 1);

    // dq's partial sum over the warp's quarter of the block's kv rows,
    // ds k: k-steps of kv rows 2t, 2t + 1, summed from zero, an n-tile a
    // chain
    const float* ap = dsT + ds_off;
    const float* kp = Ks + m_off + c0;
    float acc[NPW][4];
#pragma unroll
    for (int i = 0; i < NPW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int kq = 0; kq < C::KPW; ++kq) {
      const int kk = C::KPW * kh + kq;
      uint32_t a[4], al[4];
      a[0] = __float_as_uint(ap[8 * kk * LDS]);
      a[1] = __float_as_uint(ap[8 * kk * LDS + 8]);
      a[2] = __float_as_uint(ap[(8 * kk + 1) * LDS]);
      a[3] = __float_as_uint(ap[(8 * kk + 1) * LDS + 8]);
#pragma unroll
      for (int e = 0; e < 4; ++e) al[e] = tf32_lo(a[e]);
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        const int n = ng + NGR * i;
        if (NKO % NGR == 0 || n < NKO) {
          const uint32_t b0 = __float_as_uint(kp[8 * kk * LD + 8 * n]);
          const uint32_t b1 = __float_as_uint(kp[(8 * kk + 1) * LD + 8 * n]);
          mma3(acc[i], a, al, b0, b1, tf32_lo(b0), tf32_lo(b1));
        }
      }
    }
    // the other quarters' partial sums to shared memory; behind a barrier
    // the first quarter's warps add them in a fixed order
    if (kh > 0) {
      float* rw = red + (kh - 1) * BQ * C::LDR + red_off;
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        const int n = ng + NGR * i;
        if (NKO % NGR == 0 || n < NKO) {
          *reinterpret_cast<float2*>(rw + 8 * n) = make_float2(acc[i][0], acc[i][1]);
          *reinterpret_cast<float2*>(rw + 8 * C::LDR + 8 * n) = make_float2(acc[i][2], acc[i][3]);
        }
      }
    }
    // dq_stage is written below: the reduce of tile j - 1 has read it
    if (VEC && threadIdx.x == 0) hopper::bulk_wait_read<0>();
    __syncthreads();  // the partial sums are in; every warp is done with ds^T
    if (kh == 0) {
      // rows 16 mq + g (+ 8) of the tile, columns c0 + col, col = 8 n +
      // 2 t4 (+ 1): staged (TMA route: d % 4 == 0, so a pair is in or out
      // together), or added into dq element by element
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        const int col = 8 * (ng + NGR * i) + 2 * t4;
        if (c0 + col >= d) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * mq + g + 8 * h;
          float2 sum = make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
#pragma unroll
          for (int x = 0; x < C::KH - 1; ++x) {
            const float2 y =
                *reinterpret_cast<const float2*>(red + x * BQ * C::LDR + r * C::LDR + col);
            sum.x += y.x, sum.y += y.y;
          }
          if (VEC) {
            *reinterpret_cast<float2*>(dq_stage + r * sw + col) = sum;
          } else if (j * BQ + r < tq) {
            float* dqr = dq + (qoff + j * BQ + r) * d + c0 + col;
            atomicAdd(dqr, sum.x);
            if (c0 + col + 1 < d) atomicAdd(dqr + 1, sum.y);
          }
        }
      }
      if (VEC) hopper::fence_proxy_async();  // the staged sums, for the bulk reduce
    }
  }
  if (VEC) {
    __syncthreads();  // the last tile's part of dq is staged
    if (threadIdx.x == 0) {
      reduce_tile(ntile - 1);
      hopper::bulk_wait_all();
    }
  }

  // dk and dv: rows 16 w + g (+ 8) of the block, ragged rows and columns
  // never written
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + 16 * warp + g + 8 * h;
    if (row >= tk) continue;
    float* dkr = dk + (koff + row) * d;
    float* dvr = dv + (koff + row) * d;
#pragma unroll
    for (int n = 0; n < NKO; ++n) {
      const int col = c0 + 8 * n + 2 * t4;
      if (col < d) dkr[col] = dk_acc[n][2 * h], dvr[col] = dv_acc[n][2 * h];
      if (col + 1 < d) dkr[col + 1] = dk_acc[n][2 * h + 1], dvr[col + 1] = dv_acc[n][2 * h + 1];
    }
  }
}

// --------------------------------------------------------------------- dq

template <int DP, int RW>
struct DqCfg {
  static constexpr int BQ = 4 * RW;
  static constexpr int LDK = DP + 1;
  static constexpr size_t SMEM = sizeof(float) * (2 * (size_t)BQ * DP + 2 * TILE * LDK);
};

template <int DP, int RW>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int tq, int tk, int d, float scale) {
  typedef DqCfg<DP, RW> C;
  constexpr int NC = DP / 32;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* dOs = Qs + C::BQ * DP;
  float* Ks = dOs + C::BQ * DP;
  float* Vs = Ks + TILE * C::LDK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::BQ;
  const size_t qoff = (size_t)bh * tq, koff = (size_t)bh * tk;
  const float sl2 = scale * LOG2E;
  stage<C::BQ, DP, DP>(Qs, q + qoff * d, q0, tq, d);
  stage<C::BQ, DP, DP>(dOs, dout + qoff * d, q0, tq, d);
  const float* qw = Qs + warp * RW * DP;
  const float* dow = dOs + warp * RW * DP;
  float lse2[RW], dl[RW], acc[RW][NC];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = min(q0 + warp * RW + r, tq - 1);
    lse2[r] = lse[qoff + row] * LOG2E;
    dl[r] = delta[qoff + row];
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }
  for (int k0 = 0; k0 < tk; k0 += TILE) {
    __syncthreads();
    stage<TILE, DP, C::LDK>(Ks, k + koff * d, k0, tk, d);
    stage<TILE, DP, C::LDK>(Vs, v + koff * d, k0, tk, d);
    __syncthreads();
    float s[RW], dp[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float kc = Ks[lane * C::LDK + c], vc = Vs[lane * C::LDK + c];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        s[r] = fmaf(qw[r * DP + c], kc, s[r]);
        dp[r] = fmaf(dow[r * DP + c], vc, dp[r]);
      }
    }
    const bool valid = k0 + lane < tk;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float p = valid ? exp2f(s[r] * sl2 - lse2[r]) : 0.f;
      s[r] = p * (dp[r] - dl[r]) * scale;  // ds
    }
    const int nj = min(TILE, tk - k0);
    for (int j = 0; j < nj; ++j) {
      float kj[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) kj[i] = Ks[j * C::LDK + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float ds = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(ds, kj[i], acc[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    if (row >= tq) continue;
    float* dqrow = dq + (qoff + row) * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) dqrow[c] = acc[r][i];
    }
  }
}

// ----------------------------------------------------------------- dk, dv

template <int DP, int RW>
struct DkvCfg {
  static constexpr int BK = 4 * RW;
  static constexpr int LDQ = DP + 1;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * (size_t)BK * DP + 2 * (size_t)TILE * LDQ + 2 * TILE);
};

template <int DP, int RW>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, int tq, int tk, int d, float scale) {
  typedef DkvCfg<DP, RW> C;
  constexpr int NC = DP / 32;
  constexpr int LDQ = C::LDQ;
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;
  float* Vs = Ks + C::BK * DP;
  float* Qs = Vs + C::BK * DP;
  float* dOs = Qs + TILE * LDQ;
  float* lse_s = dOs + TILE * LDQ;  // lse * log2(e)
  float* dl_s = lse_s + TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * C::BK;
  const size_t qoff = (size_t)bh * tq, koff = (size_t)bh * tk;
  const float sl2 = scale * LOG2E;
  stage<C::BK, DP, DP>(Ks, k + koff * d, k0, tk, d);
  stage<C::BK, DP, DP>(Vs, v + koff * d, k0, tk, d);
  const float* kw = Ks + warp * RW * DP;
  const float* vw = Vs + warp * RW * DP;
  float dk_acc[RW][NC], dv_acc[RW][NC];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) dk_acc[r][i] = dv_acc[r][i] = 0.f;

  for (int q0 = 0; q0 < tq; q0 += TILE) {
    __syncthreads();  // the previous q tile's readers are done
    stage<TILE, DP, LDQ>(Qs, q + qoff * d, q0, tq, d);
    stage<TILE, DP, LDQ>(dOs, dout + qoff * d, q0, tq, d);
    for (int r = threadIdx.x; r < TILE; r += THREADS) {
      const bool in = q0 + r < tq;
      lse_s[r] = in ? lse[qoff + q0 + r] * LOG2E : 0.f;
      dl_s[r] = in ? delta[qoff + q0 + r] : 0.f;
    }
    __syncthreads();

    // lane j: q row q0 + j against this warp's RW kv rows
    float s[RW], dp[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qc = Qs[lane * LDQ + c], dc = dOs[lane * LDQ + c];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        s[r] = fmaf(kw[r * DP + c], qc, s[r]);
        dp[r] = fmaf(vw[r * DP + c], dc, dp[r]);
      }
    }
    const bool qin = q0 + lane < tq;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const bool in = qin && k0 + warp * RW + r < tk;
      s[r] = in ? exp2f(s[r] * sl2 - lse_s[lane]) : 0.f;  // p
      dp[r] = s[r] * (dp[r] - dl_s[lane]) * scale;        // ds
    }
    const int nj = min(TILE, tq - q0);
    for (int j = 0; j < nj; ++j) {
      float qj[NC], dj[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        qj[i] = Qs[j * LDQ + lane + 32 * i];
        dj[i] = dOs[j * LDQ + lane + 32 * i];
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float p = __shfl_sync(0xffffffffu, s[r], j);
        const float ds = __shfl_sync(0xffffffffu, dp[r], j);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          dv_acc[r][i] = fmaf(p, dj[i], dv_acc[r][i]);
          dk_acc[r][i] = fmaf(ds, qj[i], dk_acc[r][i]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = k0 + warp * RW + r;
    if (row >= tk) continue;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) {
        dk[(koff + row) * d + c] = dk_acc[r][i];
        dv[(koff + row) * d + c] = dv_acc[r][i];
      }
    }
  }
}

// ------------------------------------- split backward on 3xTF32 products
//
// flash_bwd_dq_f32 and flash_bwd_dkv_f32 for 128 < D <= 512 (instances
// DMAX = 256 and 512), in place of the Pallas `_dq_kernel` and
// `_dkv_kernel` on fp32 slabs: from the forward's lse and delta =
// rowsum(o do), s = scale q k^T, p = exp(s - lse), dp = do v^T,
// ds = p (dp - delta) scale, then dq = ds k, or dk = ds^T q and dv = p^T do.
//
// What bounds it: three (dq) or four (dk, dv) products of 2 BH Tq Tk D
// flops, each fp32 product as three TF32 ones at 495 TFLOP/s (0.62 and
// 0.83 ms at [2, 4096, 4096, 512]), on mma.sync (324 TFLOP/s of TF32 on
// the H100): wgmma takes TF32 only K-major, and the output products'
// stream operand (k, q, do) is MN-major. What holds it on the card: the
// work around the products (fragment loads and their hi/lo splits, the
// partial sums, the slots' hand-offs) at two warps a scheduler, then the
// products; every block reads the whole other side from L2 (4 GiB a
// launch at [2, 4096, 4096, 512]).
//
// Design: one block template in two roles. A block of NW = DMAX / 64 warps
// (and, in dq at DMAX 512, a ninth, producer warp) keeps BM = 32 rows of
// two "resident" tiles X, Y in shared memory for the whole walk and streams
// BN = 16-row tiles of the other side, U and W:
//   dq  role: X = q, Y = do (rows of q), U = k, W = v;
//             s = X U^T, dp = Y W^T, ds by row (lse, delta of X's rows),
//             dq += ds U;
//   dkv role: X = k, Y = v (rows of k), U = q, W = do;
//             s^T = X U^T, dp^T = Y W^T, p^T and ds^T by column (lse,
//             delta of U's rows), dk += ds^T U and dv += p^T W.
// The roles share everything but the statistics and the second output, so
// dk and dv come from one score tile: four products, as the reference's
// pass forms them, with 2 x 64 accumulators a thread at DMAX 512 (8 warps,
// up to 255 registers). Two 32-row tiles take 132 KB at DMAX 512 (64 rows
// would take 264 KB, more than a block may have).
//   * the stream: each 16-row tile is DMAX / 64 chunk pairs (64 columns of
//     U and of W) in a FIFO ring of RING pair slots (9 at DMAX 512: a tile
//     and one pair ahead; 4 at 256, two blocks an SM). A chunk is one TMA
//     box of 16 rows x 68 columns, zero past the slab: the four columns
//     past the chunk pad its rows to 4 (mod 32) floats, so the ldmatrix
//     rows and the phase-2 loads of rows 2t, 2t + 1 are free of bank
//     conflicts and every fragment address is a lane base plus a constant.
//     Where d % 4 != 0 or a base is off 16 bytes, a warp's lanes copy
//     4-byte words with cp.async instead. Either completes on the slot's
//     full mbarrier, on which phase 1 waits. A pair is read by the score
//     products (phase 1) and again by the output products (phase 2); then
//     its slot takes the pair RING further on, refilled by the last warp
//     to leave it (a counter a slot, behind a fence) or, in dq at DMAX 512,
//     by a producer warp waiting on the slot's empty mbarrier, on which
//     each warp arrives as it leaves. There the fence and the counter took
//     a quarter of the time (a chunk holds one output product), and dq's
//     registers leave room for a ninth warp (a block of 9-12 warps gets 168
//     registers a thread; dk and dv's accumulators need more); at DMAX 256
//     two blocks an SM hide each other's releases. No barrier a chunk: two
//     named barriers of the consumers a tile, around the partial sums.
//   * phase 1, s and dp over the head columns: warp w forms all 32 x 16 of
//     s (w even) or dp (w odd) over 16 / NW k-steps of each chunk
//     (ldmatrix of fp32 words as b16 pairs, both operands K-major); each
//     chunk's products are summed from zero and added to the warp's partial
//     sums in fp32 (the tensor cores' sums round toward zero relative to
//     what they add to). The NW / 2 partial sums of each meet in shared
//     memory (float4 by lane), and each warp adds those of its 16 rows in
//     one fixed order: warps that share rows form the same s and dp.
//   * p and ds on the fragments (exp2 of s scale log2 e - lse log2 e,
//     masked past the stream's rows), kept in registers as the A operand of
//     phase 2: the m16n8 accumulator's (row g, columns 2t, 2t + 1) are the
//     m16n8k8 A fragment's (row g, k t) and (row g, k t + 4) once the
//     k-step's rows are taken in the order 0, 2, 4, 6, 1, 3, 5, 7; so no
//     shuffle, and the B fragments (the stream tile, MN-major, 32-bit loads)
//     read rows 2t and 2t + 1.
//   * phase 2, the outputs: for each chunk, warp w owns 16 rows (w & 1) and
//     16 / NW n-tiles of the chunk's 64 columns; each k-step's products are
//     summed from zero and added to the fp32 accumulators. The outputs are
//     written once at the end; ragged rows are never written.
// No atomics on the outputs: the same bytes on every launch.

template <int DMAX, bool PROD>
struct SplitCfg {
  static constexpr int NW = DMAX / 64;    // consumer warps
  static constexpr int THREADS = 32 * (NW + PROD);  // and the producer warp
  static constexpr int BM = 32, BN = 16;  // resident rows a block, stream rows a tile
  static constexpr int NCH = DMAX / 64;   // 64-column chunks of a row
  static constexpr int KPW = 16 / NW;     // phase 1: k-steps a warp takes of a chunk
  static constexpr int NPW = 16 / NW;     // phase 2: n-tiles a warp owns of a chunk
  // row strides in floats, 4 (mod 32): ldmatrix rows and the phase-2
  // loads of rows 2t, 2t + 1 hit other banks
  static constexpr int LDR = DMAX + 4, LDC = 64 + 4;
  static constexpr int CHUNK = BN * LDC;  // one chunk of U or W: one TMA box
  static constexpr int RING = DMAX == 512 ? 9 : 4;  // pair slots
  // the ring (128-byte aligned for TMA), the tiles, the partial sums; then
  // a full mbarrier and an empty one (or a release counter) a slot (16
  // bytes), and 128 bytes of alignment
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)RING * 2 * CHUNK + 2 * (size_t)BM * LDR + (size_t)NW * 4 * 4 * 32) +
      16 * (size_t)RING + 128;
};

// Tensor map of a contiguous fp32 [bh, t, d] tensor read in boxes of
// `rows` rows x `cols` columns of one b*h slab, zero past t and d. Needs
// d % 4 == 0 and a 16-byte aligned base.
inline int f32_tile_map(CUtensorMap* map, const void* base, int bh, int t, int d, int cols,
                        int rows) {
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)t * d * 4};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides,
                  box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the split pair's chunks: boxes of 16 rows x 68 columns
inline int f32_box_map(CUtensorMap* map, const void* base, int bh, int t, int d) {
  return f32_tile_map(map, base, bh, t, d, 68, 16);
}

// whether the block has the producer warp: dq at DMAX 512
template <int DMAX, bool DKV>
struct SplitProducer {
  static constexpr bool value = !DKV && DMAX == 512;
};

template <int DMAX, bool DKV, bool VEC>
__global__ void __launch_bounds__(SplitCfg<DMAX, SplitProducer<DMAX, DKV>::value>::THREADS, 1)
flash_bwd_f32_split_kernel(const __grid_constant__ CUtensorMap umap,
                           const __grid_constant__ CUtensorMap wmap, const float* __restrict__ q,
                           const float* __restrict__ k, const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ out0, float* __restrict__ out1, int tq, int tk,
                           int d, float scale) {
  constexpr bool PROD = SplitProducer<DMAX, DKV>::value;
  typedef SplitCfg<DMAX, PROD> C;
  constexpr int BM = C::BM, BN = C::BN, NCH = C::NCH, RING = C::RING;
  constexpr int KPW = C::KPW, NPW = C::NPW, LDR = C::LDR, LDC = C::LDC;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((128u - (hopper::smem_addr(smem_raw) & 127u)) & 127u));  // [RING][U, W][BN][LDC]
  float* Xs = ring + RING * 2 * C::CHUNK;
  float* Ys = Xs + BM * LDR;
  float4* red = reinterpret_cast<float4*>(Ys + BM * LDR);  // [NW][4][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + C::NW * 4 * 32);   // [RING]
  uint64_t* empty = full + RING;                  // [RING], with the producer
  int* released = reinterpret_cast<int*>(empty);  // [RING], without it
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, r0 = blockIdx.x * BM;
  const int nres = DKV ? tk : tq, nstr = DKV ? tq : tk;
  const size_t roff = (size_t)bh * nres * d, soff = (size_t)bh * nstr * d;
  const float* Ug = (DKV ? q : k) + soff;
  const float* Wg = (DKV ? dout : v) + soff;
  const float* lse_b = lse + (size_t)bh * tq;
  const float* dl_b = delta + (size_t)bh * tq;
  const float sl2 = scale * LOG2E;
  const int d8 = (d + 7) & ~7;      // columns the k-steps read (zero past d)
  const int nc = (d8 + 63) >> 6;    // chunk pairs a tile
  const int ntile = (nstr + BN - 1) / BN;
  const int npair = ntile * nc;

  // chunk pair p (tile p / nc, chunk p % nc) of U and W into ring slot
  // `slot`, by one warp, completing on full[slot]
  auto load_pair = [&](int p, int slot) {
    const int row0 = (p / nc) * BN, c0 = 64 * (p % nc);
    float* dst = ring + slot * 2 * C::CHUNK;
    if (VEC) {  // lane 0: one box of U and one of W
      if (lane == 0) {
        hopper::mbar_arrive_tx(full + slot, 2 * C::CHUNK * 4);
        hopper::tma_load_3d(dst, &umap, c0, row0, bh, full + slot);
        hopper::tma_load_3d(dst + C::CHUNK, &wmap, c0, row0, bh, full + slot);
      }
    } else {
      for (int i = lane; i < 2 * BN * 64; i += 32) {
        const int w = i / (BN * 64), r = (i / 64) % BN, col = i % 64;
        if (c0 + col >= d8) continue;
        const bool in = row0 + r < nstr && c0 + col < d;
        const float* src = (w ? Wg : Ug) + (in ? (size_t)(row0 + r) * d + c0 + col : 0);
        cp_async4(smem_u32(dst + w * C::CHUNK + r * LDC + col), src, in ? 4 : 0);
      }
      cp_async_arrive(full + slot);
    }
  };

  // the barriers set up, the resident tiles in, the first RING pairs on
  // their way
  if (threadIdx.x < RING) {
    hopper::mbar_init(full + threadIdx.x, VEC ? 1 : 32);
    if (PROD)
      hopper::mbar_init(empty + threadIdx.x, C::NW);
    else
      released[threadIdx.x] = 0;
  }
  hopper::mbar_init_fence();
  load_tile<VEC, C::THREADS, BM, DMAX>(Xs, LDR, (DKV ? k : q) + roff, r0, nres, 0, d8, d);
  load_tile<VEC, C::THREADS, BM, DMAX>(Ys, LDR, (DKV ? v : dout) + roff, r0, nres, 0, d8, d);
  cp_commit();
  __syncthreads();
  if (warp == (PROD ? C::NW : 0))
    for (int p = 0; p < min(RING, npair); ++p) load_pair(p, p);
  cp_wait<0>();
  __syncthreads();  // the resident tiles are in

  if (PROD && warp == C::NW) {  // the producer: each slot refilled once the consumers left it
    for (int p = RING; p < npair; ++p) {
      const int slot = p % RING;
      hopper::mbar_wait(empty + slot, (p / RING - 1) & 1);
      load_pair(p, slot);
    }
    if (!VEC) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // phase 1: s (mat 0) or dp (mat 1), all 32 x 16, over k-steps kq * KPW ..
  const int mat = warp & 1, kq = warp >> 1;
  const float* a_ptr =
      (mat ? Ys : Xs) + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDR + 4 * (lane >> 4);
  const int b_off = mat * C::CHUNK + ((lane & 7) + 8 * (lane >> 4)) * LDC + 4 * ((lane >> 3) & 1);
  // phase 2 and the outputs: rows 16 mi + g (+ 8), n-tiles nq * NPW .. of
  // each chunk; stream rows 2 t4 (+ 1) of each k-step
  const int mi = warp & 1, nq = warp >> 1;
  const int p2_off = 2 * t4 * LDC + 8 * nq * NPW + g;
  // dq: the statistics of the lane's two q rows
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};
  if (!DKV) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = min(r0 + 16 * mi + g + 8 * h, tq - 1);
      lse_r[h] = lse_b[row] * LOG2E;
      dl_r[h] = dl_b[row];
    }
  }
  float acc0[NCH][NPW][4], acc1[DKV ? NCH : 1][NPW][4];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc0[c][n][e] = 0.f;
        acc1[DKV ? c : 0][n][e] = 0.f;
      }

  int slot0 = 0, phase0 = 0;  // the ring slot of the tile's first pair, its fill's parity
#pragma unroll 1
  for (int j = 0; j < ntile; ++j) {
    // dkv: the statistics of the lane's four q columns, read while phase 1 runs
    float lse_c[2][2] = {}, dl_c[2][2] = {};
    if (DKV) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = min(j * BN + 8 * n + 2 * t4 + e, tq - 1);
          lse_c[n][e] = __ldg(lse_b + row) * LOG2E;
          dl_c[n][e] = __ldg(dl_b + row);
        }
    }
    float part[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
    int slot = slot0, phase = phase0;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c < nc) {
        hopper::mbar_wait(full + slot, phase);  // pair (j, c) is in
        const float* bp = ring + slot * 2 * C::CHUNK + b_off;
        float t[2][2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) t[m][n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KPW; ++kk) {
          const int ks = kq * KPW + kk;
          if (64 * c + 8 * ks < d8) {
            uint32_t a[2][4], al[2][4], b[4], bl[4];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              ldsm4(a[m], a_ptr + 16 * m * LDR + 64 * c + 8 * ks);
#pragma unroll
              for (int e = 0; e < 4; ++e) al[m][e] = tf32_lo(a[m][e]);
            }
            ldsm4(b, bp + 8 * ks);
#pragma unroll
            for (int e = 0; e < 4; ++e) bl[e] = tf32_lo(b[e]);
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int n = 0; n < 2; ++n)
                mma3(t[m][n], a[m], al[m], b[2 * n], b[2 * n + 1], bl[2 * n], bl[2 * n + 1]);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[m][n][e] += t[m][n][e];
        if (++slot == RING) slot = 0, phase ^= 1;
      }
    }

    // the partial sums meet: s of rows 16 mi .. from warps 0, 2, ..; dp
    // from warps 1, 3, ..
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        red[(warp * 4 + 2 * m + n) * 32 + lane] =
            make_float4(part[m][n][0], part[m][n][1], part[m][n][2], part[m][n][3]);
    hopper::named_sync(1, 32 * C::NW);
    const int nvalid = nstr - j * BN;
    uint32_t pa[2][4], pal[2][4], da[2][4], dal[2][4];  // A fragments of p and ds by k-step
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < C::NW; w += 2) {
        const float4 x = red[(w * 4 + 2 * mi + n) * 32 + lane];
        const float4 y = red[((w + 1) * 4 + 2 * mi + n) * 32 + lane];
        s[0] += x.x, s[1] += x.y, s[2] += x.z, s[3] += x.w;
        dp[0] += y.x, dp[1] += y.y, dp[2] += y.z, dp[3] += y.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t4 + (e & 1);
        const float L = DKV ? lse_c[n][e & 1] : lse_r[e >> 1];
        const float dl = DKV ? dl_c[n][e & 1] : dl_r[e >> 1];
        const float p = col < nvalid ? exp2f(fmaf(s[e], sl2, -L)) : 0.f;
        const float ds = p * (dp[e] - dl) * scale;
        const int ai = ((e & 1) << 1) | (e >> 1);  // (row, column 2t + 1) -> k t + 4
        pa[n][ai] = __float_as_uint(p);
        da[n][ai] = __float_as_uint(ds);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pal[n][e] = tf32_lo(pa[n][e]);
        dal[n][e] = tf32_lo(da[n][e]);
      }
    }
    hopper::named_sync(1, 32 * C::NW);  // every consumer has read the partial sums

    // phase 2: out0 += ds U (dq, dk), out1 += p W (dv), chunk by chunk;
    // then the pair's slot takes the pair RING further on
    slot = slot0;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c < nc) {
        const float* bp = ring + slot * 2 * C::CHUNK + p2_off;
#pragma unroll
        for (int n = 0; n < NPW; ++n) {
          if (64 * c + 8 * (nq * NPW + n) < d8) {
            float t0[2][4], t1[2][4];
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
              for (int e = 0; e < 4; ++e) t0[kk][e] = t1[kk][e] = 0.f;
              const float* bu = bp + 8 * kk * LDC + 8 * n;
              const uint32_t u0 = __float_as_uint(bu[0]), u1 = __float_as_uint(bu[LDC]);
              mma3(t0[kk], da[kk], dal[kk], u0, u1, tf32_lo(u0), tf32_lo(u1));
              if (DKV) {
                const uint32_t w0 = __float_as_uint(bu[C::CHUNK]);
                const uint32_t w1 = __float_as_uint(bu[C::CHUNK + LDC]);
                mma3(t1[kk], pa[kk], pal[kk], w0, w1, tf32_lo(w0), tf32_lo(w1));
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc0[c][n][e] += t0[0][e] + t0[1][e];
              if (DKV) acc1[DKV ? c : 0][n][e] += t1[0][e] + t1[1][e];
            }
          }
        }
        __syncwarp();  // the warp is done with pair (j, c)
        if (PROD) {
          if (lane == 0) hopper::mbar_arrive(empty + slot);
        } else {  // the last warp to leave the slot refills it
          int last = 0;
          if (lane == 0) {
            __threadfence_block();
            last = atomicAdd(released + slot, 1) == C::NW - 1;
            if (last) released[slot] = 0;
          }
          const int p = (j * nc + c) + RING;
          if (__shfl_sync(0xffffffffu, last, 0) && p < npair) load_pair(p, slot);
        }
        if (++slot == RING) slot = 0;
      }
    }
    phase0 ^= (slot0 + nc) / RING & 1;
    slot0 = slot;
  }

  // the outputs: rows 16 mi + g (+ 8) of the block, ragged rows and
  // columns never written
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * mi + g + 8 * h;
    if (row >= nres) continue;
    float* o0 = out0 + roff + (size_t)row * d;
    float* o1 = DKV ? out1 + roff + (size_t)row * d : nullptr;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int n = 0; n < NPW; ++n) {
        const int col = 64 * c + 8 * (nq * NPW + n) + 2 * t4;
        if (col < d) {
          o0[col] = acc0[c][n][2 * h];
          if (DKV) o1[col] = acc1[DKV ? c : 0][n][2 * h];
        }
        if (col + 1 < d) {
          o0[col + 1] = acc0[c][n][2 * h + 1];
          if (DKV) o1[col + 1] = acc1[DKV ? c : 0][n][2 * h + 1];
        }
      }
  }
}

// --------------------------------------------------------------- launchers

template <int DMAX, bool VEC>
int run_fwd_narrow(const float* q, const float* k, const float* v, float* o, float* lse, int bh,
                   int tq, int tk, int d, float scale, cudaStream_t s) {
  typedef NarrowCfg<DMAX> C;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  if (VEC) {
    int rc = f32_tile_map(&maps[0], q, bh, tq, d, C::LDK, C::BQ);
    if (rc == 0) rc = f32_tile_map(&maps[1], k, bh, tk, d, C::LDK, C::BK);
    if (rc == 0) rc = f32_tile_map(&maps[2], v, bh, tk, d, C::LDV, C::BK);
    if (rc != 0) return rc;
  }
  auto kern = flash_fwd_f32_narrow_kernel<DMAX, VEC>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((tq + C::BQ - 1) / C::BQ, bh), C::THREADS, C::SMEM, s>>>(
      maps[0], maps[1], maps[2], q, k, v, o, lse, tq, tk, d, scale);
  return (int)cudaGetLastError();
}

// the narrow forward's instance: TMA where the rows are whole vectors and
// the bases 16-byte aligned, 4-byte copies otherwise
template <int DMAX>
int launch_fwd_narrow(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                      int tq, int tk, int d, float scale, cudaStream_t s) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const bool vec = d % 4 == 0 && bases % 16 == 0;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float *of = (float*)o, *lf = (float*)lse;
  if (vec) return run_fwd_narrow<DMAX, true>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, s);
  return run_fwd_narrow<DMAX, false>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, s);
}

template <int DMAX, bool VEC>
int run_fwd_wide(const float* q, const float* k, const float* v, float* o, float* lse,
                    int bh, int tq, int tk, int d, float scale, cudaStream_t s) {
  typedef WideCfg<DMAX> C;
  auto kern = flash_fwd_f32_wide_kernel<DMAX, VEC>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((tq + C::BQ - 1) / C::BQ, bh), C::THREADS, C::SMEM, s>>>(q, k, v, o, lse, tq,
                                                                      tk, d, scale);
  return (int)cudaGetLastError();
}

// the wide forward's instance: 16-byte copies where the rows are whole
// vectors and the bases 16-byte aligned, 4-byte copies otherwise
template <int DMAX>
int launch_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                    int tq, int tk, int d, float scale, cudaStream_t s) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const bool vec = d % 4 == 0 && bases % 16 == 0;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float *of = (float*)o, *lf = (float*)lse;
  if (vec) return run_fwd_wide<DMAX, true>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, s);
  return run_fwd_wide<DMAX, false>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, s);
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int tq, int tk, int d,
              float scale, cudaStream_t s) {
  constexpr int RW = 4;
  typedef DqCfg<DP, RW> C;
  auto kern = dq_kernel<DP, RW>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((tq + C::BQ - 1) / C::BQ, bh), THREADS, C::SMEM, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, tq, tk, d, scale);
  return (int)cudaGetLastError();
}

// RW = 8 kv rows a warp (D <= 128)
template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh, int tq, int tk,
               int d, float scale, cudaStream_t s) {
  constexpr int RW = 8;
  typedef DkvCfg<DP, RW> C;
  auto kern = dkv_kernel<DP, RW>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((tk + C::BK - 1) / C::BK, bh), THREADS, C::SMEM, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, tq, tk, d, scale);
  return (int)cudaGetLastError();
}

template <int W, bool VEC>
int run_bwd_fused(const float* q, const float* k, const float* v, const float* dout,
                  const float* lse, const float* delta, float* dq, float* dk, float* dv, int bh,
                  int tq, int tk, int d, float scale, cudaStream_t s) {
  typedef FusedCfg<W> C;
  CUtensorMap maps[4];
  memset(maps, 0, sizeof(maps));
  if (VEC) {  // q and do in stream tiles, k and v in resident ones
    int rc = f32_tile_map(&maps[0], q, bh, tq, d, C::LD, C::BQ);
    if (rc == 0) rc = f32_tile_map(&maps[1], k, bh, tk, d, C::LD, C::BK);
    if (rc == 0) rc = f32_tile_map(&maps[2], v, bh, tk, d, C::LD, C::BK);
    if (rc == 0) rc = f32_tile_map(&maps[3], dout, bh, tq, d, C::LD, C::BQ);
    if (rc != 0) return rc;
  }
  auto kern = flash_bwd_fused_f32_kernel<W, VEC>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((tk + C::BK - 1) / C::BK, bh, C::NH), C::THREADS, C::SMEM, s>>>(
      maps[0], maps[1], maps[2], maps[3], q, k, v, dout, lse, delta, dq, dk, dv, tq, tk, d,
      scale);
  return (int)cudaGetLastError();
}

// the fused backward's instance at padded width W: TMA and the bulk
// reduce-add of dq where the rows are whole vectors and the bases (dq's
// too) 16-byte aligned; 4-byte copies and atomicAdd otherwise
template <int W>
int launch_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, void* dk, void* dv, int bh,
                     int tq, int tk, int d, float scale, cudaStream_t s) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                          reinterpret_cast<uintptr_t>(dq);
  const bool vec = d % 4 == 0 && bases % 16 == 0;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  const float *df = (const float*)dout, *lf = (const float*)lse, *dl = (const float*)delta;
  float *dqf = (float*)dq, *dkf = (float*)dk, *dvf = (float*)dv;
  if (vec)
    return run_bwd_fused<W, true>(qf, kf, vf, df, lf, dl, dqf, dkf, dvf, bh, tq, tk, d, scale, s);
  return run_bwd_fused<W, false>(qf, kf, vf, df, lf, dl, dqf, dkf, dvf, bh, tq, tk, d, scale, s);
}

// the fused backward's padded widths (ops/flash.py F32_FUSED_WIDTHS): one
// instance each, so that its loops have their bounds at compile time
inline int fused_width(int d) {
  if (d <= 0) return 0;
  if (d <= 16) return 16;
  if (d <= 32) return 32;
  if (d <= 40) return 40;
  if (d <= 48) return 48;
  if (d <= 64) return 64;
  if (d <= 80) return 80;
  if (d <= 96) return 96;
  if (d <= 128) return 128;
  return 0;
}

template <int DMAX, bool DKV, bool VEC>
int run_bwd_split(const float* q, const float* k, const float* v, const float* dout,
                  const float* lse, const float* delta, float* out0, float* out1, int bh, int tq,
                  int tk, int d, float scale, cudaStream_t s) {
  typedef SplitCfg<DMAX, SplitProducer<DMAX, DKV>::value> C;
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  if (VEC) {  // the stream: U = k, W = v (dq) or U = q, W = do (dkv)
    const int nstr = DKV ? tq : tk;
    int rc = f32_box_map(&maps[0], DKV ? q : k, bh, nstr, d);
    if (rc == 0) rc = f32_box_map(&maps[1], DKV ? dout : v, bh, nstr, d);
    if (rc != 0) return rc;
  }
  auto kern = flash_bwd_f32_split_kernel<DMAX, DKV, VEC>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nres = DKV ? tk : tq;
  kern<<<dim3((nres + C::BM - 1) / C::BM, bh), C::THREADS, C::SMEM, s>>>(
      maps[0], maps[1], q, k, v, dout, lse, delta, out0, out1, tq, tk, d, scale);
  return (int)cudaGetLastError();
}

// the split pair's tensor-core instance in role dq (out0 = dq) or dkv
// (out0 = dk, out1 = dv): 16-byte copies where the rows are whole vectors
// and the bases 16-byte aligned, 4-byte copies otherwise
template <int DMAX, bool DKV>
int launch_bwd_split(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* out0, void* out1, int bh, int tq,
                     int tk, int d, float scale, cudaStream_t s) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  const bool vec = d % 4 == 0 && bases % 16 == 0;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  const float *df = (const float*)dout, *lf = (const float*)lse, *dl = (const float*)delta;
  float *o0 = (float*)out0, *o1 = (float*)out1;
  if (vec)
    return run_bwd_split<DMAX, DKV, true>(qf, kf, vf, df, lf, dl, o0, o1, bh, tq, tk, d, scale, s);
  return run_bwd_split<DMAX, DKV, false>(qf, kf, vf, df, lf, dl, o0, o1, bh, tq, tk, d, scale, s);
}

inline bool args_ok(int bh, int tq, int tk) {
  return bh > 0 && bh <= 65535 && tq > 0 && tk > 0;
}

}  // namespace flash32

// The same C interfaces as the bf16 entry points (flash_fwd.cu,
// flash_bwd.cu), on fp32 tensors: q, k, v, do, o, dq, dk, dv fp32
// [bh, t, d] contiguous; lse, delta fp32 [bh, tq]. The forward takes the
// 3xTF32 tensor-core kernels at every width (narrow up to D = 128, wide
// past it), the fused backward its tensor-core kernel (D <= 128), the split
// pair its tensor-core kernel past D = 128.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                             void* lse, int bh, int tq, int tk, int d, float scale,
                             void* stream) {
  using namespace flash32;
  if (!args_ok(bh, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pad_d(d)) {
    case 32: return launch_fwd_narrow<32>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 64: return launch_fwd_narrow<64>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 128: return launch_fwd_narrow<128>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 256: return launch_fwd_wide<256>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 512: return launch_fwd_wide<512>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the forward's block at dmax (32, 64 and 128:
// the narrow kernel; 256 and 512: the wide one; 0 otherwise), for the
// Python counts (ops/flash.py f32_narrow_smem_bytes, f32_wide_smem_bytes)
extern "C" int flash_fwd_f32_smem(int dmax) {
  using namespace flash32;
  switch (dmax) {
    case 32: return (int)NarrowCfg<32>::SMEM;
    case 64: return (int)NarrowCfg<64>::SMEM;
    case 128: return (int)NarrowCfg<128>::SMEM;
    case 256: return (int)WideCfg<256>::SMEM;
    case 512: return (int)WideCfg<512>::SMEM;
    default: return 0;
  }
}

// Dynamic shared memory of the split pair's tensor-core block in role 0
// (dq) or 1 (dkv) at dmax (256 or 512; 0 otherwise), for the Python count
// (ops/flash.py f32_split_smem_bytes); the roles lay it out alike
extern "C" int flash_bwd_f32_smem(int role, int dmax) {
  using namespace flash32;
  if (role != 0 && role != 1) return 0;
  if (dmax == 256) return (int)SplitCfg<256, false>::SMEM;
  if (dmax == 512) return role ? (int)SplitCfg<512, false>::SMEM : (int)SplitCfg<512, true>::SMEM;
  return 0;
}

// dq: fp32 [bh, tq, d], zeroed by the caller. D <= 128.
extern "C" int flash_bwd_fused_f32(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int bh, int tq, int tk,
                                   int d, float scale, void* stream) {
  using namespace flash32;
  if (!args_ok(bh, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FUSED_CASE(w) \
  case w: return launch_bwd_fused<w>(q, k, v, dout, lse, delta, dq, dk, dv, bh, tq, tk, d, scale, s)
  switch (fused_width(d)) {
    FUSED_CASE(16);
    FUSED_CASE(32);
    FUSED_CASE(40);
    FUSED_CASE(48);
    FUSED_CASE(64);
    FUSED_CASE(80);
    FUSED_CASE(96);
    FUSED_CASE(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FUSED_CASE
}

// Dynamic shared memory of the fused backward's block at padded width w
// (0 at a width it is not built for), for the Python count (ops/flash.py
// f32_fused_smem_bytes)
extern "C" int flash_bwd_fused_f32_smem(int w) {
  using namespace flash32;
  switch (w) {
    case 16: return (int)FusedCfg<16>::SMEM;
    case 32: return (int)FusedCfg<32>::SMEM;
    case 40: return (int)FusedCfg<40>::SMEM;
    case 48: return (int)FusedCfg<48>::SMEM;
    case 64: return (int)FusedCfg<64>::SMEM;
    case 80: return (int)FusedCfg<80>::SMEM;
    case 96: return (int)FusedCfg<96>::SMEM;
    case 128: return (int)FusedCfg<128>::SMEM;
    default: return 0;
  }
}

extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int bh, int tq, int tk, int d,
                                 float scale, void* stream) {
  using namespace flash32;
  if (!args_ok(bh, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pad_d(d)) {
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, s);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, s);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, s);
    case 256: return launch_bwd_split<256, true>(
        q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, s);
    case 512: return launch_bwd_split<512, true>(
        q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int bh, int tq, int tk, int d, float scale,
                                void* stream) {
  using namespace flash32;
  if (!args_ok(bh, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pad_d(d)) {
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, s);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, s);
    case 256: return launch_bwd_split<256, false>(
        q, k, v, dout, lse, delta, dq, nullptr, bh, tq, tk, d, scale, s);
    case 512: return launch_bwd_split<512, false>(
        q, k, v, dout, lse, delta, dq, nullptr, bh, tq, tk, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
