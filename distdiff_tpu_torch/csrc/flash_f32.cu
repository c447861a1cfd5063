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
//   * the wide forward (flash_fwd_f32 at 128 < D <= 512, below) runs both
//     of its products on the TF32 tensor cores as 3xTF32: each operand x
//     is split into a high part (its top 19 bits, which is what the tensor
//     cores read of a register) and a low part x - hi (exact in fp32), and
//     a b is formed as lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) with fp32
//     accumulation. What is left out, lo(a) lo(b) and the low part's own
//     truncation, is ~2^-20 of a term, where one TF32 product loses ~2^-11;
//     with the tensor cores' truncated sums the result stays within ~2e-5
//     of the largest output of fp64 attention, where one TF32 product
//     would be ~5e-4 off;
//   * the others (flash_fwd_f32 at D <= 128 and the three backward
//     kernels) are fp32 fused multiply-adds on the CUDA cores (no tensor
//     cores), so they agree with the plain fp32 version to summation order.
//
// What bounds them on this card: their products. The CUDA-core kernels
// are held by the fp32 FMA rate (67 TFLOP/s on the H100 SXM), the wide
// forward by the TF32 tensor-core rate (495 TFLOP/s, three products for
// each fp32 one) and by the instructions that feed mma.sync. The CUDA-core
// kernels are simple, not fast: the fp32 path serves the small test
// geometries, and the SD-1.5 path is bf16.
//
// Design of the CUDA-core kernels (one warp = 32 lanes; DP = head width
// rounded up to 32, 64 or 128 (and 256 or 512 for the backward); NC = DP / 32
// columns of an output row per lane):
//   * flash_fwd_f32 (D <= 128): a block of four warps takes 4 * RW q rows (RW per
//     warp) and loops over 32-row kv tiles in shared memory. Lane j forms
//     the score of kv row j against each of its warp's q rows; the online
//     softmax (running max and sum, exponentials as exp2) takes its row
//     max with shuffles; then o += p v with p broadcast from lane j and
//     lane l owning output columns l, l + 32, ...
//   * flash_bwd_dq_f32: the same loop, forming s and dp per (q row, kv
//     lane), ds = p (dp - delta) scale, and dq += ds k.
//   * flash_bwd_dkv_f32 / flash_bwd_fused_f32: a block takes 4 * RW kv
//     rows (RW per warp) and loops over 32-row q tiles; lane j takes q row
//     j: dv += p^T do and dk += ds^T q with lane l owning columns l, l + 32,
//     ... The fused kernel also forms dq = ds k for its kv rows, adds the
//     four warps' parts in shared memory and adds the tile into a zeroed
//     fp32 dq with atomicAdd (blocks run in no order, as in the bf16
//     fused kernel), so dq is not bitwise reproducible.
// Ragged rows and columns are zero-filled in shared memory and masked;
// nothing is padded in device memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ----------------------------------------------------------------- forward

template <int DP, int RW>
struct FwdCfg {
  static constexpr int BQ = 4 * RW;
  static constexpr int LDK = DP + 1;  // lane j reads row j: odd stride, no bank conflicts
  static constexpr size_t SMEM = sizeof(float) * ((size_t)BQ * DP + TILE * LDK + TILE * DP);
};

template <int DP, int RW>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
           int tq, int tk, int d, float scale) {
  typedef FwdCfg<DP, RW> C;
  constexpr int NC = DP / 32;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* Ks = Qs + C::BQ * DP;
  float* Vs = Ks + TILE * C::LDK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::BQ;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;
  const float sl2 = scale * LOG2E;
  stage<C::BQ, DP, DP>(Qs, q + (size_t)bh * tq * d, q0, tq, d);
  const float* qw = Qs + warp * RW * DP;

  float acc[RW][NC], m[RW], l[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }
  for (int k0 = 0; k0 < tk; k0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    stage<TILE, DP, C::LDK>(Ks, kb, k0, tk, d);
    stage<TILE, DP, DP>(Vs, vb, k0, tk, d);
    __syncthreads();
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float kc = Ks[lane * C::LDK + c];
#pragma unroll
      for (int r = 0; r < RW; ++r) s[r] = fmaf(qw[r * DP + c], kc, s[r]);
    }
    const bool valid = k0 + lane < tk;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float x = valid ? s[r] * sl2 : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(x));
      const float alpha = exp2f(m[r] - mn);  // 0 on the first tile (m = -inf)
      s[r] = exp2f(x - mn);
      l[r] = l[r] * alpha + s[r];  // this lane's share of the row sum
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] *= alpha;
    }
    const int nj = min(TILE, tk - k0);
    for (int j = 0; j < nj; ++j) {
      float vj[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) vj[i] = Vs[j * DP + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float p = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(p, vj[i], acc[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const float sum = warp_sum(l[r]);
    const int row = q0 + warp * RW + r;
    if (row >= tq) continue;
    const float inv = 1.f / sum;
    float* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) orow[c] = acc[r][i] * inv;
    }
    if (lane == 0) lse[(size_t)bh * tq + row] = m[r] * LN2 + logf(sum);
  }
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

// --------------------------------------------------- dk, dv (and fused dq)

template <int DP, int RW, bool DQ>
struct DkvCfg {
  static constexpr int BK = 4 * RW;
  static constexpr int LDQ = DP + 1;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * (size_t)BK * DP + (2 + DQ) * (size_t)TILE * LDQ + 2 * TILE);
};

template <int DP, int RW, bool DQ>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
           int tq, int tk, int d, float scale) {
  typedef DkvCfg<DP, RW, DQ> C;
  constexpr int NC = DP / 32;
  constexpr int LDQ = C::LDQ;
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;
  float* Vs = Ks + C::BK * DP;
  float* Qs = Vs + C::BK * DP;
  float* dOs = Qs + TILE * LDQ;
  float* lse_s = dOs + TILE * LDQ;  // lse * log2(e)
  float* dl_s = lse_s + TILE;
  float* dQs = dl_s + TILE;  // fused only: this q tile's dq, [TILE][LDQ]
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
    if (DQ)
      for (int i = threadIdx.x; i < TILE * LDQ; i += THREADS) dQs[i] = 0.f;
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
    if (DQ) {
      // dq[q row lane] += sum over this warp's kv rows of ds k; the four
      // warps meet in shared memory, then one atomicAdd per element
      for (int c = 0; c < d; ++c) {
        float part = 0.f;
#pragma unroll
        for (int r = 0; r < RW; ++r) part = fmaf(dp[r], kw[r * DP + c], part);
        atomicAdd(dQs + lane * LDQ + c, part);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < TILE * d; i += THREADS) {
        const int r = i / d, c = i - (i / d) * d;
        if (q0 + r < tq) atomicAdd(dq + (qoff + q0 + r) * d + c, dQs[r * LDQ + c]);
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

// --------------------------------------------------------------- launchers

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
               int tq, int tk, int d, float scale, cudaStream_t s) {
  constexpr int RW = 4;
  typedef FwdCfg<DP, RW> C;
  auto kern = fwd_kernel<DP, RW>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((tq + C::BQ - 1) / C::BQ, bh), THREADS, C::SMEM, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, tq, tk, d,
      scale);
  return (int)cudaGetLastError();
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

// RW kv rows a warp: 8 up to D = 128, fewer at the wide widths so that the
// dk and dv accumulators (2 * RW * DP / 32 registers) stay at 64
template <int DP, bool DQ>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk, void* dv, int bh,
               int tq, int tk, int d, float scale, cudaStream_t s) {
  constexpr int RW = DP <= 128 ? 8 : (DP == 256 ? 4 : 2);
  typedef DkvCfg<DP, RW, DQ> C;
  auto kern = dkv_kernel<DP, RW, DQ>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((tk + C::BK - 1) / C::BK, bh), THREADS, C::SMEM, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, (float*)dk, (float*)dv, tq, tk, d,
      scale);
  return (int)cudaGetLastError();
}

inline bool args_ok(int bh, int tq, int tk) {
  return bh > 0 && bh <= 65535 && tq > 0 && tk > 0;
}

}  // namespace flash32

#define F32_SWITCH(d, call, max_dp)                              \
  switch (flash32::pad_d(d) <= (max_dp) ? flash32::pad_d(d) : 0) { \
    case 32: { constexpr int DP = 32; return call; }             \
    case 64: { constexpr int DP = 64; return call; }             \
    case 128: { constexpr int DP = 128; return call; }           \
    case 256: { constexpr int DP = 256; return call; }           \
    case 512: { constexpr int DP = 512; return call; }           \
    default: return (int)cudaErrorInvalidValue;                  \
  }

// The same C interfaces as the bf16 entry points (flash_fwd.cu,
// flash_bwd.cu), on fp32 tensors: q, k, v, do, o, dq, dk, dv fp32
// [bh, t, d] contiguous; lse, delta fp32 [bh, tq].
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                             void* lse, int bh, int tq, int tk, int d, float scale,
                             void* stream) {
  using namespace flash32;
  if (!args_ok(bh, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pad_d(d)) {  // past D = 128: the 3xTF32 tensor-core kernel
    case 32: return launch_fwd<32>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 64: return launch_fwd<64>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 128: return launch_fwd<128>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 256: return launch_fwd_wide<256>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 512: return launch_fwd_wide<512>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the wide forward's block at dmax (256 or 512;
// 0 otherwise), for the Python count (ops/flash.py f32_wide_smem_bytes)
extern "C" int flash_fwd_f32_smem(int dmax) {
  using namespace flash32;
  return dmax == 256 ? (int)WideCfg<256>::SMEM : dmax == 512 ? (int)WideCfg<512>::SMEM : 0;
}

// dq: fp32 [bh, tq, d], zeroed by the caller. D <= 128.
extern "C" int flash_bwd_fused_f32(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int bh, int tq, int tk,
                                   int d, float scale, void* stream) {
  using namespace flash32;
  if (!args_ok(bh, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  F32_SWITCH(d, (launch_dkv<DP, true>(q, k, v, dout, lse, delta, dq, dk, dv, bh, tq, tk, d,
                                      scale, s)),
             128)
}

extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int bh, int tq, int tk, int d,
                                 float scale, void* stream) {
  using namespace flash32;
  if (!args_ok(bh, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  F32_SWITCH(d, (launch_dkv<DP, false>(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, tq,
                                       tk, d, scale, s)),
             512)
}

extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int bh, int tq, int tk, int d, float scale,
                                void* stream) {
  using namespace flash32;
  if (!args_ok(bh, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  F32_SWITCH(d, (launch_dq<DP>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, s)), 512)
}
