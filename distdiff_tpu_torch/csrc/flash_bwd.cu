// Attention backward for Hopper (sm_90a): flash_bwd_fused, flash_bwd_dq and
// flash_bwd_dkv.
//
// Replaces the Pallas TPU kernels in distdiff_tpu/ops/flash.py:
//   * flash_bwd_fused  <- `_bwd_fused_kernel` (through `_flash_bwd_fused_3d`),
//                         taken when D <= 128 (the UNet's D = 40 and 80);
//   * flash_bwd_dq     <- `_dq_kernel`  } (through `_flash_bwd_split_3d`),
//   * flash_bwd_dkv    <- `_dkv_kernel` }  taken when D > 128 (the VAE's 512).
// All three recompute p = exp(s*scale - lse) from the forward's lse and use
// delta = rowsum(o * do), computed by the caller before the launch as the
// reference computes it outside its kernels:
//   dv = p^T do,  dp = do v^T,  ds = p (dp - delta) scale,  dk = ds^T q,
//   dq = ds k.
//
// What bounds them on this card: five products per tile (seven for the
// split pair, which recomputes s and dp) plus one exp per score; at the
// main-path shapes the products dominate.
//
// All run their products on the tensor cores (mma.sync, bf16 operands,
// fp32 sums), with p and ds rounded to bf16 before the products that take
// them, as the reference rounds them. Design:
//   * flash_bwd_fused (narrow, D <= 128): one block of four warps per
//     (64-row kv tile, b*h), looping over 64-row q tiles. Each warp owns 16
//     kv rows and keeps their dk and dv accumulators in registers. It forms
//     s^T = k q^T and dp^T = v do^T, then p^T and ds^T on the accumulators,
//     then dv += p^T do and dk += ds^T q (the accumulators are already the
//     A operand). ds^T goes through shared memory so that each warp can
//     form 16 q rows of dq = ds k. The TPU carried dq from one grid step to
//     the next through an aliased buffer; blocks on the card run in
//     parallel in no order, so here the partial sums go into a zeroed fp32
//     [BH, T, D] buffer with atomicAdd, and the caller casts it once at the
//     end. The order of those fp32 additions varies from run to run, so dq
//     is not bitwise reproducible (its tolerance says so).
//   * flash_bwd_dq / flash_bwd_dkv (wide, D up to 512): a 32 x 512 fp32
//     accumulator is 64 KB, so a block of eight warps splits it into two
//     16-row groups by four column quarters (64 registers a thread; dkv
//     holds two). flash_bwd_dq takes a 32-row q tile and loops over 64-row
//     kv tiles; flash_bwd_dkv takes a 32-row kv tile and loops over 64-row
//     q tiles. Warp (group, quarter) forms the 16 x 16 block of s and dp
//     (of s^T and dp^T in dkv) over the full head width; p and ds go
//     through shared memory as bf16; each warp then adds its rows and
//     columns of ds k (of p^T do and ds^T q). The bf16 tiles (32 + 32 + 64
//     + 64 rows of 520) take 200 KB of the 227 KB of dynamic shared memory.
#include "flash_common.cuh"

namespace flash {

// ------------------------------------------------- fused pass (narrow)

template <int DMAX>
struct FusedCfg {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int LD = DMAX + 8;
  static constexpr int LDS = BQ + 8;
  static constexpr size_t SMEM = sizeof(bf16) * ((2 * BK + 2 * BQ) * (size_t)LD +
                                                 (size_t)BK * LDS) +
                                 sizeof(float) * 2 * BQ;
};

template <int DMAX>
__global__ void __launch_bounds__(NARROW_THREADS)
flash_bwd_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int tq, int tk, int d, float scale) {
  typedef FusedCfg<DMAX> C;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDS = C::LDS;
  constexpr int KS = DMAX / 16;  // k-steps over the head width
  constexpr int NT = DMAX / 8;   // 8-column tiles of dk, dv, dq
  constexpr int QT = BQ / 8;     // 8-column tiles of s^T, dp^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;
  bf16* dOs = Qs + BQ * LD;
  bf16* dSs = dOs + BQ * LD;  // ds^T, [kv][q]
  float* lse_s = reinterpret_cast<float*>(dSs + BK * LDS);  // lse * log2(e)
  float* dl_s = lse_s + BQ;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t qoff = (size_t)bh * tq;
  const size_t koff = (size_t)bh * tk;
  const float sl2 = scale * LOG2E;

  stage_bf16<BK, DMAX, LD, NARROW_THREADS>(Ks, k + koff * d, k0, tk, d);
  stage_bf16<BK, DMAX, LD, NARROW_THREADS>(Vs, v + koff * d, k0, tk, d);

  float dk_acc[NT][4], dv_acc[NT][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int q0 = 0; q0 < tq; q0 += BQ) {
    __syncthreads();  // the previous q tile's readers are done
    stage_bf16<BQ, DMAX, LD, NARROW_THREADS>(Qs, q + qoff * d, q0, tq, d);
    stage_bf16<BQ, DMAX, LD, NARROW_THREADS>(dOs, dout + qoff * d, q0, tq, d);
    stage_vec<BQ, NARROW_THREADS>(lse_s, lse + qoff, q0, tq, LOG2E);
    stage_vec<BQ, NARROW_THREADS>(dl_s, delta + qoff, q0, tq, 1.f);
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T for this warp's 16 kv rows
    float st[QT][4], dpt[QT][4];
    zero(st);
    zero(dpt);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned ka[4], va[4];
      ldsm_x4(ka, Ks + warp * 16 * LD + kk * 16 + lane_a(lane, LD));
      ldsm_x4(va, Vs + warp * 16 * LD + kk * 16 + lane_a(lane, LD));
#pragma unroll
      for (int p = 0; p < BQ / 16; ++p) {
        unsigned b[4];
        ldsm_x4(b, Qs + p * 16 * LD + kk * 16 + lane_nk(lane, LD));
        mma_bf16(st[2 * p], ka, b[0], b[1]);
        mma_bf16(st[2 * p + 1], ka, b[2], b[3]);
        ldsm_x4(b, dOs + p * 16 * LD + kk * 16 + lane_nk(lane, LD));
        mma_bf16(dpt[2 * p], va, b[0], b[1]);
        mma_bf16(dpt[2 * p + 1], va, b[2], b[3]);
      }
    }

    // p^T = exp(s^T scale - lse), ds^T = p^T (dp^T - delta) scale; padded
    // q columns and kv rows are 0
#pragma unroll
    for (int n = 0; n < QT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t4 + (e & 1);
        const int kr = k0 + warp * 16 + g + 8 * (e >> 1);
        const float p = (q0 + qc < tq && kr < tk)
                            ? exp2f(st[n][e] * sl2 - lse_s[qc]) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dl_s[qc]) * scale;
      }

    // dv += p^T do, dk += ds^T q (a product over the tile's 64 q rows)
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      unsigned pa[4], sa[4];
      acc_to_a(pa, st[2 * j], st[2 * j + 1]);
      acc_to_a(sa, dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        unsigned b[4];
        ldsm_x4_t(b, dOs + j * 16 * LD + n2 * 16 + lane_kn(lane, LD));
        mma_bf16(dv_acc[2 * n2], pa, b[0], b[1]);
        mma_bf16(dv_acc[2 * n2 + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, Qs + j * 16 * LD + n2 * 16 + lane_kn(lane, LD));
        mma_bf16(dk_acc[2 * n2], sa, b[0], b[1]);
        mma_bf16(dk_acc[2 * n2 + 1], sa, b[2], b[3]);
      }
    }

    // ds^T to shared memory, so that each warp can take 16 q rows of dq
#pragma unroll
    for (int n = 0; n < QT; ++n) {
      const int row = warp * 16 + g;
      const int col = n * 8 + 2 * t4;
      *reinterpret_cast<unsigned*>(dSs + row * LDS + col) = pack_bf16(dpt[n][0], dpt[n][1]);
      *reinterpret_cast<unsigned*>(dSs + (row + 8) * LDS + col) =
          pack_bf16(dpt[n][2], dpt[n][3]);
    }
    __syncthreads();

    // dq (q rows warp*16 .. +16 of the tile) += ds k, over the 64 kv rows
    float dq_acc[NT][4];
    zero(dq_acc);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      unsigned a[4];
      ldsm_x4_t(a, dSs + j * 16 * LDS + warp * 16 + lane_nk(lane, LDS));
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        unsigned b[4];
        ldsm_x4_t(b, Ks + j * 16 * LD + n2 * 16 + lane_kn(lane, LD));
        mma_bf16(dq_acc[2 * n2], a, b[0], b[1]);
        mma_bf16(dq_acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row >= tq) continue;
      float* dqrow = dq + (qoff + row) * d;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * t4;
        if (col < d) atomicAdd(dqrow + col, dq_acc[n][2 * r]);
        if (col + 1 < d) atomicAdd(dqrow + col + 1, dq_acc[n][2 * r + 1]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + 8 * r;
    if (row >= tk) continue;
    bf16* dkrow = dk + (koff + row) * d;
    bf16* dvrow = dv + (koff + row) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t4 + e;
        if (col < d) {
          dkrow[col] = __float2bfloat16(dk_acc[n][2 * r + e]);
          dvrow[col] = __float2bfloat16(dv_acc[n][2 * r + e]);
        }
      }
    }
  }
}


// ---------------------------------------------------- split pair (wide)

template <int DMAX>
struct WideBwdCfg {
  static constexpr int BR = 32;  // rows this block owns (q for dq, kv for dkv)
  static constexpr int BT = 64;  // rows of the tiles it loops over
  static constexpr int LD = DMAX + 8;
  static constexpr int LDP = BT + 8;
  static constexpr size_t SMEM = sizeof(bf16) * (2 * (BR + BT) * (size_t)LD +
                                                 2 * BR * LDP) +
                                 sizeof(float) * 2 * BT;
};

template <int DMAX>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int tq, int tk, int d, float scale) {
  typedef WideBwdCfg<DMAX> C;
  constexpr int BQ = C::BR, BK = C::BT, LD = C::LD, LDP = C::LDP;
  constexpr int CW = DMAX / 4;
  constexpr int NT = CW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  bf16* dSs = Vs + BK * LD;  // ds, [q][kv]
  float* lse_s = reinterpret_cast<float*>(dSs + BQ * LDP);  // lse * log2(e)
  float* dl_s = lse_s + BQ;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rg = warp >> 2;
  const int cq = warp & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t qoff = (size_t)bh * tq;
  const size_t koff = (size_t)bh * tk;
  const float sl2 = scale * LOG2E;

  stage_bf16<BQ, DMAX, LD, WIDE_THREADS>(Qs, q + qoff * d, q0, tq, d);
  stage_bf16<BQ, DMAX, LD, WIDE_THREADS>(dOs, dout + qoff * d, q0, tq, d);
  stage_vec<BQ, WIDE_THREADS>(lse_s, lse + qoff, q0, tq, LOG2E);
  stage_vec<BQ, WIDE_THREADS>(dl_s, delta + qoff, q0, tq, 1.f);
  float acc[NT][4];
  zero(acc);

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<BK, DMAX, LD, WIDE_THREADS>(Ks, k + koff * d, k0, tk, d);
    stage_bf16<BK, DMAX, LD, WIDE_THREADS>(Vs, v + koff * d, k0, tk, d);
    __syncthreads();

    float s[2][4], dp[2][4];
    warp_abt<DMAX>(s, Qs + rg * 16 * LD, LD, Ks + cq * 16 * LD, LD, lane);
    warp_abt<DMAX>(dp, dOs + rg * 16 * LD, LD, Vs + cq * 16 * LD, LD, lane);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rg * 16 + g + 8 * r;
        const int col = cq * 16 + n * 8 + 2 * t4;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = k0 + col + e < tk
                              ? exp2f(s[n][2 * r + e] * sl2 - lse_s[row]) : 0.f;
          ds[e] = p * (dp[n][2 * r + e] - dl_s[row]) * scale;
        }
        *reinterpret_cast<unsigned*>(dSs + row * LDP + col) = pack_bf16(ds[0], ds[1]);
      }
    __syncthreads();
    warp_ax<BK, NT>(acc, dSs + rg * 16 * LDP, LDP, Ks + cq * CW, LD, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rg * 16 + g + 8 * r;
    if (row >= tq) continue;
    bf16* dqrow = dq + (qoff + row) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = cq * CW + n * 8 + 2 * t4;
      if (col < d) dqrow[col] = __float2bfloat16(acc[n][2 * r]);
      if (col + 1 < d) dqrow[col + 1] = __float2bfloat16(acc[n][2 * r + 1]);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int tq, int tk,
                     int d, float scale) {
  typedef WideBwdCfg<DMAX> C;
  constexpr int BK = C::BR, BQ = C::BT, LD = C::LD, LDP = C::LDP;
  constexpr int CW = DMAX / 4;
  constexpr int NT = CW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;
  bf16* dOs = Qs + BQ * LD;
  bf16* Pt = dOs + BQ * LD;  // p^T, [kv][q]
  bf16* dSt = Pt + BK * LDP;  // ds^T, [kv][q]
  float* lse_s = reinterpret_cast<float*>(dSt + BK * LDP);  // lse * log2(e)
  float* dl_s = lse_s + BQ;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rg = warp >> 2;
  const int cq = warp & 3;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t qoff = (size_t)bh * tq;
  const size_t koff = (size_t)bh * tk;
  const float sl2 = scale * LOG2E;

  stage_bf16<BK, DMAX, LD, WIDE_THREADS>(Ks, k + koff * d, k0, tk, d);
  stage_bf16<BK, DMAX, LD, WIDE_THREADS>(Vs, v + koff * d, k0, tk, d);
  float dk_acc[NT][4], dv_acc[NT][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int q0 = 0; q0 < tq; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<BQ, DMAX, LD, WIDE_THREADS>(Qs, q + qoff * d, q0, tq, d);
    stage_bf16<BQ, DMAX, LD, WIDE_THREADS>(dOs, dout + qoff * d, q0, tq, d);
    stage_vec<BQ, WIDE_THREADS>(lse_s, lse + qoff, q0, tq, LOG2E);
    stage_vec<BQ, WIDE_THREADS>(dl_s, delta + qoff, q0, tq, 1.f);
    __syncthreads();

    float st[2][4], dpt[2][4];  // s^T, dp^T: kv rows x q columns
    warp_abt<DMAX>(st, Ks + rg * 16 * LD, LD, Qs + cq * 16 * LD, LD, lane);
    warp_abt<DMAX>(dpt, Vs + rg * 16 * LD, LD, dOs + cq * 16 * LD, LD, lane);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rg * 16 + g + 8 * r;  // kv
        const int col = cq * 16 + n * 8 + 2 * t4;  // q
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = col + e;
          p[e] = (q0 + qc < tq && k0 + row < tk)
                     ? exp2f(st[n][2 * r + e] * sl2 - lse_s[qc]) : 0.f;
          ds[e] = p[e] * (dpt[n][2 * r + e] - dl_s[qc]) * scale;
        }
        *reinterpret_cast<unsigned*>(Pt + row * LDP + col) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<unsigned*>(dSt + row * LDP + col) = pack_bf16(ds[0], ds[1]);
      }
    __syncthreads();
    warp_ax<BQ, NT>(dv_acc, Pt + rg * 16 * LDP, LDP, dOs + cq * CW, LD, lane);
    warp_ax<BQ, NT>(dk_acc, dSt + rg * 16 * LDP, LDP, Qs + cq * CW, LD, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + rg * 16 + g + 8 * r;
    if (row >= tk) continue;
    bf16* dkrow = dk + (koff + row) * d;
    bf16* dvrow = dv + (koff + row) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = cq * CW + n * 8 + 2 * t4 + e;
        if (col < d) {
          dkrow[col] = __float2bfloat16(dk_acc[n][2 * r + e]);
          dvrow[col] = __float2bfloat16(dv_acc[n][2 * r + e]);
        }
      }
  }
}

// ---------------------------------------------------------------- launchers

template <int DMAX>
static int launch_fused(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, void* dk,
                        void* dv, int bh, int tq, int tk, int d, float scale,
                        cudaStream_t stream) {
  typedef FusedCfg<DMAX> C;
  auto kern = flash_bwd_fused_kernel<DMAX>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tk + C::BK - 1) / C::BK, bh);
  kern<<<grid, NARROW_THREADS, C::SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, (bf16*)dk, (bf16*)dv,
      tq, tk, d, scale);
  return (int)cudaGetLastError();
}

template <int DMAX>
static int launch_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int bh, int tq,
                     int tk, int d, float scale, cudaStream_t stream) {
  typedef WideBwdCfg<DMAX> C;
  auto kern = flash_bwd_dq_kernel<DMAX>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + C::BR - 1) / C::BR, bh);
  kern<<<grid, WIDE_THREADS, C::SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, tq, tk, d, scale);
  return (int)cudaGetLastError();
}

template <int DMAX>
static int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int bh,
                      int tq, int tk, int d, float scale, cudaStream_t stream) {
  typedef WideBwdCfg<DMAX> C;
  auto kern = flash_bwd_dkv_kernel<DMAX>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tk + C::BR - 1) / C::BR, bh);
  kern<<<grid, WIDE_THREADS, C::SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, tq, tk, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

#define FLASH_ARGS_OK(bh, tq, tk) \
  ((bh) > 0 && (bh) <= 65535 && (tq) > 0 && (tk) > 0)

// q, k, v, do: bf16 [bh, t, d]; lse, delta: fp32 [bh, tq];
// dq: fp32 [bh, tq, d], zeroed by the caller; dk, dv: bf16 [bh, tk, d].
// D <= 128 only (the reference's fused-backward rule).
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dk, void* dv,
                               int bh, int tq, int tk, int d, float scale,
                               void* stream) {
  using namespace flash;
  if (!FLASH_ARGS_OK(bh, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (narrow_dmax(d)) {
    case 48: return launch_fused<48>(q, k, v, dout, lse, delta, dq, dk, dv, bh, tq, tk, d, scale, s);
    case 64: return launch_fused<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, tq, tk, d, scale, s);
    case 96: return launch_fused<96>(q, k, v, dout, lse, delta, dq, dk, dv, bh, tq, tk, d, scale, s);
    case 128: return launch_fused<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, tq, tk, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv: bf16 [bh, tk, d] (no dq).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* dk, void* dv, int bh, int tq, int tk, int d,
                             float scale, void* stream) {
  using namespace flash;
  if (!FLASH_ARGS_OK(bh, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (wide_dmax(d)) {
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, s);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, s);
    case 256: return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, s);
    case 512: return launch_dkv<512>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq: bf16 [bh, tq, d].
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            void* dq, int bh, int tq, int tk, int d, float scale,
                            void* stream) {
  using namespace flash;
  if (!FLASH_ARGS_OK(bh, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (wide_dmax(d)) {
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, s);
    case 256: return launch_dq<256>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, s);
    case 512: return launch_dq<512>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
