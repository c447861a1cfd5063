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
// to bf16: every product is an fp32 fused multiply-add on the CUDA cores
// (no tensor cores, no TF32), so they agree with the plain fp32 version to
// summation order.
//
// What bounds them on this card: the fp32 FMA rate (67 TFLOP/s on the
// H100 SXM), not memory. They are simple, not fast: the fp32 path serves
// the small test geometries, and the SD-1.5 path is bf16.
//
// Design (one warp = 32 lanes; DP = head width rounded up to 32, 64, 128,
// 256 or 512; NC = DP / 32 columns of an output row per lane):
//   * flash_fwd_f32: a block of four warps takes 4 * RW q rows (RW per
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
  F32_SWITCH(d, (launch_fwd<DP>(q, k, v, o, lse, bh, tq, tk, d, scale, s)), 512)
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
