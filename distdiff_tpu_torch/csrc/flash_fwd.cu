// flash_fwd: attention forward with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels distdiff_tpu/ops/flash.py
// `_fwd_kernel_single` and `_fwd_kernel` (reached through `_flash_fwd_3d`).
// Computes, for each (b*h) slab, o = softmax(q k^T * scale) v in bf16 and the
// per-row lse = m + log(l) in fp32, which the backward kernels read.
//
// What bounds it on this card: at the UNet's 64^2 stage ([32, 4096, 40])
// the exponentials (one per score, ~537M, on the special-function units)
// outweigh the two products on the tensor cores; at the VAE's D=512 the
// products dominate.
//
// Both kernels run the products on the tensor cores (mma.sync, bf16
// operands, fp32 sums): s = q k^T, then the online softmax (running max m
// and sum l per row, alpha = exp(m_old - m_new), exponentials as exp2 of
// scores pre-multiplied by scale * log2(e)), then o += p v with p rounded
// to bf16 as the reference rounds it. On Hopper a block loops over kv
// itself, so the TPU's one-block specialisation is not needed. Ragged kv
// columns are masked to -inf and ragged q rows are computed on zeros and
// never written; nothing is padded in device memory.
//
// Narrow kernel, D <= 128 (the UNet's 40 and 80, padded to 48 and 96 in
// shared memory only): one block of four warps per (64-row q tile, b*h);
// each warp owns 16 q rows, keeps its q fragments and its output
// accumulator in registers, and loops over 64-row kv tiles. The
// accumulators of s are already the A operand of p v, so p never leaves
// registers.
//
// Wide kernel, D up to 512 (the VAE's single head): a 32 x 512 fp32 output
// accumulator is 64 KB, so one block of eight warps per (32-row q tile,
// b*h) splits it into two 16-row groups by four 128-column quarters, 64
// registers a thread. For each 64-row kv tile, warp (group, quarter) forms
// the 16 x 16 block (group's rows, quarter's 16 kv columns) of s over the
// full head width; s goes through shared memory, where 8 threads a row
// take the softmax and write p as bf16; then each warp adds p v for its
// rows and columns. The q, k and v tiles (bf16, 32 + 64 + 64 rows of 520)
// take 166 KB of the 227 KB of dynamic shared memory.
#include "flash_common.cuh"

namespace flash {

template <int DMAX>
__global__ void __launch_bounds__(NARROW_THREADS)
flash_fwd_narrow_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, int d, float scale) {
  constexpr int BQ = 64, BK = 64;
  constexpr int LD = DMAX + 8;
  constexpr int KS = DMAX / 16;  // k-steps of q k^T
  constexpr int NT = DMAX / 8;   // 8-column tiles of o
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BK * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const bf16* kb = k + (size_t)bh * tk * d;
  const bf16* vb = v + (size_t)bh * tk * d;

  stage_bf16<BQ, DMAX, LD, NARROW_THREADS>(Qs, q + (size_t)bh * tq * d, q0, tq, d);
  __syncthreads();
  unsigned qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qa[kk], Qs + warp * 16 * LD + kk * 16 + lane_a(lane, LD));

  float acc[NT][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (log2 units)
  float l[2] = {0.f, 0.f};              // this thread's share of the running sums
  const float sl2 = scale * LOG2E;

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<BK, DMAX, LD, NARROW_THREADS>(Ks, kb, k0, tk, d);
    stage_bf16<BK, DMAX, LD, NARROW_THREADS>(Vs, vb, k0, tk, d);
    __syncthreads();

    float s[BK / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int p = 0; p < BK / 16; ++p) {
        unsigned b[4];
        ldsm_x4(b, Ks + p * 16 * LD + kk * 16 + lane_nk(lane, LD));
        mma_bf16(s[2 * p], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * p + 1], qa[kk], b[2], b[3]);
      }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t4 + (e & 1);
        const float x = col < tk ? s[n][e] * sl2 : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's 64 scores sit in the 4 lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      unsigned pa[4];
      acc_to_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        unsigned b[4];
        ldsm_x4_t(b, Vs + j * 16 * LD + n2 * 16 + lane_kn(lane, LD));
        mma_bf16(acc[2 * n2], pa, b[0], b[1]);
        mma_bf16(acc[2 * n2 + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= tq) continue;
    const float inv = 1.f / l[r];
    bf16* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < d) orow[col] = __float2bfloat16(acc[n][2 * r] * inv);
      if (col + 1 < d) orow[col + 1] = __float2bfloat16(acc[n][2 * r + 1] * inv);
    }
    if (t4 == 0) lse[(size_t)bh * tq + row] = m[r] * LN2 + logf(l[r]);
  }
}

template <int DMAX>
struct WideFwdCfg {
  static constexpr int BQ = 32, BK = 64;
  static constexpr int LD = DMAX + 8;
  static constexpr int LDP = BK + 8;  // p, bf16
  static constexpr int LDS = BK + 4;  // s, fp32
  static constexpr size_t SMEM = sizeof(bf16) * ((BQ + 2 * BK) * (size_t)LD + BQ * LDP) +
                                 sizeof(float) * (BQ * LDS + 3 * BQ);
};

template <int DMAX>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_fwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int tq, int tk, int d, float scale) {
  typedef WideFwdCfg<DMAX> C;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDP = C::LDP, LDS = C::LDS;
  constexpr int CW = DMAX / 4;  // output columns of a warp
  constexpr int NT = CW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  bf16* Ps = Vs + BK * LD;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * LDP);
  float* m_s = Ss + BQ * LDS;  // running max (log2 units)
  float* l_s = m_s + BQ;       // running sum
  float* a_s = l_s + BQ;       // this tile's rescale

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rg = warp >> 2;  // row group: rows rg*16 .. +16
  const int cq = warp & 3;   // column quarter
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const bf16* kb = k + (size_t)bh * tk * d;
  const bf16* vb = v + (size_t)bh * tk * d;
  const float sl2 = scale * LOG2E;

  stage_bf16<BQ, DMAX, LD, WIDE_THREADS>(Qs, q + (size_t)bh * tq * d, q0, tq, d);
  for (int r = threadIdx.x; r < BQ; r += WIDE_THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  float acc[NT][4];
  zero(acc);

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<BK, DMAX, LD, WIDE_THREADS>(Ks, kb, k0, tk, d);
    stage_bf16<BK, DMAX, LD, WIDE_THREADS>(Vs, vb, k0, tk, d);
    __syncthreads();

    float s[2][4];
    warp_abt<DMAX>(s, Qs + rg * 16 * LD, LD, Ks + cq * 16 * LD, LD, lane);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rg * 16 + g + 8 * (e >> 1);
        const int col = cq * 16 + n * 8 + 2 * t4 + (e & 1);
        Ss[row * LDS + col] = k0 + col < tk ? s[n][e] * sl2 : -INFINITY;
      }
    __syncthreads();

    {  // online softmax: 8 consecutive threads share one row
      const int row = threadIdx.x >> 3;
      const int c0 = (threadIdx.x & 7) * 8;
      float x[8];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] = Ss[row * LDS + c0 + i];
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        const float p0 = exp2f(x[i] - m_new);
        const float p1 = exp2f(x[i + 1] - m_new);
        sum += p0 + p1;
        *reinterpret_cast<unsigned*>(Ps + row * LDP + c0 + i) = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if ((threadIdx.x & 7) == 0) {
        const float alpha = exp2f(m_old - m_new);  // 0 on the first tile
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    const float a0 = a_s[rg * 16 + g];
    const float a1 = a_s[rg * 16 + g + 8];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    warp_ax<BK, NT>(acc, Ps + rg * 16 * LDP, LDP, Vs + cq * CW, LD, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lrow = rg * 16 + g + 8 * r;
    const int row = q0 + lrow;
    if (row >= tq) continue;
    const float inv = 1.f / l_s[lrow];
    bf16* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = cq * CW + n * 8 + 2 * t4;
      if (col < d) orow[col] = __float2bfloat16(acc[n][2 * r] * inv);
      if (col + 1 < d) orow[col + 1] = __float2bfloat16(acc[n][2 * r + 1] * inv);
    }
    if (cq == 0 && t4 == 0)
      lse[(size_t)bh * tq + row] = m_s[lrow] * LN2 + logf(l_s[lrow]);
  }
}

template <int DMAX>
static int launch_narrow(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int tq, int tk, int d, float scale,
                         cudaStream_t stream) {
  constexpr size_t SMEM = sizeof(bf16) * 3 * 64 * (DMAX + 8);
  auto kern = flash_fwd_narrow_kernel<DMAX>;
  cudaError_t err = set_smem(kern, SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + 63) / 64, bh);
  kern<<<grid, NARROW_THREADS, SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      tq, tk, d, scale);
  return (int)cudaGetLastError();
}

template <int DMAX>
static int launch_wide(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int tq, int tk, int d, float scale,
                       cudaStream_t stream) {
  typedef WideFwdCfg<DMAX> C;
  auto kern = flash_fwd_wide_kernel<DMAX>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + C::BQ - 1) / C::BQ, bh);
  kern<<<grid, WIDE_THREADS, C::SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      tq, tk, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

// q, k, v, o: bf16 [bh, t, d] contiguous; lse: fp32 [bh, tq].
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int tq, int tk, int d, float scale,
                         void* stream) {
  using namespace flash;
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (narrow_dmax(d)) {
    case 48: return launch_narrow<48>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 64: return launch_narrow<64>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 96: return launch_narrow<96>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 128: return launch_narrow<128>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
  }
  switch (wide_dmax(d)) {
    case 256: return launch_wide<256>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 512: return launch_wide<512>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
