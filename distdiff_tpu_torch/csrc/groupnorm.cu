// GroupNorm(+SiLU) for Hopper (sm_90a): gn_fused, gn_stats and gn_apply.
//
// Replaces the Pallas TPU kernels in distdiff_tpu/ops/groupnorm.py:
//   * gn_fused  <- `_gn_kernel` (through `_pallas_group_norm`): single pass;
//   * gn_stats  <- `_gn_stats_kernel` } (through `_pallas_group_norm_chunked`):
//   * gn_apply  <- `_gn_apply_kernel` }  the two-pass path for big slabs.
// They compute what `xla_group_norm` computes: fp32 sums of x and x^2 per
// (batch row, group), mean = s1 / n, var = s2 / n - mean^2 (the reference's
// formula, not Welford), inv = rsqrt(var + eps); per channel
// a = inv * scale and b = bias - mean * inv * scale, each rounded to x's
// type; y = x * a + b in x's type (the product and the sum each rounded, as
// the plain version's two elementwise operations round: no fused
// multiply-add); optionally SiLU in fp32, rounded back.
//
// What bounds them on this card: bytes. A norm reads its slab and writes
// it once at least; the arithmetic is a few operations an element.
// gn_fused reads the slab once and writes it once; the pair reads it twice
// and writes it once.
//
// Layouts. The port's tensors are NCHW in shape, but the models enter
// through a permute of NHWC and cuDNN keeps that memory format, so a norm
// sees either contiguous NCHW, where a (row, group) span is one run of
// cpg * H * W elements, or channels-last (NHWC in memory), where each pixel
// holds the group's cpg channels contiguous at a stride of C. Both are
// read in place (`nhwc` selects the addressing); the output has the
// input's layout. V elements move per load and store (16 bytes where the
// shape and the pointers allow; the wrapper picks V).
//
// Design. The TPU grid ran in order, so pass 1 carried its sums across
// row chunks in VMEM scratch, and the per-group reduction was a 0/1-matrix
// product on the MXU. Blocks on the card run in parallel, and a per-group
// sum is a plain sum:
//   * gn_fused: one block per (group, batch row) stages the whole span in
//     shared memory while it sums it, reduces over the block, folds
//     (a, b) per channel into shared memory and writes act(x a + b) from
//     shared memory: one read and one write of device memory. It is taken
//     when the span fits the block's shared memory (227 KB on the H100, so
//     the UNet's spans up to 64^2 x 640 in bf16); the wrapper decides.
//   * gn_stats: the VAE has few (row, group) pairs and spans of up to
//     4 MB, so each span is split over many blocks to fill the card: in
//     NCHW a block takes a contiguous piece of one span; in NHWC a block
//     takes a band of pixel rows of one batch row with every channel
//     (coalesced), each thread keeping fixed channels, and adds its sums
//     into per-group shared sums. Each block writes its fp32 partial sums
//     (no atomics in device memory, so the result is deterministic); the
//     last block of a batch row (an atomic counter) adds the partials in
//     a fixed order and writes (a, b) as fp32 [B, 2, C], as the
//     reference's pass 1 does.
//   * gn_apply: act(x a + b) over the whole tensor, a grid-stride loop of
//     vector loads; a and b are rounded to x's type as the reference's
//     pass 2 casts them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace gn {

typedef __nv_bfloat16 bf16;

constexpr int FUSED_THREADS = 512;
constexpr int STATS_THREADS = 256;
constexpr int APPLY_THREADS = 256;
constexpr int ACT_SILU = 1;
// shared floats before gn_fused's span: 2 x 32 warp partials, mean and inv
constexpr int RED_FLOATS = 68;

template <int NB> struct Raw;
template <> struct Raw<16> { typedef uint4 t; };
template <> struct Raw<8> { typedef uint2 t; };
template <> struct Raw<4> { typedef unsigned t; };
template <> struct Raw<2> { typedef unsigned short t; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, as an fp32 value
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float param(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

// act(x * a + b) with a and b already rounded to T
template <typename T>
__device__ __forceinline__ float affine_act(float x, float a, float b, int act) {
  float y = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, a)), b));
  if (act == ACT_SILU) y = rnd<T>(y / (1.f + expf(-y)));
  return y;
}

// (a, b) of one channel from its group's statistics, rounded to T
template <typename T>
__device__ __forceinline__ void fold(float mean, float inv, float sc, float bi,
                                     float& a, float& b) {
  a = rnd<T>(__fmul_rn(inv, sc));
  b = rnd<T>(__fsub_rn(bi, __fmul_rn(__fmul_rn(mean, inv), sc)));
}

__device__ __forceinline__ void mean_inv(float s1, float s2, float n, float eps,
                                         float& mean, float& inv) {
  mean = __fdiv_rn(s1, n);
  const float var = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean));
  inv = rsqrtf(var + eps);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum a and b over the block; every thread gets the totals. red: 66 floats.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = (blockDim.x + 31) >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    float x = lane < nw ? red[lane] : 0.f;
    float y = lane < nw ? red[32 + lane] : 0.f;
    x = warp_sum(x);
    y = warp_sum(y);
    if (lane == 0) {
      red[64] = x;
      red[65] = y;
    }
  }
  __syncthreads();
  a = red[64];
  b = red[65];
}

// ------------------------------------------------------------- gn_fused

// Element i of the (b, g) span: i = c * S + s in NCHW, s * cpg + c in NHWC
// (c the channel within the group).
__device__ __forceinline__ size_t span_offset(size_t slab, int i, int g, int cpg,
                                              int C, int S, int nhwc) {
  return nhwc ? slab + (size_t)(i / cpg) * C + (size_t)g * cpg + (i % cpg)
              : slab + (size_t)g * cpg * S + i;
}

template <typename T, int V>
__global__ void __launch_bounds__(FUSED_THREADS)
gn_fused_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                const void* __restrict__ bias, int param_bf16, T* __restrict__ y,
                int C, int S, int G, float eps, int nhwc, int act, int header_bytes) {
  typedef typename Raw<sizeof(T) * V>::t R;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  const int cpg = C / G;
  float* a_s = red + RED_FLOATS;
  float* b_s = a_s + cpg;
  T* span = reinterpret_cast<T*>(smem + header_bytes);
  const int g = blockIdx.x;
  const size_t slab = (size_t)blockIdx.y * C * S;
  const int n = cpg * S;

  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x * V; i < n; i += FUSED_THREADS * V) {
    const R r = *reinterpret_cast<const R*>(x + span_offset(slab, i, g, cpg, C, S, nhwc));
    *reinterpret_cast<R*>(span + i) = r;
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f(e[j]);
      s1 += f;
      s2 += f * f;
    }
  }
  block_sum2(s1, s2, red);
  float mean, inv;
  mean_inv(s1, s2, (float)n, eps, mean, inv);
  for (int j = threadIdx.x; j < cpg; j += FUSED_THREADS) {
    const int c = g * cpg + j;
    fold<T>(mean, inv, param(scale, c, param_bf16), param(bias, c, param_bf16),
            a_s[j], b_s[j]);
  }
  __syncthreads();

  for (int i = threadIdx.x * V; i < n; i += FUSED_THREADS * V) {
    const R r = *reinterpret_cast<const R*>(span + i);
    const T* e = reinterpret_cast<const T*>(&r);
    R out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = nhwc ? (i + j) % cpg : (i + j) / S;
      o[j] = from_f<T>(affine_act<T>(to_f(e[j]), a_s[c], b_s[c], act));
    }
    *reinterpret_cast<R*>(y + span_offset(slab, i, g, cpg, C, S, nhwc)) = out;
  }
}

// ------------------------------------------------------------- gn_stats

// The last block of batch row b adds the partial sums [nsplit, G, 2] in a
// fixed order and writes (a, b) as fp32 ab[b, 0, :] and ab[b, 1, :].
// stats: 2 * G shared floats.
template <typename T>
__device__ void finish_row(const float* __restrict__ part, int* __restrict__ counter,
                           float* __restrict__ ab, const void* scale, const void* bias,
                           int param_bf16, int b, int blocks_per_row, int nsplit, int C,
                           int S, int G, float eps, float* stats) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter + b, 1) == blocks_per_row - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int cpg = C / G;
  const float n = (float)cpg * (float)S;
  for (int gg = warp; gg < G; gg += nw) {
    float s1 = 0.f, s2 = 0.f;
    for (int sp = lane; sp < nsplit; sp += 32) {
      const float* p = part + ((size_t)(b * nsplit + sp) * G + gg) * 2;
      s1 += __ldcg(p);
      s2 += __ldcg(p + 1);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) mean_inv(s1, s2, n, eps, stats[2 * gg], stats[2 * gg + 1]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int gg = c / cpg;
    const float mean = stats[2 * gg], inv = stats[2 * gg + 1];
    const float sc = param(scale, c, param_bf16), bi = param(bias, c, param_bf16);
    // fp32, as the reference's pass 1 emits them; gn_apply rounds to T
    ab[(size_t)(2 * b) * C + c] = __fmul_rn(inv, sc);
    ab[(size_t)(2 * b + 1) * C + c] = __fsub_rn(bi, __fmul_rn(__fmul_rn(mean, inv), sc));
  }
  if (threadIdx.x == 0) counter[b] = 0;
}

// NCHW: block (split, g, b) sums elements [split * chunk, +chunk) of the
// contiguous (b, g) span.
template <typename T, int V>
__global__ void __launch_bounds__(STATS_THREADS)
gn_stats_nchw_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                     const void* __restrict__ bias, int param_bf16,
                     float* __restrict__ part, int* __restrict__ counter,
                     float* __restrict__ ab, int C, int S, int G, float eps, int nsplit,
                     int chunk) {
  typedef typename Raw<sizeof(T) * V>::t R;
  extern __shared__ __align__(16) float fsm[];  // red (66) then stats (2G)
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int cpg = C / G;
  const int n = cpg * S;
  const T* base = x + ((size_t)b * C + (size_t)g * cpg) * S;
  const int lo = split * chunk;
  const int hi = min(n, lo + chunk);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int i = lo + threadIdx.x * V; i < hi; i += STATS_THREADS * V) {
    const R r = *reinterpret_cast<const R*>(base + i);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f(e[j]);
      s1 += f;
      s2 += f * f;
    }
  }
  block_sum2(s1, s2, fsm);
  if (threadIdx.x == 0) {
    float* p = part + ((size_t)(b * nsplit + split) * G + g) * 2;
    p[0] = s1;
    p[1] = s2;
  }
  finish_row<T>(part, counter, ab, scale, bias, param_bf16, b, nsplit * G, nsplit, C, S,
                G, eps, fsm + RED_FLOATS);
}

// NHWC: block (split, b) takes pixel rows [split * rows, +rows) of batch
// row b with every channel. Thread (tx, ty) keeps the V channels of
// vector column cv = tx (+ NVT ...) fixed and walks rows ty, ty + R, ...
template <typename T, int V>
__global__ void __launch_bounds__(STATS_THREADS)
gn_stats_nhwc_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                     const void* __restrict__ bias, int param_bf16,
                     float* __restrict__ part, int* __restrict__ counter,
                     float* __restrict__ ab, int C, int S, int G, float eps, int nsplit,
                     int rows) {
  typedef typename Raw<sizeof(T) * V>::t R;
  extern __shared__ __align__(16) float fsm[];  // group sums (2G) then stats (2G)
  float* gs = fsm;
  const int split = blockIdx.x, b = blockIdx.z;
  const int cpg = C / G;
  const int nv = C / V;
  const int nvt = min(nv, STATS_THREADS);
  const int rr = STATS_THREADS / nvt;
  const int tx = threadIdx.x % nvt, ty = threadIdx.x / nvt;
  const int r0 = split * rows;
  const int r1 = min(S, r0 + rows);
  for (int i = threadIdx.x; i < 2 * G; i += STATS_THREADS) gs[i] = 0.f;
  __syncthreads();
  const T* slab = x + (size_t)b * S * C;
  for (int cv = tx; cv < nv; cv += nvt) {
    float a1[V], a2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
    if (ty < rr) {
#pragma unroll 4
      for (int r = r0 + ty; r < r1; r += rr) {
        const R raw = *reinterpret_cast<const R*>(slab + (size_t)r * C + cv * V);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = to_f(e[j]);
          a1[j] += f;
          a2[j] += f * f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int gg = (cv * V + j) / cpg;
      atomicAdd(gs + 2 * gg, a1[j]);
      atomicAdd(gs + 2 * gg + 1, a2[j]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * G; i += STATS_THREADS)
    part[(size_t)(b * nsplit + split) * G * 2 + i] = gs[i];
  finish_row<T>(part, counter, ab, scale, bias, param_bf16, b, nsplit, nsplit, C, S, G,
                eps, fsm + 2 * G);
}

// ------------------------------------------------------------- gn_apply

template <typename T, int V>
__global__ void __launch_bounds__(APPLY_THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ ab, T* __restrict__ y,
                int C, int S, int nhwc, int act, long long nvec) {
  typedef typename Raw<sizeof(T) * V>::t R;
  const long long row = (long long)C * S;
  for (long long vi = (long long)blockIdx.x * APPLY_THREADS + threadIdx.x; vi < nvec;
       vi += (long long)gridDim.x * APPLY_THREADS) {
    const long long e0 = vi * V;
    const int b = (int)(e0 / row);
    const long long w = e0 - (long long)b * row;
    const float* a_row = ab + (size_t)(2 * b) * C;
    const float* b_row = a_row + C;
    const R raw = *reinterpret_cast<const R*>(x + e0);
    const T* e = reinterpret_cast<const T*>(&raw);
    R out;
    T* o = reinterpret_cast<T*>(&out);
    if (nhwc) {
      const int c0 = (int)(w % C);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = from_f<T>(affine_act<T>(to_f(e[j]), rnd<T>(__ldg(a_row + c0 + j)),
                                       rnd<T>(__ldg(b_row + c0 + j)), act));
    } else {
      const int c = (int)(w / S);
      const float a = rnd<T>(__ldg(a_row + c)), bb = rnd<T>(__ldg(b_row + c));
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = from_f<T>(affine_act<T>(to_f(e[j]), a, bb, act));
    }
    *reinterpret_cast<R*>(y + e0) = out;
  }
}

// ------------------------------------------------------------- launchers

template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int V>
int launch_fused(const void* x, const void* scale, const void* bias, int param_bf16,
                 void* y, int B, int C, int S, int G, float eps, int nhwc, int act,
                 int header_bytes, cudaStream_t stream) {
  const size_t smem = header_bytes + (size_t)(C / G) * S * sizeof(T);
  auto kern = gn_fused_kernel<T, V>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(G, B), FUSED_THREADS, smem, stream>>>(
      (const T*)x, scale, bias, param_bf16, (T*)y, C, S, G, eps, nhwc, act, header_bytes);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_stats(const void* x, const void* scale, const void* bias, int param_bf16,
                 void* part, void* counter, void* ab, int B, int C, int S, int G,
                 float eps, int nhwc, int nsplit, cudaStream_t stream) {
  if (nhwc) {
    const size_t smem = sizeof(float) * 4 * G;
    auto kern = gn_stats_nhwc_kernel<T, V>;
    cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return (int)err;
    const int rows = (S + nsplit - 1) / nsplit;
    kern<<<dim3(nsplit, 1, B), STATS_THREADS, smem, stream>>>(
        (const T*)x, scale, bias, param_bf16, (float*)part, (int*)counter, (float*)ab, C,
        S, G, eps, nsplit, rows);
  } else {
    const size_t smem = sizeof(float) * (RED_FLOATS + 2 * G);
    auto kern = gn_stats_nchw_kernel<T, V>;
    cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return (int)err;
    const int n = (C / G) * S;
    const int chunk = ((n + nsplit - 1) / nsplit + V - 1) / V * V;
    kern<<<dim3(nsplit, G, B), STATS_THREADS, smem, stream>>>(
        (const T*)x, scale, bias, param_bf16, (float*)part, (int*)counter, (float*)ab, C,
        S, G, eps, nsplit, chunk);
  }
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_apply(const void* x, const void* ab, void* y, int B, int C, int S, int nhwc,
                 int act, int sm_count, cudaStream_t stream) {
  const long long nvec = (long long)B * C * S / V;
  const long long want = (nvec + APPLY_THREADS - 1) / APPLY_THREADS;
  const int grid = (int)(want < 16LL * sm_count ? want : 16LL * sm_count);
  gn_apply_kernel<T, V><<<grid, APPLY_THREADS, 0, stream>>>(
      (const T*)x, (const float*)ab, (T*)y, C, S, nhwc, act, nvec);
  return (int)cudaGetLastError();
}

// vec: elements per load (1, 2, 4, or 8 for bf16); 16 bytes at most
#define GN_DISPATCH(T, vec, call)                                         \
  switch (vec) {                                                          \
    case 1: { constexpr int V = 1; return call; }                         \
    case 2: { constexpr int V = 2; return call; }                         \
    case 4: { constexpr int V = 4; return call; }                         \
    case 8:                                                               \
      if constexpr (sizeof(T) * 8 <= 16) { constexpr int V = 8; return call; } \
      return (int)cudaErrorInvalidValue;                                  \
    default: return (int)cudaErrorInvalidValue;                           \
  }

template <typename T>
int fused_t(const void* x, const void* scale, const void* bias, int param_bf16, void* y,
            int B, int C, int S, int G, float eps, int nhwc, int act, int header_bytes,
            int vec, cudaStream_t s) {
  GN_DISPATCH(T, vec, (launch_fused<T, V>(x, scale, bias, param_bf16, y, B, C, S, G, eps,
                                          nhwc, act, header_bytes, s)))
}

template <typename T>
int stats_t(const void* x, const void* scale, const void* bias, int param_bf16,
            void* part, void* counter, void* ab, int B, int C, int S, int G, float eps,
            int nhwc, int nsplit, int vec, cudaStream_t s) {
  GN_DISPATCH(T, vec, (launch_stats<T, V>(x, scale, bias, param_bf16, part, counter, ab, B,
                                          C, S, G, eps, nhwc, nsplit, s)))
}

template <typename T>
int apply_t(const void* x, const void* ab, void* y, int B, int C, int S, int nhwc, int act,
            int sm_count, int vec, cudaStream_t s) {
  GN_DISPATCH(T, vec, (launch_apply<T, V>(x, ab, y, B, C, S, nhwc, act, sm_count, s)))
}

inline bool shape_ok(int B, int C, int S, int G) {
  return B > 0 && B <= 65535 && C > 0 && S > 0 && G > 0 && G <= 65535 && C % G == 0;
}

}  // namespace gn

// x, y: [B, C, S] (nhwc = 0) or [B, S, C] (nhwc = 1) in bf16 (is_bf16 = 1)
// or fp32; scale, bias: [C] in bf16 (param_bf16 = 1) or fp32. header_bytes:
// the shared bytes before the span (16-byte multiple, >= 4 * (68 + 2 C/G)).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int gn_fused(const void* x, const void* scale, const void* bias, void* y,
                        int is_bf16, int param_bf16, int B, int C, int S, int G,
                        float eps, int nhwc, int act, int header_bytes, int vec,
                        void* stream) {
  using namespace gn;
  if (!shape_ok(B, C, S, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? fused_t<bf16>(x, scale, bias, param_bf16, y, B, C, S, G, eps, nhwc, act,
                                 header_bytes, vec, s)
                 : fused_t<float>(x, scale, bias, param_bf16, y, B, C, S, G, eps, nhwc,
                                  act, header_bytes, vec, s);
}

// part: fp32 [B, nsplit, G, 2] scratch; counter: int32 [B], zero (the last
// block of a row sets it back to zero); ab: fp32 [B, 2, C] out.
extern "C" int gn_stats(const void* x, const void* scale, const void* bias, void* part,
                        void* counter, void* ab, int is_bf16, int param_bf16, int B, int C,
                        int S, int G, float eps, int nhwc, int nsplit, int vec,
                        void* stream) {
  using namespace gn;
  if (!shape_ok(B, C, S, G) || nsplit <= 0 || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? stats_t<bf16>(x, scale, bias, param_bf16, part, counter, ab, B, C, S, G,
                                 eps, nhwc, nsplit, vec, s)
                 : stats_t<float>(x, scale, bias, param_bf16, part, counter, ab, B, C, S,
                                  G, eps, nhwc, nsplit, vec, s);
}

// ab: fp32 [B, 2, C] from gn_stats.
extern "C" int gn_apply(const void* x, const void* ab, void* y, int is_bf16, int B, int C,
                        int S, int nhwc, int act, int sm_count, int vec, void* stream) {
  using namespace gn;
  if (!shape_ok(B, C, S, 1) || sm_count <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? apply_t<bf16>(x, ab, y, B, C, S, nhwc, act, sm_count, vec, s)
                 : apply_t<float>(x, ab, y, B, C, S, nhwc, act, sm_count, vec, s);
}

// The shared memory one block may use, after opting in (232448 bytes on the
// H100); the wrapper sizes gn_fused's spans against it. < 0: CUDA error.
extern "C" int gn_smem_optin(int device) {
  int v = 0;
  cudaError_t err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? v : -(int)err;
}
