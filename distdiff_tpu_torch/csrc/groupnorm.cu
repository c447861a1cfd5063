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
// it once at least; gn_fused reads the slab once and writes it once, the
// pair reads it twice and writes it once. Close behind come the SiLU's exp
// and division and the roundings to bf16, which the SM issues at a fraction
// of its fp32 rate: gn_fused rounds bf16 values in packed pairs.
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
//   * gn_fused: a unit is one batch row and a set of `gs` adjacent groups
//     (so that in NHWC each pixel holds one contiguous run of gs * cpg
//     channels). A thread-block cluster of `cl` blocks splits the unit's
//     pixels (NCHW: each group's span) into slices; each block keeps its
//     slice in its own shared memory while it sums it, the blocks add their
//     per-group partial sums through distributed shared memory (each block
//     gathers every rank's partials, one remote load a thread, then adds
//     them in rank order, so every block gets the same bytes and the result
//     does not depend on timing), fold (a, b) per channel, and each block
//     writes act(x a + b) from its own slice: one read and one write of
//     device memory, no partial sums in device memory, no atomics. bf16
//     values are transformed in pairs (`affine_act_bf16x2`). In NHWC each
//     thread keeps fixed channel columns (its channel-to-group map and a, b
//     are computed once) and walks pixel rows; the slice arrives either by
//     TMA (a 3-d tensor map over [B, S, C], boxes of chunk rows x the set's
//     channels, each chunk on its own mbarrier and summed as it lands) or,
//     where TMA cannot describe it (a run off 16 bytes, an unaligned base,
//     NCHW), by the threads' own vector loads. The wrapper's plan
//     (ops/groupnorm.py `fused_plan`) picks gs, cl, the vector width and the
//     route, so that the main path's shapes fill the card. It is taken when
//     one (row, group) span fits a block's shared memory (the route rule,
//     unchanged); the wrapper decides.
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
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

namespace gn {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int FUSED_THREADS = 256;
constexpr int MAX_CLUSTER = 16;
constexpr int TMA_BOX_MAX = 256;  // rows or channels of one TMA box
constexpr int TMA_CHUNKS = 4;     // a slice arrives in about this many chunks
constexpr int STATS_THREADS = 256;
constexpr int APPLY_THREADS = 256;
constexpr int ACT_SILU = 1;
// shared floats of block_sum2 (2 x 32 warp partials and the two totals),
// padded to 16 bytes
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

// act(x * a + b) of V bf16 values in pairs, a and b already rounded to
// bf16 (a2: the pairs of a): the product on bf16x2 (the exact product of
// two bf16 values, rounded once, as rounding the fp32 product does), the
// sum in fp32, each rounding to bf16 one packed conversion of two values.
// The same bits as affine_act<bf16> with a quarter of its conversions.
template <int V>
__device__ __forceinline__ void affine_act_bf16x2(const bf16* e, const __nv_bfloat162* a2,
                                                  const float* b, int act, bf16* o) {
#pragma unroll
  for (int j = 0; j < V / 2; ++j) {
    const float2 p = __bfloat1622float2(__hmul2(reinterpret_cast<const __nv_bfloat162*>(e)[j],
                                                a2[j]));
    __nv_bfloat162 y2 = __floats2bfloat162_rn(__fadd_rn(p.x, b[2 * j]),
                                              __fadd_rn(p.y, b[2 * j + 1]));
    if (act == ACT_SILU) {
      const float2 y = __bfloat1622float2(y2);
      y2 = __floats2bfloat162_rn(y.x / (1.f + expf(-y.x)), y.y / (1.f + expf(-y.y)));
    }
    reinterpret_cast<__nv_bfloat162*>(o)[j] = y2;
  }
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

// The unit's barrier: the cluster's, or the block's where the cluster is
// one block (a cluster barrier costs more than a block barrier)
__device__ __forceinline__ void unit_sync(int cl) {
  if (cl > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
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

// The geometry of one gn_fused launch, from the plan (see fused_geom).
struct FusedGeom {
  int C, S, G, cpg;
  int gs;        // groups in a unit (NCHW: 1)
  int W;         // channels in a unit: gs * cpg
  int cl;        // blocks in a cluster, each one slice of the unit
  int P;         // a slice: pixel rows (NHWC) or elements of the span (NCHW)
  int chunk;     // TMA: pixel rows of one box (a multiple of 8)
  int nchunks;   // TMA: boxes of a slice
  int nvt, rr;   // NHWC: vector columns walked at once, rows of threads
  int param_bf16, nhwc, act;
  float eps;
  // shared memory: the slice (128-byte aligned), then the fp32 column sums
  // (2 x rr x W; NCHW: block_sum2's), the group partials (2 gs), every
  // rank's partials gathered (2 gs x cl), the group statistics (2 gs), a
  // and b (W each), the mbarriers
  int off_red, off_part, off_ab, off_bar, smem;
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Completes the geometry from (C, S, G, gs, cl, itemsize, V, tma, nhwc);
// returns 0, or cudaErrorInvalidValue for a plan the kernel cannot take.
// ops/groupnorm.py `fused_smem_bytes` mirrors it.
inline int fused_geom(FusedGeom& g, int C, int S, int G, int gs, int cl, int itemsize,
                      int V, int tma, int nhwc) {
  g.C = C, g.S = S, g.G = G, g.cpg = C / G, g.gs = gs, g.cl = cl, g.nhwc = nhwc;
  g.W = gs * g.cpg;
  if (gs <= 0 || G % gs || cl <= 0 || cl > MAX_CLUSTER || (!nhwc && (gs != 1 || tma)) ||
      (tma && (g.W > TMA_BOX_MAX || (g.W * itemsize) % 16)))
    return (int)cudaErrorInvalidValue;
  long long slice, red;  // bytes
  if (nhwc) {
    if (g.W % V) return (int)cudaErrorInvalidValue;
    g.nvt = g.W / V < FUSED_THREADS ? g.W / V : FUSED_THREADS;
    g.rr = FUSED_THREADS / g.nvt;
    g.P = (S + cl - 1) / cl;
    g.chunk = round_up((g.P + TMA_CHUNKS - 1) / TMA_CHUNKS, 8);
    if (g.chunk > TMA_BOX_MAX) g.chunk = TMA_BOX_MAX;
    g.nchunks = tma ? (g.P + g.chunk - 1) / g.chunk : 0;
    slice = (long long)(tma ? g.nchunks * g.chunk : g.P) * g.W * itemsize;
    red = 4LL * 2 * g.rr * g.W;
  } else {
    const int n = g.cpg * S;
    if (n % V) return (int)cudaErrorInvalidValue;
    g.nvt = g.rr = 1;
    g.P = round_up((n + cl - 1) / cl, V);
    g.chunk = g.nchunks = 0;
    slice = (long long)g.P * itemsize;
    red = 4 * RED_FLOATS;
  }
  const long long total = slice + red + 8LL * (gs * (cl + 2) + g.W) + 8LL * g.nchunks + 512;
  if (total > (1 << 28)) return (int)cudaErrorInvalidValue;
  g.off_red = round_up((int)slice, 128);
  g.off_part = g.off_red + (int)red;
  g.off_ab = g.off_part + round_up(4 * 2 * gs * (cl + 2), 16);
  g.off_bar = g.off_ab + round_up(4 * 2 * g.W, 16);
  g.smem = g.off_bar + 8 * g.nchunks + 128;  // + alignment of the base
  return 0;
}

// One block: slice `rank` of unit (batch row blockIdx.y, group set
// blockIdx.x / cl). TMA: the slice by tensor-map boxes (NHWC only).
template <typename T, int V, bool TMA>
__global__ void __launch_bounds__(FUSED_THREADS)
gn_fused_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ x,
                const void* __restrict__ scale, const void* __restrict__ bias,
                T* __restrict__ y, const FusedGeom g) {
  typedef typename Raw<sizeof(T) * V>::t R;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128u - (hopper::smem_addr(smem_raw) & 127u)) & 127u);
  T* slice = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + g.off_red);
  float* part = reinterpret_cast<float*>(smem + g.off_part);
  float* gath = part + 2 * g.gs;
  float* stat = gath + 2 * g.gs * g.cl;
  float* a_s = reinterpret_cast<float*>(smem + g.off_ab);
  float* b_s = a_s + g.W;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + g.off_bar);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int set = blockIdx.x / g.cl;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  // NHWC: thread (tx, ty) keeps the V channels of vector columns tx,
  // tx + nvt, ... and walks pixel rows ty, ty + rr, ...; NCHW: vectors
  // tid, tid + threads, ... of the slice.
  const int nv = g.W / V;
  const int tx = tid % g.nvt, ty = tid / g.nvt;
  const int r0 = rank * g.P;                   // first row / element
  const int n = g.nhwc ? g.S : g.cpg * g.S;
  const int cnt = max(0, min(g.P, n - r0));    // rows / elements held
  // the slice's first element (the tensor has fewer than 2^31 elements)
  const int base = g.nhwc ? (b * g.S + r0) * g.C + set * g.W : (b * g.C + set * g.cpg) * g.S + r0;
  const T* __restrict__ xs = x + base;
  T* __restrict__ ys = y + base;

  if constexpr (TMA) {
    if (tid == 0) {
      for (int k = 0; k < g.nchunks; ++k) hopper::mbar_init(bars + k, 1);
      hopper::mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
      const uint32_t box = (uint32_t)g.chunk * g.W * sizeof(T);
      for (int k = 0; k * g.chunk < cnt; ++k) {
        hopper::mbar_arrive_tx(bars + k, box);
        hopper::tma_load_3d(slice + k * g.chunk * g.W, &map, set * g.W,
                            r0 + k * g.chunk, b, bars + k);
      }
    }
  }

  if (g.nhwc) {
    if (ty < g.rr) {
      for (int cv = tx; cv < nv; cv += g.nvt) {
        float a1[V], a2[V];
#pragma unroll
        for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
        int ready = 0;  // TMA: rows [0, ready) have landed
#pragma unroll 4
        for (int r = ty; r < cnt; r += g.rr) {
          R raw;
          if constexpr (TMA) {
            if (r >= ready) {
              const int k = r / g.chunk;
              hopper::mbar_wait(bars + k, 0);
              ready = (k + 1) * g.chunk;
            }
            raw = *reinterpret_cast<const R*>(slice + r * g.W + cv * V);
          } else {
            raw = *reinterpret_cast<const R*>(xs + r * g.C + cv * V);
            *reinterpret_cast<R*>(slice + r * g.W + cv * V) = raw;
          }
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float f = to_f(e[j]);
            a1[j] += f;
            a2[j] += f * f;
          }
        }
        // column sums by row of threads: s1 at red[ty][c], s2 at red[rr + ty][c]
#pragma unroll
        for (int j = 0; j < V; ++j) {
          red[ty * g.W + cv * V + j] = a1[j];
          red[(g.rr + ty) * g.W + cv * V + j] = a2[j];
        }
      }
    }
    __syncthreads();
    for (int c = tid; c < g.W; c += FUSED_THREADS) {  // channel c over the rows, in order
      float s1 = 0.f, s2 = 0.f;
      for (int t = 0; t < g.rr; ++t) {
        s1 += red[t * g.W + c];
        s2 += red[(g.rr + t) * g.W + c];
      }
      red[c] = s1;  // only this thread reads column c
      red[g.rr * g.W + c] = s2;
    }
    __syncthreads();
    for (int q = tid; q < g.gs; q += FUSED_THREADS) {  // group q over its channels, in order
      float s1 = 0.f, s2 = 0.f;
      for (int c = q * g.cpg; c < (q + 1) * g.cpg; ++c) {
        s1 += red[c];
        s2 += red[g.rr * g.W + c];
      }
      part[2 * q] = s1;
      part[2 * q + 1] = s2;
    }
  } else {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int i = tid * V; i < cnt; i += FUSED_THREADS * V) {
      const R raw = *reinterpret_cast<const R*>(xs + i);
      *reinterpret_cast<R*>(slice + i) = raw;
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(e[j]);
        s1 += f;
        s2 += f * f;
      }
    }
    block_sum2(s1, s2, red);
    if (tid == 0) {
      part[0] = s1;
      part[1] = s2;
    }
  }
  unit_sync(g.cl);  // every block's partials are in its shared memory

  // every rank's partials, one remote load a thread, all in flight at once
  for (int i = tid; i < 2 * g.gs * g.cl; i += FUSED_THREADS)
    gath[i] = cluster.map_shared_rank(part, i / (2 * g.gs))[i % (2 * g.gs)];
  unit_sync(g.cl);  // gathered: no block reads another's shared memory after this
  for (int q = tid; q < g.gs; q += FUSED_THREADS) {  // group q over the ranks, in order
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < g.cl; ++k) {
      s1 += gath[2 * (k * g.gs + q)];
      s2 += gath[2 * (k * g.gs + q) + 1];
    }
    mean_inv(s1, s2, (float)(g.cpg * g.S), g.eps, stat[2 * q], stat[2 * q + 1]);
  }
  __syncthreads();
  for (int c = tid; c < g.W; c += FUSED_THREADS) {
    const int q = c / g.cpg, gc = set * g.W + c;
    fold<T>(stat[2 * q], stat[2 * q + 1], param(scale, gc, g.param_bf16),
            param(bias, gc, g.param_bf16), a_s[c], b_s[c]);
  }
  __syncthreads();  // a and b are ready

  if (g.nhwc) {
    if (ty < g.rr) {
      constexpr bool PAIRS = std::is_same<T, bf16>::value && V % 2 == 0;
      for (int cv = tx; cv < nv; cv += g.nvt) {
        float av[V], bv[V];
        __nv_bfloat162 a2[V / 2 > 0 ? V / 2 : 1];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          av[j] = a_s[cv * V + j];
          bv[j] = b_s[cv * V + j];
        }
        if constexpr (PAIRS) {
#pragma unroll
          for (int j = 0; j < V / 2; ++j) a2[j] = __floats2bfloat162_rn(av[2 * j], av[2 * j + 1]);
        }
#pragma unroll 4
        for (int r = ty; r < cnt; r += g.rr) {
          const R raw = *reinterpret_cast<const R*>(slice + r * g.W + cv * V);
          const T* e = reinterpret_cast<const T*>(&raw);
          R out;
          T* o = reinterpret_cast<T*>(&out);
          if constexpr (PAIRS) {
            affine_act_bf16x2<V>(e, a2, bv, g.act, o);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j)
              o[j] = from_f<T>(affine_act<T>(to_f(e[j]), av[j], bv[j], g.act));
          }
          *reinterpret_cast<R*>(ys + r * g.C + cv * V) = out;
        }
      }
    }
  } else {
    for (int i = tid * V; i < cnt; i += FUSED_THREADS * V) {
      const R raw = *reinterpret_cast<const R*>(slice + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      R out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = (r0 + i + j) / g.S;
        o[j] = from_f<T>(affine_act<T>(to_f(e[j]), a_s[c], b_s[c], g.act));
      }
      *reinterpret_cast<R*>(ys + i) = out;
    }
  }
}

// An empty kernel of gn_fused's grid, cluster and block: the launch's own
// latency, the floor under a small norm.
__global__ void __launch_bounds__(FUSED_THREADS) gn_empty_kernel(int) {}

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

// Launch `kern` over `grid` in clusters of `cl` blocks along x.
template <typename K, typename... Args>
cudaError_t launch_cluster(K kern, dim3 grid, int cl, size_t smem, cudaStream_t stream,
                           Args... args) {
  cudaError_t err = set_smem(kern, smem);
  if (err == cudaSuccess && cl > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(FUSED_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Tensor map of an NHWC [B, S, C] tensor, read in boxes of W channels by
// `rows` pixel rows of one batch row; rows past S read as zero. Needs a
// 16-byte aligned base, C * itemsize and W * itemsize multiples of 16.
inline int nhwc_map(CUtensorMap* map, const void* base, bool is_bf16, int B, int C, int S,
                    int W, int rows) {
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const int isz = is_bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * isz, (cuuint64_t)S * C * isz};
  const cuuint32_t box[3] = {(cuuint32_t)W, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  3, const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int V>
int launch_fused(const void* x, const void* scale, const void* bias, int param_bf16,
                 void* y, int B, int C, int S, int G, float eps, int nhwc, int act, int gs,
                 int cl, int tma, cudaStream_t stream) {
  FusedGeom g;
  int rc = fused_geom(g, C, S, G, gs, cl, sizeof(T), V, tma, nhwc);
  if (rc) return rc;
  g.param_bf16 = param_bf16, g.act = act, g.eps = eps;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma) {
    if (reinterpret_cast<uintptr_t>(x) % 16) return (int)cudaErrorInvalidValue;
    rc = nhwc_map(&map, x, sizeof(T) == 2, B, C, S, g.W, g.chunk);
    if (rc) return rc;
  }
  const dim3 grid(cl * (G / gs), B);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  return (int)(tma ? launch_cluster(gn_fused_kernel<T, V, true>, grid, cl, g.smem, stream, map,
                                    xt, scale, bias, yt, g)
                   : launch_cluster(gn_fused_kernel<T, V, false>, grid, cl, g.smem, stream,
                                    map, xt, scale, bias, yt, g));
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
            int B, int C, int S, int G, float eps, int nhwc, int act, int gs, int cl,
            int vec, int tma, cudaStream_t s) {
  GN_DISPATCH(T, vec, (launch_fused<T, V>(x, scale, bias, param_bf16, y, B, C, S, G, eps,
                                          nhwc, act, gs, cl, tma, s)))
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
// or fp32; scale, bias: [C] in bf16 (param_bf16 = 1) or fp32. The plan:
// group_set adjacent groups a unit (NCHW: 1), cluster blocks a unit (1 to
// 16), vec elements a load, tma = 1 to load NHWC slices by TMA. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int gn_fused(const void* x, const void* scale, const void* bias, void* y,
                        int is_bf16, int param_bf16, int B, int C, int S, int G,
                        float eps, int nhwc, int act, int group_set, int cluster, int vec,
                        int tma, void* stream) {
  using namespace gn;
  if (!shape_ok(B, C, S, G) || (long long)B * C * S >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? fused_t<bf16>(x, scale, bias, param_bf16, y, B, C, S, G, eps, nhwc, act,
                                 group_set, cluster, vec, tma, s)
                 : fused_t<float>(x, scale, bias, param_bf16, y, B, C, S, G, eps, nhwc,
                                  act, group_set, cluster, vec, tma, s);
}

// gn_fused's shared bytes for a plan (< 0: a plan the kernel cannot take).
extern "C" int gn_fused_smem(int is_bf16, int C, int S, int G, int nhwc, int group_set,
                             int cluster, int vec, int tma) {
  gn::FusedGeom g;
  const int rc = gn::fused_geom(g, C, S, G, group_set, cluster, is_bf16 ? 2 : 4, vec, tma, nhwc);
  return rc ? -rc : g.smem;
}

// An empty kernel over gn_fused's grid for a plan ((cluster * G / group_set,
// B) blocks in clusters of `cluster`, `smem` dynamic shared bytes each):
// the latency floor of a launch.
extern "C" int gn_empty(int B, int G, int group_set, int cluster, int smem, void* stream) {
  using namespace gn;
  if (group_set <= 0 || G % group_set || cluster <= 0 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  return (int)launch_cluster(gn_empty_kernel, dim3(cluster * (G / group_set), B), cluster,
                             (size_t)smem, (cudaStream_t)stream, 0);
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
