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
//   * gn_stats and gn_apply: the pair for spans no cluster's shared memory
//     holds (the VAE decoder's slabs of up to 268 MB, the UNet's
//     960-channel norm at 64^2). Both take one launch plan
//     (ops/groupnorm.py `pair_plan`): in NHWC a block takes a band of pixel
//     rows of one batch row with every channel, 4 blocks an SM in one
//     wave; each thread keeps fixed channel columns (tx) and walks the
//     band's rows ty, ty + rr, ..., with a few 16-byte loads in flight. In
//     NCHW a block takes a band of one channel plane.
//     gn_stats keeps each thread's column sums in registers, adds them over
//     the block's rows of threads and then over each group's channels in
//     shared memory in a fixed order (no atomics), and writes the block's
//     per-group partials; the last block of a batch row (an atomic counter,
//     which it sets back to zero) reads the row's partials as float4
//     columns with all its threads at once, adds them in a fixed order,
//     and writes (a, b) as fp32 [B, 2, C], as the reference's pass 1 does.
//     Two launches give the same bytes. gn_apply loads and rounds a and b
//     once per column (bf16: pairs, `affine_act_bf16x2`), so no division
//     runs per vector, and walks each band's rows last to first: the rows
//     gn_stats read last are the likeliest still in L2. It is launched as
//     a programmatic dependent of gn_stats, so its launch overlaps
//     gn_stats' last block.
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
constexpr int PAIR_THREADS = 256;  // gn_stats and gn_apply: most threads a block
constexpr int STATS_UNROLL = 4;    // NHWC: 16-byte loads in flight a thread
constexpr int APPLY_UNROLL = 2;
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

// ------------------------------------------------------ gn_stats, gn_apply

// Programmatic dependent launch (sm_90): gn_stats lets gn_apply's grid
// launch once each of its blocks has written its partials, and gn_apply
// waits for gn_stats' whole grid (and its memory) before it reads (a, b),
// so gn_apply's launch overlaps gn_stats' last block. Without a
// programmatic predecessor the wait returns at once.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// NHWC: a block of nvt x rr threads; thread (tx, ty) keeps vector columns
// tx, tx + nvt, ... and walks its band's rows ty, ty + rr, ...
struct PairThread {
  int nv, nvt, rr, tx, ty;
  __device__ __forceinline__ PairThread(int C, int V) {
    nv = C / V;
    nvt = min(nv, (int)blockDim.x);
    rr = blockDim.x / nvt;
    tx = threadIdx.x % nvt;
    ty = threadIdx.x / nvt;
  }
  // the rows of [r0, r1) this thread walks
  __device__ __forceinline__ int count(int r0, int r1) const {
    const int n = r1 - r0 - ty;
    return n > 0 ? (n + rr - 1) / rr : 0;
  }
};

// The last block of batch row b to finish (an atomic counter) adds the
// partial sums in a fixed order and writes (a, b) as fp32 ab[b, 0, :] and
// ab[b, 1, :]. Group g's k-th partial pair (k < K) is at
// part_row[g * gstride + k * kstride + {0, 1}]. The 2G columns (a group's
// s1 or s2) are read W at a time (W = 4, one 16-byte load, where the
// columns of a partial are contiguous: gstride 2); thread t adds column
// set t % (2G / W) over k = phase, phase + ph, ... (phase = t / (2G / W),
// ph phases where the sets are fewer than the threads), 8 loads in flight,
// so that all of the row's partials are read in a few round trips; the
// phases are then added in order. fsm: max(threads * W, 2G) floats.
template <int W>
__device__ void finish_cols(const float* __restrict__ part_row, int K, int gstride, int kstride,
                            int cols, float* fsm) {
  typedef typename std::conditional<W == 4, float4, float>::type F;
  const int T = blockDim.x, tid = threadIdx.x;
  const int sets = cols / W;
  const int ph = sets < T ? T / sets : 1;
  const int phase = tid / sets;
  if (phase < ph) {
    for (int q = tid % sets; q < sets; q += (ph > 1 ? sets : T)) {
      const int col = q * W;
      const F* p = reinterpret_cast<const F*>(part_row + (size_t)(col >> 1) * gstride + (col & 1));
      const size_t kst = (size_t)kstride / W;  // W = 4: kstride % 4 == 0
      float s[W];
#pragma unroll
      for (int j = 0; j < W; ++j) s[j] = 0.f;
      int k = phase;
      for (; k + 7 * ph < K; k += 8 * ph) {
        F v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __ldcg(p + (k + u * ph) * kst);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float* e = reinterpret_cast<const float*>(&v[u]);
#pragma unroll
          for (int j = 0; j < W; ++j) s[j] += e[j];
        }
      }
      for (; k < K; k += ph) {
        const F v = __ldcg(p + k * kst);
        const float* e = reinterpret_cast<const float*>(&v);
#pragma unroll
        for (int j = 0; j < W; ++j) s[j] += e[j];
      }
#pragma unroll
      for (int j = 0; j < W; ++j) fsm[phase * cols + col + j] = s[j];
    }
  }
  __syncthreads();
  if (ph > 1) {
    for (int col = tid; col < cols; col += T) {  // the phases of column col, in order
      float s = fsm[col];
      for (int q = 1; q < ph; ++q) s += fsm[q * cols + col];
      fsm[col] = s;
    }
    __syncthreads();
  }
}

__device__ void finish_row(const float* __restrict__ part_row, int* __restrict__ counter,
                           float* __restrict__ ab, const void* scale, const void* bias,
                           int param_bf16, int b, int blocks_per_row, int K, int gstride,
                           int kstride, int C, int S, int G, float eps, float* fsm) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter + b, 1) == blocks_per_row - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int T = blockDim.x, tid = threadIdx.x;
  const int cols = 2 * G;
  if (gstride == 2 && cols % 4 == 0 && kstride % 4 == 0 &&
      reinterpret_cast<uintptr_t>(part_row) % 16 == 0)
    finish_cols<4>(part_row, K, gstride, kstride, cols, fsm);
  else
    finish_cols<1>(part_row, K, gstride, kstride, cols, fsm);
  const float n = (float)(C / G) * (float)S;
  for (int g = tid; g < G; g += T) {
    float mean, inv;
    mean_inv(fsm[2 * g], fsm[2 * g + 1], n, eps, mean, inv);
    fsm[2 * g] = mean;
    fsm[2 * g + 1] = inv;
  }
  __syncthreads();
  const int cpg = C / G;
  for (int c = tid; c < C; c += T) {
    const int g = c / cpg;
    const float mean = fsm[2 * g], inv = fsm[2 * g + 1];
    const float sc = param(scale, c, param_bf16), bi = param(bias, c, param_bf16);
    // fp32, as the reference's pass 1 emits them; gn_apply rounds to T
    ab[(size_t)(2 * b) * C + c] = __fmul_rn(inv, sc);
    ab[(size_t)(2 * b + 1) * C + c] = __fsub_rn(bi, __fmul_rn(__fmul_rn(mean, inv), sc));
  }
  if (tid == 0) counter[b] = 0;
}

template <typename T, int V>
__device__ __forceinline__ void add_sq(const T* e, float* a1, float* a2) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float f = to_f(e[j]);
    a1[j] += f;
    a2[j] += f * f;
  }
}

// NHWC: block (band, b) sums pixel rows [band * rows, +rows) of batch row b
// with every channel into part[b, band, G, 2]. fsm: the column sums
// [2][rr][C] (the s1 rows, then the s2 rows), later the finish's.
template <typename T, int V>
__global__ void __launch_bounds__(PAIR_THREADS, 4)
gn_stats_nhwc_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                     const void* __restrict__ bias, int param_bf16, float* __restrict__ part,
                     int* __restrict__ counter, float* __restrict__ ab, int C, int S, int G,
                     float eps, int rows) {
  typedef typename Raw<sizeof(T) * V>::t R;
  extern __shared__ __align__(16) float fsm[];
  const int band = blockIdx.x, b = blockIdx.y, bands = gridDim.x;
  const PairThread t(C, V);
  const int r0 = band * rows, r1 = min(S, r0 + rows);
  const int n = t.count(r0, r1);
  const int step = t.rr * C;
  for (int cv = t.tx; cv < t.nv; cv += t.nvt) {
    float a1[V], a2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
    // the tensor has fewer than 2^31 elements
    const T* p = x + (b * S + r0 + t.ty) * C + cv * V;
    int k = 0;
    for (; k + STATS_UNROLL <= n; k += STATS_UNROLL) {
      R raw[STATS_UNROLL];
#pragma unroll
      for (int u = 0; u < STATS_UNROLL; ++u) raw[u] = *reinterpret_cast<const R*>(p + u * step);
#pragma unroll
      for (int u = 0; u < STATS_UNROLL; ++u)
        add_sq<T, V>(reinterpret_cast<const T*>(&raw[u]), a1, a2);
      p += STATS_UNROLL * step;
    }
    for (; k < n; ++k, p += step) {
      const R raw = *reinterpret_cast<const R*>(p);
      add_sq<T, V>(reinterpret_cast<const T*>(&raw), a1, a2);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      fsm[t.ty * C + cv * V + j] = a1[j];
      fsm[(t.rr + t.ty) * C + cv * V + j] = a2[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {  // channel c over the rows of threads
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < t.rr; ++r) {
      s1 += fsm[r * C + c];
      s2 += fsm[(t.rr + r) * C + c];
    }
    fsm[c] = s1;  // only this thread reads column c
    fsm[t.rr * C + c] = s2;
  }
  __syncthreads();
  const int cpg = C / G;
  float* prow = part + (size_t)(b * bands + band) * 2 * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {  // group g over its channels, in order
    float s1 = 0.f, s2 = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      s1 += fsm[c];
      s2 += fsm[t.rr * C + c];
    }
    prow[2 * g] = s1;
    prow[2 * g + 1] = s2;
  }
  launch_dependents();
  finish_row(part + (size_t)b * bands * 2 * G, counter, ab, scale, bias, param_bf16, b, bands,
             bands, 2, 2 * G, C, S, G, eps, fsm);
}

// NCHW: block (plane = b * C + c, band) sums elements [band * rows, +rows)
// of channel plane c of batch row b into part[b, c, band, 2], so that each
// group's partials are one run of cpg * bands pairs.
template <typename T, int V>
__global__ void __launch_bounds__(PAIR_THREADS)
gn_stats_nchw_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                     const void* __restrict__ bias, int param_bf16, float* __restrict__ part,
                     int* __restrict__ counter, float* __restrict__ ab, int C, int S, int G,
                     float eps, int rows) {
  typedef typename Raw<sizeof(T) * V>::t R;
  extern __shared__ __align__(16) float fsm[];  // block_sum2's, later the finish's
  const int plane = blockIdx.x, band = blockIdx.y, bands = gridDim.y;
  const int b = plane / C;
  const int lo = band * rows;
  const int n = min(rows, S - lo);
  const T* base = x + plane * S + lo;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x * V; i < n; i += blockDim.x * V) {
    const R raw = *reinterpret_cast<const R*>(base + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f(e[j]);
      s1 += f;
      s2 += f * f;
    }
  }
  block_sum2(s1, s2, fsm);
  if (threadIdx.x == 0) {
    float* p = part + (size_t)(plane * bands + band) * 2;
    p[0] = s1;
    p[1] = s2;
  }
  launch_dependents();
  const int cpg = C / G;
  finish_row(part + (size_t)b * C * bands * 2, counter, ab, scale, bias, param_bf16, b,
             C * bands, cpg * bands, 2 * cpg * bands, 2, C, S, G, eps, fsm);
}

// act(x * a + b) of the V elements at e into o, a and b already rounded to
// T (a2: a's pairs, for bf16)
template <typename T, int V>
__device__ __forceinline__ void apply_vec(const T* e, const float* av, const float* bv,
                                          const __nv_bfloat162* a2, int act, T* o) {
  if constexpr (std::is_same<T, bf16>::value && V % 2 == 0) {
    affine_act_bf16x2<V>(e, a2, bv, act, o);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = from_f<T>(affine_act<T>(to_f(e[j]), av[j], bv[j], act));
  }
}

// NHWC: block (band, b) writes act(x a + b) over pixel rows [band * rows,
// +rows) of batch row b; each thread walks its rows last to first, so that
// the rows gn_stats read last, the likeliest still in L2, come first.
template <typename T, int V>
__global__ void __launch_bounds__(PAIR_THREADS, 4)
gn_apply_nhwc_kernel(const T* __restrict__ x, const float* __restrict__ ab, T* __restrict__ y,
                     int C, int S, int act, int rows) {
  typedef typename Raw<sizeof(T) * V>::t R;
  const int band = blockIdx.x, b = blockIdx.y;
  const PairThread t(C, V);
  const int r0 = band * rows, r1 = min(S, r0 + rows);
  const int n = t.count(r0, r1);
  const int step = -t.rr * C;
  const float* a_row = ab + (size_t)(2 * b) * C;
  const float* b_row = a_row + C;
  wait_prerequisites();  // gn_stats has written ab
  for (int cv = t.tx; cv < t.nv; cv += t.nvt) {
    float av[V], bv[V];
    __nv_bfloat162 a2[V / 2 > 0 ? V / 2 : 1];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      av[j] = rnd<T>(__ldg(a_row + cv * V + j));
      bv[j] = rnd<T>(__ldg(b_row + cv * V + j));
    }
#pragma unroll
    for (int j = 0; j < V / 2; ++j) a2[j] = __floats2bfloat162_rn(av[2 * j], av[2 * j + 1]);
    // the tensor has fewer than 2^31 elements
    int off = (b * S + r0 + t.ty + (n > 0 ? (n - 1) * t.rr : 0)) * C + cv * V;
    int k = 0;
    for (; k + APPLY_UNROLL <= n; k += APPLY_UNROLL) {
      R raw[APPLY_UNROLL];
#pragma unroll
      for (int u = 0; u < APPLY_UNROLL; ++u)
        raw[u] = *reinterpret_cast<const R*>(x + off + u * step);
#pragma unroll
      for (int u = 0; u < APPLY_UNROLL; ++u) {
        R out;
        apply_vec<T, V>(reinterpret_cast<const T*>(&raw[u]), av, bv, a2, act,
                        reinterpret_cast<T*>(&out));
        *reinterpret_cast<R*>(y + off + u * step) = out;
      }
      off += APPLY_UNROLL * step;
    }
    for (; k < n; ++k, off += step) {
      const R raw = *reinterpret_cast<const R*>(x + off);
      R out;
      apply_vec<T, V>(reinterpret_cast<const T*>(&raw), av, bv, a2, act,
                      reinterpret_cast<T*>(&out));
      *reinterpret_cast<R*>(y + off) = out;
    }
  }
}

// NCHW: block (plane = b * C + c, band) writes act(x a + b) over elements
// [band * rows, +rows) of the plane, with a and b of channel c.
template <typename T, int V>
__global__ void __launch_bounds__(PAIR_THREADS)
gn_apply_nchw_kernel(const T* __restrict__ x, const float* __restrict__ ab, T* __restrict__ y,
                     int C, int S, int act, int rows) {
  typedef typename Raw<sizeof(T) * V>::t R;
  const int plane = blockIdx.x, band = blockIdx.y;
  const int b = plane / C, c = plane - b * C;
  float av[V], bv[V];
  __nv_bfloat162 a2[V / 2 > 0 ? V / 2 : 1];
  wait_prerequisites();  // gn_stats has written ab
  const float a = rnd<T>(__ldg(ab + (size_t)(2 * b) * C + c));
  const float bb = rnd<T>(__ldg(ab + (size_t)(2 * b + 1) * C + c));
#pragma unroll
  for (int j = 0; j < V; ++j) av[j] = a, bv[j] = bb;
#pragma unroll
  for (int j = 0; j < V / 2; ++j) a2[j] = __floats2bfloat162_rn(a, a);
  const int lo = band * rows;
  const int n = min(rows, S - lo);
  const int base = plane * S + lo;
#pragma unroll 4
  for (int i = threadIdx.x * V; i < n; i += blockDim.x * V) {
    const R raw = *reinterpret_cast<const R*>(x + base + i);
    R out;
    apply_vec<T, V>(reinterpret_cast<const T*>(&raw), av, bv, a2, act,
                    reinterpret_cast<T*>(&out));
    *reinterpret_cast<R*>(y + base + i) = out;
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

// The pair's plan, checked (ops/groupnorm.py `pair_plan`, `pair_smem_bytes`):
// V elements a load, `threads` a block, `bands` blocks a batch row (NHWC) or
// a channel plane (NCHW) of `rows` pixel rows (elements) each. Returns
// gn_stats' dynamic shared bytes (its column sums, or block_sum2's, and the
// finish's max(4 threads, 2G) floats), or -1 for a plan the kernels cannot
// take.
inline long long pair_smem(int C, int S, int G, int nhwc, int V, int threads, int bands,
                           int rows) {
  if (V <= 0 || threads <= 0 || threads > PAIR_THREADS || bands <= 0 || rows <= 0 ||
      (long long)(bands - 1) * rows >= S || (long long)bands * rows < S)
    return -1;
  const long long fin = 4LL * threads > 2 * G ? 4LL * threads : 2 * G;
  if (nhwc) {
    if (C % V) return -1;
    const int nvt = C / V < threads ? C / V : threads;
    if (threads % nvt) return -1;
    const long long red = 2LL * (threads / nvt) * C;
    return 4 * (red > fin ? red : fin);
  }
  if (S % V || rows % V || bands > 65535 || threads % 32) return -1;
  return 4 * (fin > RED_FLOATS ? fin : (long long)RED_FLOATS);
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int V>
int launch_stats(const void* x, const void* scale, const void* bias, int param_bf16,
                 void* part, void* counter, void* ab, int B, int C, int S, int G,
                 float eps, int nhwc, int threads, int bands, int rows, cudaStream_t stream) {
  const long long smem = pair_smem(C, S, G, nhwc, V, threads, bands, rows);
  if (smem < 0 || smem > (1 << 28) || !aligned(x, sizeof(T) * V))
    return (int)cudaErrorInvalidValue;
  decltype(&gn_stats_nhwc_kernel<T, V>) kern =
      nhwc ? &gn_stats_nhwc_kernel<T, V> : &gn_stats_nchw_kernel<T, V>;
  if (smem > 48 * 1024) {
    cudaError_t err = set_smem(kern, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid = nhwc ? dim3(bands, B) : dim3(B * C, bands);
  kern<<<grid, threads, (size_t)smem, stream>>>((const T*)x, scale, bias, param_bf16,
                                                (float*)part, (int*)counter, (float*)ab, C,
                                                S, G, eps, rows);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_apply(const void* x, const void* ab, void* y, int B, int C, int S, int nhwc,
                 int act, int threads, int bands, int rows, cudaStream_t stream) {
  if (pair_smem(C, S, 1, nhwc, V, threads, bands, rows) < 0 || !aligned(x, sizeof(T) * V) ||
      !aligned(y, sizeof(T) * V))
    return (int)cudaErrorInvalidValue;
  // a programmatic dependent of the kernel before it (gn_stats)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = nhwc ? dim3(bands, B) : dim3(B * C, bands);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const T* xt = static_cast<const T*>(x);
  const float* abt = static_cast<const float*>(ab);
  T* yt = static_cast<T*>(y);
  const cudaError_t err =
      nhwc ? cudaLaunchKernelEx(&cfg, gn_apply_nhwc_kernel<T, V>, xt, abt, yt, C, S, act, rows)
           : cudaLaunchKernelEx(&cfg, gn_apply_nchw_kernel<T, V>, xt, abt, yt, C, S, act, rows);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
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
            int nhwc, int vec, int threads, int bands, int rows, cudaStream_t s) {
  GN_DISPATCH(T, vec, (launch_stats<T, V>(x, scale, bias, param_bf16, part, counter, ab, B,
                                          C, S, G, eps, nhwc, threads, bands, rows, s)))
}

template <typename T>
int apply_t(const void* x, const void* ab, void* y, int B, int C, int S, int nhwc, int act,
            int vec, int threads, int bands, int rows, cudaStream_t s) {
  GN_DISPATCH(T, vec, (launch_apply<T, V>(x, ab, y, B, C, S, nhwc, act, threads, bands, rows,
                                          s)))
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

// The pair's plan (see pair_smem): vec elements a load, threads a block,
// bands blocks a batch row (NHWC) or a channel plane (NCHW) of rows pixel
// rows (elements) each. part: fp32 scratch of B * bands * G * 2 (NHWC) or
// B * C * bands * 2 (NCHW) floats; counter: int32 [B], zero (the last block
// of a row sets it back to zero); ab: fp32 [B, 2, C] out.
extern "C" int gn_stats(const void* x, const void* scale, const void* bias, void* part,
                        void* counter, void* ab, int is_bf16, int param_bf16, int B, int C,
                        int S, int G, float eps, int nhwc, int vec, int threads, int bands,
                        int rows, void* stream) {
  using namespace gn;
  if (!shape_ok(B, C, S, G) || (long long)B * C * S >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? stats_t<bf16>(x, scale, bias, param_bf16, part, counter, ab, B, C, S, G,
                                 eps, nhwc, vec, threads, bands, rows, s)
                 : stats_t<float>(x, scale, bias, param_bf16, part, counter, ab, B, C, S,
                                  G, eps, nhwc, vec, threads, bands, rows, s);
}

// gn_stats' dynamic shared bytes for a plan (< 0: a plan it cannot take).
extern "C" int gn_stats_smem(int C, int S, int G, int nhwc, int vec, int threads, int bands,
                             int rows) {
  const long long b = gn::pair_smem(C, S, G, nhwc, vec, threads, bands, rows);
  return b < 0 || b > (1 << 28) ? -(int)cudaErrorInvalidValue : (int)b;
}

// ab: fp32 [B, 2, C] from gn_stats; the plan as gn_stats'.
extern "C" int gn_apply(const void* x, const void* ab, void* y, int is_bf16, int B, int C,
                        int S, int nhwc, int act, int vec, int threads, int bands, int rows,
                        void* stream) {
  using namespace gn;
  if (!shape_ok(B, C, S, 1) || (long long)B * C * S >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? apply_t<bf16>(x, ab, y, B, C, S, nhwc, act, vec, threads, bands, rows, s)
                 : apply_t<float>(x, ab, y, B, C, S, nhwc, act, vec, threads, bands, rows, s);
}

// The shared memory one block may use, after opting in (232448 bytes on the
// H100); the wrapper sizes gn_fused's spans against it. < 0: CUDA error.
extern "C" int gn_smem_optin(int device) {
  int v = 0;
  cudaError_t err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? v : -(int)err;
}
