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
// p and ds are rounded to bf16 before the products that take them, as the
// reference rounds them.
//
// flash_bwd_fused (narrow, D <= 128). What bounds it on this card: its five
// products (0.217 ms at the bf16 tensor-core peak at [32, 4096, 40]) over
// one exp per score (0.138 ms); and, since dq is summed across kv tiles
// that run in parallel, the traffic of dq's partial sums. Design (kv-major,
// as the TPU kernel: one block per kv tile, dk and dv in registers):
//   * warp specialisation: a producer warp loads the block's 128-row k and
//     v tiles once, then 64-row q and do tiles (with their lse and delta)
//     by TMA into a ring of 2-3 stages with full/empty mbarriers; the
//     staged route of flash_fwd.cu serves slabs TMA cannot describe;
//   * two consumer warpgroups, each owning 64 kv rows, run the five
//     products on wgmma: s^T = k q^T and dp^T = v do^T, then p^T and ds^T
//     on the accumulators as bf16, dv += p^T do, dk += ds^T q and dq_c =
//     ds_c k_c with ds^T in shared memory (read transposed for dq). At
//     D <= 48 p^T and ds^T are the register A operands of dv and dk; wider,
//     they too come from shared memory, so that a thread's 168 registers
//     hold dk, dv, dq and the score tiles. The exponentials run
//     while dp^T is in flight. Past D = 80 two blocks split the head
//     columns of dk, dv and dq, each recomputing s^T and dp^T;
//   * dq: the TPU carried dq from one grid step to the next; blocks on the
//     card run in parallel in no order, so each block adds its partial dq
//     into a zeroed fp32 [BH, T, D] buffer, which the caller casts once.
//     Each consumer stages its partial sum in shared memory (two buffers,
//     handed over through mbarriers, so that one drains while the next
//     fills), and a dq warp sends the q tile's rows (one contiguous fp32
//     range, D being the full row) out as one bulk reduce-add
//     (cp.reduce.async.bulk .add.f32): one reduction per (64-row kv half,
//     64-row q tile), where the mma.sync kernel made one atomicAdd per
//     element. The consumers never wait for each other (summing their two
//     shares in shared memory first halves the reduce traffic but did not
//     pay on the H100). The staged route adds with atomicAdd. The order of
//     the fp32 additions varies from run to run, so dq is not bitwise
//     reproducible (its tolerance says so);
//   * no masks: q rows past tq carry lse = +inf and delta = 0 (p = ds = 0),
//     and k/v rows past tk are zero (their p never reaches dq; their dk and
//     dv rows are not written).
//
// flash_bwd_dq / flash_bwd_dkv (wide, D up to 512), on mma.sync: a 32 x 512
// fp32 accumulator is 64 KB, so a block of eight warps splits it into two
// 16-row groups by four column quarters (64 registers a thread; dkv holds
// two). flash_bwd_dq takes a 32-row q tile and loops over 64-row kv tiles;
// flash_bwd_dkv takes a 32-row kv tile and loops over 64-row q tiles. Warp
// (group, quarter) forms the 16 x 16 block of s and dp (of s^T and dp^T in
// dkv) over the full head width; p and ds go through shared memory as
// bf16; each warp then adds its rows and columns of ds k (of p^T do and
// ds^T q). The bf16 tiles (32 + 32 + 64 + 64 rows of 520) take 200 KB of
// the 227 KB of dynamic shared memory.
#include "flash_common.cuh"

namespace flash {

// ----------------------------------------- fused pass (narrow), Hopper

template <int DP>
struct NarrowBwdCfg {
  static constexpr int BK = 128, BQ = 64;  // two consumer warpgroups of 64 kv rows
  static constexpr int CH = DP / 16;       // 16-column chunks of a tile
  // head columns of dk, dv and dq a block owns: past 80, two blocks split
  // them (each recomputing s^T and dp^T), so that dk, dv and dq fit the
  // registers of a thread
  static constexpr int NH = DP > 80 ? 2 : 1;
  static constexpr int DH = DP / NH;
  // q columns of s^T and dp^T taken at once: past D = 64, two halves (the
  // registers they free keep ptxas from serialising the wgmmas at D = 80)
  static constexpr int QH = DP > 64 ? 2 : 1;
  static constexpr int QW = BQ / QH;
  static constexpr int STAGES = DP <= 96 ? 3 : 2;
  static constexpr int KV_CHUNK = BK * 32, Q_CHUNK = BQ * 32;
  static constexpr int KV_BYTES = CH * KV_CHUNK, Q_BYTES = CH * Q_CHUNK;
  static constexpr int DS_BYTES = (BQ / 16) * 64 * 32;  // one consumer's p^T or ds^T tile
  static constexpr int DQ_BYTES = BQ * DH * 4;  // one fp32 dq partial sum
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * Q_BYTES;
  static constexpr int OFF_DS = OFF_DO + STAGES * Q_BYTES;
  static constexpr int OFF_DQ = OFF_DS + 4 * DS_BYTES;      // [consumer][2] dq sums
  static constexpr int OFF_VEC = OFF_DQ + 4 * DQ_BYTES;     // lse * log2(e), delta
  static constexpr int OFF_BAR = OFF_VEC + STAGES * 2 * BQ * 4;
  static constexpr size_t SMEM = OFF_BAR + 8 * (1 + 2 * STAGES + 8) + 1024;  // + alignment
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
  // two consumer warpgroups, the producer warp (8) and the dq warp (9)
  static constexpr int THREADS = 320;
};

// Named barriers 1 and 2: consumer 0's / 1's p^T and ds^T are in shared
// memory.
constexpr int DS_BAR = 1;

template <int DP, bool TMA>
__global__ void __launch_bounds__(NarrowBwdCfg<DP>::THREADS, 1)
flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap domap, const bf16* __restrict__ q,
                       const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int tq, int tk, int d,
                       float scale) {
  typedef NarrowBwdCfg<DP> C;
  constexpr int BQ = C::BQ, CH = C::CH, S = C::STAGES, DH = C::DH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* Ks = smem;
  uint8_t* Vs = smem + C::OFF_V;
  uint8_t* Qs = smem + C::OFF_Q;
  uint8_t* dOs = smem + C::OFF_DO;
  float* vec = reinterpret_cast<float*>(smem + C::OFF_VEC);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + S;
  uint64_t* dq_full = q_empty + S;  // [consumer][2]: a dq partial sum is in
  uint64_t* dq_empty = dq_full + 4;  // [consumer][2]: it has gone out

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * C::BK;
  const int h = blockIdx.z;  // this block's DH head columns of dk, dv, dq
  const int nq = (tq + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, TMA ? 1 : 32);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(q_full + s, 32);  // the producer warp
      hopper::mbar_init(q_empty + s, 8);  // lane 0 of each consumer warp
    }
    for (int b = 0; b < 4; ++b) {
      hopper::mbar_init(dq_full + b, 128);  // a consumer warpgroup
      hopper::mbar_init(dq_empty + b, 1);   // the dq warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (wg == 2 && tid < 32) {
    // ---- producer warp: the k and v tiles once, then q, do, lse and delta
    // tiles into the ring (lse * log2 e; +inf and 0 past tq, so that p and
    // ds vanish there without a mask)
    const float* lse_b = lse + (size_t)bh * tq;
    const float* delta_b = delta + (size_t)bh * tq;
    if (TMA) {
      if (tid == 0) {
        hopper::mbar_arrive_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll 1
        for (int c = 0; c < CH; ++c) {
          hopper::tma_load_3d(Ks + c * C::KV_CHUNK, &kmap, 16 * c, k0, bh, kv_full);
          hopper::tma_load_3d(Vs + c * C::KV_CHUNK, &vmap, 16 * c, k0, bh, kv_full);
        }
      }
    } else {
      hopper::stage_tile<C::BK, DP>(Ks, k + (size_t)bh * tk * d, k0, tk, d, tid, 32);
      hopper::stage_tile<C::BK, DP>(Vs, v + (size_t)bh * tk * d, k0, tk, d, tid, 32);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(kv_full);
    }
    for (int i = 0; i < nq; ++i) {
      const int s = i % S;
      hopper::mbar_wait(q_empty + s, ((i / S) & 1) ^ 1);
      float* lse2 = vec + s * 2 * BQ;
      for (int r = tid; r < BQ; r += 32) {
        const int row = i * BQ + r;
        lse2[r] = row < tq ? lse_b[row] * LOG2E : INFINITY;
        lse2[BQ + r] = row < tq ? delta_b[row] : 0.f;
      }
      if (TMA) {
        if (tid == 0) {
          hopper::mbar_arrive_tx(q_full + s, 2 * C::Q_BYTES);
#pragma unroll 1
          for (int c = 0; c < CH; ++c) {
            hopper::tma_load_3d(Qs + s * C::Q_BYTES + c * C::Q_CHUNK, &qmap, 16 * c, i * BQ, bh,
                                q_full + s);
            hopper::tma_load_3d(dOs + s * C::Q_BYTES + c * C::Q_CHUNK, &domap, 16 * c, i * BQ,
                                bh, q_full + s);
          }
        } else {
          hopper::mbar_arrive(q_full + s);
        }
      } else {
        hopper::stage_tile<BQ, DP>(Qs + s * C::Q_BYTES, q + (size_t)bh * tq * d, i * BQ, tq, d,
                                   tid, 32);
        hopper::stage_tile<BQ, DP>(dOs + s * C::Q_BYTES, dout + (size_t)bh * tq * d, i * BQ,
                                   tq, d, tid, 32);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(q_full + s);
      }
    }
    return;
  }
  if (wg == 2) {
    // ---- dq warp: each consumer's partial sum of a q tile goes out as bulk
    // reduce-adds into the fp32 dq (one for the tile's rows, which are one
    // contiguous range of [BH, Tq, D] when a block owns every head column;
    // one a row otherwise: a bulk operation has a large fixed cost, so the
    // contiguous one is much cheaper). A tile's buffers are freed once the
    // reduces of the next tile are issued and theirs have been read, so
    // the reads overlap the wait for the next tile.
    if (!TMA) return;
    const int lane = tid - 32;
    const int cols = min(DH, d - h * DH);  // a multiple of 8 on the TMA route
    for (int i = 0; i < nq; ++i) {
      const int b = i & 1;
      const int q0 = i * BQ;
      const int rows = min(BQ, tq - q0);
#pragma unroll 1
      for (int c = 0; c < 2; ++c) {
        hopper::mbar_wait(dq_full + 2 * c + b, (i >> 1) & 1);
        const float* sum = reinterpret_cast<const float*>(
            smem + C::OFF_DQ + (2 * c + b) * C::DQ_BYTES);
        if (C::NH == 1) {
          if (lane == 0)
            hopper::bulk_reduce_add_f32(dq + ((size_t)bh * tq + q0) * d, sum,
                                        (uint32_t)(rows * d * 4));
        } else {
          for (int r = lane; r < rows; r += 32)
            hopper::bulk_reduce_add_f32(dq + ((size_t)bh * tq + q0 + r) * d + h * DH,
                                        sum + r * DH, (uint32_t)(cols * 4));
        }
      }
      hopper::bulk_commit();
      hopper::bulk_wait_read<1>();
      __syncwarp();
      if (i > 0 && lane == 0) {
        hopper::mbar_arrive(dq_empty + (b ^ 1));
        hopper::mbar_arrive(dq_empty + 2 + (b ^ 1));
      }
    }
    hopper::bulk_wait_all();
    return;
  }

  // ---- consumers: warpgroup c owns kv rows k0 + 64c .. + 64
  const int c = wg;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const float sl2 = scale * LOG2E;
  const uint32_t k_addr = hopper::smem_addr(Ks) + c * 64 * 32;  // this consumer's kv rows
  const uint32_t v_addr = hopper::smem_addr(Vs) + c * 64 * 32;
  const uint32_t kh_addr = k_addr + h * (DH / 16) * C::KV_CHUNK;  // this block's k columns
  uint8_t* p_tile = smem + C::OFF_DS + 2 * c * C::DS_BYTES;  // [kv][q], chunks of 16 q
  uint8_t* ds_tile = p_tile + C::DS_BYTES;
  const uint32_t p_addr = hopper::smem_addr(p_tile);
  const uint32_t ds_addr = hopper::smem_addr(ds_tile);
  const int dq_ld = C::NH == 1 ? d : DH;  // row stride of a dq partial sum
  float dk_acc[DH / 2], dv_acc[DH / 2];
  // at D <= 48, p^T and ds^T stay in registers as the A operands of dv and
  // dk (faster); wider, the registers hold dk and dv instead
  constexpr bool AB_REGS = DP <= 48;
  uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  for (int i = 0; i < nq; ++i) {
    const int s = i % S;
    hopper::mbar_wait(q_full + s, (i / S) & 1);
    const uint32_t q_addr = hopper::smem_addr(Qs) + s * C::Q_BYTES;
    const uint32_t do_addr = hopper::smem_addr(dOs) + s * C::Q_BYTES;
    const uint32_t qh_addr = q_addr + h * (DH / 16) * C::Q_CHUNK;
    const uint32_t doh_addr = do_addr + h * (DH / 16) * C::Q_CHUNK;
    const float* lse2 = vec + s * 2 * BQ;

    // s^T = k q^T, then dp^T = v do^T, for this consumer's 64 kv rows x the
    // q tile's columns over the full head width (A = k or v, B = q or do,
    // both K-major), in QH column parts of QW
#pragma unroll
    for (int hq = 0; hq < C::QH; ++hq) {
      constexpr int QW = C::QW;
      float st[QW / 2], dpt[QW / 2];
#pragma unroll
      for (int j = 0; j < QW / 2; ++j) st[j] = dpt[j] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CH; ++kk)
        hopper::Wgmma<QW>::template ss<0, 0>(
            st, hopper::desc(k_addr + kk * C::KV_CHUNK, 16, 256),
            hopper::desc(q_addr + kk * C::Q_CHUNK + hq * QW * 32, 16, 256), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < CH; ++kk)
        hopper::Wgmma<QW>::template ss<0, 0>(
            dpt, hopper::desc(v_addr + kk * C::KV_CHUNK, 16, 256),
            hopper::desc(do_addr + kk * C::Q_CHUNK + hq * QW * 32, 16, 256), kk > 0);
      hopper::wgmma_commit();

      // p^T = exp(s^T scale - lse) while dp^T is in flight, then ds^T =
      // p^T (dp^T - delta) scale, as bf16: ds^T to shared memory as a
      // [kv][q] tile (chunk t holds q columns 16t .. 16t + 15), and p^T
      // beside it or in registers
      const float* lse_h = lse2 + hq * QW;
      hopper::wgmma_wait<1>();
      hopper::fence_regs(st);
#pragma unroll
      for (int n = 0; n < QW / 8; ++n) {
        const float2 ls = *reinterpret_cast<const float2*>(lse_h + n * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * n + e] = hopper::ex2(fmaf(st[4 * n + e], sl2, -((e & 1) ? ls.y : ls.x)));
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dpt);
#pragma unroll
      for (int n = 0; n < QW / 8; ++n) {
        const float2 dl = *reinterpret_cast<const float2*>(lse_h + BQ + n * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
#pragma unroll
      for (int t = 0; t < QW / 16; ++t)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int tc = hq * (QW / 16) + t;  // chunk of the q tile
          const uint32_t off = tc * 2048 + hopper::swizzle_off(warp * 16 + g + 8 * (x & 1),
                                                               ((x >> 1) * 8 + 2 * t4) * 2);
          pa[tc][x] = hopper::pack_bf16(st[8 * t + 2 * x], st[8 * t + 2 * x + 1]);
          sa[tc][x] = hopper::pack_bf16(dpt[8 * t + 2 * x], dpt[8 * t + 2 * x + 1]);
          if (!AB_REGS) *reinterpret_cast<uint32_t*>(p_tile + off) = pa[tc][x];
          *reinterpret_cast<uint32_t*>(ds_tile + off) = sa[tc][x];
        }
    }
    hopper::fence_proxy_async();
    hopper::named_sync(DS_BAR + c, 128);

    // dv += p^T do, dk += ds^T q (A = p^T or ds^T, B = do or q MN-major: K
    // = the q rows); dq_c = ds_c k_c (A = ds^T MN-major, B = k MN-major: K
    // = the kv rows), over this block's DH head columns
    float dq_acc[DH / 2];
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) dq_acc[j] = 0.f;
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    if (AB_REGS) {
      hopper::fence_regs(pa);
      hopper::fence_regs(sa);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
      const uint64_t b = hopper::desc(doh_addr + t * 512, C::Q_CHUNK, 256);
      if (AB_REGS)
        hopper::Wgmma<DH>::template rs<1>(dv_acc, pa[t], b, 1);
      else
        hopper::Wgmma<DH>::template ss<0, 1>(dv_acc, hopper::desc(p_addr + t * 2048, 16, 256), b,
                                             1);
    }
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
      const uint64_t b = hopper::desc(qh_addr + t * 512, C::Q_CHUNK, 256);
      if (AB_REGS)
        hopper::Wgmma<DH>::template rs<1>(dk_acc, sa[t], b, 1);
      else
        hopper::Wgmma<DH>::template ss<0, 1>(dk_acc, hopper::desc(ds_addr + t * 2048, 16, 256), b,
                                             1);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      hopper::Wgmma<DH>::template ss<1, 1>(dq_acc, hopper::desc(ds_addr + t * 512, 2048, 256),
                                           hopper::desc(kh_addr + t * 512, C::KV_CHUNK, 256),
                                           t > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(dq_acc);
    if (AB_REGS) {
      hopper::fence_regs(pa);
      hopper::fence_regs(sa);
    }
    if (lane == 0) hopper::mbar_arrive(q_empty + s);

    // dq += ds_c k_c
    const int q0 = i * BQ;
    if (TMA) {  // to the dq warp, through one of this consumer's two buffers
      const int b = i & 1;
      float* sum = reinterpret_cast<float*>(smem + C::OFF_DQ + (2 * c + b) * C::DQ_BYTES);
      hopper::mbar_wait(dq_empty + 2 * c + b, ((i >> 1) & 1) ^ 1);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        const int col = n * 8 + 2 * t4;
        if (h * DH + col >= d) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(sum + (warp * 16 + g + 8 * r) * dq_ld + col) =
              make_float2(dq_acc[4 * n + 2 * r], dq_acc[4 * n + 2 * r + 1]);
      }
      hopper::fence_proxy_async();
      hopper::mbar_arrive(dq_full + 2 * c + b);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        if (row >= tq) continue;
        float* dqrow = dq + ((size_t)bh * tq + row) * d + h * DH;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          const int col = n * 8 + 2 * t4;
          if (h * DH + col < d) atomicAdd(dqrow + col, dq_acc[4 * n + 2 * r]);
          if (h * DH + col + 1 < d) atomicAdd(dqrow + col + 1, dq_acc[4 * n + 2 * r + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + c * 64 + warp * 16 + g + 8 * r;
    if (row >= tk) continue;
    bf16* dkrow = dk + ((size_t)bh * tk + row) * d + h * DH;
    bf16* dvrow = dv + ((size_t)bh * tk + row) * d + h * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t4 + e;
        if (h * DH + col < d) {
          dkrow[col] = __float2bfloat16(dk_acc[4 * n + 2 * r + e]);
          dvrow[col] = __float2bfloat16(dv_acc[4 * n + 2 * r + e]);
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

template <int DP>
static int launch_fused(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, void* dk, void* dv,
                        int bh, int tq, int tk, int d, int tma, float scale,
                        cudaStream_t stream) {
  typedef NarrowBwdCfg<DP> C;
  CUtensorMap maps[4];
  memset(maps, 0, sizeof(maps));
  if (tma) {
    int rc = hopper::tile_map(&maps[0], q, bh, tq, d, C::BQ);
    if (rc == 0) rc = hopper::tile_map(&maps[1], k, bh, tk, d, C::BK);
    if (rc == 0) rc = hopper::tile_map(&maps[2], v, bh, tk, d, C::BK);
    if (rc == 0) rc = hopper::tile_map(&maps[3], dout, bh, tq, d, C::BQ);
    if (rc != 0) return rc;
  }
  auto kern = tma ? flash_bwd_fused_kernel<DP, true> : flash_bwd_fused_kernel<DP, false>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tk + C::BK - 1) / C::BK, bh, C::NH);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const bf16*)q, (const bf16*)k, (const bf16*)v,
      (const bf16*)dout, (const float*)lse, (const float*)delta, (float*)dq, (bf16*)dk,
      (bf16*)dv, tq, tk, d, scale);
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
// D <= 128 only (the reference's fused-backward rule). dp and tma as for
// flash_fwd's narrow kernel (dp may not be 0 here).
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dk, void* dv,
                               int bh, int tq, int tk, int d, int dp, int tma,
                               float scale, void* stream) {
  using namespace flash;
  if (!FLASH_ARGS_OK(bh, tq, tk) || d <= 0 || d > dp) return (int)cudaErrorInvalidValue;
  if (!tma_ok(d, tma, q, k, v, dout) || (tma && reinterpret_cast<uintptr_t>(dq) % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dp) {
    case 48: return launch_fused<48>(q, k, v, dout, lse, delta, dq, dk, dv, bh, tq, tk, d, tma, scale, s);
    case 64: return launch_fused<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, tq, tk, d, tma, scale, s);
    case 80: return launch_fused<80>(q, k, v, dout, lse, delta, dq, dk, dv, bh, tq, tk, d, tma, scale, s);
    case 96: return launch_fused<96>(q, k, v, dout, lse, delta, dq, dk, dv, bh, tq, tk, d, tma, scale, s);
    case 128: return launch_fused<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, tq, tk, d, tma, scale, s);
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

// Dynamic shared memory of the fused pass's block at padded width dp (0:
// not a width it is built for).
extern "C" int flash_bwd_fused_smem(int dp) {
  using namespace flash;
  switch (dp) {
    case 48: return (int)NarrowBwdCfg<48>::SMEM;
    case 64: return (int)NarrowBwdCfg<64>::SMEM;
    case 80: return (int)NarrowBwdCfg<80>::SMEM;
    case 96: return (int)NarrowBwdCfg<96>::SMEM;
    case 128: return (int)NarrowBwdCfg<128>::SMEM;
    default: return 0;
  }
}
