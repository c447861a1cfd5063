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
// flash_bwd_dq / flash_bwd_dkv (the split pair, D up to 512; the VAE's
// single 512-wide head). What bounds them on this card: their products, 3
// (dq) and 4 (dk, dv) of 2 BH Tq Tk D flops (0.104 and 0.139 ms at [2, 4096,
// 4096, 512] at the bf16 tensor-core peak). In the way: a 64 x 512 fp32
// accumulator is 128 KB of registers, so a block cannot hold dk and dv of
// one 64-row kv tile (256 KB, the whole register file); a 64-row bf16 tile
// is 64 KB, so shared memory holds three and little more; and every block
// reads all of the other side's tiles from L2 (1 GiB a launch at 64-row
// tiles). Design, one block template (split_block) in three roles, a
// block owning 64 rows and walking 64-row tiles of the other side:
//   * roles: dq (q rows: s, dp, dq += ds k), dk (kv rows: s^T, dp^T,
//     dk += ds^T q) and dv (kv rows: s^T, dv += p^T do). flash_bwd_dkv
//     launches dk and dv blocks in one grid (z = 2): each recomputes s^T,
//     5 products for dk and dv together where the reference's one pass
//     forms 4, but the accumulators of either fit;
//   * warp specialisation as in the wide forward: one score warpgroup
//     forms the 64 x 64 score tiles (m64n64k16, both operands K-major in
//     the 128-byte swizzle), the exponentials and ds, and hands ds (p in
//     dv) as bf16 to D / 128 output warpgroups through mbarriers; output
//     warpgroup w adds ds X[:, 128 w .. + 128] (two m64n64k16, one a
//     chunk, X MN-major) into 64 fp32 registers a thread. 640 threads at
//     D = 512 get 96 registers each;
//   * shared memory: the block's A1 and A2 tiles (q and do, or k and v)
//     stay for the whole walk. The stream passes through one ring of
//     64-column chunks (11 slots at D = 512, 16 narrower): per tile the
//     chunks of the operand only the score product reads (v, do, or q in
//     dv), then those of X, the tile the output product reads (k, q or do;
//     the score product reads it too outside dv). Whoever reads a chunk
//     last loads the chunk 11 further into its slot: the score warpgroup
//     for the first kind, output warpgroup w for X's chunks 2w and 2w + 1.
//     So loads of the next tile start while this one's outputs are still
//     waiting, and no slot sits empty for a fixed role. ds takes one
//     buffer; dv, which has no A2, keeps a second in A2's space so that
//     its next s^T runs under the outputs. 226 KB at D = 512;
//   * order in the score warpgroup: the first kind's product (dp) first,
//     then s over X's chunks as they arrive, so that dp fills the tensor
//     cores while the outputs of the tile before finish. (A resident X
//     tile beside a ring of three chunks leaves the loads' latency in the
//     chain: each tile waits for eight ring refills, three at a time, and
//     X reloads only after the outputs: 18% slower for dq, 24% for dkv);
//   * no masks and no padding in device memory: rows past T are zero in
//     shared memory (TMA's fill, the staged loads' zeros), so p and ds
//     there meet zero rows of the output product's operand; lse and delta
//     past tq read as 0; rows of the block past T are not written;
//   * deterministic: each output element is one block's sum in a fixed
//     order, no atomics. Slabs TMA cannot describe are staged element by
//     element, each chunk by the warpgroup that would have loaded it.
#include "flash_common.cuh"

#define FLASH_ARGS_OK(bh, tq, tk) \
  ((bh) > 0 && (bh) <= 65535 && (tq) > 0 && (tk) > 0)

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

// The three roles of a split-backward block. A block owns 64 rows of one
// side and walks 64-row tiles of the other (the stream):
//   DQ: q rows (A1 = q, A2 = do), stream kv: s = q k^T, dp = do v^T,
//       dq += ds k;
//   DK: kv rows (A1 = k, A2 = v), stream q: s^T = k q^T, dp^T = v do^T,
//       dk += ds^T q;
//   DV: kv rows (A1 = k), stream q: s^T = k q^T, dv += p^T do.
// X is the stream tile that the output product reads (k, q or do): resident
// for the tile, one mbarrier a 64-column chunk. The ring carries the
// stream's other operand (v, do or q) a 64-column chunk at a time.
enum SplitMode { SPLIT_DQ = 0, SPLIT_DK = 1, SPLIT_DV = 2 };

template <int DMAX>
struct SplitBwdCfg {
  static constexpr int BR = 64, BT = 64;   // the block's rows, a stream tile's rows
  static constexpr int OUTS = DMAX / 128;  // output warpgroups, 128 columns each
  static constexpr int THREADS = 128 * (OUTS + 1);  // and the score warpgroup
  static constexpr int CH = DMAX / 64;     // 64-column chunks of a tile
  static constexpr int ON = 128;           // output columns of an output warpgroup
  static constexpr int CHUNK = 64 * 128;   // 64 rows x 64 columns, bf16
  static constexpr int TILE = CH * CHUNK;
  static constexpr int RING = DMAX == 512 ? 11 : 16;  // ring slots, one chunk each
  static constexpr int OFF_A2 = TILE;
  static constexpr int OFF_R = 2 * TILE;
  static constexpr int OFF_DS = OFF_R + RING * CHUNK;  // ds (p in DV), bf16
  static constexpr int OFF_VEC = OFF_DS + CHUNK;       // [2][lse2, delta][BT] fp32
  static constexpr int OFF_BAR = OFF_VEC + 2 * 2 * BT * 4;
  // a_full, ring_full[RING], ds_full[2], ds_empty[2]
  static constexpr int BARS = 1 + RING + 4;
  static constexpr size_t SMEM = OFF_BAR + 8 * BARS + 1024;  // + alignment
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
  static_assert(RING > CH, "a tile's X chunks must not wait for its own outputs");
};

// Named barriers: 1, the score warpgroup's 128 threads; 2 + w, output
// warpgroup w's.
constexpr int SPLIT_SCORE_BAR = 1;
constexpr int SPLIT_OUT_BAR = 2;

// acc (+)= A[:, chunk] B[:, chunk]^T over one 64-column chunk of the head
// width (four k-steps; A and B K-major in the 128-byte swizzle).
__device__ __forceinline__ void split_chunk_product(float (&acc)[32], uint64_t ad, uint64_t bd,
                                                    bool first) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    hopper::Wgmma<64>::template ss<0, 0>(acc, desc_at(ad, i * 32), desc_at(bd, i * 32),
                                         !first || i > 0);
}

// One block of role MODE (the kernels below pick it).
template <int DMAX, bool TMA, int MODE>
__device__ __forceinline__ void split_block(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                            const CUtensorMap* vmap, const CUtensorMap* domap,
                                            const bf16* __restrict__ q, const bf16* __restrict__ k,
                                            const bf16* __restrict__ v,
                                            const bf16* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            bf16* __restrict__ out, int tq, int tk, int d,
                                            float scale) {
  typedef SplitBwdCfg<DMAX> C;
  constexpr int CH = C::CH, CHUNK = C::CHUNK, RING = C::RING;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* A1 = smem;
  uint8_t* A2 = smem + C::OFF_A2;
  uint8_t* R = smem + C::OFF_R;
  uint8_t* DSB = smem + C::OFF_DS;
  float* vec = reinterpret_cast<float*>(smem + C::OFF_VEC);
  uint64_t* a_full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* ring_full = a_full + 1;
  uint64_t* ds_full = ring_full + RING;
  uint64_t* ds_empty = ds_full + 2;

  constexpr bool DQ = MODE == SPLIT_DQ;
  constexpr bool dv = MODE == SPLIT_DV;
  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * C::BR;
  const int nr = DQ ? tq : tk;      // rows of the block's side
  const int ns = DQ ? tk : tq;      // rows of the stream
  const int nt = (ns + C::BT - 1) / C::BT;
  const int total = nt * 2 * CH;    // stream chunks through the ring
  // DV leaves A2's space free: it holds a second p buffer there, so that
  // its s^T of one tile runs while the outputs take the tile before
  constexpr int nb = dv ? 2 : 1;
  if (threadIdx.x == 0) {
    hopper::mbar_init(a_full, 1);
    for (int s = 0; s < RING; ++s) hopper::mbar_init(ring_full + s, 1);  // one loading thread
    for (int b = 0; b < 2; ++b) {
      hopper::mbar_init(ds_full + b, 1);         // the score warpgroup's thread 0
      hopper::mbar_init(ds_empty + b, C::OUTS);  // thread 0 of each output warpgroup
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int row0 = warp * 16 + g;  // this thread's rows of the block: row0 and row0 + 8
  const size_t off_r = (size_t)bh * nr * d, off_s = (size_t)bh * ns * d;
  // The stream: per tile, CH chunks of the ring operand (v, do, or q in
  // DV), then CH chunks of X (k, q or do), all through one ring of RING
  // slots; chunk r sits in slot r % RING. Whoever is done with a chunk
  // last loads the chunk RING further into its slot: the score warpgroup
  // for a ring-operand chunk, output warpgroup c / 2 for X chunk c.
  const CUtensorMap* rmap = DQ ? vmap : (dv ? qmap : domap);
  const CUtensorMap* xmap = DQ ? kmap : (dv ? domap : qmap);
  const bf16* rs = (DQ ? v : (dv ? q : dout)) + off_s;
  const bf16* xs = (DQ ? k : (dv ? dout : q)) + off_s;
  // chunk r into its slot, by the calling warpgroup (bar: its named
  // barrier): TMA by its thread 0, or staged by all its threads
  auto refill = [&](int r, int bar) {
    if (r >= total) return;
    const int s = r % RING, p = r % (2 * CH);
    const int row = r / (2 * CH) * C::BT, col = 64 * (p % CH);
    if (TMA) {
      if (tid == 0) {
        hopper::mbar_arrive_tx(ring_full + s, CHUNK);
        hopper::tma_load_3d(R + s * CHUNK, p < CH ? rmap : xmap, col, row, bh, ring_full + s);
      }
    } else {
      hopper::stage_tile<C::BT, 64, 128>(R + s * CHUNK, p < CH ? rs : xs, row, ns, d, tid, 128, col);
      hopper::fence_proxy_async();
      hopper::named_sync(bar, 128);
      if (tid == 0) hopper::mbar_arrive(ring_full + s);
    }
  };
  const uint64_t r_desc = hopper::desc<128>(hopper::smem_addr(R), 16, 1024);

  if (wg == C::OUTS) {
    // ---- score warpgroup: per stream tile, the ring operand's product (dp,
    // or s in DV) chunk by chunk as they arrive, then s over X's chunks;
    // p = exp(s scale - lse) and ds = p (dp - delta) scale (p in DV) as
    // bf16 into a buffer that the output warpgroups read. It loads A1, A2
    // and the ring's first RING chunks.
    if (TMA) {
      if (tid == 0) {
        hopper::mbar_arrive_tx(a_full, (dv ? 1 : 2) * C::TILE);
        for (int c = 0; c < CH; ++c) {
          hopper::tma_load_3d(A1 + c * CHUNK, DQ ? qmap : kmap, 64 * c, r0, bh, a_full);
          if (!dv) hopper::tma_load_3d(A2 + c * CHUNK, DQ ? domap : vmap, 64 * c, r0, bh, a_full);
        }
      }
    } else {
      hopper::stage_tile<C::BR, DMAX, 128>(A1, (DQ ? q : k) + off_r, r0, nr, d, tid, 128);
      if (!dv) hopper::stage_tile<C::BR, DMAX, 128>(A2, (DQ ? dout : v) + off_r, r0, nr, d, tid, 128);
      hopper::fence_proxy_async();
    }
    for (int r = 0; r < RING; ++r) refill(r, SPLIT_SCORE_BAR);
    // a ring-operand chunk has been read: every score warp is past its wait
    // for the chunk's group, then its slot takes the chunk RING further
    auto release = [&](int r) {
      hopper::named_sync(SPLIT_SCORE_BAR, 128);
      refill(r + RING, SPLIT_SCORE_BAR);
    };
    // lse (times log2 e) and delta: of the block's rows in DQ, held in
    // registers; of the stream tile's columns otherwise, staged a tile
    // ahead into vec[tile % 2] (thread t: lse of column t, delta of
    // column t - 64). Past tq both are 0: q and do rows there are zero, so
    // p and ds meet only zeros in the output product.
    const float* lse_b = lse + (size_t)bh * tq;
    const float* delta_b = delta + (size_t)bh * tq;
    auto col_vec = [&](int j) {
      const int col = j * C::BT + (tid & 63);
      if (col >= tq) return 0.f;
      return tid < 64 ? lse_b[col] * LOG2E : delta_b[col];
    };
    float lrow[2] = {0.f, 0.f}, drow[2] = {0.f, 0.f};
    if (DQ) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + row0 + 8 * r;
        if (row < tq) {
          lrow[r] = lse_b[row] * LOG2E;
          drow[r] = delta_b[row];
        }
      }
    } else {
      vec[tid] = col_vec(0);
    }
    hopper::named_sync(SPLIT_SCORE_BAR, 128);  // staged tiles and the first vectors are in
    if (TMA) hopper::mbar_wait(a_full, 0);
    const float sl2 = scale * LOG2E;
    const uint64_t a1_desc = hopper::desc<128>(hopper::smem_addr(A1), 16, 1024);
    const uint64_t a2_desc = hopper::desc<128>(hopper::smem_addr(A2), 16, 1024);
    float s_acc[32], dp_acc[32];  // this warp's 16 rows x the tile's 64 columns
    for (int j = 0; j < nt; ++j) {
      const float nv = (!DQ && j + 1 < nt) ? col_vec(j + 1) : 0.f;
      // the ring operand's product: dp = A2 R^T (s = A1 R^T in DV), one
      // commit group a chunk, in a loop that is not unrolled (unrolled,
      // ptxas hoists the descriptors out of the tile loop and spills them)
      uint64_t ad = dv ? a1_desc : a2_desc;
      const int r_base = j * 2 * CH;
#pragma unroll 1
      for (int c = 0; c < CH; ++c) {
        const int r = r_base + c, s = r % RING;
        hopper::mbar_wait(ring_full + s, (r / RING) & 1);
        hopper::wgmma_fence();
        if (dv)
          split_chunk_product(s_acc, ad, desc_at(r_desc, s * CHUNK), c == 0);
        else
          split_chunk_product(dp_acc, ad, desc_at(r_desc, s * CHUNK), c == 0);
        hopper::wgmma_commit();
        ad = desc_at(ad, CHUNK);
        if (c > 0) {
          hopper::wgmma_wait<1>();
          release(r - 1);
        }
      }
      if (!DQ) vec[((j + 1) & 1) * 128 + tid] = nv;  // read at tile j + 1, past the barrier below
      if (!dv) {
        // s = A1 X^T, a chunk as it arrives
        uint64_t a1d = a1_desc;
#pragma unroll 1
        for (int c = 0; c < CH; ++c) {
          const int r = r_base + CH + c, s = r % RING;
          hopper::mbar_wait(ring_full + s, (r / RING) & 1);
          hopper::wgmma_fence();
          split_chunk_product(s_acc, a1d, desc_at(r_desc, s * CHUNK), c == 0);
          hopper::wgmma_commit();
          a1d = desc_at(a1d, CHUNK);
          if (c == 0) {
            hopper::wgmma_wait<1>();
            release(r_base + CH - 1);
          }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp_acc);
      } else {
        hopper::wgmma_wait<0>();
        release(r_base + CH - 1);
      }
      hopper::fence_regs(s_acc);
      // p = exp2(s scale log2 e - lse log2 e); ds = p (dp - delta) scale
      const float* lv = vec + (j & 1) * 128;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float2 lc = make_float2(0.f, 0.f), dc = make_float2(0.f, 0.f);
        if (!DQ) {
          lc = *reinterpret_cast<const float2*>(lv + n * 8 + 2 * t4);
          dc = *reinterpret_cast<const float2*>(lv + 64 + n * 8 + 2 * t4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float L = DQ ? lrow[e >> 1] : ((e & 1) ? lc.y : lc.x);
          const float p = hopper::ex2(fmaf(s_acc[4 * n + e], sl2, -L));
          if (dv) {
            s_acc[4 * n + e] = p;
          } else {
            const float D = DQ ? drow[e >> 1] : ((e & 1) ? dc.y : dc.x);
            s_acc[4 * n + e] = p * (dp_acc[4 * n + e] - D) * scale;
          }
        }
      }
      // ds (p) as bf16 into buffer j % nb (the A operand of the output
      // product: 128-byte swizzle, K-major), once the outputs are done with
      // its last tile
      const int b = j % nb;
      hopper::mbar_wait(ds_empty + b, ((j / nb) & 1) ^ 1);
      uint8_t* pb = b ? A2 : DSB;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(pb + hopper::swizzle_off<128>(row0 + 8 * r, (n * 8 + 2 * t4) * 2)) =
              hopper::pack_bf16(s_acc[4 * n + 2 * r], s_acc[4 * n + 2 * r + 1]);
      // one arrival, once all 128 threads have written
      hopper::fence_proxy_async();
      hopper::named_sync(SPLIT_SCORE_BAR, 128);
      if (tid == 0) hopper::mbar_arrive(ds_full + b);
    }
    return;
  }

  // ---- output warpgroup w: out[:, 128 w .. + 128] += ds X[:, 128 w .. + 128]
  // as two m64n64k16 products, one for each of its X chunks 2w and 2w + 1
  // (ds K-major, X MN-major, both from shared memory). Once both are done,
  // it loads the chunks RING further into their slots (the score
  // warpgroup's s of the tile is done by then).
  const int w = wg;
  float acc[2][32];  // this warp's 16 rows x 64 columns of each chunk
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
  const uint64_t xr_desc = hopper::desc<128>(hopper::smem_addr(R), CHUNK, 1024);
  for (int j = 0; j < nt; ++j) {
    const int b = j % nb;
    const int rx = j * 2 * CH + CH + 2 * w;  // X chunk 2w of tile j
    hopper::mbar_wait(ds_full + b, (j / nb) & 1);
    const uint64_t p_desc = hopper::desc<128>(hopper::smem_addr(b ? A2 : DSB), 16, 1024);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = (rx + i) % RING;
      hopper::mbar_wait(ring_full + s, ((rx + i) / RING) & 1);
      hopper::fence_regs(acc[i]);
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < C::BT / 16; ++t)
        hopper::Wgmma<64>::template ss<0, 1>(acc[i], desc_at(p_desc, t * 32),
                                             desc_at(xr_desc, s * CHUNK + t * 2048), 1);
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    hopper::named_sync(SPLIT_OUT_BAR + w, 128);  // every warp's part has been read
    if (tid == 0) hopper::mbar_arrive(ds_empty + b);
    refill(rx + RING, SPLIT_OUT_BAR + w);
    refill(rx + 1 + RING, SPLIT_OUT_BAR + w);
  }
  out += off_r;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + row0 + 8 * r;
    if (row >= nr) continue;
    bf16* orow = out + (size_t)row * d;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = w * C::ON + i * 64 + n * 8 + 2 * t4;
        const float a = acc[i][4 * n + 2 * r], c = acc[i][4 * n + 2 * r + 1];
        if (d % 2 == 0) {  // rows of whole bf16 pairs: one 4-byte store
          if (col < d) *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(a, c);
        } else {
          if (col < d) orow[col] = __float2bfloat16(a);
          if (col + 1 < d) orow[col + 1] = __float2bfloat16(c);
        }
      }
  }
}

#define SPLIT_KERNEL_PARAMS                                                                  \
  const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,        \
      const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,   \
      const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,    \
      const bf16 *__restrict__ dout, const float *__restrict__ lse,                          \
      const float *__restrict__ delta, bf16 *__restrict__ out0, bf16 *__restrict__ out1,     \
      int tq, int tk, int d, float scale
#define SPLIT_BLOCK_ARGS(out) \
  &qmap, &kmap, &vmap, &domap, q, k, v, dout, lse, delta, out, tq, tk, d, scale

// dq: one block per 64-row q tile (out1 unused).
template <int DMAX, bool TMA>
__global__ void __launch_bounds__(SplitBwdCfg<DMAX>::THREADS, 1)
flash_bwd_dq_kernel(SPLIT_KERNEL_PARAMS) {
  split_block<DMAX, TMA, SPLIT_DQ>(SPLIT_BLOCK_ARGS(out0));
}

// dk (grid z = 0, into out0) and dv (z = 1, into out1): one block per
// 64-row kv tile and role, in one launch.
template <int DMAX, bool TMA>
__global__ void __launch_bounds__(SplitBwdCfg<DMAX>::THREADS, 1)
flash_bwd_dkv_kernel(SPLIT_KERNEL_PARAMS) {
  if (blockIdx.z)
    split_block<DMAX, TMA, SPLIT_DV>(SPLIT_BLOCK_ARGS(out1));
  else
    split_block<DMAX, TMA, SPLIT_DK>(SPLIT_BLOCK_ARGS(out0));
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

// Head width rounded up to a split kernel's (0: unsupported).
inline int split_dmax(int d) {
  if (d <= 0) return 0;
  if (d <= 128) return 128;
  if (d <= 256) return 256;
  if (d <= 512) return 512;
  return 0;
}

// dq (DQ) or dk and dv (one grid of both roles).
template <int DMAX, bool DQ>
static int launch_split(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* out0, void* out1, int bh,
                        int tq, int tk, int d, int tma, float scale, cudaStream_t stream) {
  typedef SplitBwdCfg<DMAX> C;
  CUtensorMap maps[4];
  memset(maps, 0, sizeof(maps));
  if (tma) {
    int rc = hopper::tile_map(&maps[0], q, bh, tq, d, 64, 64);
    if (rc == 0) rc = hopper::tile_map(&maps[1], k, bh, tk, d, 64, 64);
    if (rc == 0) rc = hopper::tile_map(&maps[2], v, bh, tk, d, 64, 64);
    if (rc == 0) rc = hopper::tile_map(&maps[3], dout, bh, tq, d, 64, 64);
    if (rc != 0) return rc;
  }
  auto kern = DQ ? (tma ? flash_bwd_dq_kernel<DMAX, true> : flash_bwd_dq_kernel<DMAX, false>)
                 : (tma ? flash_bwd_dkv_kernel<DMAX, true> : flash_bwd_dkv_kernel<DMAX, false>);
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(((DQ ? tq : tk) + C::BR - 1) / C::BR, bh, DQ ? 1 : 2);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const bf16*)q, (const bf16*)k, (const bf16*)v,
      (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)out0, (bf16*)out1, tq,
      tk, d, scale);
  return (int)cudaGetLastError();
}

template <bool DQ>
static int split_entry(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* out0, void* out1, int bh,
                       int tq, int tk, int d, int tma, float scale, void* stream) {
  if (!FLASH_ARGS_OK(bh, tq, tk) || !tma_ok(d, tma, q, k, v, dout))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (split_dmax(d)) {
    case 128: return launch_split<128, DQ>(q, k, v, dout, lse, delta, out0, out1, bh, tq, tk, d, tma, scale, s);
    case 256: return launch_split<256, DQ>(q, k, v, dout, lse, delta, out0, out1, bh, tq, tk, d, tma, scale, s);
    case 512: return launch_split<512, DQ>(q, k, v, dout, lse, delta, out0, out1, bh, tq, tk, d, tma, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash

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

// q, k, v, do: bf16 [bh, t, d] contiguous; lse, delta: fp32 [bh, tq]; d up
// to 512. tma: 1 to load the tiles by TMA (d % 8 == 0 and 16-byte aligned q,
// k, v, do; ops/flash.py split_plan), 0 to stage them element by element.
// dk, dv: bf16 [bh, tk, d] (no dq).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* dk, void* dv, int bh, int tq, int tk, int d, int tma,
                             float scale, void* stream) {
  return flash::split_entry<false>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, tma,
                                   scale, stream);
}

// dq: bf16 [bh, tq, d].
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            void* dq, int bh, int tq, int tk, int d, int tma, float scale,
                            void* stream) {
  return flash::split_entry<true>(q, k, v, dout, lse, delta, dq, nullptr, bh, tq, tk, d, tma,
                                  scale, stream);
}

// Dynamic shared memory of a split-backward block at dmax = 128, 256 or 512
// (0: not a width it is built for).
extern "C" int flash_bwd_split_smem(int dmax) {
  using namespace flash;
  switch (dmax) {
    case 128: return (int)SplitBwdCfg<128>::SMEM;
    case 256: return (int)SplitBwdCfg<256>::SMEM;
    case 512: return (int)SplitBwdCfg<512>::SMEM;
    default: return 0;
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
