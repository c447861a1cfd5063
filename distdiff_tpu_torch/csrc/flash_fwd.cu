// flash_fwd: attention forward with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels distdiff_tpu/ops/flash.py
// `_fwd_kernel_single` and `_fwd_kernel` (reached through `_flash_fwd_3d`).
// Computes, for each (b*h) slab, o = softmax(q k^T * scale) v in bf16 and the
// per-row lse = m + log(l) in fp32, which the backward kernels read. p is
// rounded to bf16 before p v, as the reference rounds it. Ragged kv columns
// are masked to -inf (in the last kv tile only) and ragged q rows are
// computed on zeros and never written; nothing is padded in device memory.
//
// Narrow kernel, D <= 128 (the UNet's 40 and 80). What bounds it on this
// card: at the 64^2 stage ([32, 4096, 40]) the exponentials, one per score
// (537M at 3.9 T/s: 0.138 ms), over the two products (0.087 ms at the bf16
// tensor-core peak); at the 32^2 stage ([32, 1024, 80]) the same two nearly
// tie. So the tensor cores and the special-function units have to run at
// once, and the per-score work on the FMA pipe has to stay small. Design:
//   * warp specialisation: one producer warp and two consumer warpgroups,
//     each consumer owning 64 q rows of a 128-row q tile, so that every k/v
//     tile a block loads serves 128 q rows (half the L2 reads of 64-row
//     tiles). ptxas holds a thread of this block to 168 registers (as for
//     a block of 12 warps; setmaxnreg did not raise it); the score, p and
//     output fragments stay in them, with 64-row kv tiles past D = 80;
//   * loads: q once, then k and v tiles by TMA (one 64-column box a row in
//     the 128-byte swizzle up to D = 64, 16-column boxes in the 32-byte
//     swizzle past it; zero fill past D and past T) into a ring of 3-4
//     stages with full/empty mbarriers, so the loads run ahead of the
//     products. Slabs TMA cannot describe (D % 8 != 0, or a base off 16
//     bytes) are staged element by element by the producer warp into
//     the same layout (hopper.cuh stage_tile): same kernel, same pipeline;
//   * products on wgmma: s = q k^T with q and k from shared memory
//     (m64n128 or m64n64, K = D in 16-column steps), o += p v with p from
//     registers (the s accumulators packed to bf16) and v from shared
//     memory (N = 64 up to D = 64, else N = D);
//   * overlap, after FlashAttention-3: in each step a consumer issues s of
//     tile j and p v of tile j - 1 together and runs tile j's softmax while
//     p v is in flight. At these head widths the products are short and the
//     exponentials long, so the two consumers take turns at the
//     exponentials (named barriers 1 and 2) rather than at the tensor
//     cores: one's row maxima, sums, packing and products run while the
//     other's ex2 stream keeps the special-function units busy;
//   * per score: one FMA (scale * log2 e and the row max folded together),
//     one ex2, a max and an add; the kv mask only in the last, ragged tile.
//
// Wide kernel, 128 < D <= 512 (the VAE mid-block's single 512-wide head;
// built for DMAX = 256 and 512). What bounds it on this card: the two
// products, 2 x 2 BH Tq Tk D flops (0.0695 ms at [2, 4096, 512] at the bf16
// tensor-core peak), against exponentials at 1/1024 of that per score and
// 32 MiB of device memory. In the way: a 64-row fp32 accumulator 512
// columns wide is 256 registers a thread of one warpgroup; every q tile
// reads all of K and V from L2 (1 GiB a launch at 64-row q tiles); and
// shared memory holds q, one k and one v tile at D = 512 and little more.
// Design, one block per (64-row q tile, b*h), 128 blocks at [2, 4096, 512]
// (one wave on 132 SMs), five warpgroups:
//   * four output warpgroups split o by columns: warpgroup w owns
//     o[:, w DMAX/4 .. + DMAX/4] (64 fp32 registers a thread at D = 512)
//     and adds p v[:, cols_w] as m64n128k16 (m64n64k16 at DMAX = 256)
//     wgmma, p and v's column slice (MN-major) from shared memory. It loads
//     its own columns of each v tile by TMA, which no other warpgroup
//     reads, as soon as its product of the tile before is done;
//   * one score warpgroup computes s of a whole 64 x 64 tile as m64n64k16
//     wgmma (q and k K-major: full rate, where four warpgroups each taking
//     16 kv columns re-read q from shared memory four times), owns whole
//     rows for the online softmax (no row maxima to exchange), and hands p
//     (bf16, in the layout wgmma reads) and the rescale alpha to the
//     output warpgroups through two buffers with full/empty mbarriers;
//   * k tiles are D / 64 chunks of 64 columns (128-byte rows and swizzle,
//     zero fill past D and past T), each with its own mbarrier: s commits
//     one group a chunk, and as each chunk's products finish, the next
//     tile's chunk loads into it, under the rest of s and the softmax;
//   * an output warpgroup starts p v of tile j only once s of tile j + 1 is
//     done (s_done), so that p v fills the tensor cores during that tile's
//     softmax instead of competing with its products;
//   * no producer warp and no block-wide barrier: the score warpgroup's
//     thread 0 loads q and k, each output warpgroup's thread 0 its v; where
//     TMA cannot describe the slab, the same warpgroups stage their tiles
//     element by element. A 640-thread block gets 96 registers a thread
//     (five warps on an SM sub-partition): enough for 64 accumulators or a
//     64-column score tile, not both (ptxas then serialises the wgmmas);
//   * per score: one FMA (scale * log2 e and the row max folded together),
//     one ex2; the kv mask only in the last, ragged tile. q rows past Tq
//     are computed on TMA's zeros and never written.
// What holds it at ~2.7x its bound (PERF.md): the score warpgroup's chain
// of s, waits, softmax and hand-off, one warp on each sub-partition, and
// the 1 GiB from L2. A second score warpgroup on alternate tiles needs 768
// threads, 80 registers (the output product needs 90); k/v multicast over
// a 2-block cluster puts a cross-block round trip on that chain.
#include "flash_common.cuh"

namespace flash {

// ------------------------------------------- narrow kernel (D <= 128), Hopper

template <int DP>
struct NarrowFwdCfg {
  static constexpr int BQ = 128;  // two consumer warpgroups of 64 q rows
  // kv rows of a tile: 128, or 64 past D = 80, so that the score, p and
  // output fragments fit the registers of a thread
  static constexpr int BK = DP <= 80 ? 128 : 64;
  // Up to D = 64 a tile row is one 64-column TMA box (128-byte rows and
  // swizzle, p v at N = 64): one request and at most three 32-byte sectors
  // a row, where 16-column boxes of a 40-wide (80-byte) row took three
  // requests and up to five sectors. Wider, 16-column chunks (32-byte rows
  // and swizzle) keep p v at N = D.
  static constexpr int SW = DP <= 64 ? 128 : 32;  // bytes of a chunk row
  static constexpr int CC = SW / 2;              // columns of a chunk
  static constexpr int TW = DP <= 64 ? 64 : DP;  // columns of a tile (and N of p v)
  static constexpr int CH = TW / CC;             // chunks of a tile
  static constexpr int KS = DP / 16;             // k-steps of q k^T
  static constexpr int STAGES = DP == 80 ? 3 : 4;
  static constexpr int THREADS = 288;  // two consumer warpgroups and the producer warp
  static constexpr int Q_CHUNK = BQ * SW, KV_CHUNK = BK * SW;
  static constexpr int Q_BYTES = CH * Q_CHUNK, KV_BYTES = CH * KV_CHUNK;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr size_t SMEM = OFF_BAR + 8 * (1 + 4 * STAGES) + 1024;  // + alignment
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};


// Named barriers 1 and 2: the turns of consumers 0 and 1 at the
// exponentials (the special-function units take one consumer's at a time;
// the other's row maxima, sums, packing and products run meanwhile).
constexpr int SCHED_BAR = 1;

// Byte offset of head columns 16 kk .. 16 kk + 15 of a tile's row 0.
template <typename C>
__device__ __forceinline__ uint32_t fwd_kstep(int kk, int chunk_bytes) {
  return (kk * 16) / C::CC * chunk_bytes + (kk * 16) % C::CC * 2;
}

// s = q k^T over the head width for one consumer: A = its 64 q rows, B =
// the k tile, both K-major.
template <typename C>
__device__ __forceinline__ void fwd_issue_s(float (&s)[C::BK / 2], uint32_t q_addr,
                                            uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk)
    hopper::Wgmma<C::BK>::template ss<0, 0>(
        s, hopper::desc<C::SW>(q_addr + fwd_kstep<C>(kk, C::Q_CHUNK), 16, 8 * C::SW),
        hopper::desc<C::SW>(k_addr + fwd_kstep<C>(kk, C::KV_CHUNK), 16, 8 * C::SW), kk > 0);
}

// o += p v over the tile's kv rows: A = p (registers), B = the v tile
// (MN-major).
template <typename C>
__device__ __forceinline__ void fwd_issue_pv(float (&o)[C::TW / 2],
                                             const uint32_t (&p)[C::BK / 16][4],
                                             uint32_t v_addr) {
#pragma unroll
  for (int t = 0; t < C::BK / 16; ++t)
    hopper::Wgmma<C::TW>::template rs<1>(
        o, p[t], hopper::desc<C::SW>(v_addr + t * 16 * C::SW, C::KV_CHUNK, 8 * C::SW), 1);
}

// Online softmax of one kv tile in s (p replaces s, fp32): the running max
// m (raw scores) and this thread's running sums l of rows g and g + 8, and
// the rescale alpha of the earlier tiles. Columns from `valid` on are
// masked (valid < BK in the last, ragged tile only). The exponentials wait
// for consumer c's turn and, with `pass`, hand the turn on.
template <int BK>
__device__ __forceinline__ void fwd_softmax(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], int valid, float sl2, int t4,
                                            int c, bool pass) {
  if (valid < BK) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n * 8 + 2 * t4 + (e & 1) >= valid) s[4 * n + e] = -INFINITY;
  }
  // row maxima and sums over four independent chains a row, so that they
  // are not one long dependent chain of latency
  float mx4[2][4], sum4[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx4[r][i] = m[r];
      sum4[r][i] = 0.f;
    }
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx4[e >> 1][(n & 1) * 2 + (e & 1)] = fmaxf(mx4[e >> 1][(n & 1) * 2 + (e & 1)], s[4 * n + e]);
  float mx[2], mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's scores sit in the 4 lanes of a quad
    mx[r] = fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = hopper::ex2((m[r] - mx[r]) * sl2);  // 0 on the first tile (m = -inf)
    m[r] = mx[r];
    mc[r] = mx[r] * sl2;
  }
  hopper::named_sync(SCHED_BAR + c, 256);  // this consumer's turn at the exponentials
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = hopper::ex2(fmaf(s[4 * n + e], sl2, -mc[e >> 1]));
      s[4 * n + e] = p;
      sum4[e >> 1][(n & 1) * 2 + (e & 1)] += p;
    }
  if (pass) hopper::named_arrive(SCHED_BAR + (1 - c), 256);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((sum4[r][0] + sum4[r][1]) + (sum4[r][2] + sum4[r][3]));
}

// p (fp32 accumulator layout) -> the bf16 A fragments of p v, k-step t =
// kv columns 16t .. 16t + 15.
template <int BK>
__device__ __forceinline__ void fwd_pack_p(uint32_t (&p)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[t][i] = hopper::pack_bf16(s[8 * t + 2 * i], s[8 * t + 2 * i + 1]);
}

template <int DP, bool TMA>
__global__ void __launch_bounds__(NarrowFwdCfg<DP>::THREADS, 1)
flash_fwd_narrow_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ q,
                        const bf16* __restrict__ k, const bf16* __restrict__ v,
                        bf16* __restrict__ o, float* __restrict__ lse, int tq, int tk, int d,
                        float scale) {
  typedef NarrowFwdCfg<DP> C;
  constexpr int BK = C::BK, CH = C::CH, S = C::STAGES;
  constexpr int FULL = TMA ? 1 : 32;  // arrivals that fill a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + C::OFF_K;
  uint8_t* Vs = smem + C::OFF_V;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::BQ;
  const int nk = (tk + BK - 1) / BK;
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, FULL);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(k_full + s, FULL);
      hopper::mbar_init(v_full + s, FULL);
      hopper::mbar_init(k_empty + s, 8);  // lane 0 of each consumer warp
      hopper::mbar_init(v_empty + s, 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (wg == 2) {
    // ---- producer warp: the q tile once, then k and v tiles into the ring
    if (TMA) {
      if (tid != 0) return;
      hopper::mbar_arrive_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < CH; ++c)
        hopper::tma_load_3d(Qs + c * C::Q_CHUNK, &qmap, C::CC * c, q0, bh, q_full);
      for (int j = 0; j < nk; ++j) {
        const int s = j % S;
        const uint32_t ph = (j / S) & 1;
        hopper::mbar_wait(k_empty + s, ph ^ 1);
        hopper::mbar_arrive_tx(k_full + s, C::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          hopper::tma_load_3d(Ks + s * C::KV_BYTES + c * C::KV_CHUNK, &kmap, C::CC * c, j * BK,
                              bh, k_full + s);
        hopper::mbar_wait(v_empty + s, ph ^ 1);
        hopper::mbar_arrive_tx(v_full + s, C::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          hopper::tma_load_3d(Vs + s * C::KV_BYTES + c * C::KV_CHUNK, &vmap, C::CC * c, j * BK,
                              bh, v_full + s);
      }
    } else {
      const bf16* kb = k + (size_t)bh * tk * d;
      const bf16* vb = v + (size_t)bh * tk * d;
      hopper::stage_tile<C::BQ, C::TW, C::SW>(Qs, q + (size_t)bh * tq * d, q0, tq, d, tid, 32);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(q_full);
      for (int j = 0; j < nk; ++j) {
        const int s = j % S;
        const uint32_t ph = (j / S) & 1;
        hopper::mbar_wait(k_empty + s, ph ^ 1);
        hopper::stage_tile<BK, C::TW, C::SW>(Ks + s * C::KV_BYTES, kb, j * BK, tk, d, tid, 32);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(k_full + s);
        hopper::mbar_wait(v_empty + s, ph ^ 1);
        hopper::stage_tile<BK, C::TW, C::SW>(Vs + s * C::KV_BYTES, vb, j * BK, tk, d, tid, 32);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(v_full + s);
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns q rows q0 + 64c .. + 64
  const int c = wg;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const float sl2 = scale * LOG2E;  // scores to log2 units: one FMA with the row max
  const uint32_t q_addr = hopper::smem_addr(Qs) + c * 64 * C::SW;
  const uint32_t k_addr = hopper::smem_addr(Ks);
  const uint32_t v_addr = hopper::smem_addr(Vs);
  float s_acc[BK / 2];      // scores of this warp's 16 rows x BK kv columns
  float o_acc[C::TW / 2];   // output accumulator, 16 rows x TW
  uint32_t p_frag[BK / 16][4];  // p as the A operand of p v (bf16 pairs)
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8 (raw scores)
  float l[2] = {0.f, 0.f};              // this thread's part of their running sums
#pragma unroll
  for (int i = 0; i < C::TW / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s_acc[i] = 0.f;

  // consumer c's turn at the exponentials ends by handing the turn on;
  // consumer 1 hands on no turn after its last
  const bool pass_last = c == 0;
  if (c == 1) hopper::named_arrive(SCHED_BAR, 256);  // consumer 0 takes the first turn
  hopper::mbar_wait(q_full, 0);

  // tile 0: s only
  hopper::mbar_wait(k_full, 0);
  hopper::wgmma_fence();
  fwd_issue_s<C>(s_acc, q_addr, k_addr);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s_acc);
  if (lane == 0) hopper::mbar_arrive(k_empty);
  {
    float alpha[2];
    fwd_softmax<BK>(s_acc, m, l, alpha, nk == 1 ? tk : BK, sl2, t4, c, pass_last || nk > 1);
  }
  fwd_pack_p<BK>(p_frag, s_acc);

  // tile j: s of tile j and p v of tile j - 1 in flight together; the
  // softmax of tile j runs under p v of tile j - 1 (and under the other
  // consumer's products)
  for (int j = 1; j < nk; ++j) {
    const int s = j % S, sp = (j - 1) % S;
    hopper::mbar_wait(k_full + s, (j / S) & 1);
    hopper::mbar_wait(v_full + sp, ((j - 1) / S) & 1);
    hopper::fence_regs(o_acc);
    hopper::fence_regs(p_frag);
    hopper::wgmma_fence();
    fwd_issue_s<C>(s_acc, q_addr, k_addr + s * C::KV_BYTES);
    hopper::wgmma_commit();
    fwd_issue_pv<C>(o_acc, p_frag, v_addr + sp * C::KV_BYTES);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s_acc);
    if (lane == 0) hopper::mbar_arrive(k_empty + s);
    float alpha[2];
    fwd_softmax<BK>(s_acc, m, l, alpha, j == nk - 1 ? tk - j * BK : BK, sl2, t4, c,
                    pass_last || j < nk - 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o_acc);
    hopper::fence_regs(p_frag);
    if (lane == 0) hopper::mbar_arrive(v_empty + sp);
#pragma unroll
    for (int n = 0; n < C::TW / 8; ++n) {
      o_acc[4 * n] *= alpha[0];
      o_acc[4 * n + 1] *= alpha[0];
      o_acc[4 * n + 2] *= alpha[1];
      o_acc[4 * n + 3] *= alpha[1];
    }
    fwd_pack_p<BK>(p_frag, s_acc);
  }

  // p v of the last tile
  const int sl = (nk - 1) % S;
  hopper::mbar_wait(v_full + sl, ((nk - 1) / S) & 1);
  hopper::fence_regs(o_acc);
  hopper::fence_regs(p_frag);
  hopper::wgmma_fence();
  fwd_issue_pv<C>(o_acc, p_frag, v_addr + sl * C::KV_BYTES);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o_acc);
  hopper::fence_regs(p_frag);
  if (lane == 0) hopper::mbar_arrive(v_empty + sl);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + c * 64 + warp * 16 + g + 8 * r;
    if (row >= tq) continue;
    const float inv = 1.f / l[r];
    bf16* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int n = 0; n < C::TW / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < d) orow[col] = __float2bfloat16(o_acc[4 * n + 2 * r] * inv);
      if (col + 1 < d) orow[col + 1] = __float2bfloat16(o_acc[4 * n + 2 * r + 1] * inv);
    }
    if (t4 == 0) lse[(size_t)bh * tq + row] = m[r] * scale + logf(l[r]);
  }
}

// ------------------------------------------ wide kernel (128 < D <= 512), Hopper

template <int DMAX>
struct WideFwdCfg {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int OUTS = 4;                    // output warpgroups
  static constexpr int THREADS = 128 * (OUTS + 1);  // and the score warpgroup
  static constexpr int CH = DMAX / 64;              // 64-column chunks of a q, k or v tile
  static constexpr int ON = DMAX / OUTS;            // output columns of an output warpgroup
  static constexpr int VCH = ON / 64;               // its chunks of v
  static constexpr int CHUNK = 64 * 128;            // 64 rows x 64 columns, bf16
  static constexpr int TILE = CH * CHUNK;
  static constexpr int P_BYTES = BQ * BK * 2;       // p, bf16: one chunk
  static constexpr int OFF_K = TILE;
  static constexpr int OFF_V = OFF_K + TILE;
  static constexpr int OFF_P = OFF_V + TILE;        // two p buffers
  static constexpr int OFF_ALPHA = OFF_P + 2 * P_BYTES;  // [2][BQ] fp32: each p's rescale
  static constexpr int OFF_L = OFF_ALPHA + 2 * BQ * 4;   // [BQ] fp32: the final row sums
  static constexpr int OFF_BAR = OFF_L + BQ * 4;
  // q_full, k_full[CH], v_full[OUTS], p_full[2], p_empty[2], l_full, s_done[2]
  static constexpr int BARS = 1 + CH + OUTS + 2 + 2 + 1 + 2;
  static constexpr size_t SMEM = OFF_BAR + 8 * BARS + 1024;  // + alignment
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
  static_assert(ON % 64 == 0, "an output warpgroup's columns are whole chunks");
};

// Named barrier 1: the score warpgroup's 128 threads, before p is handed on.
constexpr int SCORE_BAR = 1;

template <int DMAX, bool TMA>
__global__ void __launch_bounds__(WideFwdCfg<DMAX>::THREADS, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ q,
                      const bf16* __restrict__ k, const bf16* __restrict__ v,
                      bf16* __restrict__ o, float* __restrict__ lse, int tq, int tk, int d,
                      float scale) {
  typedef WideFwdCfg<DMAX> C;
  constexpr int BQ = C::BQ, BK = C::BK, CH = C::CH, ON = C::ON, VCH = C::VCH;
  constexpr int CHUNK = C::CHUNK;
  constexpr int LOADERS = TMA ? 1 : 128;  // arrivals that complete a load
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* Qt = smem;
  uint8_t* Kt = smem + C::OFF_K;
  uint8_t* Vt = smem + C::OFF_V;
  uint8_t* Pt = smem + C::OFF_P;
  float* alpha_s = reinterpret_cast<float*>(smem + C::OFF_ALPHA);
  float* l_s = reinterpret_cast<float*>(smem + C::OFF_L);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + CH;
  uint64_t* p_full = v_full + C::OUTS;
  uint64_t* p_empty = p_full + 2;
  uint64_t* l_full = p_empty + 2;
  uint64_t* s_done = l_full + 1;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int nk = (tk + BK - 1) / BK;
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, LOADERS);
    for (int c = 0; c < CH; ++c) hopper::mbar_init(k_full + c, LOADERS);
    for (int w = 0; w < C::OUTS; ++w) hopper::mbar_init(v_full + w, LOADERS);
    for (int b = 0; b < 2; ++b) {
      hopper::mbar_init(p_full + b, 1);        // the score warpgroup's thread 0
      hopper::mbar_init(p_empty + b, C::OUTS);  // thread 0 of each output warpgroup
    }
    hopper::mbar_init(l_full, 128);
    for (int b = 0; b < 2; ++b) hopper::mbar_init(s_done + b, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int row0 = warp * 16 + g;  // this thread's rows of the q tile: row0 and row0 + 8
  const uint32_t p_addr = hopper::smem_addr(Pt);
  if (wg == C::OUTS) {
    // ---- score warpgroup: s = q k^T of a whole 64 x 64 tile (m64n64k16,
    // q and k K-major), its online softmax, and p and the rescale alpha
    // handed to the output warpgroups through two buffers; it loads q and k
    const bf16* kb = k + (size_t)bh * tk * d;
    if (TMA) {
      if (tid == 0) {
        hopper::mbar_arrive_tx(q_full, C::TILE);
        for (int c = 0; c < CH; ++c) {
          hopper::tma_load_3d(Qt + c * CHUNK, &qmap, 64 * c, q0, bh, q_full);
          hopper::mbar_arrive_tx(k_full + c, CHUNK);
          hopper::tma_load_3d(Kt + c * CHUNK, &kmap, 64 * c, 0, bh, k_full + c);
        }
      }
    } else {
      hopper::stage_tile<BQ, DMAX, 128>(Qt, q + (size_t)bh * tq * d, q0, tq, d, tid, 128);
      hopper::stage_tile<BK, DMAX, 128>(Kt, kb, 0, tk, d, tid, 128);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(q_full);
      for (int c = 0; c < CH; ++c) hopper::mbar_arrive(k_full + c);
    }
    const float sl2 = scale * LOG2E;  // scores to log2 units: one FMA with the row max
    const uint64_t q_desc = hopper::desc<128>(hopper::smem_addr(Qt), 16, 1024);
    const uint64_t k_desc = hopper::desc<128>(hopper::smem_addr(Kt), 16, 1024);
    float s_acc[BK / 2];  // scores of this warp's 16 rows x 64 kv columns
    float m[2] = {-INFINITY, -INFINITY};  // running max of rows row0, row0 + 8 (raw scores)
    float l[2] = {0.f, 0.f};              // this thread's part of their running sums
    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
      // one commit group a chunk, in a loop that is not unrolled, so that
      // the descriptors are formed a chunk at a time (unrolled, ptxas
      // hoists all of them out of the tile loop and spills them)
      uint64_t qd = q_desc, kd = k_desc;
#pragma unroll 1
      for (int c = 0; c < CH; ++c) {
        hopper::mbar_wait(k_full + c, j & 1);
        hopper::wgmma_fence();
#pragma unroll
        for (int i = 0; i < 4; ++i)
          hopper::Wgmma<BK>::template ss<0, 0>(s_acc, desc_at(qd, i * 32), desc_at(kd, i * 32),
                                               c > 0 || i > 0);
        hopper::wgmma_commit();
        qd = desc_at(qd, CHUNK);
        kd = desc_at(kd, CHUNK);
      }
      // each k chunk is free once its products are done: tile j + 1's
      // chunk loads into it under the rest of s and the softmax
      if (TMA) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          hopper::wgmma_wait_n(CH - 1 - c);
          if (tid == 0 && j + 1 < nk) {
            hopper::mbar_arrive_tx(k_full + c, CHUNK);
            hopper::tma_load_3d(Kt + c * CHUNK, &kmap, 64 * c, (j + 1) * BK, bh, k_full + c);
          }
        }
      } else {
        hopper::wgmma_wait<0>();
        if (j + 1 < nk) {
          hopper::stage_tile<BK, DMAX, 128>(Kt, kb, (j + 1) * BK, tk, d, tid, 128);
          hopper::fence_proxy_async();
          for (int c = 0; c < CH; ++c) hopper::mbar_arrive(k_full + c);
        }
      }
      hopper::fence_regs(s_acc);
      if (tid == 0) hopper::mbar_arrive(s_done + (j & 1));  // p v of tile j - 1 may go now
      const int valid = tk - j * BK;
      if (valid < BK) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n * 8 + 2 * t4 + (e & 1) >= valid) s_acc[4 * n + e] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]}, alpha[2], mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s_acc[4 * n + e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // a row's scores sit in the 4 lanes of a quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = hopper::ex2((m[r] - mx[r]) * sl2);  // 0 on the first tile (m = -inf)
        m[r] = mx[r];
        mc[r] = mx[r] * sl2;
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = hopper::ex2(fmaf(s_acc[4 * n + e], sl2, -mc[e >> 1]));
          s_acc[4 * n + e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
      // p (bf16, 128-byte swizzle: the A operand of p v) and alpha into
      // buffer j % 2, once the output warpgroups are done with tile j - 2
      const int b = j & 1;
      hopper::mbar_wait(p_empty + b, ((j >> 1) & 1) ^ 1);
      uint8_t* pb = Pt + b * C::P_BYTES;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(pb + hopper::swizzle_off<128>(row0 + 8 * r, (n * 8 + 2 * t4) * 2)) =
              hopper::pack_bf16(s_acc[4 * n + 2 * r], s_acc[4 * n + 2 * r + 1]);
      if (t4 == 0) {
        alpha_s[b * BQ + row0] = alpha[0];
        alpha_s[b * BQ + row0 + 8] = alpha[1];
      }
      // one arrival, once all 128 threads have written
      hopper::fence_proxy_async();
      hopper::named_sync(SCORE_BAR, 128);
      if (tid == 0) hopper::mbar_arrive(p_full + b);
    }
    // the row sums for the output warpgroups, and lse
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = q0 + row0 + 8 * r;
      if (t4 == 0) {
        l_s[row0 + 8 * r] = l[r];
        if (row < tq) lse[(size_t)bh * tq + row] = m[r] * scale + logf(l[r]);
      }
    }
    hopper::mbar_arrive(l_full);
    return;
  }

  // ---- output warpgroup w: o[:, ON w .. + ON] += p v[:, ON w .. + ON]
  // (m64nONk16, p K-major and v MN-major from shared memory); it loads its
  // own columns of each v tile, which no other warpgroup reads
  const int w = wg;
  const bf16* vb = v + (size_t)bh * tk * d;
  uint8_t* Vw = Vt + w * VCH * CHUNK;
  auto load_v = [&](int j) {
    if (TMA) {
      if (tid == 0) {
        hopper::mbar_arrive_tx(v_full + w, VCH * CHUNK);
        for (int i = 0; i < VCH; ++i)
          hopper::tma_load_3d(Vw + i * CHUNK, &vmap, 64 * (w * VCH + i), j * BK, bh, v_full + w);
      }
    } else {
      hopper::stage_tile<BK, ON, 128>(Vw, vb, j * BK, tk, d, tid, 128, w * ON);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(v_full + w);
    }
  };
  load_v(0);
  const uint64_t p_desc = hopper::desc<128>(p_addr, 16, 1024);
  const uint64_t v_desc = hopper::desc<128>(hopper::smem_addr(Vw), CHUNK, 1024);
  float o_acc[ON / 2];  // this warp's 16 rows x ON
#pragma unroll
  for (int i = 0; i < ON / 2; ++i) o_acc[i] = 0.f;
  for (int j = 0; j < nk; ++j) {
    const int b = j & 1;
    hopper::mbar_wait(p_full + b, (j >> 1) & 1);
    const float a0 = alpha_s[b * BQ + row0], a1 = alpha_s[b * BQ + row0 + 8];
#pragma unroll
    for (int n = 0; n < ON / 8; ++n) {
      o_acc[4 * n] *= a0;
      o_acc[4 * n + 1] *= a0;
      o_acc[4 * n + 2] *= a1;
      o_acc[4 * n + 3] *= a1;
    }
    hopper::mbar_wait(v_full + w, j & 1);
    // after s of tile j + 1, so that p v runs under that tile's softmax
    // rather than beside its products. One barrier for each tile parity:
    // the score warpgroup may finish s of tile j + 2 before this wait (it
    // waits for p v of tile j only to write p of tile j + 2), and a single
    // barrier two phases on would pass this parity wait wrongly.
    if (j + 1 < nk) hopper::mbar_wait(s_done + ((j + 1) & 1), ((j + 1) >> 1) & 1);
    hopper::fence_regs(o_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      hopper::Wgmma<ON>::template ss<0, 1>(o_acc, desc_at(p_desc, b * C::P_BYTES + t * 32),
                                           desc_at(v_desc, t * 2048), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o_acc);
    if (tid == 0) hopper::mbar_arrive(p_empty + b);  // the warpgroup's products are done
    if (j + 1 < nk) load_v(j + 1);
  }
  hopper::mbar_wait(l_full, 0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    if (row >= tq) continue;
    const float inv = 1.f / l_s[row0 + 8 * r];
    bf16* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int n = 0; n < ON / 8; ++n) {
      const int col = w * ON + n * 8 + 2 * t4;
      const float a = o_acc[4 * n + 2 * r] * inv, b = o_acc[4 * n + 2 * r + 1] * inv;
      if (d % 2 == 0) {  // rows of whole bf16 pairs: one 4-byte store
        if (col < d) *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(a, b);
      } else {
        if (col < d) orow[col] = __float2bfloat16(a);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16(b);
      }
    }
  }
}

template <int DP>
static int launch_narrow(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int tq, int tk, int d, int tma, float scale,
                         cudaStream_t stream) {
  typedef NarrowFwdCfg<DP> C;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  if (tma) {
    int rc = hopper::tile_map(&maps[0], q, bh, tq, d, C::BQ, C::CC);
    if (rc == 0) rc = hopper::tile_map(&maps[1], k, bh, tk, d, C::BK, C::CC);
    if (rc == 0) rc = hopper::tile_map(&maps[2], v, bh, tk, d, C::BK, C::CC);
    if (rc != 0) return rc;
  }
  auto kern = tma ? flash_fwd_narrow_kernel<DP, true> : flash_fwd_narrow_kernel<DP, false>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + C::BQ - 1) / C::BQ, bh);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
      (float*)lse, tq, tk, d, scale);
  return (int)cudaGetLastError();
}

template <int DMAX>
static int launch_wide(const void* q, const void* k, const void* v, void* o, void* lse,
                       int bh, int tq, int tk, int d, int tma, float scale,
                       cudaStream_t stream) {
  typedef WideFwdCfg<DMAX> C;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  if (tma) {
    int rc = hopper::tile_map(&maps[0], q, bh, tq, d, C::BQ, 64);
    if (rc == 0) rc = hopper::tile_map(&maps[1], k, bh, tk, d, C::BK, 64);
    if (rc == 0) rc = hopper::tile_map(&maps[2], v, bh, tk, d, C::BK, 64);
    if (rc != 0) return rc;
  }
  auto kern = tma ? flash_fwd_wide_kernel<DMAX, true> : flash_fwd_wide_kernel<DMAX, false>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + C::BQ - 1) / C::BQ, bh);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
      (float*)lse, tq, tk, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

// q, k, v, o: bf16 [bh, t, d] contiguous; lse: fp32 [bh, tq]. dp: the
// narrow kernel's padded head width (48, 64, 80, 96 or 128, at least d; the
// caller's choice, ops/flash.py bf16_plan), or 0 for the wide kernel
// (128 < d <= 512); tma: 1 to load the tiles by TMA (d % 8 == 0 and 16-byte
// aligned q, k, v), 0 to stage them through the producer's registers.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int tq, int tk, int d, int dp, int tma,
                         float scale, void* stream) {
  using namespace flash;
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (!tma_ok(d, tma, q, k, v, v)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dp != 0) {
    if (d > dp) return (int)cudaErrorInvalidValue;
    switch (dp) {
      case 48: return launch_narrow<48>(q, k, v, o, lse, bh, tq, tk, d, tma, scale, s);
      case 64: return launch_narrow<64>(q, k, v, o, lse, bh, tq, tk, d, tma, scale, s);
      case 80: return launch_narrow<80>(q, k, v, o, lse, bh, tq, tk, d, tma, scale, s);
      case 96: return launch_narrow<96>(q, k, v, o, lse, bh, tq, tk, d, tma, scale, s);
      case 128: return launch_narrow<128>(q, k, v, o, lse, bh, tq, tk, d, tma, scale, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (d <= 128) return (int)cudaErrorInvalidValue;  // the narrow kernels' widths
  switch (wide_dmax(d)) {
    case 256: return launch_wide<256>(q, k, v, o, lse, bh, tq, tk, d, tma, scale, s);
    case 512: return launch_wide<512>(q, k, v, o, lse, bh, tq, tk, d, tma, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the forward's block: the narrow kernel's at
// padded width dp, the wide kernel's at dp = 256 or 512 (its DMAX); 0 for
// a width it is not built for.
extern "C" int flash_fwd_smem(int dp) {
  using namespace flash;
  switch (dp) {
    case 48: return (int)NarrowFwdCfg<48>::SMEM;
    case 64: return (int)NarrowFwdCfg<64>::SMEM;
    case 80: return (int)NarrowFwdCfg<80>::SMEM;
    case 96: return (int)NarrowFwdCfg<96>::SMEM;
    case 128: return (int)NarrowFwdCfg<128>::SMEM;
    case 256: return (int)WideFwdCfg<256>::SMEM;
    case 512: return (int)WideFwdCfg<512>::SMEM;
    default: return 0;
  }
}
