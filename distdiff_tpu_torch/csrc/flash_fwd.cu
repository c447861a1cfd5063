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
// Wide kernel, D up to 512 (the VAE's single head), on mma.sync: a 32 x 512
// fp32 output accumulator is 64 KB, so one block of eight warps per (32-row
// q tile, b*h) splits it into two 16-row groups by four 128-column
// quarters, 64 registers a thread. For each 64-row kv tile, warp (group,
// quarter) forms the 16 x 16 block (group's rows, quarter's 16 kv columns)
// of s over the full head width; s goes through shared memory, where 8
// threads a row take the softmax and write p as bf16; then each warp adds
// p v for its rows and columns. The q, k and v tiles (bf16, 32 + 64 + 64
// rows of 520) take 166 KB of the 227 KB of dynamic shared memory.
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

// q, k, v, o: bf16 [bh, t, d] contiguous; lse: fp32 [bh, tq]. dp: the
// narrow kernel's padded head width (48, 64, 80, 96 or 128, at least d; the
// caller's choice, ops/flash.py narrow_plan), or 0 for the wide kernel
// (d up to 512); tma: 1 to load the narrow kernel's tiles by TMA (d % 8 == 0
// and 16-byte aligned q, k, v), 0 to stage them through the producer's
// registers. Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int tq, int tk, int d, int dp, int tma,
                         float scale, void* stream) {
  using namespace flash;
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dp != 0) {
    if (d > dp || !narrow_tma_ok(d, tma, q, k, v, v)) return (int)cudaErrorInvalidValue;
    switch (dp) {
      case 48: return launch_narrow<48>(q, k, v, o, lse, bh, tq, tk, d, tma, scale, s);
      case 64: return launch_narrow<64>(q, k, v, o, lse, bh, tq, tk, d, tma, scale, s);
      case 80: return launch_narrow<80>(q, k, v, o, lse, bh, tq, tk, d, tma, scale, s);
      case 96: return launch_narrow<96>(q, k, v, o, lse, bh, tq, tk, d, tma, scale, s);
      case 128: return launch_narrow<128>(q, k, v, o, lse, bh, tq, tk, d, tma, scale, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (wide_dmax(d)) {
    case 256: return launch_wide<256>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
    case 512: return launch_wide<512>(q, k, v, o, lse, bh, tq, tk, d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the narrow forward's block at padded width dp
// (0: not a width it is built for).
extern "C" int flash_fwd_narrow_smem(int dp) {
  using namespace flash;
  switch (dp) {
    case 48: return (int)NarrowFwdCfg<48>::SMEM;
    case 64: return (int)NarrowFwdCfg<64>::SMEM;
    case 80: return (int)NarrowFwdCfg<80>::SMEM;
    case 96: return (int)NarrowFwdCfg<96>::SMEM;
    case 128: return (int)NarrowFwdCfg<128>::SMEM;
    default: return 0;
  }
}
