// The bf16 flash kernels written for Hopper (sm_90a): flash_fwd_wgmma_kernel,
// flash_dq_wgmma_kernel and flash_dkv_wgmma_kernel, behind the bf16 C entry
// points flash_attention_bf16_fwd, flash_attention_bf16_bwd_dq and
// flash_attention_bf16_bwd_dkv (flash_attention_bf16.cu). They replace, on
// bf16 inputs, the Pallas TPU kernels _fwd_kernel
// (fedml_tpu/ops/flash_attention.py:79), _bwd_dq_kernel (:213) and
// _bwd_dkv_kernel (:238). They took the place of the port's first bf16
// kernels, mma.sync kernels that ran them as TF32 products on operands
// converted to float32 per fragment.
//
// What they compute is the reference's on bf16 inputs (:84-107, :218-235,
// :243-265): every tile is read as float32 and the math is float32; o, dQ,
// dK and dV are rounded to bf16 once, to nearest even; lse and corr stay
// float32; masked scores are -1e30, the forward's l is floored at 1e-30,
// tiles wholly above the causal diagonal are skipped and keys k >= T are
// masked. No atomics (dQ keeps its own launch, apart from dK/dV), and every
// sum runs in a fixed order, so runs repeat bitwise.
//
// What bounds them: tensor-core work. Per unmasked (query, key) pair the
// forward does 2*D flops of Q K^T and 2*D of P V; dQ 2*D each of S = Q K^T,
// dP = dO V^T and dQ += dS K; dK/dV 2*D each of S^T = K Q^T, dP^T = V dO^T,
// dV += P^T dO and dK += dS^T Q. A product of two bf16 tiles (Q K^T, dO V^T,
// K Q^T, V dO^T) is exact in one bf16 pass with a float32 accumulator. A
// product of a float32 tile (P, dS) and a bf16 tile
// needs the float32 operand carried to float32 accuracy: each x is split in
// registers into three bf16 parts, hi = rn(x), mid = rn(x - hi),
// lo = rn(x - hi - mid) (each residual exact in float32, so hi + mid + lo
// = x for |x| >= 2^-100), and the product runs as three bf16 passes,
// smallest first (lo, mid, hi). That carries 24 significant bits where two
// TF32 passes carry 22, at 3 x 1/989.4 against 2 x 1/495 s per PFLOP: the
// cheapest float32-accurate recipe on the card, and the one chip_smoke.py's
// bf16 bound prices. Two passes would be a different result.
//
// The design (the Hopper shape: TMA ring, warp-specialised warpgroups):
// - Block: warpgroup 0 is the producer: one thread issues every TMA copy
//   (for dK/dV its warp also stages lse and corr; dQ's consumers read their
//   rows' lse and corr into registers once). Each consumer warpgroup owns 64
//   rows (queries in the forward and dQ, keys in dK/dV). The forward has
//   three consumers at D <= 32, two above; dQ two; dK/dV three at D <= 32,
//   two at D = 64, one at D = 128. setmaxnreg hands the producer's
//   registers to the consumers (WgBlock).
// - Loads: the owned tiles (Q; Q and dO; K and V) come once, the streamed
//   tiles (K and V; K and V; Q and dO) through a ring of kStages buffers in
//   shared memory, each by
//   cp.async.bulk.tensor over the [B, T, H, D] tensor (dims D, H, T, B; box
//   min(D, 64) x 1 x rows x 1), completing on an mbarrier per buffer; the
//   consumers free a buffer with an arrive per warp. Rows at or beyond T
//   arrive zero-filled. A row of D bf16 values is 32, 64 or 128 bytes and
//   takes the swizzle of that width; D = 128 is two 64-column panels.
// - Products: wgmma.mma_async m64nNk16, bf16 x bf16 -> float32. The
//   exact products read both operands from shared memory, K-major (Q, K, V,
//   dO rows as they are stored). The split products take A from registers:
//   the m64 accumulator layout of S (dS, S^T, dS^T) is the A fragment
//   layout, so P and dS are split and packed where they lie. B (V; K; dO and
//   Q) is read MN-major, transposed by the tensor core, which wgmma allows
//   for 16-bit types: no transposed copy exists. O, dQ, dK and dV accumulate
//   across tiles in the wgmma accumulator (their outputs are bf16: the drift
//   of the accumulator's truncating adds, ~1e-6 relative, is far inside one
//   bf16 ulp).
// - Overlap: every product batch is its own wgmma group behind its own
//   fence. The forward issues tile k+1's S before tile k's P V, dQ tile
//   k+1's S and dP before tile k's dS K, so each warpgroup keeps the tensor
//   cores fed for a whole tile; the waits are placed for the next tile's
//   softmax (P and dS) to run while the last product runs, but ptxas
//   schedules most of the exponentials below the final wait (the SASS shows
//   MUFU.EX2 after WARPGROUP.DEPBAR), so the overlap comes mostly from the
//   other consumer warpgroups. dK/dV computes P^T while dP^T runs and dS^T
//   while P^T dO runs. The forward's and dQ's last tiles are peeled, so no
//   wgmma issues under a branch, and no group is in flight over a loop's
//   back edge.
// - Softmax: online, in the accumulator's registers; a row lies in a quad,
//   so its max takes a tree over the lane's values and two shuffles; scores
//   in log2 units, one ex2 each; masking only on tiles that cross the
//   diagonal or the ragged edge (in the forward and dQ behind a warp-uniform
//   branch: a select per score on every tile was most of what slowed dQ's
//   first build to half its speed).
// - Registers bound the tiles. ptxas compiles a consumer to the block's
//   launch share (168 registers at two consumers, 128 at three), not to the
//   count setmaxnreg raises it to at run time, and it serializes every wgmma
//   (a wait after each) when a thread's accumulators, the next product's
//   scores and the split fragments in flight do not fit: the forward streams
//   64 keys (32 at D = 128), dQ 64 keys (32 from D = 64: the next tile's S
//   and dP, BK/2 floats each, beside dQ's D/2 and the 3 x BK/4 split dS
//   registers in flight), dK/dV 32 queries (16 at D = 128, where dK and
//   dV hold 128 registers a thread and one consumer gets 255). The host
//   refuses to launch a kernel that ptxas gave other than the block's share
//   (kErrRegisterShare), since the raise would then wait forever.
// - A wait that never completes traps after 2^34 SM cycles (9-17 s at the
//   card's clocks) instead of hanging the card.
//
// The tensor maps are built on the host per call with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint (no -lcuda), and passed as
// __grid_constant__ kernel parameters. What these kernels share with the
// float32 wgmma kernels (WgBlock, mbarriers, TMA, descriptors, split3) is in
// flash_attention_sm90.cuh. q, k, v and dO must start on a 16-byte
// boundary (the Python wrappers refuse other views).

#pragma once

#include "flash_attention_sm90.cuh"

namespace {

constexpr int kStages = 3;  // the ring of streamed tiles

// Consumer warpgroups a block, by what a thread's accumulators need: three
// at D <= 32 (128 registers each), two up to D = 64 (168), and for dK/dV at
// D = 128, whose dK and dV alone hold 128, one (255, no rebalancing).
template <int D>
__host__ __device__ constexpr int fwd_consumers() { return D <= 32 ? 3 : 2; }
template <int D>
__host__ __device__ constexpr int dkv_consumers() { return D <= 32 ? 3 : D <= 64 ? 2 : 1; }
// dQ holds two score tiles (S, dP) where the forward holds one: two
// consumers (168) at every D.
constexpr int kDqConsumers = 2;

// Key rows of the forward's and dQ's streamed tiles, and query rows of
// dK/dV's: sized so that a consumer thread's accumulators, the next
// product's scores and the split A fragments in flight fit its registers
// (WgBlock); fewer at D = 128, where O (dK and dV) hold 64 (128) of them,
// and for dQ from D = 64.
template <int D>
__host__ __device__ constexpr int fwd_stream_rows() { return D > 64 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr int dq_stream_rows() { return D > 32 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr int dkv_stream_rows() { return D > 64 ? 16 : 32; }
static_assert(WgBlock<2>::kConsumerRegisters == 240 && WgBlock<3>::kConsumerRegisters == 160,
              "the consumers' raise is what the producer frees");

// acc += x * B in three bf16 passes a step, smallest first, B MN-major in
// the ROWS x D tile at `tile` (its rows are the contraction).
template <int D, int ROWS, int NK>
__device__ __forceinline__ void mma_split3(float (&acc)[D / 2], const uint32_t (&a)[NK][3][4],
                                           uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint64_t db = desc_mn<D, ROWS>(tile, kk);
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) Wg<D>::template rs<1>(acc, a[kk][pass], db, 1);
  }
}

// O and lse for one query tile (64 rows a consumer warpgroup), streaming K
// and V tiles of fwd_stream_rows<D>() rows. Within a warpgroup the next
// tile's S = Q K^T is issued before this tile's P V, and its softmax runs
// while P V is on the tensor cores (two wgmma groups in flight); the last
// tile is peeled, so no wgmma issues under a branch.
template <int D, bool kCausal>
__global__ void __launch_bounds__(WgBlock<fwd_consumers<D>()>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int T, int H, float scale) {
  using Blk = WgBlock<fwd_consumers<D>()>;
  constexpr int BN = fwd_stream_rows<D>(), BQ = Blk::kRows;
  constexpr uint32_t kQBytes = tile_bytes<D>(BQ), kKVBytes = tile_bytes<D>(BN);
  extern __shared__ __align__(1024) unsigned char smem[];
  // barriers: q_full, k_full[kStages], v_full[kStages], empty[kStages]
  const uint32_t bar0 = smem_addr(smem);
  const uint32_t q_full = bar0, k_full = bar0 + 8, v_full = k_full + 8 * kStages,
                 empty = v_full + 8 * kStages;
  const uint32_t Qs = tiles_base(smem), Ks = Qs + kQBytes, Vs = Ks + kStages * kKVBytes;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int n_all = (T + BN - 1) / BN;
  const int n_tiles = kCausal ? min(n_all, (q0 + BQ + BN - 1) / BN) : n_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, Blk::kConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // producer
    producer_registers<Blk>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, kQBytes);
      tma_tile<D>(Qs, &tm_q, q_full, BQ, h, q0, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + 8 * s, kKVBytes);
        tma_tile<D>(Ks + s * kKVBytes, &tm_k, k_full + 8 * s, BN, h, kt * BN, b);
        mbar_arrive_expect_tx(v_full + 8 * s, kKVBytes);
        tma_tile<D>(Vs + s * kKVBytes, &tm_v, v_full + 8 * s, BN, h, kt * BN, b);
      }
    }
  } else {  // consumers
    consumer_registers<Blk>();
    const int c = threadIdx.x / kWgThreads - 1, tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int rw = q0 + 64 * c + 16 * warp;  // this warp's first query row

    OnlineSoftmax<BN, kCausal> sm{rw, T, g, t4, scale * kLog2e};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // S = Q K^T of key tile kt into sc: one bf16 pass, exact products, both
    // operands K-major from shared memory; one wgmma group
    auto issue_s = [&](float(&sc)[BN / 2], int kt) {
      const int s = kt % kStages;
      mbar_wait(k_full + 8 * s, (kt / kStages) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wg<BN>::template ss<0>(sc, desc_k<D, BQ>(Qs, 64 * c, kk),
                               desc_k<D, BN>(Ks + s * kKVBytes, 0, kk), kk > 0);
      wg_commit();
    };
    // O += P V of key tile kt: P split in three bf16 passes, V read MN-major;
    // one wgmma group
    auto issue_pv = [&](const uint32_t(&a)[BN / 16][3][4], int kt) {
      const int s = kt % kStages;
      mbar_wait(v_full + 8 * s, (kt / kStages) & 1);
      wg_fence();
      mma_split3<D, BN>(acc, a, Vs + s * kKVBytes);
      wg_commit();
    };
    float sc[BN / 2], corr[2];
    uint32_t a[BN / 16][3][4];  // P split in three
    mbar_wait(q_full, 0);
    issue_s(sc, 0);
    wg_wait<0>();
    pin(sc);
    sm.step(sc, 0, corr);  // O is still zero: nothing to rescale
    for (int kt = 0; kt + 1 < n_tiles; ++kt) {
      split_frags(a, sc);
      issue_s(sc, kt + 1);  // runs on the tensor cores before this tile's P V
      issue_pv(a, kt);
      wg_wait<1>();  // the next S is done, P V may still run
      pin(sc);
      sm.step(sc, (kt + 1) * BN, corr);
      wg_wait<0>();
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (kt % kStages));  // this warp is done with it
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    }
    split_frags(a, sc);  // the last tile (its buffer is not refilled)
    issue_pv(a, n_tiles - 1);
    wg_wait<0>();
    pin(acc);

    sm.template store<D>(acc, o, lse, b, h, H, bh);
  }
}

// dQ for one query tile (64 rows a consumer warpgroup), streaming K and V
// tiles of dq_stream_rows<D>() rows: S = Q K^T and dP = dO V^T (one bf16
// pass each), P = exp(S scale - lse), dS = P * (dP + corr), dQ += dS K (dS
// split in three bf16 passes, K read MN-major), dQ * scale rounded to bf16
// once. Within a warpgroup the next tile's S and dP are issued before this
// tile's dS K (three wgmma groups in flight), and the waits let the next
// tile's P and dS run under dP and dS K (as far as ptxas schedules them
// there: the source note). The last tile is peeled, so no wgmma issues under
// a branch. Every consumer walks the block's tiles, so each arrives on every
// `empty` barrier, a consumer whose rows all lie at or beyond T too.
template <int D, bool kCausal>
__global__ void __launch_bounds__(WgBlock<kDqConsumers>::kThreads, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                      const float* __restrict__ corr, __nv_bfloat16* __restrict__ dq, int T,
                      int H, float scale) {
  using Blk = WgBlock<kDqConsumers>;
  constexpr int BK = dq_stream_rows<D>(), BQ = Blk::kRows;
  constexpr uint32_t kQBytes = tile_bytes<D>(BQ), kKVBytes = tile_bytes<D>(BK);
  extern __shared__ __align__(1024) unsigned char smem[];
  // barriers: q_full (Q and dO), k_full[kStages], v_full[kStages], empty[kStages]
  const uint32_t bar0 = smem_addr(smem);
  const uint32_t q_full = bar0, k_full = bar0 + 8, v_full = k_full + 8 * kStages,
                 empty = v_full + 8 * kStages;
  const uint32_t Qs = tiles_base(smem), dOs = Qs + kQBytes, Ks = dOs + kQBytes,
                 Vs = Ks + kStages * kKVBytes;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int n_all = (T + BK - 1) / BK;
  const int n_tiles = kCausal ? min(n_all, (q0 + BQ + BK - 1) / BK) : n_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, Blk::kConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // producer
    producer_registers<Blk>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, 2 * kQBytes);
      tma_tile<D>(Qs, &tm_q, q_full, BQ, h, q0, b);
      tma_tile<D>(dOs, &tm_do, q_full, BQ, h, q0, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + 8 * s, kKVBytes);
        tma_tile<D>(Ks + s * kKVBytes, &tm_k, k_full + 8 * s, BK, h, kt * BK, b);
        mbar_arrive_expect_tx(v_full + 8 * s, kKVBytes);
        tma_tile<D>(Vs + s * kKVBytes, &tm_v, v_full + 8 * s, BK, h, kt * BK, b);
      }
    }
  } else {  // consumers
    consumer_registers<Blk>();
    const int c = threadIdx.x / kWgThreads - 1, tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int rw = q0 + 64 * c + 16 * warp;  // this warp's first query row
    const float scale2 = scale * kLog2e;     // scores in log2 units

    // lse (log2 units) and corr of rows g, g+8; 0 at rows >= T, whose Q and
    // dO arrive as zeros, so that their dS is 0
    float lse2[2], corr_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = rw + g + 8 * r;
      lse2[r] = t < T ? lse[(size_t)bh * T + t] * kLog2e : 0.f;
      corr_r[r] = t < T ? corr[(size_t)bh * T + t] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // S = Q K^T and dP = dO V^T of key tile kt: one bf16 pass each, both
    // operands K-major from shared memory; two wgmma groups
    auto issue_s_dp = [&](float(&sc)[BK / 2], float(&dp)[BK / 2], int kt) {
      const int s = kt % kStages;
      mbar_wait(k_full + 8 * s, (kt / kStages) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wg<BK>::template ss<0>(sc, desc_k<D, BQ>(Qs, 64 * c, kk),
                               desc_k<D, BK>(Ks + s * kKVBytes, 0, kk), kk > 0);
      wg_commit();
      mbar_wait(v_full + 8 * s, (kt / kStages) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wg<BK>::template ss<0>(dp, desc_k<D, BQ>(dOs, 64 * c, kk),
                               desc_k<D, BK>(Vs + s * kKVBytes, 0, kk), kk > 0);
      wg_commit();
    };
    // dQ += dS K of key tile kt: dS split in three bf16 passes, K read
    // MN-major; one wgmma group
    auto issue_dsk = [&](const uint32_t(&a)[BK / 16][3][4], int kt) {
      wg_fence();
      mma_split3<D, BK>(acc, a, Ks + (kt % kStages) * kKVBytes);
      wg_commit();
    };
    // P = exp(S scale - lse) in place of S, masked where the tile crosses
    // the ragged edge or, for this warp's rows, the causal diagonal
    auto probs = [&](float(&sc)[BK / 2], int kt) {
      const int k0 = kt * BK;
      if (k0 + BK > T || (kCausal && k0 + BK - 1 > rw)) {  // a warp-uniform test
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int qpos = rw + g + 8 * ((i >> 1) & 1);
          const int kpos = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (kpos >= T || (kCausal && kpos > qpos)) sc[i] = kNegInf;
        }
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = ex2(fmaf(sc[i], scale2, -lse2[(i >> 1) & 1]));
    };
    // dS = P * (dP + corr) in place of dP
    auto grad_scores = [&](const float(&p)[BK / 2], float(&dp)[BK / 2]) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) dp[i] = p[i] * (dp[i] + corr_r[(i >> 1) & 1]);
    };

    float sc[BK / 2], dp[BK / 2];
    uint32_t a[BK / 16][3][4];  // dS split in three
    mbar_wait(q_full, 0);
    issue_s_dp(sc, dp, 0);
    wg_wait<1>();
    pin(sc);
    probs(sc, 0);
    wg_wait<0>();
    pin(dp);
    grad_scores(sc, dp);
    for (int kt = 0; kt + 1 < n_tiles; ++kt) {
      split_frags(a, dp);
      issue_s_dp(sc, dp, kt + 1);  // run on the tensor cores before this tile's dS K
      issue_dsk(a, kt);
      wg_wait<2>();  // the next S is done; its dP and this dS K may still run
      pin(sc);
      probs(sc, kt + 1);
      wg_wait<1>();  // the next dP is done
      pin(dp);
      grad_scores(sc, dp);
      wg_wait<0>();
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (kt % kStages));  // this warp is done with it
    }
    split_frags(a, dp);  // the last tile (its buffers are not refilled)
    issue_dsk(a, n_tiles - 1);
    wg_wait<0>();
    pin(acc);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = rw + g + 8 * r;
      if (t < T) {
        __nv_bfloat16* row = dq + ((size_t)b * T + t) * H * D + (size_t)h * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          store2(row + 8 * j, acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
      }
    }
  }
}

// dK and dV for one key tile (64 rows a consumer warpgroup), streaming
// query tiles of dkv_stream_rows<D>() rows from the diagonal on: with the
// scores held transposed (key rows x query columns), P^T = exp(S^T - lse),
// dS^T = P^T * (dP^T + corr), dV += P^T dO and dK += scale * dS^T Q. S^T and
// dP^T are two wgmma groups, so P^T is computed while dP^T runs; P^T dO is
// issued before dS^T is computed, so dS^T is computed while it runs.
template <int D, bool kCausal>
__global__ void __launch_bounds__(WgBlock<dkv_consumers<D>()>::kThreads, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                       const float* __restrict__ corr, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int T, int H, float scale) {
  using Blk = WgBlock<dkv_consumers<D>()>;
  constexpr int BM = dkv_stream_rows<D>(), BK = Blk::kRows;
  constexpr uint32_t kKVBytes = tile_bytes<D>(BK), kQBytes = tile_bytes<D>(BM);
  extern __shared__ __align__(1024) unsigned char smem[];
  // head: kv_full, full[kStages], empty[kStages], then lse * log2(e) and
  // corr rows of each buffer
  const uint32_t bar0 = smem_addr(smem);
  const uint32_t kv_full = bar0, full = bar0 + 8, empty = full + 8 * kStages;
  float* Ls = reinterpret_cast<float*>(smem + 256);  // [kStages][BM]
  float* Cs = Ls + kStages * BM;                      // [kStages][BM]
  const uint32_t Ks = tiles_base(smem), Vs = Ks + kKVBytes, Qs = Vs + kKVBytes,
                 dOs = Qs + kStages * kQBytes;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * BK;  // tile 0 visits the most query tiles: first
  const int qt0 = kCausal ? k0 / BM : 0;
  const int n_q = (T + BM - 1) / BM;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);                // the copies' arrive + the lse / corr warp
      mbar_init(empty + 8 * s, Blk::kConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // producer
    producer_registers<Blk>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * kKVBytes);
        tma_tile<D>(Ks, &tm_k, kv_full, BK, h, k0, b);
        tma_tile<D>(Vs, &tm_v, kv_full, BK, h, k0, b);
      }
      const float* lse_h = lse + (size_t)bh * T;
      const float* corr_h = corr + (size_t)bh * T;
      for (int qt = qt0; qt < n_q; ++qt) {
        const int it = qt - qt0, s = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(full + 8 * s, 2 * kQBytes);
          tma_tile<D>(Qs + s * kQBytes, &tm_q, full + 8 * s, BM, h, qt * BM, b);
          tma_tile<D>(dOs + s * kQBytes, &tm_do, full + 8 * s, BM, h, qt * BM, b);
        }
        for (int i = lane; i < BM; i += 32) {  // entries >= T are 0 (and masked)
          const int t = qt * BM + i;
          Ls[s * BM + i] = t < T ? lse_h[t] * kLog2e : 0.f;  // log2 units
          Cs[s * BM + i] = t < T ? corr_h[t] : 0.f;
        }
        mbar_arrive(full + 8 * s);
      }
    }
  } else {  // consumers
    consumer_registers<Blk>();
    const int c = threadIdx.x / kWgThreads - 1, tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int kw = k0 + 64 * c + 16 * warp;  // this warp's first key row
    const float scale2 = scale * kLog2e;

    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int qt = qt0; qt < n_q; ++qt) {
      const int it = qt - qt0, s = it % kStages, q0 = qt * BM;
      const uint32_t Qt = Qs + s * kQBytes, dOt = dOs + s * kQBytes;
      const float* Lt = Ls + s * BM;
      const float* Ct = Cs + s * BM;

      // S^T = K Q^T and dP^T = V dO^T: one bf16 pass each, two wgmma groups
      float sc[BM / 2], dp[BM / 2];
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wg<BM>::template ss<0>(sc, desc_k<D, BK>(Ks, 64 * c, kk), desc_k<D, BM>(Qt, 0, kk),
                               kk > 0);
      wg_commit();
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wg<BM>::template ss<0>(dp, desc_k<D, BK>(Vs, 64 * c, kk), desc_k<D, BM>(dOt, 0, kk),
                               kk > 0);
      wg_commit();

      // P^T = exp(S^T scale - lse) in place of S^T while dP^T runs (columns
      // 2t4, 2t4+1 of each 8 share a float2 of lse)
      wg_wait<1>();
      pin(sc);
      const bool edge = kw + 15 >= T || q0 + BM > T || (kCausal && kw + 15 > q0);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, col = 8 * j + 2 * t4 + (e & 1);
          const int kpos = kw + g + 8 * (e >> 1), qpos = q0 + col;
          const bool ok = !edge || (kpos < T && qpos < T && (!kCausal || kpos <= qpos));
          sc[i] = ex2(fmaf(ok ? sc[i] : kNegInf, scale2, -((e & 1) ? l2.y : l2.x)));
        }
      }
      // dV += P^T dO: three bf16 passes, dO read MN-major
      uint32_t ap[BM / 16][3][4];
      split_frags(ap, sc);
      wg_fence();
      mma_split3<D, BM>(acc_v, ap, dOt);
      wg_commit();
      wg_wait<1>();  // dP^T done, P^T dO may still run
      pin(dp);
      // dS^T = P^T * (dP^T + corr) in place of dP^T, while P^T dO runs
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 c2 = *reinterpret_cast<const float2*>(Ct + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] + ((e & 1) ? c2.y : c2.x));
      }
      // dK += dS^T Q: three bf16 passes, Q read MN-major
      uint32_t ads[BM / 16][3][4];
      split_frags(ads, dp);
      wg_fence();
      mma_split3<D, BM>(acc_k, ads, Qt);
      wg_commit();
      wg_wait<0>();
      pin(acc_v);
      pin(acc_k);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = kw + g + 8 * r;
      if (t < T) {
        const size_t off = ((size_t)b * T + t) * H * D + (size_t)h * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          store2(dk + off + 8 * j, acc_k[4 * j + 2 * r] * scale, acc_k[4 * j + 2 * r + 1] * scale);
          store2(dv + off + 8 * j, acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// The tensor map of a contiguous [B, T, H, D] bf16 tensor read as tiles of
// `rows` rows of one head, a panel of columns per copy, in the swizzle of
// the panel's width; rows at or beyond T arrive as zeros.
template <int D>
cudaError_t rows_map(CUtensorMap* map, const __nv_bfloat16* x, int B, int T, int H, int rows) {
  constexpr int P = panel<D>();
  return head_rows_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B, T, H, D, P, rows,
                       P == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                       : P == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int D, bool kCausal>
cudaError_t run_fwd_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, __nv_bfloat16* o, float* lse, int B, int T,
                          int H, float scale, cudaStream_t st) {
  using Blk = WgBlock<fwd_consumers<D>()>;
  constexpr int BN = fwd_stream_rows<D>();
  static const cudaError_t share = check_share<Blk>(flash_fwd_wgmma_kernel<D, kCausal>);
  if (share != cudaSuccess) return share;
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = rows_map<D>(&mq, q, B, T, H, Blk::kRows)) != cudaSuccess ||
      (err = rows_map<D>(&mk, k, B, T, H, BN)) != cudaSuccess ||
      (err = rows_map<D>(&mv, v, B, T, H, BN)) != cudaSuccess)
    return err;
  const size_t smem =
      kHeadBytes + 1024 + tile_bytes<D>(Blk::kRows) + 2 * kStages * tile_bytes<D>(BN);
  if ((err = allow_smem(flash_fwd_wgmma_kernel<D, kCausal>, smem)) != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<D, kCausal><<<wg_grid(B, T, H, Blk::kRows), Blk::kThreads, smem, st>>>(
      mq, mk, mv, o, lse, T, H, scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t run_dq_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const __nv_bfloat16* dout, const float* lse,
                         const float* corr, __nv_bfloat16* dq, int B, int T, int H, float scale,
                         cudaStream_t st) {
  using Blk = WgBlock<kDqConsumers>;
  constexpr int BK = dq_stream_rows<D>();
  static const cudaError_t share = check_share<Blk>(flash_dq_wgmma_kernel<D, kCausal>);
  if (share != cudaSuccess) return share;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = rows_map<D>(&mq, q, B, T, H, Blk::kRows)) != cudaSuccess ||
      (err = rows_map<D>(&mk, k, B, T, H, BK)) != cudaSuccess ||
      (err = rows_map<D>(&mv, v, B, T, H, BK)) != cudaSuccess ||
      (err = rows_map<D>(&mdo, dout, B, T, H, Blk::kRows)) != cudaSuccess)
    return err;
  const size_t smem =
      kHeadBytes + 1024 + 2 * tile_bytes<D>(Blk::kRows) + 2 * kStages * tile_bytes<D>(BK);
  if ((err = allow_smem(flash_dq_wgmma_kernel<D, kCausal>, smem)) != cudaSuccess) return err;
  flash_dq_wgmma_kernel<D, kCausal><<<wg_grid(B, T, H, Blk::kRows), Blk::kThreads, smem, st>>>(
      mq, mk, mv, mdo, lse, corr, dq, T, H, scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t run_dkv_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const __nv_bfloat16* dout, const float* lse,
                          const float* corr, __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int T,
                          int H, float scale, cudaStream_t st) {
  using Blk = WgBlock<dkv_consumers<D>()>;
  constexpr int BM = dkv_stream_rows<D>();
  static const cudaError_t share = check_share<Blk>(flash_dkv_wgmma_kernel<D, kCausal>);
  if (share != cudaSuccess) return share;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = rows_map<D>(&mq, q, B, T, H, BM)) != cudaSuccess ||
      (err = rows_map<D>(&mk, k, B, T, H, Blk::kRows)) != cudaSuccess ||
      (err = rows_map<D>(&mv, v, B, T, H, Blk::kRows)) != cudaSuccess ||
      (err = rows_map<D>(&mdo, dout, B, T, H, BM)) != cudaSuccess)
    return err;
  const size_t smem =
      kHeadBytes + 1024 + 2 * tile_bytes<D>(Blk::kRows) + 2 * kStages * tile_bytes<D>(BM);
  if ((err = allow_smem(flash_dkv_wgmma_kernel<D, kCausal>, smem)) != cudaSuccess) return err;
  flash_dkv_wgmma_kernel<D, kCausal><<<wg_grid(B, T, H, Blk::kRows), Blk::kThreads, smem, st>>>(
      mq, mk, mv, mdo, lse, corr, dk, dv, T, H, scale);
  return cudaGetLastError();
}

}  // namespace
