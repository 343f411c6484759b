// The float32 flash forward and dK/dV kernels written for Hopper (sm_90a):
// flash_fwd_wgmma_f32_kernel and flash_dkv_wgmma_f32_kernel, behind the C
// entry points flash_attention_fwd and flash_attention_bwd_dkv
// (flash_attention.cu). They replace, on float32 inputs, the Pallas TPU
// kernels _fwd_kernel (fedml_tpu/ops/flash_attention.py:79) and
// _bwd_dkv_kernel (:238). The float32 dQ (_bwd_dq_kernel, :213) is still
// flash_dq_kernel of flash_attention.cuh, on mma.sync.
//
// What they compute is the reference's (:84-107, :243-265) in float32:
// masked scores are -1e30, the forward's l is floored at 1e-30 and
// lse = m + log(l); tiles wholly above the causal diagonal are skipped and
// keys k >= T are masked; no atomics, every sum in a fixed order, so runs
// repeat bitwise.
//
// What bounds them: tensor-core work at float32 accuracy. Per unmasked
// (query, key) pair the forward does 2*D flops of Q K^T and 2*D of P V,
// dK/dV 2*D each of S^T = K Q^T, dP^T = V dO^T, dV += P^T dO and
// dK += dS^T Q. Every one of those is a product of two float32 operands.
//
// Why six bf16 passes and not TF32: each float32 operand x is split into
// three bf16 parts, hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid)
// (split3; each residual is exact, so hi + mid + lo = x with all 24 bits),
// and a product runs as the six bf16 wgmma passes that carry float32
// accuracy, smallest first: lo*hi, hi*lo, mid*mid, mid*hi, hi*mid, hi*hi
// (mid*lo and smaller, below 2^-24 relative, are dropped; without mid*mid
// the error grows 10-20x, tests/test_torch_flash_attention.py). Six passes
// at 989.4 TFLOP/s cost the same tensor-core time as 3xTF32 at 495 (6.06e-15
// s a flop either way), so the bound is unchanged. But wgmma takes .tf32
// operands only K-major from shared memory, and P V, P^T dO and dS^T Q
// contract over a tile's rows: TF32 would need transposed copies of V, dO
// and Q, split in two each. 16-bit wgmma reads B MN-major (transposed by the
// tensor core), so the split tiles have exactly the bf16 kernels' layout and
// their descriptors serve unchanged; and a streamed element costs 6 bytes of
// split tiles, not 8 bytes twice over.
//
// The design (the bf16 kernels' shape, flash_attention_sm90_bf16.cuh):
// - Block: warpgroup 0 is the producer, the consumer warpgroups own 64 rows
//   each (queries in the forward, keys in dK/dV): two at D <= 64, one at
//   D = 128, whose accumulators need a thread's every register. One producer
//   thread issues the TMA copies of the raw float32 tiles (no swizzle; rows
//   at or beyond T arrive as zeros) into a ring of kRawStages buffers; then
//   the whole producer warpgroup splits each streamed tile once, into its
//   three bf16 tiles laid out as TMA lays a bf16 tile (split_tile), into a
//   ring of kSplitStages buffers the consumers read. Each streamed element
//   is split once a block, where the mma.sync kernels split it once a warp.
//   The producer keeps kSplitterRegisters registers (WgBlock).
// - Operands. The A side comes from registers, split in place by
//   split_frags: Q (forward, D <= 32: the m64 A fragments are made once);
//   P, P^T and dS^T (the m64 accumulator layout of S, S^T and dP^T is the A
//   fragment layout). An owned tile whose three parts do not fit beside the
//   accumulators is split once a block into shared memory by the producer
//   and read K-major: Q in the forward from D = 64, K and V in dK/dV. The B
//   side is three split tiles in shared memory: K K-major for Q K^T, V
//   MN-major for P V; Q and dO K-major for S^T and dP^T, and the same tiles
//   MN-major for dV and dK. No transposed copy exists.
// - Accumulating at float32 accuracy. The tensor cores add with truncation
//   (a long chain drifts 10-20x past float32's error, flash_attention.cuh's
//   acc_add), so each score tile sums every 32 columns of D from zero, the
//   partials added in float32; each tile's P V, P^T dO and dS^T Q runs from
//   zero, in column chunks of a 64-column panel at most, and is added into a
//   float32 register sum, rounded (the forward's O = O corr + P V in one
//   fma). Within a partial the passes run outermost (every k-step's lo*hi,
//   then hi*lo, ..., hi*hi last): the small terms are summed while the
//   accumulator is small, and only the hi*hi steps truncate at its full
//   magnitude. Step by step, each step's five small passes would add into
//   the full sum: dK at T = 64 came out 4.2x plain float32's error against
//   float64 on an H100 (the gate is 4x), 1.4x pass by pass with P^T in
//   natural units (below).
// - Overlap, as the bf16 kernels: the forward issues tile k+1's S before
//   tile k's P V and runs tile k+1's softmax under P V (its last tile
//   peeled, no wgmma under a branch, no group in flight over a loop's back
//   edge); dK/dV computes P^T while dP^T runs and dS^T while P^T dO runs.
//   Masking runs behind a warp-uniform branch, only on tiles that cross the
//   diagonal or the ragged edge. Heaviest causal tiles first.
// - A wait that never completes traps after 2^34 SM cycles.
//
// q, k, v and dO must start on a 16-byte boundary (the Python wrappers
// refuse other views); o, dK and dV are written two values at a time.

#pragma once

#include "flash_attention_sm90.cuh"

namespace {

constexpr int kRawStages = 2;          // raw float32 tiles in flight (TMA)
constexpr int kSplitStages = 3;        // split tiles ready for the consumers
constexpr int kSplitterRegisters = 56;  // the producer's: copies and splits

// The six bf16 passes of a float32-accurate product, smallest first: the
// part of A and the part of B of pass p (0 = lo, 1 = mid, 2 = hi, the order
// of split_frags' fragments and of the split tiles).
__host__ __device__ constexpr int pass_a(int p) { return p == 0 ? 0 : p == 1 ? 2 : p < 4 ? 1 : 2; }
__host__ __device__ constexpr int pass_b(int p) {
  return p == 0 ? 2 : p == 1 ? 0 : p == 2 ? 1 : p == 3 ? 2 : p == 4 ? 1 : 2;
}
// k-steps of 16 in a score partial: 32 columns of D (all of D = 16).
template <int D>
__host__ __device__ constexpr int steps_per_chunk() { return D < 32 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int score_chunks() { return D / 16 / steps_per_chunk<D>(); }

// Tiles of the forward: BQ query rows a block, BN key rows a streamed tile
// (fewer as D grows: the scores, the split P and O's partial share a
// consumer's registers with O); Q's A fragments in registers at D <= 32.
template <int D>
struct FwdF32 {
  using Blk = WgBlock<(D <= 64 ? 2 : 1), kSplitterRegisters>;
  static constexpr int BQ = Blk::kRows, BN = D <= 32 ? 64 : D == 64 ? 32 : 16;
  static constexpr bool kQRegs = D <= 32;
  static constexpr uint32_t kRawQ = BQ * D * 4, kRaw = BN * D * 4;
  static constexpr uint32_t kPartQ = tile_bytes<D>(BQ), kPart = tile_bytes<D>(BN);
  static constexpr uint32_t kStage = 6 * kPart;  // K's three parts, then V's
  // Q's area (raw for the registers, or split), then the raw ring and the
  // split ring, over which Q's raw tile lies until it is split
  static constexpr uint32_t kQArea = kQRegs ? kRawQ : 3 * kPartQ;
  static constexpr uint32_t kRings = kRawStages * 2 * kRaw + kSplitStages * kStage;
  static constexpr uint32_t kTiles = kQArea + (kQRegs || kRings >= kRawQ ? kRings : kRawQ);
  static constexpr size_t kSmem = kHeadBytes + 1024 + kTiles;
};
// Tiles of dK/dV: BK key rows a block (K and V split once), BM query rows a
// streamed tile (Q, dO, lse, corr).
template <int D>
struct DkvF32 {
  using Blk = WgBlock<(D <= 64 ? 2 : 1), kSplitterRegisters>;
  static constexpr int BK = Blk::kRows, BM = D <= 32 ? 32 : 16;
  static constexpr uint32_t kRawKV = BK * D * 4, kRaw = BM * D * 4;
  static constexpr uint32_t kPartKV = tile_bytes<D>(BK), kPart = tile_bytes<D>(BM);
  static constexpr uint32_t kStage = 6 * kPart;  // Q's three parts, then dO's
  // K's and V's split parts, then the rings, over which their raw tiles lie
  // until they are split
  static constexpr uint32_t kRings = kRawStages * 2 * kRaw + kSplitStages * kStage;
  static constexpr uint32_t kTiles = 6 * kPartKV + (kRings >= 2 * kRawKV ? kRings : 2 * kRawKV);
  static constexpr size_t kSmem = kHeadBytes + 1024 + kTiles;
};

__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The producer warpgroup's own barrier (id 1; __syncthreads is 0).
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWgThreads) : "memory");
}
__device__ __forceinline__ float4 ld_shared4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ float2 ld_shared2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ void st_shared2(uint32_t a, uint32_t x, uint32_t y) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(a), "r"(x), "r"(y) : "memory");
}

// The float32 ROWS x D tile at `raw` (row-major, as TMA writes it without
// swizzle) split into its lo, mid and hi bf16 tiles at dst + p *
// tile_bytes<D>(ROWS), each laid out as TMA lays a bf16 tile: 64-column
// panels, a row of a panel 2 * panel<D>() bytes, and the swizzle of that
// width on the shared address (16-byte chunk bits 4.. XORed with the row
// bits 7..: Swizzle<3,4,3>, <2,4,3>, <1,4,3>), which is what desc_k and
// desc_mn read. split3's own arithmetic. By the producer warpgroup's 128
// threads, four values each at a time: a warp's loads and stores cover whole
// lines, without bank conflicts.
template <int D, int ROWS>
__device__ __forceinline__ void split_tile(uint32_t dst, uint32_t raw, int pt) {
  constexpr int P = panel<D>(), PB = 2 * P, kQuads = ROWS * D / 4;
  constexpr uint32_t kPart = tile_bytes<D>(ROWS);
  constexpr uint32_t kSwizzle = P == 64 ? 0x70 : P == 32 ? 0x30 : 0x10;
  static_assert(kQuads % kWgThreads == 0, "a tile splits evenly over the producer");
#pragma unroll 2
  for (int i = pt; i < kQuads; i += kWgThreads) {
    const float4 x = ld_shared4(raw + 16 * i);
    const int r = i / (D / 4), c = i % (D / 4) * 4;
    uint32_t hi[2], mid[2], lo[2];
    split3(x.x, x.y, hi[0], mid[0], lo[0]);
    split3(x.z, x.w, hi[1], mid[1], lo[1]);
    const uint32_t at = dst + (c / P) * ROWS * PB + r * PB + (c % P) * 2;
    const uint32_t part[3][2] = {{lo[0], lo[1]}, {mid[0], mid[1]}, {hi[0], hi[1]}};
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const uint32_t a = at + p * kPart;
      st_shared2(a ^ ((a >> 3) & kSwizzle), part[p][0], part[p][1]);
    }
  }
}

// acc (a rows x NC accumulator) = x B over the ROWS rows of a split tile,
// its columns hc*NC .. (a panel): x split in registers (split_frags), B's
// three parts at `tile` (tile_bytes<D>(ROWS) apart) read MN-major; six
// passes from zero, each over every k-step (the source note).
template <int D, int ROWS>
__device__ __forceinline__ void out6(float (&acc)[panel<D>() / 2],
                                     const uint32_t (&a)[ROWS / 16][3][4], uint32_t tile, int hc) {
  constexpr uint32_t kPart = tile_bytes<D>(ROWS);
  const uint32_t b = tile + hc * ROWS * 2 * panel<D>();
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
      Wg<panel<D>()>::template rs<1>(acc, a[kk][pass_a(p)],
                                     desc_mn<D, ROWS>(b + pass_b(p) * kPart, kk), kk + p > 0);
}

// O and lse for one query tile (64 rows a consumer warpgroup), streaming K
// and V tiles of FwdF32<D>::BN rows (the source note above).
template <int D, bool kCausal>
__global__ void __launch_bounds__(FwdF32<D>::Blk::kThreads, 1)
flash_fwd_wgmma_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                           float* __restrict__ lse, int T, int H, float scale) {
  using L = FwdF32<D>;
  using Blk = typename L::Blk;
  constexpr int BN = L::BN, BQ = L::BQ, NC = panel<D>(), KPC = steps_per_chunk<D>(),
                NCH = score_chunks<D>();
  extern __shared__ __align__(1024) unsigned char smem[];
  // barriers: q_raw (the copy), q_full (Q split), raw_full[kRawStages],
  // full[kSplitStages], empty[kSplitStages]
  const uint32_t bar0 = smem_addr(smem);
  const uint32_t q_raw = bar0, q_full = bar0 + 8, raw_full = bar0 + 16,
                 full = raw_full + 8 * kRawStages, empty = full + 8 * kSplitStages;
  const uint32_t Qs = tiles_base(smem), Rs = Qs + L::kQArea,
                 Ss = Rs + kRawStages * 2 * L::kRaw;
  const uint32_t Qraw = L::kQRegs ? Qs : Rs;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int n_all = (T + BN - 1) / BN;
  const int n_tiles = kCausal ? min(n_all, (q0 + BQ + BN - 1) / BN) : n_all;

  if (threadIdx.x == 0) {
    mbar_init(q_raw, 1);
    mbar_init(q_full, kWgThreads);  // every producer thread, after its part of the split
    for (int r = 0; r < kRawStages; ++r) mbar_init(raw_full + 8 * r, 1);
    for (int s = 0; s < kSplitStages; ++s) {
      mbar_init(full + 8 * s, kWgThreads);
      mbar_init(empty + 8 * s, Blk::kConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // producer: copies and splits
    producer_registers<Blk>();
    const int pt = threadIdx.x;
    // raw K and V of key tile kt into raw buffer kt % kRawStages
    auto copy_kv = [&](int kt) {
      const int r = kt % kRawStages;
      const uint32_t dst = Rs + r * 2 * L::kRaw;
      mbar_arrive_expect_tx(raw_full + 8 * r, 2 * L::kRaw);
      tma_rows(dst, &tm_k, raw_full + 8 * r, 0, h, kt * BN, b);
      tma_rows(dst + L::kRaw, &tm_v, raw_full + 8 * r, 0, h, kt * BN, b);
    };
    if (pt == 0) {
      mbar_arrive_expect_tx(q_raw, L::kRawQ);
      tma_rows(Qraw, &tm_q, q_raw, 0, h, q0, b);
    }
    if constexpr (!L::kQRegs) {
      mbar_wait(q_raw, 0);
      split_tile<D, BQ>(Qs, Qraw, pt);
      fence_async_proxy();
      mbar_arrive(q_full);
      producer_sync();  // every thread is done with raw Q, which the ring overwrites
    }
    if (pt == 0)
      for (int kt = 0; kt < kRawStages && kt < n_tiles; ++kt) copy_kv(kt);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int r = kt % kRawStages, s = kt % kSplitStages;
      const uint32_t raw = Rs + r * 2 * L::kRaw, split = Ss + s * L::kStage;
      mbar_wait(raw_full + 8 * r, (kt / kRawStages) & 1);
      if (kt >= kSplitStages) mbar_wait(empty + 8 * s, ((kt / kSplitStages) & 1) ^ 1);
      split_tile<D, BN>(split, raw, pt);
      split_tile<D, BN>(split + 3 * L::kPart, raw + L::kRaw, pt);
      fence_async_proxy();  // the split tiles, written here, are read by wgmma
      mbar_arrive(full + 8 * s);
      producer_sync();  // every thread is done with raw buffer r
      if (pt == 0 && kt + kRawStages < n_tiles) copy_kv(kt + kRawStages);
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

    uint32_t qa[L::kQRegs ? D / 16 : 1][3][4];  // Q's A fragments, split in three
    if constexpr (L::kQRegs) {
      mbar_wait(q_raw, 0);
      float x[D / 2];  // rows g, g+8, columns 8j + 2t4, +1: the accumulator layout
      const uint32_t row = Qraw + (64 * c + 16 * warp + g) * D * 4 + 8 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = ld_shared2(row + r * 8 * D * 4 + 32 * j);
          x[4 * j + 2 * r] = v.x;
          x[4 * j + 2 * r + 1] = v.y;
        }
      split_frags(qa, x);
    } else {
      mbar_wait(q_full, 0);
    }

    // S = Q K^T of key tile kt: each 32 columns of D a partial from zero in
    // six bf16 passes, each over the partial's k-steps, K's parts read
    // K-major; one wgmma group
    auto issue_s = [&](float(&sp)[NCH][BN / 2], int kt) {
      const int s = kt % kSplitStages;
      const uint32_t kt_tile = Ss + s * L::kStage;
      mbar_wait(full + 8 * s, (kt / kSplitStages) & 1);
      wg_fence();
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int kk = ch * KPC; kk < (ch + 1) * KPC; ++kk) {
            const uint64_t db = desc_k<D, BN>(kt_tile + pass_b(p) * L::kPart, 0, kk);
            const int acc_in = kk > ch * KPC || p > 0;
            if constexpr (L::kQRegs)
              Wg<BN>::template rs<0>(sp[ch], qa[kk][pass_a(p)], db, acc_in);
            else
              Wg<BN>::template ss<0>(sp[ch], desc_k<D, BQ>(Qs + pass_a(p) * L::kPartQ, 64 * c, kk),
                                     db, acc_in);
          }
      wg_commit();
    };
    // the finished score partials, added in float32 into sp[0]
    auto sum_chunks = [&](float(&sp)[NCH][BN / 2]) {
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) pin(sp[ch]);
#pragma unroll
      for (int ch = 1; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sp[0][i] += sp[ch][i];
    };
    // the tile's P V, columns hc*NC .., from zero; one wgmma group
    auto issue_pv = [&](float(&pv)[NC / 2], const uint32_t(&a)[BN / 16][3][4], int kt, int hc) {
      wg_fence();
      out6<D, BN>(pv, a, Ss + (kt % kSplitStages) * L::kStage + 3 * L::kPart, hc);
      wg_commit();
    };
    // O = O corr + P V, columns hc*NC .., rounded once
    auto add_pv = [&](const float(&pv)[NC / 2], int hc, const float(&cr)[2]) {
#pragma unroll
      for (int i = 0; i < NC / 2; ++i)
        acc[hc * NC / 2 + i] = fmaf(acc[hc * NC / 2 + i], cr[(i >> 1) & 1], pv[i]);
    };
    float sp[NCH][BN / 2], corr[2], pv[NC / 2];
    uint32_t a[BN / 16][3][4];  // P split in three
    issue_s(sp, 0);
    wg_wait<0>();
    sum_chunks(sp);
    sm.step(sp[0], 0, corr);  // O is still zero: its rescale is moot
    for (int kt = 0; kt + 1 < n_tiles; ++kt) {
      split_frags(a, sp[0]);
      const float cr[2] = {corr[0], corr[1]};
      issue_s(sp, kt + 1);  // runs on the tensor cores before this tile's P V
      issue_pv(pv, a, kt, 0);
      wg_wait<1>();  // the next S is done, P V may still run
      sum_chunks(sp);
      sm.step(sp[0], (kt + 1) * BN, corr);
      wg_wait<0>();
      pin(pv);
      add_pv(pv, 0, cr);
#pragma unroll
      for (int hc = 1; hc < D / NC; ++hc) {
        issue_pv(pv, a, kt, hc);
        wg_wait<0>();
        pin(pv);
        add_pv(pv, hc, cr);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (kt % kSplitStages));  // this warp is done with it
    }
    split_frags(a, sp[0]);  // the last tile (its buffer is not refilled)
#pragma unroll
    for (int hc = 0; hc < D / NC; ++hc) {
      issue_pv(pv, a, n_tiles - 1, hc);
      wg_wait<0>();
      pin(pv);
      add_pv(pv, hc, corr);
    }

    sm.template store<D>(acc, o, lse, b, h, H, bh);
  }
}

// dK and dV for one key tile (64 rows a consumer warpgroup), streaming
// query tiles of DkvF32<D>::BM rows from the diagonal on: with the scores
// held transposed (key rows x query columns), P^T = exp(S^T - lse),
// dS^T = P^T * (dP^T + corr), dV += P^T dO and dK += scale * dS^T Q (the
// source note above).
template <int D, bool kCausal>
__global__ void __launch_bounds__(DkvF32<D>::Blk::kThreads, 1)
flash_dkv_wgmma_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse, const float* __restrict__ corr,
                           float* __restrict__ dk, float* __restrict__ dv, int T, int H,
                           float scale) {
  using L = DkvF32<D>;
  using Blk = typename L::Blk;
  constexpr int BM = L::BM, BK = L::BK, NC = panel<D>(), KPC = steps_per_chunk<D>(),
                NCH = score_chunks<D>();
  extern __shared__ __align__(1024) unsigned char smem[];
  // head: kv_raw (the copies), kv_full (K and V split), raw_full[kRawStages],
  // full[kSplitStages], empty[kSplitStages], then the lse and corr rows of
  // each split buffer
  const uint32_t bar0 = smem_addr(smem);
  const uint32_t kv_raw = bar0, kv_full = bar0 + 8, raw_full = bar0 + 16,
                 full = raw_full + 8 * kRawStages, empty = full + 8 * kSplitStages;
  float* Ls = reinterpret_cast<float*>(smem + 256);  // [kSplitStages][BM]
  float* Cs = Ls + kSplitStages * BM;                 // [kSplitStages][BM]
  const uint32_t KVs = tiles_base(smem), Rs = KVs + 6 * L::kPartKV,
                 Ss = Rs + kRawStages * 2 * L::kRaw;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * BK;  // tile 0 visits the most query tiles: first
  const int qt0 = kCausal ? k0 / BM : 0;
  const int n_q = (T + BM - 1) / BM;

  if (threadIdx.x == 0) {
    mbar_init(kv_raw, 1);
    mbar_init(kv_full, kWgThreads);
    for (int r = 0; r < kRawStages; ++r) mbar_init(raw_full + 8 * r, 1);
    for (int s = 0; s < kSplitStages; ++s) {
      mbar_init(full + 8 * s, kWgThreads);            // every producer thread
      mbar_init(empty + 8 * s, Blk::kConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // producer: copies and splits
    producer_registers<Blk>();
    const int pt = threadIdx.x;
    // raw Q and dO of query tile qt0 + it into raw buffer it % kRawStages
    auto copy_q = [&](int it) {
      const int r = it % kRawStages;
      const uint32_t dst = Rs + r * 2 * L::kRaw;
      mbar_arrive_expect_tx(raw_full + 8 * r, 2 * L::kRaw);
      tma_rows(dst, &tm_q, raw_full + 8 * r, 0, h, (qt0 + it) * BM, b);
      tma_rows(dst + L::kRaw, &tm_do, raw_full + 8 * r, 0, h, (qt0 + it) * BM, b);
    };
    if (pt == 0) {  // raw K and V lie over the rings until they are split
      mbar_arrive_expect_tx(kv_raw, 2 * L::kRawKV);
      tma_rows(Rs, &tm_k, kv_raw, 0, h, k0, b);
      tma_rows(Rs + L::kRawKV, &tm_v, kv_raw, 0, h, k0, b);
    }
    mbar_wait(kv_raw, 0);
    split_tile<D, BK>(KVs, Rs, pt);
    split_tile<D, BK>(KVs + 3 * L::kPartKV, Rs + L::kRawKV, pt);
    fence_async_proxy();
    mbar_arrive(kv_full);
    producer_sync();  // every thread is done with raw K and V
    const int n_it = n_q - qt0;
    if (pt == 0)
      for (int it = 0; it < kRawStages && it < n_it; ++it) copy_q(it);
    const float* lse_h = lse + (size_t)bh * T;
    const float* corr_h = corr + (size_t)bh * T;
    for (int it = 0; it < n_it; ++it) {
      const int r = it % kRawStages, s = it % kSplitStages;
      const uint32_t raw = Rs + r * 2 * L::kRaw, split = Ss + s * L::kStage;
      const int t = (qt0 + it) * BM + pt;  // this thread's lse and corr entry, if pt < BM
      const float lv = pt < BM && t < T ? lse_h[t] : 0.f;  // 0 past T (masked)
      const float cv = pt < BM && t < T ? corr_h[t] : 0.f;
      mbar_wait(raw_full + 8 * r, (it / kRawStages) & 1);
      if (it >= kSplitStages) mbar_wait(empty + 8 * s, ((it / kSplitStages) & 1) ^ 1);
      split_tile<D, BM>(split, raw, pt);
      split_tile<D, BM>(split + 3 * L::kPart, raw + L::kRaw, pt);
      if (pt < BM) {
        Ls[s * BM + pt] = lv;
        Cs[s * BM + pt] = cv;
      }
      fence_async_proxy();  // the split tiles, written here, are read by wgmma
      mbar_arrive(full + 8 * s);
      producer_sync();  // every thread is done with raw buffer r
      if (pt == 0 && it + kRawStages < n_it) copy_q(it + kRawStages);
    }
  } else {  // consumers
    consumer_registers<Blk>();
    const int c = threadIdx.x / kWgThreads - 1, tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int kw = k0 + 64 * c + 16 * warp;  // this warp's first key row

    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    // sp = owned rows x streamed tile^T (S^T = K Q^T, dP^T = V dO^T): each
    // 32 columns of D a partial from zero in six bf16 passes, each over the
    // partial's k-steps, both operands' parts K-major; one wgmma group
    auto issue_scores = [&](float(&sp)[NCH][BM / 2], uint32_t owned, uint32_t streamed) {
      wg_fence();
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int kk = ch * KPC; kk < (ch + 1) * KPC; ++kk)
            Wg<BM>::template ss<0>(sp[ch],
                                   desc_k<D, BK>(owned + pass_a(p) * L::kPartKV, 64 * c, kk),
                                   desc_k<D, BM>(streamed + pass_b(p) * L::kPart, 0, kk),
                                   kk > ch * KPC || p > 0);
      wg_commit();
    };
    auto sum_chunks = [&](float(&sp)[NCH][BM / 2]) {
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) pin(sp[ch]);
#pragma unroll
      for (int ch = 1; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) sp[0][i] += sp[ch][i];
    };
    // x B of this tile, columns hc*NC .., from zero; one wgmma group
    auto issue_out = [&](float(&part)[NC / 2], const uint32_t(&a)[BM / 16][3][4],
                         uint32_t tile, int hc) {
      wg_fence();
      out6<D, BM>(part, a, tile, hc);
      wg_commit();
    };
    auto add_out = [](float(&acc)[D / 2], const float(&part)[NC / 2], int hc) {
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) acc[hc * NC / 2 + i] += part[i];
    };

    mbar_wait(kv_full, 0);
    for (int qt = qt0; qt < n_q; ++qt) {
      const int it = qt - qt0, s = it % kSplitStages, q0 = qt * BM;
      const uint32_t Qt = Ss + s * L::kStage, dOt = Qt + 3 * L::kPart;
      const float* Lt = Ls + s * BM;
      const float* Ct = Cs + s * BM;

      float st[NCH][BM / 2], dpt[NCH][BM / 2];
      mbar_wait(full + 8 * s, (it / kSplitStages) & 1);
      issue_scores(st, KVs, Qt);                   // S^T
      issue_scores(dpt, KVs + 3 * L::kPartKV, dOt);  // dP^T

      // P^T = exp(S^T scale - lse) in place of S^T while dP^T runs (columns
      // 2t4, 2t4+1 of each 8 share a float2 of lse), masked where the tile
      // crosses the ragged edge or this warp's rows cross the diagonal (a
      // warp-uniform test). In natural units, the argument rounded once
      // (fma) and expf to 2 ulp: exp2 of a log2-unit argument carries the
      // roundings of lse * log2(e) and scale * log2(e) besides, several
      // times float32's error where T is short
      wg_wait<1>();
      sum_chunks(st);
      float(&sc)[BM / 2] = st[0];
      if (kw + 15 >= T || q0 + BM > T || (kCausal && kw + 15 > q0)) {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) {
          const int kpos = kw + g + 8 * ((i >> 1) & 1);
          const int qpos = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (kpos >= T || qpos >= T || (kCausal && kpos > qpos)) sc[i] = kNegInf;
        }
      }
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = expf(fmaf(sc[4 * j + e], scale, -((e & 1) ? l2.y : l2.x)));
      }
      uint32_t ap[BM / 16][3][4], ads[BM / 16][3][4];  // P^T and dS^T split in three
      split_frags(ap, sc);
      float part[NC / 2];
      // dV += P^T dO, dO's parts read MN-major; dS^T = P^T * (dP^T + corr)
      // in place of dP^T while the first chunk runs
#pragma unroll
      for (int hc = 0; hc < D / NC; ++hc) {
        issue_out(part, ap, dOt, hc);
        if (hc == 0) {
          wg_wait<1>();  // dP^T done
          sum_chunks(dpt);
#pragma unroll
          for (int j = 0; j < BM / 8; ++j) {
            const float2 c2 = *reinterpret_cast<const float2*>(Ct + 8 * j + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[0][4 * j + e] = sc[4 * j + e] * (dpt[0][4 * j + e] + ((e & 1) ? c2.y : c2.x));
          }
          split_frags(ads, dpt[0]);
        }
        wg_wait<0>();
        pin(part);
        add_out(acc_v, part, hc);
      }
      // dK += dS^T Q, Q's parts read MN-major
#pragma unroll
      for (int hc = 0; hc < D / NC; ++hc) {
        issue_out(part, ads, Qt, hc);
        wg_wait<0>();
        pin(part);
        add_out(acc_k, part, hc);
      }
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

// ------------------------------------------------------------------- host
// The tensor map of a contiguous [B, T, H, D] float32 tensor read as raw
// tiles of `rows` whole rows of one head, unswizzled; rows at or beyond T
// arrive as zeros.
template <int D>
cudaError_t raw_map(CUtensorMap* map, const float* x, int B, int T, int H, int rows) {
  return head_rows_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, B, T, H, D, D, rows,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int D, bool kCausal>
cudaError_t run_fwd_wgmma_f32(const float* q, const float* k, const float* v, float* o,
                              float* lse, int B, int T, int H, float scale, cudaStream_t st) {
  using L = FwdF32<D>;
  static const cudaError_t share =
      check_share<typename L::Blk>(flash_fwd_wgmma_f32_kernel<D, kCausal>);
  if (share != cudaSuccess) return share;
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = raw_map<D>(&mq, q, B, T, H, L::BQ)) != cudaSuccess ||
      (err = raw_map<D>(&mk, k, B, T, H, L::BN)) != cudaSuccess ||
      (err = raw_map<D>(&mv, v, B, T, H, L::BN)) != cudaSuccess)
    return err;
  if ((err = allow_smem(flash_fwd_wgmma_f32_kernel<D, kCausal>, L::kSmem)) != cudaSuccess)
    return err;
  flash_fwd_wgmma_f32_kernel<D, kCausal>
      <<<wg_grid(B, T, H, L::BQ), L::Blk::kThreads, L::kSmem, st>>>(mq, mk, mv, o, lse, T, H,
                                                                  scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t run_dkv_wgmma_f32(const float* q, const float* k, const float* v, const float* dout,
                              const float* lse, const float* corr, float* dk, float* dv, int B,
                              int T, int H, float scale, cudaStream_t st) {
  using L = DkvF32<D>;
  static const cudaError_t share =
      check_share<typename L::Blk>(flash_dkv_wgmma_f32_kernel<D, kCausal>);
  if (share != cudaSuccess) return share;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = raw_map<D>(&mq, q, B, T, H, L::BM)) != cudaSuccess ||
      (err = raw_map<D>(&mk, k, B, T, H, L::BK)) != cudaSuccess ||
      (err = raw_map<D>(&mv, v, B, T, H, L::BK)) != cudaSuccess ||
      (err = raw_map<D>(&mdo, dout, B, T, H, L::BM)) != cudaSuccess)
    return err;
  if ((err = allow_smem(flash_dkv_wgmma_f32_kernel<D, kCausal>, L::kSmem)) != cudaSuccess)
    return err;
  flash_dkv_wgmma_f32_kernel<D, kCausal>
      <<<wg_grid(B, T, H, L::BK), L::Blk::kThreads, L::kSmem, st>>>(mq, mk, mv, mdo, lse, corr,
                                                                  dk, dv, T, H, scale);
  return cudaGetLastError();
}

static_assert(FwdF32<128>::kSmem <= 232448 && DkvF32<128>::kSmem <= 232448 &&
                  FwdF32<64>::kSmem <= 232448 && DkvF32<64>::kSmem <= 232448,
              "a block's tiles fit the 227 KB of shared memory a block may use");

}  // namespace
