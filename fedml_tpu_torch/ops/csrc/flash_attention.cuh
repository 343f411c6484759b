// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels on float32
// q, k, v, dO (outputs o, dQ, dK, dV float32; lse and corr float32), behind
// the C entry points of flash_attention.cu. On bf16 inputs the three
// reference kernels are replaced by the wgmma kernels of
// flash_attention_sm90_bf16.cuh (flash_fwd_wgmma_kernel,
// flash_dq_wgmma_kernel, flash_dkv_wgmma_kernel) behind
// flash_attention_bf16.cu; two nvcc processes build the two sources side by
// side.
//
// Replaces the Pallas TPU kernels of fedml_tpu/ops/flash_attention.py on
// float32 inputs:
//   flash_fwd_kernel  <- _fwd_kernel      (:79, launched by _pallas_fwd)
//   flash_dq_kernel   <- _bwd_dq_kernel   (:213, launched by _pallas_bwd, first call)
//   flash_dkv_kernel  <- _bwd_dkv_kernel  (:238, launched by _pallas_bwd, second call)
//
// What bounds them: matrix products, 4*D (forward), 6*D (dQ) and 8*D (dK/dV)
// flops per unmasked (query, key) pair, in two, three and four products per
// tile pair:
//   forward:      S = Q K^T, O += P V (online softmax between them)
//   dQ kernel:    S = Q K^T, dP = dO V^T, dQ += dS K
//   dK/dV kernel: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q
// At the long-context training shape (B*H = 32 heads, T = 2048, D = 32) that
// work exceeds the time to move 34-51 MB of inputs and outputs several
// times over. All three run on the tensor cores, which hold most of the
// card's arithmetic, at float32 accuracy, so their floor is 3xTF32
// tensor-core work (three TF32 products per product at 495 TFLOP/s). Above
// that floor what limits them is instruction issue: most instructions split
// operands, load fragments from shared memory, add partials and apply the
// softmax; about one in ten is an mma. The design:
// - 3xTF32. mma.sync m16n8k8 takes TF32 operands (10-bit mantissa), which
//   alone would put ~1e-3 errors into the outputs. Each f32 operand x is
//   split into big = tf32(x) and small = tf32(x - big), and every product
//   is accumulated in f32 as big*small + small*big + big*big (small*small,
//   ~2^-22 relative, is dropped), at a third of the TF32 rate: ~165 TFLOP/s
//   of f32-accurate work against 67 on the CUDA cores. No product runs as a
//   single TF32 pass. The tensor cores add with truncation, so the sums over
//   the streamed rows (O, dQ, dK, dV) start from zero in each tile and each
//   tile's partial is added into an f32 register sum, rounded (acc_add, or
//   the forward's rescale-and-add). Against a float64 oracle the outputs are
//   then as accurate as the plain f32 version (chip_smoke.py checks it).
// - Scores stay in registers. One block of 4 warps owns a 64-row tile
//   (queries for the forward and dQ, keys for dK/dV), 16 rows per warp. The
//   m16n8 accumulator fragments of S and dP become the A fragments of the
//   next product (P V, dS K, P^T dO, dS^T Q) without a trip through shared
//   memory. An accumulator holds columns (2t, 2t+1) where an A fragment
//   wants (t, t+4), so the contraction index is permuted instead of the
//   registers: logical k = t is physical row 2t and t+4 is 2t+1, and the B
//   rows are loaded in that order (a sum does not depend on its order).
// - Forward's online softmax. A row's scores lie in the 4 lanes of a quad;
//   its running max m is taken across the quad with two shuffles per tile,
//   its running sum l is kept per lane and added across the quad once at
//   the end. Scores are kept in log2 units (scale * log2(e) folded into the
//   scale), so each exponential is one exp2. Per tile: m_new = max(m, rowmax
//   S), corr = exp(m - m_new), P = exp(S - m_new), l = l corr + rowsum P,
//   O = O corr + P V with the tile's P V from zero. Q does not change across
//   key tiles, so for D <= 32 its split A fragments are made once and held
//   in registers (32 of them at D = 32); from D = 64 they would crowd out
//   the O accumulators, and are loaded and split per tile as in dQ.
// - Asynchronous loads. The streamed tiles (K, V in the forward and dQ; Q,
//   dO, lse, corr in dK/dV) arrive by cp.async, 16 bytes a thread,
//   double-buffered, so the next tile's copy runs under this tile's
//   products. Rows are padded to D+4 floats: 16-byte aligned for cp.async,
//   and every fragment load, including those of the operands contracted
//   over a tile's rows (V in P V, K in dS K; dO and Q in dK/dV), hits 32
//   distinct banks.
// - Operands are split per warp. Each warp splits the K and V fragments it
//   loads, so the four warps of a block split every streamed element four
//   times. Splitting each element once per tile into big and small tiles in
//   shared memory removes those repeats but doubles the bytes read from
//   shared memory per fragment and adds a pass and a barrier per tile; tried
//   for the forward, it was slower on the card (PERF.md).
// - Registers and shared memory. Streamed tiles are 64 rows; 32 for dK/dV
//   from D = 64, whose two accumulators need the registers; 16 at D = 128,
//   where the tiles would otherwise fill shared memory for one block per SM.
//   O, dQ, dK and dV are summed tile by tile in passes of at most 32
//   columns.
// - Causal balance. The grid is (B*H, tiles) and blocks are issued x first,
//   so every head's heaviest tile goes first: a query tile i visits i+1 key
//   tiles, so the forward and dQ walk their tiles in reverse; a dK/dV key
//   tile i visits n-i query tiles, so it walks them in order.
// - Why mma.sync and not wgmma here: the bf16 kernels run on wgmma
//   (flash_attention_sm90_bf16.cuh), because wgmma may read a 16-bit B
//   operand transposed (MN-major), so P V, dS K, P^T dO and dS^T Q read V,
//   K, dO and Q as they are stored. For tf32 wgmma takes both operands
//   K-major from shared memory, and those four products contract over a
//   tile's rows, so the float32 kernels would need transposed copies of V,
//   K, dO and Q, and the split big and small tiles, in shared memory.
//   mma.sync loads its fragments per thread in any order. That redesign is
//   later work.
//
// All three kernels skip tiles wholly above the causal diagonal (the TPU
// kernels did the full T^2 work) and mask the ragged edge k >= T here, so the
// caller passes unpadded [B, T, H, D] tensors and no padding copy exists. The
// forward's per-row l is floored at 1e-30 and lse = m + log(l), as in the
// TPU kernel. The dQ / dK,dV split of the TPU version is kept: no atomics,
// and every output element is summed in a fixed order, so results are the
// same bitwise from run to run.
//
// Layouts: q, k, v, o, dO, dQ, dK, dV are contiguous [B, T, H, D]; lse and
// corr (= lse cotangent - rowsum(dO * O)) are contiguous [B, H, T]. The
// kernels need q, k, v and dO to start on a 16-byte boundary (the Python
// wrappers refuse other views) and write o, dQ, dK, dV two values at a time.
// Kernels launch on the caller's stream, allocate nothing, and each C entry
// point returns cudaGetLastError() of its launch.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kOwn = 16 * kWarps;  // rows a block owns: 16 per warp

// Rows of the streamed tiles: 64; 32 for dK/dV from D = 64, whose two
// accumulators would not fit in registers beside 64-row score tiles; 16 at
// D = 128, where the tiles' shared memory would otherwise leave room for one
// block per SM. And the padded row stride of every tile, in floats: a row
// plus 16 bytes.
template <int D, bool kTwoAccumulators>
__host__ __device__ constexpr int stream_rows() {
  return D > 64 ? 16 : (kTwoAccumulators && D > 32) ? 32 : 64;
}
template <int D>
__host__ __device__ constexpr int tile_ld() { return D + 4; }
// Column groups of 8 whose tile partials one pass of the O/dQ/dK/dV product
// holds in registers at once.
template <int D>
__host__ __device__ constexpr int col_groups() { return D / 8 < 4 ? D / 8 : 4; }

// Two neighbouring output values (columns 2t, 2t+1 of an accumulator row).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0+ROWS-1 of one head (src points at element (b, 0, h, 0);
// row t lies at src + t * stride) into a [ROWS][tile_ld] shared tile, 16
// bytes a thread; rows >= T are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void async_rows(float* dst, const float* __restrict__ src, int row0,
                                           int T, int stride) {
  constexpr int kPerChunk = 4, kPerRow = D / kPerChunk, kChunks = ROWS * kPerRow;
  static_assert(kChunks % kThreads == 0, "tile copy must split evenly over the block");
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kPerRow, c = (i % kPerRow) * kPerChunk;
    const int t = row0 + r;
    const bool ok = t < T;
    cp_async16(dst + r * tile_ld<D>() + c, src + (size_t)(ok ? t : 0) * stride + c, ok);
  }
}

// Entries row0 .. row0+ROWS-1 of one [T] row of lse or corr, 4 bytes a thread
// (a row of ragged T need not be 16-byte aligned); entries >= T are zero.
template <int ROWS>
__device__ __forceinline__ void async_vec(float* dst, const float* __restrict__ src, int row0,
                                          int T) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const int t = row0 + i;
    const bool ok = t < T;
    cp_async4(dst + i, src + (ok ? t : 0), ok);
  }
}

// One f32 operand fragment of mma.m16n8k8.tf32, split into big + small.
template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

// x rounded to TF32 (10-bit mantissa), to nearest with ties away from zero:
// cvt.rna.tf32.f32 for finite x, in two integer instructions where cvt takes
// four on sm_90.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));  // x - big is exact in f32
}

template <int N>
__device__ __forceinline__ void split_frag(Frag<N>& f, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], f.big[i], f.small[i]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b at f32 accuracy: big*small + small*big + big*big.
__device__ __forceinline__ void mma_split(float (&c)[4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.big);
}

// The tensor cores add with truncation, not rounding, so a long chain of
// mma into one accumulator drifts (over a 2048-row sum, 10-20x f32's
// error). Sums over the streamed rows are therefore taken one tile at a
// time from zero in the tensor cores, and each tile's partial is added into
// the f32 accumulator here, rounded to nearest.
__device__ __forceinline__ void acc_add(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// A fragment (16 rows x 8 of the contraction) of a row-major [rows][ld] tile
// p, contracted along its columns: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4).
__device__ __forceinline__ void load_a(Frag<4>& f, const float* p, int ld, int g, int t) {
  const float x[4] = {p[g * ld + t], p[(g + 8) * ld + t], p[g * ld + t + 4],
                      p[(g + 8) * ld + t + 4]};
  split_frag(f, x);
}

// B fragment (8 of the contraction x 8 columns) taken from a row-major tile p
// whose ROWS are B's columns (B = p^T, as K in Q K^T): b0 (t, g), b1 (t+4, g).
__device__ __forceinline__ void load_b_trans(Frag<2>& f, const float* p, int ld, int g, int t) {
  const float x[2] = {p[g * ld + t], p[g * ld + t + 4]};
  split_frag(f, x);
}

// B fragment taken from a row-major tile p contracted over its ROWS (as V in
// P V, K in dS K), in the permuted contraction order that matches
// accum_to_a: logical rows t and t+4 are physical rows 2t and 2t+1.
__device__ __forceinline__ void load_b_perm(Frag<2>& f, const float* p, int ld, int g, int t) {
  const float x[2] = {p[2 * t * ld + g], p[(2 * t + 1) * ld + g]};
  split_frag(f, x);
}

// The m16n8 accumulator c (c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
// c3 (g+8, 2t+1)) as the A fragment of a product contracted over its 8
// columns, in the permuted order of load_b_perm. Scores are float32: split.
__device__ __forceinline__ void accum_to_a(Frag<4>& f, const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split_frag(f, x);
}

// O and lse for one 64-row query tile, looping over streamed key tiles with
// an online softmax (source note above).
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int T, int H, float scale) {
  constexpr int LD = tile_ld<D>(), BN = stream_rows<D, false>(), KD = D / 8, NJ = BN / 8,
                KC = col_groups<D>();
  constexpr bool kQInRegs = D <= 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kOwn * LD;  // [2][BN][LD]
  float* Vs = Ks + 2 * BN * LD;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;  // heaviest causal tiles first
  const int stride = H * D;
  const size_t base = ((size_t)b * T * H + h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;  // this warp's rows of the tile
  const float scale2 = scale * kLog2e;  // scores in log2 units

  async_rows<D, kOwn>(Qs, q + base, q0, T, stride);
  cp_async_commit();
  async_rows<D, BN>(Ks, k + base, 0, T, stride);
  async_rows<D, BN>(Vs, v + base, 0, T, stride);
  cp_async_commit();

  Frag<4> qf[kQInRegs ? KD : 1];
  if constexpr (kQInRegs) {
    cp_async_wait<1>();  // Q only
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) load_a(qf[kd], Qs + r0 * LD + kd * 8, LD, g, t4);
  }

  // rows g and g+8 of this warp: running max (log2 units) and this lane's
  // part of the running sum
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int n_all = (T + BN - 1) / BN;
  const int n_tiles = kCausal ? min(n_all, (q0 + kOwn + BN - 1) / BN) : n_all;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_tiles) {  // the next tile's copy runs under this tile's products
      async_rows<D, BN>(Ks + (cur ^ 1) * BN * LD, k + base, (kt + 1) * BN, T, stride);
      async_rows<D, BN>(Vs + (cur ^ 1) * BN * LD, v + base, (kt + 1) * BN, T, stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + cur * BN * LD;
    const float* Vt = Vs + cur * BN * LD;
    const int k0 = kt * BN;

    // S = Q K^T, summed from zero in the tensor cores over each 32 columns
    // of D, the chunks added in f32: one chain of truncating adds over all
    // of D = 64 or 128 would bias the scores, and so lse, toward zero
    float s[NJ][4];
#pragma unroll
    for (int c0 = 0; c0 < KD; c0 += 4) {
      float part[NJ][4] = {};
#pragma unroll
      for (int kd = c0; kd < c0 + 4 && kd < KD; ++kd) {
        Frag<4> aq;
        if constexpr (kQInRegs) {
          aq = qf[kd];
        } else {
          load_a(aq, Qs + r0 * LD + kd * 8, LD, g, t4);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          Frag<2> bk;
          load_b_trans(bk, Kt + j * 8 * LD + kd * 8, LD, g, t4);
          mma_split(part[j], aq, bk);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (c0 == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = part[j][e];
        } else {
          acc_add(s[j], part[j]);
        }
      }
    }

    // scale, and mask where the tile crosses the ragged edge or, for this
    // warp's rows, the causal diagonal (a warp-uniform test)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    if (k0 + BN > T || (kCausal && k0 + BN - 1 > q0 + r0)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + r0 + g + 8 * (e >> 1);
          const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
          if (kpos >= T || (kCausal && kpos > qpos)) s[j][e] = kNegInf;
        }
    }

    // online softmax: P in place of S
    float corr[2], mx[2] = {kNegInf, kNegInf}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      corr[i] = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_r[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + rs[i];

    // O = O corr + P V, the tile's P V summed from zero in the tensor cores
#pragma unroll
    for (int n1 = 0; n1 < KD; n1 += KC) {
      float part[KC][4] = {};
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        Frag<4> ap;
        accum_to_a(ap, s[kk]);
#pragma unroll
        for (int nd = 0; nd < KC; ++nd) {
          Frag<2> bv;
          load_b_perm(bv, Vt + kk * 8 * LD + (n1 + nd) * 8, LD, g, t4);
          mma_split(part[nd], ap, bv);
        }
      }
#pragma unroll
      for (int nd = 0; nd < KC; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n1 + nd][e] *= corr[e >> 1];
#pragma unroll
      for (int nd = 0; nd < KC; ++nd) acc_add(acc[n1 + nd], part[nd]);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];  // the quad's four parts of the row sum
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int t = q0 + r0 + g + 8 * i;
    if (t < T) {
      const float l_safe = fmaxf(l, 1e-30f);
      float* row = o + base + (size_t)t * stride + 2 * t4;
#pragma unroll
      for (int nd = 0; nd < KD; ++nd)
        store2(row + nd * 8, acc[nd][2 * i] / l_safe, acc[nd][2 * i + 1] / l_safe);
      if (t4 == 0) lse[(size_t)bh * T + t] = m_r[i] * kLn2 + logf(l_safe);
    }
  }
}

// dQ for one 64-row query tile: P = exp(S - lse), dS = P * (dO V^T + corr),
// dQ = scale * dS K, looping over streamed key tiles.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ corr,
                float* __restrict__ dq, int T, int H, float scale) {
  constexpr int LD = tile_ld<D>(), BN = stream_rows<D, false>(), KD = D / 8, NJ = BN / 8,
                KC = col_groups<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + kOwn * LD;
  float* Ks = dOs + kOwn * LD;  // [2][BN][LD]
  float* Vs = Ks + 2 * BN * LD;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;  // heaviest causal tiles first
  const int stride = H * D;
  const size_t base = ((size_t)b * T * H + h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;  // this warp's rows of the tile

  async_rows<D, kOwn>(Qs, q + base, q0, T, stride);
  async_rows<D, kOwn>(dOs, dout + base, q0, T, stride);
  async_rows<D, BN>(Ks, k + base, 0, T, stride);
  async_rows<D, BN>(Vs, v + base, 0, T, stride);
  cp_async_commit();

  float lse_r[2], c_r[2];  // rows g and g+8 of this warp
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + g + 8 * i;
    lse_r[i] = t < T ? lse[(size_t)bh * T + t] : 0.f;
    c_r[i] = t < T ? corr[(size_t)bh * T + t] : 0.f;
  }
  float acc[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int n_all = (T + BN - 1) / BN;
  const int n_tiles = kCausal ? min(n_all, (q0 + kOwn + BN - 1) / BN) : n_all;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_tiles) {  // the next tile's copy runs under this tile's products
      async_rows<D, BN>(Ks + (cur ^ 1) * BN * LD, k + base, (kt + 1) * BN, T, stride);
      async_rows<D, BN>(Vs + (cur ^ 1) * BN * LD, v + base, (kt + 1) * BN, T, stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + cur * BN * LD;
    const float* Vt = Vs + cur * BN * LD;
    const int k0 = kt * BN;

    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      Frag<4> aq, ado;
      load_a(aq, Qs + r0 * LD + kd * 8, LD, g, t4);
      load_a(ado, dOs + r0 * LD + kd * 8, LD, g, t4);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        Frag<2> bk, bv;
        load_b_trans(bk, Kt + j * 8 * LD + kd * 8, LD, g, t4);
        load_b_trans(bv, Vt + j * 8 * LD + kd * 8, LD, g, t4);
        mma_split(s[j], aq, bk);
        mma_split(dp[j], ado, bv);
      }
    }

    // dS = P * (dP + corr), in place of dP
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + r0 + g + 8 * (e >> 1);
        const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
        const bool ok = kpos < T && (!kCausal || kpos <= qpos);
        const float p = expf((ok ? s[j][e] * scale : kNegInf) - lse_r[e >> 1]);
        dp[j][e] = p * (dp[j][e] + c_r[e >> 1]);
      }

#pragma unroll
    for (int n1 = 0; n1 < KD; n1 += KC) {
      float part[KC][4] = {};
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        Frag<4> ads;
        accum_to_a(ads, dp[kk]);
#pragma unroll
        for (int nd = 0; nd < KC; ++nd) {
          Frag<2> bk;
          load_b_perm(bk, Kt + kk * 8 * LD + (n1 + nd) * 8, LD, g, t4);
          mma_split(part[nd], ads, bk);
        }
      }
#pragma unroll
      for (int nd = 0; nd < KC; ++nd) acc_add(acc[n1 + nd], part[nd]);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + g + 8 * i;
    if (t < T) {
      float* row = dq + base + (size_t)t * stride + 2 * t4;
#pragma unroll
      for (int nd = 0; nd < KD; ++nd)
        store2(row + nd * 8, acc[nd][2 * i] * scale, acc[nd][2 * i + 1] * scale);
    }
  }
}

// dK, dV for one 64-row key tile, looping over streamed query tiles: with the
// scores held transposed (key rows x query cols), dV += P^T dO and
// dK += scale * dS^T Q.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ corr,
                 float* __restrict__ dk, float* __restrict__ dv, int T, int H, float scale) {
  constexpr int LD = tile_ld<D>(), BN = stream_rows<D, true>(), KD = D / 8, NJ = BN / 8,
                KC = col_groups<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kOwn * LD;
  float* Qs = Vs + kOwn * LD;     // [2][BN][LD]
  float* dOs = Qs + 2 * BN * LD;  // [2][BN][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BN * LD);  // [2][BN]
  float* Cs = Ls + 2 * BN;                                   // [2][BN]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kOwn;  // tile 0 visits the most query tiles: first
  const int stride = H * D;
  const size_t base = ((size_t)b * T * H + h) * D;
  const float* lse_h = lse + (size_t)bh * T;
  const float* corr_h = corr + (size_t)bh * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;

  // causal: the first query tile holding a query at or after this tile's first key
  const int qt0 = kCausal ? k0 / BN : 0;
  const int n_tiles = (T + BN - 1) / BN;
  async_rows<D, kOwn>(Ks, k + base, k0, T, stride);
  async_rows<D, kOwn>(Vs, v + base, k0, T, stride);
  async_rows<D, BN>(Qs, q + base, qt0 * BN, T, stride);
  async_rows<D, BN>(dOs, dout + base, qt0 * BN, T, stride);
  async_vec<BN>(Ls, lse_h, qt0 * BN, T);
  async_vec<BN>(Cs, corr_h, qt0 * BN, T);
  cp_async_commit();

  float acc_k[KD][4], acc_v[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nd][e] = acc_v[nd][e] = 0.f;

  for (int qt = qt0; qt < n_tiles; ++qt) {
    const int cur = (qt - qt0) & 1, nxt = cur ^ 1;
    if (qt + 1 < n_tiles) {
      const int q1 = (qt + 1) * BN;
      async_rows<D, BN>(Qs + nxt * BN * LD, q + base, q1, T, stride);
      async_rows<D, BN>(dOs + nxt * BN * LD, dout + base, q1, T, stride);
      async_vec<BN>(Ls + nxt * BN, lse_h, q1, T);
      async_vec<BN>(Cs + nxt * BN, corr_h, q1, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + cur * BN * LD;
    const float* dOt = dOs + cur * BN * LD;
    const float* Lt = Ls + cur * BN;
    const float* Ct = Cs + cur * BN;
    const int q0 = qt * BN;

    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      Frag<4> ak, av;
      load_a(ak, Ks + r0 * LD + kd * 8, LD, g, t4);
      load_a(av, Vs + r0 * LD + kd * 8, LD, g, t4);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        Frag<2> bq, bdo;
        load_b_trans(bq, Qt + j * 8 * LD + kd * 8, LD, g, t4);
        load_b_trans(bdo, dOt + j * 8 * LD + kd * 8, LD, g, t4);
        mma_split(s[j], ak, bq);
        mma_split(dp[j], av, bdo);
      }
    }

    // P^T in place of S^T, dS^T = P^T * (dP^T + corr) in place of dP^T
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + r0 + g + 8 * (e >> 1);
        const int c = j * 8 + 2 * t4 + (e & 1);
        const int qpos = q0 + c;
        const bool ok = kpos < T && qpos < T && (!kCausal || kpos <= qpos);
        const float p = expf((ok ? s[j][e] * scale : kNegInf) - Lt[c]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] + Ct[c]);
      }

#pragma unroll
    for (int n1 = 0; n1 < KD; n1 += KC) {
      float part_v[KC][4] = {}, part_k[KC][4] = {};
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        Frag<4> ap, ads;
        accum_to_a(ap, s[kk]);
        accum_to_a(ads, dp[kk]);
#pragma unroll
        for (int nd = 0; nd < KC; ++nd) {
          Frag<2> bdo, bq;
          load_b_perm(bdo, dOt + kk * 8 * LD + (n1 + nd) * 8, LD, g, t4);
          load_b_perm(bq, Qt + kk * 8 * LD + (n1 + nd) * 8, LD, g, t4);
          mma_split(part_v[nd], ap, bdo);
          mma_split(part_k[nd], ads, bq);
        }
      }
#pragma unroll
      for (int nd = 0; nd < KC; ++nd) {
        acc_add(acc_v[n1 + nd], part_v[nd]);
        acc_add(acc_k[n1 + nd], part_k[nd]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + r0 + g + 8 * i;
    if (t < T) {
      const size_t off = base + (size_t)t * stride + 2 * t4;
#pragma unroll
      for (int nd = 0; nd < KD; ++nd) {
        store2(dk + off + nd * 8, acc_k[nd][2 * i] * scale, acc_k[nd][2 * i + 1] * scale);
        store2(dv + off + nd * 8, acc_v[nd][2 * i], acc_v[nd][2 * i + 1]);
      }
    }
  }
}

// Shared memory above 48 KB must be opted into per kernel before its launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The grid is (B*H, tiles): blocks issue x first, so the tiles that do the
// most causal work go first for every head.
inline dim3 tile_grid(int B, int T, int H) { return dim3(B * H, (T + kOwn - 1) / kOwn); }

// kOwned owned tiles and two double-buffered streamed tiles.
template <int D, int kOwned, int kStreamRows>
constexpr size_t tiles_smem() {
  return (kOwned * kOwn + 4 * kStreamRows) * tile_ld<D>() * sizeof(float);
}

template <int D, bool kCausal>
cudaError_t run_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B,
                    int T, int H, float scale, cudaStream_t st) {
  const size_t smem = tiles_smem<D, 1, stream_rows<D, false>()>();
  cudaError_t err = allow_smem(flash_fwd_kernel<D, kCausal>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D, kCausal><<<tile_grid(B, T, H), kThreads, smem, st>>>(q, k, v, o, lse, T,
                                                                           H, scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t run_dq(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* corr, float* dq, int B, int T, int H,
                   float scale, cudaStream_t st) {
  const size_t smem = tiles_smem<D, 2, stream_rows<D, false>()>();
  cudaError_t err = allow_smem(flash_dq_kernel<D, kCausal>, smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<D, kCausal><<<tile_grid(B, T, H), kThreads, smem, st>>>(
      q, k, v, dout, lse, corr, dq, T, H, scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t run_dkv(const float* q, const float* k, const float* v, const float* dout,
                    const float* lse, const float* corr, float* dk, float* dv, int B, int T,
                    int H, float scale, cudaStream_t st) {
  // + lse and corr, double-buffered
  constexpr int BN = stream_rows<D, true>();
  const size_t smem = tiles_smem<D, 2, BN>() + 4 * BN * sizeof(float);
  cudaError_t err = allow_smem(flash_dkv_kernel<D, kCausal>, smem);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<D, kCausal><<<tile_grid(B, T, H), kThreads, smem, st>>>(
      q, k, v, dout, lse, corr, dk, dv, T, H, scale);
  return cudaGetLastError();
}

}  // namespace

// Instantiate RUN<D, causal> for the head dims the kernels support.
#define FLASH_DISPATCH(RUN, ...)                                                   \
  switch (D) {                                                                     \
    case 16: return causal ? RUN<16, true>(__VA_ARGS__) : RUN<16, false>(__VA_ARGS__); \
    case 32: return causal ? RUN<32, true>(__VA_ARGS__) : RUN<32, false>(__VA_ARGS__); \
    case 64: return causal ? RUN<64, true>(__VA_ARGS__) : RUN<64, false>(__VA_ARGS__); \
    case 128:                                                                      \
      return causal ? RUN<128, true>(__VA_ARGS__) : RUN<128, false>(__VA_ARGS__);  \
    default: return cudaErrorInvalidValue;                                         \
  }

// The three C entry points for element type E, named NAME_fwd, NAME_bwd_dq
// and NAME_bwd_dkv, over the run functions FWD, DQ and DKV.
#define FLASH_ENTRY_POINTS(NAME, E, FWD, DQ, DKV)                                          \
  extern "C" int NAME##_fwd(const E* q, const E* k, const E* v, E* o, float* lse, int B,   \
                            int T, int H, int D, int causal, float scale, void* stream) {  \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);                             \
    FLASH_DISPATCH(FWD, q, k, v, o, lse, B, T, H, scale, st)                               \
  }                                                                                        \
  extern "C" int NAME##_bwd_dq(const E* q, const E* k, const E* v, const E* dout,          \
                               const float* lse, const float* corr, E* dq, int B, int T,   \
                               int H, int D, int causal, float scale, void* stream) {      \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);                             \
    FLASH_DISPATCH(DQ, q, k, v, dout, lse, corr, dq, B, T, H, scale, st)                   \
  }                                                                                        \
  extern "C" int NAME##_bwd_dkv(const E* q, const E* k, const E* v, const E* dout,         \
                                const float* lse, const float* corr, E* dk, E* dv, int B,  \
                                int T, int H, int D, int causal, float scale,              \
                                void* stream) {                                            \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);                             \
    FLASH_DISPATCH(DKV, q, k, v, dout, lse, corr, dk, dv, B, T, H, scale, st)              \
  }
