// The float32 flash dQ kernel for Hopper (sm_90a), flash_dq_kernel on
// mma.sync, behind the C entry point flash_attention_bwd_dq
// (flash_attention.cu); and what every flash kernel of the port shares: the
// mask value, the log2 constants, the dispatch over head dims and the C entry
// points' macro. It replaces the Pallas TPU kernel _bwd_dq_kernel
// (fedml_tpu/ops/flash_attention.py:213, the first call of _pallas_bwd) on
// float32 inputs. The float32 forward and dK/dV run on wgmma
// (flash_attention_sm90_f32.cuh), all three bf16 kernels too
// (flash_attention_sm90_bf16.cuh).
//
// What bounds it: matrix products, 6*D flops per unmasked (query, key) pair
// in three products per tile pair: S = Q K^T, dP = dO V^T, dQ += dS K. At
// the long-context training shape (B*H = 128 heads, T = 2048, D = 32) that
// work exceeds the time to move its inputs and output several times over.
// It runs on the tensor cores, at float32 accuracy, so its floor is 3xTF32
// tensor-core work (three TF32 products per product at 495 TFLOP/s). Above
// that floor what limits it is instruction issue: most instructions split
// operands, load fragments from shared memory, add partials and apply the
// softmax; about one in ten is an mma. The design:
// - 3xTF32. mma.sync m16n8k8 takes TF32 operands (10-bit mantissa), which
//   alone would put ~1e-3 errors into the outputs. Each f32 operand x is
//   split into big = tf32(x) and small = tf32(x - big), and every product
//   is accumulated in f32 as big*small + small*big + big*big (small*small,
//   ~2^-22 relative, is dropped), at a third of the TF32 rate: ~165 TFLOP/s
//   of f32-accurate work against 67 on the CUDA cores. No product runs as a
//   single TF32 pass. The tensor cores add with truncation, so the sum over
//   the streamed rows (dQ) starts from zero in each tile and each tile's
//   partial is added into an f32 register sum, rounded (acc_add). Against a
//   float64 oracle the output is then as accurate as the plain f32 version
//   (chip_smoke.py checks it).
// - Scores stay in registers. One block of 4 warps owns a 64-row query tile,
//   16 rows per warp. The m16n8 accumulator fragments of dP become the A
//   fragments of dS K without a trip through shared memory. An accumulator
//   holds columns (2t, 2t+1) where an A fragment wants (t, t+4), so the
//   contraction index is permuted instead of the registers: logical k = t is
//   physical row 2t and t+4 is 2t+1, and K's rows are loaded in that order
//   (a sum does not depend on its order).
// - Asynchronous loads. The streamed K and V tiles arrive by cp.async, 16
//   bytes a thread, double-buffered, so the next tile's copy runs under this
//   tile's products. Rows are padded to D+4 floats: 16-byte aligned for
//   cp.async, and every fragment load, K's in dS K included, hits 32
//   distinct banks.
// - Operands are split per warp: each warp splits the K and V fragments it
//   loads, so the four warps of a block split every streamed element four
//   times.
// - Registers and shared memory. Streamed tiles are 64 rows, 16 at D = 128,
//   where they would otherwise fill shared memory for one block per SM. dQ
//   is summed tile by tile in passes of at most 32 columns.
// - Causal balance. The grid is (B*H, tiles) and blocks are issued x first,
//   so every head's heaviest tile goes first: a query tile i visits i+1 key
//   tiles, so the blocks walk the query tiles in reverse.
// - Why mma.sync and not wgmma here: the float32 forward and dK/dV run on
//   wgmma on operands split into three bf16 parts, six passes a product
//   (flash_attention_sm90_f32.cuh's note says why that recipe and not TF32);
//   dQ is to follow on the same design.
//
// The kernel skips tiles wholly above the causal diagonal (the TPU kernel
// did the full T^2 work) and masks the ragged edge k >= T here, so the
// caller passes unpadded [B, T, H, D] tensors and no padding copy exists.
// The dQ / dK,dV split of the TPU version is kept: no atomics, and every
// output element is summed in a fixed order, so results are the same
// bitwise from run to run.
//
// Layouts: q, k, v, dO, dQ are contiguous [B, T, H, D]; lse and corr
// (= lse cotangent - rowsum(dO * O)) are contiguous [B, H, T]. The kernel
// needs q, k, v and dO to start on a 16-byte boundary (the Python wrappers
// refuse other views) and writes dQ two values at a time. Kernels launch on
// the caller's stream, allocate nothing, and each C entry point returns
// cudaGetLastError() of its launch.

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

// Rows of the streamed tiles: 64; 16 at D = 128, where the tiles' shared
// memory would otherwise leave room for one block per SM. And the padded row
// stride of every tile, in floats: a row plus 16 bytes.
template <int D>
__host__ __device__ constexpr int stream_rows() { return D > 64 ? 16 : 64; }
template <int D>
__host__ __device__ constexpr int tile_ld() { return D + 4; }
// Column groups of 8 whose tile partials one pass of the dQ product holds in
// registers at once.
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

// dQ for one 64-row query tile: P = exp(S - lse), dS = P * (dO V^T + corr),
// dQ = scale * dS K, looping over streamed key tiles.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ corr,
                float* __restrict__ dq, int T, int H, float scale) {
  constexpr int LD = tile_ld<D>(), BN = stream_rows<D>(), KD = D / 8, NJ = BN / 8,
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

// Shared memory above 48 KB must be opted into per kernel before its launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The grid is (B*H, tiles): blocks issue x first, so the tiles that do the
// most causal work go first for every head.
inline dim3 tile_grid(int B, int T, int H) { return dim3(B * H, (T + kOwn - 1) / kOwn); }

// The owned Q and dO tiles and the double-buffered streamed K and V tiles.
template <int D>
constexpr size_t dq_smem() {
  return (2 * kOwn + 4 * stream_rows<D>()) * tile_ld<D>() * sizeof(float);
}

template <int D, bool kCausal>
cudaError_t run_dq(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* corr, float* dq, int B, int T, int H,
                   float scale, cudaStream_t st) {
  const size_t smem = dq_smem<D>();
  cudaError_t err = allow_smem(flash_dq_kernel<D, kCausal>, smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<D, kCausal><<<tile_grid(B, T, H), kThreads, smem, st>>>(
      q, k, v, dout, lse, corr, dq, T, H, scale);
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
