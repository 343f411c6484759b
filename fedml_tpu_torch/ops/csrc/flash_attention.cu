// Flash attention for Hopper (sm_90a), float32: forward, dQ and dK/dV kernels.
//
// Replaces the Pallas TPU kernels of fedml_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _fwd_kernel      (launched by _pallas_fwd)
//   flash_dq_kernel   <- _bwd_dq_kernel   (launched by _pallas_bwd, first call)
//   flash_dkv_kernel  <- _bwd_dkv_kernel  (launched by _pallas_bwd, second call)
//
// What bounds them: arithmetic. At the long-context training shape
// (B*H = 32 heads, T = 2048, D = 32) the forward does 4*D flops per unmasked
// (query, key) pair and reads ~34 MB, so f32 FMA work exceeds the memory time
// by an order of magnitude. The TPU kernels ran scores on the MXU; this first
// Hopper version stays in f32 on the CUDA cores (no TF32 / wgmma), so the
// results match the f32 reference to ~1e-6, and its real limiter is the
// shared-memory load rate feeding those FMAs.
//
// What the design does about it:
// - one block of 256 threads owns a 64-row tile (queries for fwd/dQ, keys for
//   dK/dV) and loops over the other operand in 64-row tiles staged through
//   shared memory; rows are padded to D+1 floats so column walks hit distinct
//   banks;
// - each thread keeps a 4x4 register micro-tile of scores (rows ty+16i, cols
//   tx+16j), so each shared-memory value it loads feeds four FMAs; row maxima
//   and sums of the online softmax are reduced with 16-lane shuffles and never
//   leave registers;
// - tiles that lie wholly above the causal diagonal are skipped (the TPU
//   kernels did the full T^2 work); the ragged edge k >= T is masked here, so
//   the caller passes unpadded [B, T, H, D] tensors and no padding copy exists;
// - the dQ / dK,dV split of the TPU version is kept: no atomics, and every
//   output element is summed in a fixed order, so results are deterministic.
//
// Layouts: q, k, v, o, dO, dQ, dK, dV are contiguous [B, T, H, D]; lse and
// corr (= lse cotangent - rowsum(dO * O)) are contiguous [B, H, T]. Kernels
// launch on the caller's stream, allocate nothing, and each C entry point
// returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBlock = 64;         // rows per tile, both operands
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 scores each
constexpr int kLdS = kBlock + 1;   // padded stride of score tiles in shared memory
constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows row0 .. row0+63 of one head (src points at element (b, 0, h, 0); row t
// lies at src + t * stride) into a [64][D+1] shared tile; rows >= T are zero.
template <int D>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const float* __restrict__ src,
                                          int row0, int T, int stride) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = row0 + r;
    dst[r * (D + 1) + d] = t < T ? src[(size_t)t * stride + d] : 0.f;
  }
}

// Key tiles a 64-row query tile starting at q0 must visit.
template <bool kCausal>
__device__ __forceinline__ int key_tiles(int q0, int T) {
  const int n = (T + kBlock - 1) / kBlock;
  return kCausal ? min(n, (q0 + kBlock - 1) / kBlock + 1) : n;
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int T, int H, float scale) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlock * LD;
  float* Vs = Ks + kBlock * LD;
  float* Ps = Vs + kBlock * LD;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBlock;
  const int stride = H * D;
  const size_t base = ((size_t)b * T * H + h) * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows<D>(Qs, q + base, q0, T, stride);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }

  const int n_tiles = key_tiles<kCausal>(q0, T);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(Ks, k + base, k0, T, stride);
    load_rows<D>(Vs, v + base, k0, T, stride);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < T && (!kCausal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group16_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      rs = group16_sum(rs);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) acc[i][jd] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kLdS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < kBlock; ++n) {
      float a[4], c[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[(ty + 16 * i) * kLdS + n];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) c[jd] = Vs[n * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = fmaf(a[i], c[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t < T) {
      const float l_safe = fmaxf(l[i], 1e-30f);
      float* orow = o + base + (size_t)t * stride;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) orow[tx + 16 * jd] = acc[i][jd] / l_safe;
      if (tx == 0) lse[(size_t)bh * T + t] = m[i] + logf(l_safe);
    }
  }
}

// dQ for one 64-row query tile: P = exp(S - lse), dS = P * (dO V^T + corr),
// dQ = scale * dS K, looping over key tiles.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ corr,
                float* __restrict__ dq, int T, int H, float scale) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBlock * LD;
  float* Ks = dOs + kBlock * LD;
  float* Vs = Ks + kBlock * LD;
  float* Ds = Vs + kBlock * LD;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBlock;
  const int stride = H * D;
  const size_t base = ((size_t)b * T * H + h) * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows<D>(Qs, q + base, q0, T, stride);
  load_rows<D>(dOs, dout + base, q0, T, stride);

  float lse_r[4], c_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    lse_r[i] = t < T ? lse[(size_t)bh * T + t] : 0.f;
    c_r[i] = t < T ? corr[(size_t)bh * T + t] : 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }

  const int n_tiles = key_tiles<kCausal>(q0, T);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();
    load_rows<D>(Ks, k + base, k0, T, stride);
    load_rows<D>(Vs, v + base, k0, T, stride);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], kc[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * LD + d];
        g[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j] = Ks[(tx + 16 * j) * LD + d];
        vc[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vc[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < T && (!kCausal || kpos <= qpos);
        const float p = expf((ok ? s[i][j] * scale : kNegInf) - lse_r[i]);
        Ds[(ty + 16 * i) * kLdS + tx + 16 * j] = p * (dp[i][j] + c_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < kBlock; ++n) {
      float a[4], c[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ds[(ty + 16 * i) * kLdS + n];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) c[jd] = Ks[n * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = fmaf(a[i], c[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t < T) {
      float* row = dq + base + (size_t)t * stride;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) row[tx + 16 * jd] = acc[i][jd] * scale;
    }
  }
}

// dK, dV for one 64-row key tile, looping over query tiles: with the scores
// held transposed (key rows x query cols), dV += P^T dO and
// dK += scale * dS^T Q.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ corr,
                 float* __restrict__ dk, float* __restrict__ dv, int T, int H,
                 float scale) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlock * LD;
  float* Qs = Vs + kBlock * LD;
  float* dOs = Qs + kBlock * LD;
  float* Ps = dOs + kBlock * LD;
  float* Ds = Ps + kBlock * kLdS;
  float* Ls = Ds + kBlock * kLdS;
  float* Cs = Ls + kBlock;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kBlock;
  const int stride = H * D;
  const size_t base = ((size_t)b * T * H + h) * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows<D>(Ks, k + base, k0, T, stride);
  load_rows<D>(Vs, v + base, k0, T, stride);

  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc_k[i][jd] = acc_v[i][jd] = 0.f;

  const int n_tiles = (T + kBlock - 1) / kBlock;
  // causal: the first query tile holding a query at or after this tile's first key
  for (int qt = kCausal ? k0 / kBlock : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();
    load_rows<D>(Qs, q + base, q0, T, stride);
    load_rows<D>(dOs, dout + base, q0, T, stride);
    for (int r = threadIdx.x; r < kBlock; r += kThreads) {
      const int t = q0 + r;
      Ls[r] = t < T ? lse[(size_t)bh * T + t] : 0.f;
      Cs[r] = t < T ? corr[(size_t)bh * T + t] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qc[4], gc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = Ks[(ty + 16 * i) * LD + d];
        va[i] = Vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qc[j] = Qs[(tx + 16 * j) * LD + d];
        gc[j] = dOs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(ka[i], qc[j], s[i][j]);
          dp[i][j] = fmaf(va[i], gc[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qpos = q0 + c;
        const bool ok = kpos < T && qpos < T && (!kCausal || kpos <= qpos);
        const float p = expf((ok ? s[i][j] * scale : kNegInf) - Ls[c]);
        Ps[(ty + 16 * i) * kLdS + c] = p;
        Ds[(ty + 16 * i) * kLdS + c] = p * (dp[i][j] + Cs[c]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < kBlock; ++n) {
      float pa[4], da[4], gc[DJ], qc[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = Ps[(ty + 16 * i) * kLdS + n];
        da[i] = Ds[(ty + 16 * i) * kLdS + n];
      }
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) {
        gc[jd] = dOs[n * LD + tx + 16 * jd];
        qc[jd] = Qs[n * LD + tx + 16 * jd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd) {
          acc_v[i][jd] = fmaf(pa[i], gc[jd], acc_v[i][jd]);
          acc_k[i][jd] = fmaf(da[i], qc[jd], acc_k[i][jd]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t < T) {
      float* krow = dk + base + (size_t)t * stride;
      float* vrow = dv + base + (size_t)t * stride;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) {
        krow[tx + 16 * jd] = acc_k[i][jd] * scale;
        vrow[tx + 16 * jd] = acc_v[i][jd];
      }
    }
  }
}

// Shared memory above 48 KB must be opted into per kernel before its launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

dim3 tile_grid(int B, int T, int H) { return dim3((T + kBlock - 1) / kBlock, B * H); }

template <int D, bool kCausal>
cudaError_t run_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                    int B, int T, int H, float scale, cudaStream_t st) {
  const size_t smem = (3 * kBlock * (D + 1) + kBlock * kLdS) * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<D, kCausal>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D, kCausal><<<tile_grid(B, T, H), kThreads, smem, st>>>(q, k, v, o, lse, T, H,
                                                                           scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t run_dq(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* corr, float* dq, int B, int T, int H,
                   float scale, cudaStream_t st) {
  const size_t smem = (4 * kBlock * (D + 1) + kBlock * kLdS) * sizeof(float);
  cudaError_t err = allow_smem(flash_dq_kernel<D, kCausal>, smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<D, kCausal><<<tile_grid(B, T, H), kThreads, smem, st>>>(q, k, v, dout, lse, corr,
                                                                          dq, T, H, scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t run_dkv(const float* q, const float* k, const float* v, const float* dout,
                    const float* lse, const float* corr, float* dk, float* dv, int B, int T,
                    int H, float scale, cudaStream_t st) {
  const size_t smem = (4 * kBlock * (D + 1) + 2 * kBlock * kLdS + 2 * kBlock) * sizeof(float);
  cudaError_t err = allow_smem(flash_dkv_kernel<D, kCausal>, smem);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<D, kCausal><<<tile_grid(B, T, H), kThreads, smem, st>>>(
      q, k, v, dout, lse, corr, dk, dv, T, H, scale);
  return cudaGetLastError();
}

}  // namespace

// Instantiate RUN<D, causal> for the head dims the kernels support.
#define FLASH_DISPATCH(RUN, ...)                                                 \
  switch (D) {                                                                   \
    case 16: return causal ? RUN<16, true>(__VA_ARGS__) : RUN<16, false>(__VA_ARGS__);    \
    case 32: return causal ? RUN<32, true>(__VA_ARGS__) : RUN<32, false>(__VA_ARGS__);    \
    case 64: return causal ? RUN<64, true>(__VA_ARGS__) : RUN<64, false>(__VA_ARGS__);    \
    case 128: return causal ? RUN<128, true>(__VA_ARGS__) : RUN<128, false>(__VA_ARGS__); \
    default: return cudaErrorInvalidValue;                                       \
  }

extern "C" int flash_attention_fwd(const float* q, const float* k, const float* v, float* o,
                                   float* lse, int B, int T, int H, int D, int causal,
                                   float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(run_fwd, q, k, v, o, lse, B, T, H, scale, st)
}

extern "C" int flash_attention_bwd_dq(const float* q, const float* k, const float* v,
                                      const float* dout, const float* lse, const float* corr,
                                      float* dq, int B, int T, int H, int D, int causal,
                                      float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(run_dq, q, k, v, dout, lse, corr, dq, B, T, H, scale, st)
}

extern "C" int flash_attention_bwd_dkv(const float* q, const float* k, const float* v,
                                       const float* dout, const float* lse, const float* corr,
                                       float* dk, float* dv, int B, int T, int H, int D,
                                       int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(run_dkv, q, k, v, dout, lse, corr, dk, dv, B, T, H, scale, st)
}
