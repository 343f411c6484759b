// The Hopper (sm_90a) machinery that the wgmma flash kernels of both element
// types share: flash_attention_sm90_bf16.cuh (bf16 q, k, v, dO) and
// flash_attention_sm90_f32.cuh (float32). A block is a producer warpgroup
// and consumer warpgroups of 64 owned rows each, with setmaxnreg moving
// registers between them (WgBlock); tiles arrive by TMA
// (cp.async.bulk.tensor) and complete on mbarriers; wgmma.mma_async
// m64nNk16 multiplies bf16 tiles in shared memory (K-major or MN-major, the
// swizzle of the tile's row width, D = 128 as two 64-column panels) or a
// bf16 A fragment in registers; split3 carries a float32 value as three
// bf16 parts (hi + mid + lo = x). The source notes of the two kernel headers
// say how each kernel uses them. Here too: the mask value, the log2
// constants, the dispatch over head dims and the C entry points' macro.
//
// Layouts: q, k, v, dO, o, dQ, dK, dV are contiguous [B, T, H, D]; lse and
// corr (= lse cotangent - rowsum(dO * O)) are contiguous [B, H, T], float32.
// Kernels launch on the caller's stream, allocate nothing, and each C entry
// point returns cudaGetLastError() of its launch.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWgThreads = 128;

// A block: the producer warpgroup and kConsumers consumer warpgroups of 64
// owned rows each. A thread of it has kRegisters registers at launch (the
// register file over the block's threads, in units of 8): ptxas compiles
// the consumers to that count, and setmaxnreg hands the producer's unused
// registers to them at run time (kProducerRegisters left to the producer:
// 24 where it only issues copies, more where it also splits tiles; the
// consumers' raise is exactly what it frees, since a raise the pool cannot
// meet would wait forever).
template <int kConsumers_, int kProducerRegisters_ = 24>
struct WgBlock {
  static constexpr int kConsumers = kConsumers_;
  static constexpr int kThreads = (1 + kConsumers) * kWgThreads;
  static constexpr int kRows = 64 * kConsumers;  // rows a block owns
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kShare = 65536 / kThreads / 8 * 8;
  static constexpr int kRegisters = kShare > 255 ? 255 : kShare;
  static constexpr int kProducerRegisters = kProducerRegisters_;
  static constexpr int kConsumerRegisters =
      kRegisters + (kRegisters - kProducerRegisters) / kConsumers / 8 * 8;
  static_assert(kConsumers == 1 || (kProducerRegisters % 8 == 0 &&
                                    kProducerRegisters + kConsumers * kConsumerRegisters <=
                                        (1 + kConsumers) * kRegisters),
                "the consumers' raise must be what the producer frees");
};

// The columns of one shared-memory panel (a swizzle row: 32, 64 or 128 B).
template <int D>
__host__ __device__ constexpr int panel() { return D < 64 ? D : 64; }
// Bytes of a rows x D bf16 tile: its panels one after the other.
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) { return (uint32_t)rows * D * 2; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers, TMA
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase of parity `parity` to complete; trap after 2^34 cycles
// of this SM's clock, so a fault in the pipeline ends the launch with an
// error instead of a hang. (The SM's own counter: a step of %globaltimer,
// which is kept in line with the host's clock, could trap a sound
// wait.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// Rows t0 .. t0+rows-1 of head h of batch b, columns d0 .. d0+panel-1, into
// the panel at shared address dst.
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h), "r"(t0), "r"(b)
      : "memory");
}
// A rows x D tile: one copy per panel.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int rows, int h, int t0, int b) {
#pragma unroll
  for (int p = 0; p < D / panel<D>(); ++p)
    tma_rows(dst + p * rows * panel<D>() * 2, map, bar, p * panel<D>(), h, t0, b);
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor of the operand at byte `off` of the tile
// at `tile`: start address, leading and stride byte offsets, and the swizzle
// of a D-wide tile's panels (128 B: 1, 64 B: 2, 32 B: 3). A shared address
// is below 2^18, so the start field is addr >> 4, and an offset (a multiple
// of 16) adds to the tile's field: the compiler makes one add of a step's
// descriptor, not a mask and shift.
template <int D>
__device__ __forceinline__ uint64_t wg_desc(uint32_t tile, uint32_t off, uint32_t lbo,
                                            uint32_t sbo) {
  constexpr uint32_t kSwizzle = panel<D>() == 64 ? 1 : panel<D>() == 32 ? 2 : 3;
  const uint32_t lo = ((tile >> 4) | (lbo >> 4) << 16) + (off >> 4);
  return (uint64_t)((sbo >> 4) | kSwizzle << 30) << 32 | lo;
}
// Operand contracted over D (K-major): rows row0 .. of a ROWS x D tile at
// `tile`, the 16 columns of step kk. Eight-row groups lie a panel row x 8
// apart; a step moves 32 bytes along the (swizzled) row, or to the next panel.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  constexpr int P = panel<D>(), PB = 2 * P;
  return wg_desc<D>(tile, (kk * 16 / P) * ROWS * PB + row0 * PB + (kk * 16 % P) * 2, 16,
                    8 * PB);
}
// Operand contracted over its rows (MN-major, N = D): rows 16kk .. 16kk+15
// of a ROWS x D tile. Eight-row groups lie 8 panel rows apart, panels (the
// next 64 columns of N) ROWS panel rows apart.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  constexpr int PB = 2 * panel<D>();
  return wg_desc<D>(tile, kk * 16 * PB, ROWS * PB, 8 * PB);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin accumulator registers: no read of them moves above the wait, no write
// below the next product's issue.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16: ss takes A and B from
// shared-memory descriptors, rs takes A from four registers per thread (the
// m64k16 A fragment); kTransB = 1 reads B MN-major. scale_d = 0 overwrites d.
template <int N>
struct Wg;

template <>
struct Wg<16> {
  template <int kTransB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, %11;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct Wg<32> {
  template <int kTransB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct Wg<64> {
  template <int kTransB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(kTransB));
  }
};

template <>
struct Wg<128> {  // O, dK and dV at D = 128 (no 128-wide score tile)
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(kTransB));
  }
};

// ----------------------------------------------------------- the 3 x bf16 split
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// Two float32 values (columns c, c+1 of an accumulator row) split into hi,
// mid and lo bf16 pairs, packed as A-fragment registers (c in the low half).
// A bf16 value is the top half of its float32, so each part comes back out
// of the pair with one integer instruction (the bf16 intrinsics unpack and
// repack the halves).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = bf16x2_bits(__floats2bfloat162_rn(x0, x1));
  x0 -= __uint_as_float(hi << 16);
  x1 -= __uint_as_float(hi & 0xffff0000u);
  mid = bf16x2_bits(__floats2bfloat162_rn(x0, x1));
  x0 -= __uint_as_float(mid << 16);
  x1 -= __uint_as_float(mid & 0xffff0000u);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0, x1));
}
// The float32 m64 accumulator x as A fragments of a product contracted over
// its columns: a[kk][0..2] are the lo, mid and hi parts of columns
// 16kk .. 16kk+15.
template <int NX>
__device__ __forceinline__ void split_frags(uint32_t (&a)[NX / 8][3][4], const float (&x)[NX]) {
#pragma unroll
  for (int kk = 0; kk < NX / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], a[kk][2][r], a[kk][1][r], a[kk][0][r]);
}
// 2^x, flushing results below 2^-126 to zero (no output can see them).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of a block: barriers (and dK/dV's lse and corr rows) in the
// head, then the tiles from the first 1024-byte boundary (the 128-byte
// swizzle's period).
constexpr uint32_t kHeadBytes = 2048;
__device__ __forceinline__ uint32_t tiles_base(const unsigned char* smem) {
  return (smem_addr(smem) + kHeadBytes + 1023) & ~1023u;
}

// op over row r (0: g, 1: g+8) of this lane's part of an m64nN accumulator,
// as a tree (a fixed order, a short dependency chain).
template <int N, typename Op>
__device__ __forceinline__ float row_reduce(const float (&x)[N / 2], int r, Op op) {
  float t[N / 8];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) t[j] = op(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
#pragma unroll
  for (int w = N / 16; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = op(t[j], t[j + w]);
  return t[0];
}

// Two neighbouring output values (columns 2t, 2t+1 of an accumulator row),
// as they are in float32, or rounded once to bf16, to nearest even (as
// astype does).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The forward's online softmax over a consumer warp's rows g and g+8 of an
// m64 score tile of BN keys (a row lies in a quad): the running max m in
// log2 units and this lane's part of the running sum l. Both wgmma
// forwards (bf16 and float32) run it.
template <int BN, bool kCausal>
struct OnlineSoftmax {
  int rw, T, g, t4;  // the warp's first query row, the sequence length, the lane's place
  float scale2;      // scale * log2(e): scores in log2 units
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // P (log2 units) in place of the raw scores sc of the key tile at k0, m
  // and l updated, corr the rescale of O. Masked where the tile crosses the
  // ragged edge or, for this warp's rows, the causal diagonal (a
  // warp-uniform test); a row's max takes a tree over the lane's values
  // and two shuffles.
  __device__ __forceinline__ void step(float (&sc)[BN / 2], int k0, float (&corr)[2]) {
    if (k0 + BN > T || (kCausal && k0 + BN - 1 > rw)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int qpos = rw + g + 8 * ((i >> 1) & 1);
        const int kpos = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (kpos >= T || (kCausal && kpos > qpos)) sc[i] = kNegInf;
      }
    }
    const auto max_op = [](float x, float y) { return fmaxf(x, y); };
    const auto add_op = [](float x, float y) { return x + y; };
    float mx[2], rs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = row_reduce<BN>(sc, r, max_op);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale2);  // max commutes with scale2 > 0
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = ex2(fmaf(sc[i], scale2, -m[(i >> 1) & 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) rs[r] = row_reduce<BN>(sc, r, add_op);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
  }

  // o = acc / l (rows of head h of batch b, [B, T, H, D]) and lse = m + log(l)
  // ([B, H, T], head bh) of the rows below T; l is floored at 1e-30.
  template <int D, typename E>
  __device__ __forceinline__ void store(const float (&acc)[D / 2], E* o, float* lse, int b,
                                        int h, int H, int bh) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];  // the quad's four parts of the row sum
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int t = rw + g + 8 * r;
      if (t < T) {
        const float l_safe = fmaxf(lr, 1e-30f);
        E* row = o + ((size_t)b * T + t) * H * D + (size_t)h * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          store2(row + 8 * j, acc[4 * j + 2 * r] / l_safe, acc[4 * j + 2 * r + 1] / l_safe);
        if (t4 == 0) lse[(size_t)bh * T + t] = m[r] * kLn2 + logf(l_safe);
      }
    }
  }
};

// The register rebalancing of a WgBlock, one call per warpgroup (none for a
// single consumer, which has all it can address).
template <typename Blk>
__device__ __forceinline__ void producer_registers() {
  if constexpr (Blk::kConsumers > 1)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Blk::kProducerRegisters));
}
template <typename Blk>
__device__ __forceinline__ void consumer_registers() {
  if constexpr (Blk::kConsumers > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Blk::kConsumerRegisters));
}

// ------------------------------------------------------------------- host
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched once through the runtime's entry-point query.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a contiguous [B, T, H, D] tensor of `type` (elements of
// `elem` bytes) read as tiles of `rows` rows of one head, `cols` columns a
// copy, in `swizzle`; rows at or beyond T arrive as zeros.
inline cudaError_t head_rows_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                                 const void* x, int B, int T, int H, int D, int cols, int rows,
                                 CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * elem, (cuuint64_t)H * D * elem,
                                 (cuuint64_t)T * H * D * elem};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(x), dims, strides, box, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What the run_*_wgmma launchers return, in place of a cudaError_t,
// for a kernel that ptxas gave other than its block's register share.
constexpr int kErrRegisterShare = -1;

// setmaxnreg balances only if ptxas gave each thread of a block of several
// consumers exactly the block's share at launch; with fewer, the consumers'
// raise asks for more than the producer frees and waits until the trap.
// Asked once per kernel.
template <typename Blk, typename Kernel>
cudaError_t check_share(Kernel kernel) {
  if (Blk::kConsumers == 1) return cudaSuccess;  // no rebalancing
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return attr.numRegs == Blk::kRegisters ? cudaSuccess
                                         : static_cast<cudaError_t>(kErrRegisterShare);
}

// The grid is (B*H, tiles of `rows`): blocks issue x first, so the tiles that
// do the most causal work go first for every head.
inline dim3 wg_grid(int B, int T, int H, int rows) { return dim3(B * H, (T + rows - 1) / rows); }

// Shared memory above 48 KB must be opted into per kernel before its launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
