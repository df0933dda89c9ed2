// Kernel B7: the split-precision product of f32 activations with a pre-split
// bf16 weight, as three or four bf16 tensor-core passes with f32 sums:
//
//   out[b, m, n] = sum_{k < K} hi(x[b, m, k]) * t_hi[k, n]
//                            + lo(x[b, m, k]) * t_hi[k, n]
//                            + hi(x[b, m, k]) * t_lo[k, n]
//                 (passes 4:) + lo(x[b, m, k]) * t_lo[k, n]
//
// hi, lo = split_hi_lo(x) (csrc/bf16_split.cuh: bit for bit the port's plain
// version).  Every product of two bf16 values is exact in f32, so this is the
// plain version's arithmetic up to the order of the f32 sums.  Three passes
// are JAX's Precision.HIGH on a device with bf16 passes (the FFT engine's
// matmul and conv backends); four add the lo*lo product that the FIR fleet's
// 100 dB alias gate needs (three measured 95.6 dB in the JAX package).
//
// Replaces resampler_tpu/ops/matmul3.py:78 matmul3 (body _kernel :64, which
// takes three passes and tile multiples), and the four-pass split einsum of
// resampler_tpu/engine/fir_fleets.py:594-617 (precision="bf16x4").
//
// x is any strided view [batch, M, K] (strides in elements, 64-bit): the FIR
// fleet's overlapping ring window [K blocks, R lanes, span rows] with the
// lanes contiguous, and the FFT conv backend's window view [g, R, (g+1) L']
// with K contiguous.  t_hi, t_lo [K, N] bf16 have contiguous columns and a
// leading stride ldt (the FIR fleet passes a window of its pre-split,
// transposed atlas).  out [batch, M, N] has its own strides (the fleet's
// time-major [K, Mg, R] output is written as [K, R, Mg], lanes contiguous).
//
// Bound on an H100: at the FFT projector, [16384, 1176] @ [1176, 2560] in
// three passes, 296 GFLOP, 0.299 ms at 989 TFLOP/s dense bf16, against
// 257 MB of compulsory traffic, 0.077 ms at 3.35 TB/s: operations.  At the
// FIR fleet's window (K 28, R 2048, span 276, Mg 160, four passes) 20.3
// GFLOP, 0.0205 ms, against ~72 MB, 0.021 ms: both.
//
// Design: two launches.
//
// 1. matmul3_split: a split pass reads x through its strides (threads along
//    its contiguous axis, a 32 x 64 tile transposed in shared memory) and
//    writes hi(x) and lo(x) as compact, K-major bf16 [batch, M, Kp], Kp = K
//    rounded up to 8 with zeros, so that every row is 16-byte aligned and
//    TMA can map any caller's view.
// 2. matmul3_gemm: a warp-specialised wgmma GEMM.  A block computes 128 rows
//    x BN columns (BN 160, a template parameter) of one batch entry
//    with 384 threads: one producer warpgroup, whose first thread keeps a
//    ring of 3 stages of 64-deep K tiles in flight with TMA (x_hi, x_lo:
//    3-D maps [batch, M, Kp], 128-byte swizzle; t_hi, t_lo: 2-D maps [K,
//    N], 64-byte swizzle, 32-column boxes, read as MN-major B), full and
//    empty mbarriers per stage, setmaxnreg 40; and two consumer warpgroups
//    (setmaxnreg 232), 64 rows each, that issue wgmma.mma_async m64nBNk16
//    bf16 -> f32 with A and B from shared memory, one per pass and k16
//    step.  BN 160 is N of the tm window and the conv in one tile, and 16
//    tiles of the projector's 2560 (0.553 ms there against 0.600 for BN
//    128, whose 20 tiles reuse each x tile less; H100, 700 W).  The 64-byte
//    swizzle on the weight lets BN 160 keep three stages in 227 KB; 64-
//    column boxes of the 128-byte swizzle would need 240 KB.  The f32 sums are
//    either one chained accumulator over the whole K, or per K tile a fresh
//    accumulator added to f32 sums in registers (kPromote).  The wrapper
//    fixes the promoted form: the chained one missed 1e-5 at the
//    projector (2.29e-5 against 4.77e-6 on an H100): the tensor cores'
//    accumulation truncates.  The epilogue stages the tile in the ring's shared
//    memory and writes out's strided view with the threads along its
//    contiguous axis, masked.  Ragged M, N and K: TMA fills rows, columns
//    and K past the maps' extents with zeros.
//
// The TMA, mbarrier and descriptor helpers and the tensor-map encoder (the
// driver's cuTensorMapEncodeTiled, reached through the runtime's driver
// entry point: the library links nothing) are in hopper_tma.cuh, shared
// with B4/B5.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_split.cuh"
#include "hopper_tma.cuh"

namespace {

// ---------------------------------------------------------------- split pass

constexpr int kSplitRows = 32;      // rows of x per block
constexpr int kSplitK = 64;         // K per block
constexpr int kSplitThreads = 256;

struct SplitGeometry {
  int M, K, Kp;
  int64_t sxb, sxm, sxk;  // x strides (batch, row, k)
};

__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const float* __restrict__ x, __nv_bfloat162* __restrict__ x_hi,
             __nv_bfloat162* __restrict__ x_lo, SplitGeometry g) {
  __shared__ float tile[kSplitK][kSplitRows + 1];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kSplitK, m0 = blockIdx.y * kSplitRows;
  const int64_t b = blockIdx.z;
  const float* xb = x + b * g.sxb;
  // threads run along the contiguous axis of x: m when the lanes are
  // contiguous (the FIR ring), k otherwise
  const bool m_major = g.sxm == 1 && g.sxk != 1;
#pragma unroll
  for (int i = 0; i < kSplitRows * kSplitK / kSplitThreads; ++i) {
    const int e = tid + kSplitThreads * i;
    const int m = m_major ? e % kSplitRows : e / kSplitK;
    const int k = m_major ? e / kSplitRows : e % kSplitK;
    const int gm = m0 + m, gk = k0 + k;
    tile[k][m] = (gm < g.M && gk < g.K) ? __ldg(xb + gm * g.sxm + gk * g.sxk) : 0.0f;
  }
  __syncthreads();
  // one warp per row: 32 bf16 pairs of hi and of lo, 128 bytes each; the
  // zeros past K fill the row to Kp
#pragma unroll
  for (int i = 0; i < kSplitRows * kSplitK / 2 / kSplitThreads; ++i) {
    const int p = tid + kSplitThreads * i;
    const int m = p / (kSplitK / 2), kp = p % (kSplitK / 2);
    const int gm = m0 + m, gk = k0 + 2 * kp;
    if (gm >= g.M || gk >= g.Kp) continue;
    const float a0 = tile[2 * kp][m], a1 = tile[2 * kp + 1][m];
    const float h0 = bf16_split_hi(a0), h1 = bf16_split_hi(a1);
    const int64_t off = ((b * g.M + gm) * g.Kp + gk) / 2;
    x_hi[off] = __halves2bfloat162(__float2bfloat16_rn(h0), __float2bfloat16_rn(h1));
    x_lo[off] = __halves2bfloat162(bf16_split_lo(a0, h0), bf16_split_lo(a1, h1));
  }
}

// ---------------------------------------------------------------------- GEMM

constexpr int kBM = 128;       // rows per block: two consumer warpgroups of 64
constexpr int kBN = 160;       // columns per block
constexpr int kBK = 64;        // K per stage: one 128-byte row of bf16
constexpr int kStages = 3;
constexpr int kThreads = 384;  // the producer warpgroup, then two consumers
constexpr int kBoxN = 32;      // weight columns per TMA box: 64 bytes
static_assert(kBK == 64 && kBoxN == 32, "desc_b (hopper_tma.cuh) reads boxes of 64 K rows x 32 columns");

template <int BN>
struct Tiles {
  static constexpr int kA = kBM * kBK * 2;         // one half of x's tile, bytes
  static constexpr int kBChunk = kBK * kBoxN * 2;  // one 64 x 32 box of a weight half
  static constexpr int kB = BN / kBoxN * kBChunk;  // one half of the weight's tile
  static constexpr int kStage = 2 * kA + 2 * kB;
  static constexpr int kOutStride = BN + 1;        // floats per row of the staged output
  // the ring, its barriers, and slack to align the ring to 1024 bytes
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
  static_assert(BN % kBoxN == 0, "BN is a multiple of the weight's box");
  static_assert(kBM * kOutStride * 4 <= kStages * kStage, "the output tile fits in the ring");
  static_assert(kSmem <= 232448, "the ring fits in a block's shared memory");
};

struct GemmGeometry {
  int M, N, K;
  int64_t sob, som, son;  // out strides (batch, row, column)
};

// wgmma shared-memory descriptors: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1: 128 bytes, 2: 64 bytes).
// A, K-major under the 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart; a k16 step moves the start 32 bytes along the row.
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= A B over one k16 step, m64n160k16, A K-major and B MN-major
// (transposed) from shared memory; scale_d 0 ignores d's old value.
__device__ __forceinline__ void wgmma_n(float (&d)[80], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN, int kPasses, bool kPromote>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_xh, const __grid_constant__ CUtensorMap map_xl,
            const __grid_constant__ CUtensorMap map_th, const __grid_constant__ CUtensorMap map_tl,
            float* __restrict__ out, const GemmGeometry g) {
  using T = Tiles<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1024-byte alignment
  float* const staged = reinterpret_cast<float*>(smem_raw + (ring - raw));
  const uint32_t full0 = ring + kStages * T::kStage;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM, b = blockIdx.z;
  const int n_k = (g.K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty0 + 8 * s, ((kt / kStages) & 1) ^ 1);  // the first round passes
        const uint32_t full = full0 + 8 * s, st = ring + s * T::kStage;
        mbar_expect_tx(full, T::kStage);
        tma_load_3d(st, &map_xh, full, kt * kBK, m0, b);
        tma_load_3d(st + T::kA, &map_xl, full, kt * kBK, m0, b);
#pragma unroll
        for (int j = 0; j < BN / kBoxN; ++j) {
          const int col = n0 + j * kBoxN;
          tma_load_2d(st + 2 * T::kA + j * T::kBChunk, &map_th, full, col, kt * kBK);
          tma_load_2d(st + 2 * T::kA + T::kB + j * T::kBChunk, &map_tl, full, col, kt * kBK);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;  // rows 64 cw .. 64 cw + 63 of the tile
    float acc[BN / 2];
    float sum[kPromote ? BN / 2 : 1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      acc[i] = 0.0f;
      if constexpr (kPromote) sum[i] = 0.0f;
    }
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
      const uint32_t a_hi = ring + s * T::kStage + cw * 64 * kBK * 2, a_lo = a_hi + T::kA;
      const uint32_t b_hi = ring + s * T::kStage + 2 * T::kA, b_lo = b_hi + T::kB;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t ah = desc_a(a_hi + kk * 32), al = desc_a(a_lo + kk * 32);
        const uint64_t bh = desc_b(b_hi + kk * 16 * kBoxN * 2);
        const uint64_t bl = desc_b(b_lo + kk * 16 * kBoxN * 2);
        wgmma_n(acc, ah, bh, kPromote && kk == 0 ? 0 : 1);
        wgmma_n(acc, al, bh, 1);
        wgmma_n(acc, ah, bl, 1);
        if constexpr (kPasses == 4) wgmma_n(acc, al, bl, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (t == 0) mbar_arrive(empty0 + 8 * s);
      if constexpr (kPromote) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
      }
    }

    // epilogue: both consumers are past their last wgmma and every load has
    // landed, so the ring is free; the tile goes through it, then out to
    // the strided view with the threads along out's contiguous axis
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int warp = t / 32, lane = t % 32;
    const int r0 = cw * 64 + warp * 16 + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v;
          if constexpr (kPromote) v = sum[4 * j + 2 * h + c];
          else v = acc[4 * j + 2 * h + c];
          staged[(r0 + 8 * h) * T::kOutStride + 8 * j + c0 + c] = v;
        }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const bool o_m_major = g.som == 1 && g.son != 1;
    float* ob = out + static_cast<int64_t>(b) * g.sob;
    for (int e = threadIdx.x - 128; e < kBM * BN; e += 256) {
      const int r = o_m_major ? e % kBM : e / BN;
      const int c = o_m_major ? e / kBM : e % BN;
      const int gm = m0 + r, gn = n0 + c;
      if (gm < g.M && gn < g.N) ob[gm * g.som + gn * g.son] = staged[r * T::kOutStride + c];
    }
  }
}

template <int BN, int kPasses, bool kPromote>
int launch_gemm(const CUtensorMap (&maps)[4], float* out, int batch, const GemmGeometry& g,
                cudaStream_t stream) {
  using T = Tiles<BN>;
  const auto kernel = gemm_kernel<BN, kPasses, kPromote>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.N + BN - 1) / BN, (g.M + kBM - 1) / kBM, batch);
  if (grid.y > 65535u || grid.z > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(maps[0], maps[1], maps[2], maps[3], out, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The GEMM's dynamic shared memory per block, bytes (ptxas reports only
// static shared memory).
extern "C" int matmul3_gemm_smem() { return Tiles<kBN>::kSmem; }

// The split pass: x [batch, M, K] f32 (strides in elements) -> x_hi, x_lo
// [batch, M, Kp] bf16, zero past K.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  The caller checks dtypes, devices,
// shapes and that every strided offset lies inside its tensor.
extern "C" int matmul3_split(const float* x, void* x_hi, void* x_lo, int batch, int M, int K,
                             int Kp, int64_t sxb, int64_t sxm, int64_t sxk, void* stream) {
  if (batch < 1 || M < 1 || K < 1 || Kp < K || Kp % 8 != 0 || !aligned16(x_hi) ||
      !aligned16(x_lo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Kp + kSplitK - 1) / kSplitK, (M + kSplitRows - 1) / kSplitRows, batch);
  if (grid.y > 65535u || grid.z > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  split_kernel<<<grid, kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<__nv_bfloat162*>(x_hi), static_cast<__nv_bfloat162*>(x_lo),
      SplitGeometry{M, K, Kp, sxb, sxm, sxk});
  return static_cast<int>(cudaGetLastError());
}

// The GEMM over the split pass's x_hi, x_lo [batch, M, Kp] and the weight
// t_hi, t_lo [K, N]: 16-byte aligned bases and a row stride ldt (elements)
// that is a multiple of 8, as TMA needs (a box's innermost coordinate must
// sit on 16 bytes too, so an unaligned base cannot be aligned down; the
// wrapper copies such a weight).  promote 1 sums each K tile into fresh
// accumulators added in f32 registers, 0 chains one accumulator over K.
// Returns 0, a CUDA error, or kMapError + a CUresult.
extern "C" int matmul3_gemm(const void* x_hi, const void* x_lo, const void* t_hi,
                            const void* t_lo, float* out, int batch, int M, int N, int K, int Kp,
                            int64_t ldt, int64_t sob, int64_t som, int64_t son,
                            int passes, int promote, void* stream) {
  if (batch < 1 || M < 1 || N < 1 || K < 1 || Kp < K || Kp % 8 != 0 || ldt % 8 != 0 ||
      (passes != 3 && passes != 4) ||
      !aligned16(x_hi) || !aligned16(x_lo) || !aligned16(t_hi) || !aligned16(t_lo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[4];
  const cuuint64_t a_dims[3] = {static_cast<cuuint64_t>(Kp), static_cast<cuuint64_t>(M),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t a_strides[2] = {2ull * Kp, 2ull * Kp * M};
  const cuuint32_t a_box[3] = {kBK, kBM, 1};
  const cuuint64_t b_dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t b_strides[1] = {2ull * ldt};
  const cuuint32_t b_box[2] = {kBoxN, kBK};
  int err = encode(&maps[0], x_hi, 3, a_dims, a_strides, a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = encode(&maps[1], x_lo, 3, a_dims, a_strides, a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = encode(&maps[2], t_hi, 2, b_dims, b_strides, b_box, CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err) err = encode(&maps[3], t_lo, 2, b_dims, b_strides, b_box, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  const GemmGeometry g{M, N, K, sob, som, son};
  const auto st = static_cast<cudaStream_t>(stream);
  if (passes == 3) {
    return promote ? launch_gemm<kBN, 3, true>(maps, out, batch, g, st)
                   : launch_gemm<kBN, 3, false>(maps, out, batch, g, st);
  }
  return promote ? launch_gemm<kBN, 4, true>(maps, out, batch, g, st)
                 : launch_gemm<kBN, 4, false>(maps, out, batch, g, st);
}
