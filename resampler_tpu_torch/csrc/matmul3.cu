// Kernel B7: the split-precision product of f32 activations with a pre-split
// bf16 weight, as three or four bf16 tensor-core passes with f32 sums:
//
//   out[b, m, n] = sum_{k < K} hi(x[b, m, k]) * t_hi[k, n]
//                            + lo(x[b, m, k]) * t_hi[k, n]
//                            + hi(x[b, m, k]) * t_lo[k, n]
//                 (passes 4:) + lo(x[b, m, k]) * t_lo[k, n]
//
// hi, lo = split_hi_lo(x), done in registers (csrc/bf16_split.cuh: bit for
// bit the port's plain version).  Every product of two bf16 values is exact
// in f32, so this is the plain version's arithmetic up to the order of the
// f32 sums.  Three passes are JAX's Precision.HIGH on a device with bf16
// passes (the FFT engine's matmul and conv backends); four add the lo*lo
// product that the FIR fleet's 100 dB alias gate needs (three measured 95.6
// dB in the JAX package).
//
// Replaces resampler_tpu/ops/matmul3.py:78 matmul3 (body _kernel :64, which
// takes three passes and tile multiples), and the four-pass split einsum of
// resampler_tpu/engine/fir_fleets.py:594-617 (precision="bf16x4").
//
// x is any strided view [batch, M, K] (strides in elements, 64-bit): the FIR
// fleet's overlapping ring window [K blocks, R lanes, span rows] with the
// lanes contiguous, and the FFT conv backend's window view [g, R, (g+1) L']
// with K contiguous, need no copy.  t_hi, t_lo [K, N] bf16 have contiguous
// columns and a leading stride ldt (the FIR fleet passes a window of its
// pre-split, transposed atlas).  out [batch, M, N] has its own strides (the
// fleet's time-major [K, Mg, R] output is written as [K, R, Mg] with the
// lanes contiguous).
//
// Bound on an H100: at the FFT projector, [16384, 1176] @ [1176, 2560] in
// three passes, 296 GFLOP, 0.299 ms at 989 TFLOP/s dense bf16, against
// 257 MB of compulsory traffic, 0.077 ms at 3.35 TB/s: operations.  At the
// FIR fleet's window (K 28, R 2048, span 276, Mg 160, four passes) 20.3
// GFLOP, 0.0205 ms, against ~72 MB, 0.021 ms: both.  Design (a simple tiled
// kernel, as B4; wgmma and TMA are later work): a thread block computes 64
// rows x 64*NF columns of one batch entry with 8 warps (2 x 4, each 32 x
// 16*NF) of nvcuda::wmma 16x16x16 bf16 fragments, 32 of K per step.  Each
// step loads the f32 x tile (element-granular, threads along whichever of m
// and k is contiguous) and the bf16 weight tiles into registers while the
// previous step's MMAs run, then splits x in registers into hi and lo tiles
// in shared memory.  Each step's products are summed on the tensor cores into
// fresh fragments and added to the f32 sums on the CUDA cores, rounding to
// nearest (tensor-core accumulation may truncate).  Ragged M, N and K edges
// are zero-filled at the load and masked at the store; no tile multiples are
// required.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "bf16_split.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 64;        // rows per block
constexpr int kBK = 32;        // K per step
constexpr int kThreads = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int kPad = 8;        // shared-memory row padding, in bf16

struct Geometry {
  int M, N, K, passes;
  int64_t sxb, sxm, sxk;  // x strides (batch, row, k)
  int64_t ldt;            // t row stride (columns contiguous)
  int64_t sob, som, son;  // out strides (batch, row, column)
};

template <int NF>
__global__ void __launch_bounds__(kThreads)
matmul3_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ t_hi,
               const __nv_bfloat16* __restrict__ t_lo, float* __restrict__ out,
               Geometry g) {
  constexpr int kBN = 64 * NF;                  // 4 column warps x NF fragments
  constexpr int kAPer = kBM * kBK / kThreads;   // 8 x values per thread
  constexpr int kBPer = kBK * kBN / kThreads;   // 8 * NF weights per thread and half
  __shared__ __align__(32) __nv_bfloat16 Ah[kBM][kBK + kPad];
  __shared__ __align__(32) __nv_bfloat16 Al[kBM][kBK + kPad];
  __shared__ __align__(32) __nv_bfloat16 Bh[kBK][kBN + kPad];
  __shared__ __align__(32) __nv_bfloat16 Bl[kBK][kBN + kPad];
  __shared__ __align__(32) float stage[kThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const float* xb = x + static_cast<int64_t>(blockIdx.z) * g.sxb;
  // threads run along the contiguous axis of x: m when the lanes are
  // contiguous (the FIR ring), k otherwise
  const bool a_m_major = g.sxm == 1 && g.sxk != 1;
  const int n_k = (g.K + kBK - 1) / kBK;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  float a_raw[kAPer];
  __nv_bfloat16 bh_raw[kBPer], bl_raw[kBPer];

  auto a_coord = [&](int i, int* m, int* k) {
    const int e = tid + kThreads * i;
    if (a_m_major) {
      *m = e % kBM;
      *k = e / kBM;
    } else {
      *k = e % kBK;
      *m = e / kBK;
    }
  };

  auto load_tile = [&](int t) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      int m, k;
      a_coord(i, &m, &k);
      const int gm = row0 + m, gk = t * kBK + k;
      a_raw[i] = (gm < g.M && gk < g.K) ? __ldg(xb + gm * g.sxm + gk * g.sxk) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int e = tid + kThreads * i;
      const int gk = t * kBK + e / kBN, gn = col0 + e % kBN;
      const bool ok = gk < g.K && gn < g.N;
      const int64_t off = gk * g.ldt + gn;
      bh_raw[i] = ok ? t_hi[off] : zero;
      bl_raw[i] = ok ? t_lo[off] : zero;
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      int m, k;
      a_coord(i, &m, &k);
      const float hi = bf16_split_hi(a_raw[i]);
      Ah[m][k] = __float2bfloat16_rn(hi);
      Al[m][k] = bf16_split_lo(a_raw[i], hi);
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int e = tid + kThreads * i;
      Bh[e / kBN][e % kBN] = bh_raw[i];
      Bl[e / kBN][e % kBN] = bl_raw[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_tile(0);
  for (int t = 0; t < n_k; ++t) {
    store_tile();
    __syncthreads();
    if (t + 1 < n_k) load_tile(t + 1);  // in flight during this step's MMAs
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> ah[2][2], al[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(ah[h][i], &Ah[wm * 32 + i * 16][h * 16], kBK + kPad);
        wmma::load_matrix_sync(al[h][i], &Al[wm * 32 + i * 16][h * 16], kBK + kPad);
      }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      // this step's products into fresh fragments, then added to the sums
      // on the CUDA cores (round to nearest)
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::fill_fragment(part[i], 0.0f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bh, bl;
        wmma::load_matrix_sync(bh, &Bh[h * 16][wn * NF * 16 + j * 16], kBN + kPad);
        wmma::load_matrix_sync(bl, &Bl[h * 16][wn * NF * 16 + j * 16], kBN + kPad);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(part[i], ah[h][i], bh, part[i]);
          wmma::mma_sync(part[i], al[h][i], bh, part[i]);
          wmma::mma_sync(part[i], ah[h][i], bl, part[i]);
          if (g.passes == 4) wmma::mma_sync(part[i], al[h][i], bl, part[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < part[i].num_elements; ++e) acc[i][j].x[e] += part[i].x[e];
    }
    __syncthreads();
  }

  // each warp's fragments through its own shared-memory stage, masked, with
  // the threads along out's contiguous axis
  const bool o_m_major = g.som == 1 && g.son != 1;
  float* st = stage[warp];
  float* ob = out + static_cast<int64_t>(blockIdx.z) * g.sob;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16,
                              o_m_major ? wmma::mem_col_major : wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = o_m_major ? e % 16 : e / 16;
        const int c = o_m_major ? e / 16 : e % 16;
        const int gm = row0 + wm * 32 + i * 16 + r;
        const int gn = col0 + wn * NF * 16 + j * 16 + c;
        if (gm < g.M && gn < g.N) ob[gm * g.som + gn * g.son] = st[e];
      }
      __syncwarp();
    }
  }
}

template <int NF>
int launch(const float* x, const __nv_bfloat16* t_hi, const __nv_bfloat16* t_lo,
           float* out, int batch, const Geometry& g, cudaStream_t stream) {
  constexpr int kBN = 64 * NF;
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, batch);
  if (grid.y > 65535u || grid.z > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  matmul3_kernel<NF><<<grid, kThreads, 0, stream>>>(x, t_hi, t_lo, out, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks dtypes, devices, shapes and that every strided offset lies
// inside its tensor; `col_frags` (1 or 2) sets the column tile, 64 *
// col_frags columns.
extern "C" int matmul3(const float* x, const void* t_hi, const void* t_lo, float* out,
                       int batch, int M, int N, int K, int64_t sxb, int64_t sxm,
                       int64_t sxk, int64_t ldt, int64_t sob, int64_t som, int64_t son,
                       int passes, int col_frags, void* stream) {
  if (batch < 1 || M < 1 || N < 1 || K < 1 || (passes != 3 && passes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{M, N, K, passes, sxb, sxm, sxk, ldt, sob, som, son};
  const auto* th = static_cast<const __nv_bfloat16*>(t_hi);
  const auto* tl = static_cast<const __nv_bfloat16*>(t_lo);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (col_frags) {
    case 1: return launch<1>(x, th, tl, out, batch, g, st);
    case 2: return launch<2>(x, th, tl, out, batch, g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
