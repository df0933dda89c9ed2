// Kernels B4 and B5: the FFT engine's banded magnitude-split chunk
// operator, out = [prev | cur] @ T2, as bf16 tensor-core passes with f32
// accumulation.  With x2 = [prev | cur] (never materialised: column k < N
// reads prev, the rest cur) and, for each column group q < s,
// r0 = q * bps * lp and rb = r0 + b0 * lp:
//
//   out[r, q*cols + c] = sum_{i < rows} hi(x2[r, r0 + i]) * wh[q, i, c]
//                      + sum_{i < wc}   hi(x2[r, rb + i]) * wcorr[q, i, c]
//                      + sum_{i < wc}   lo(x2[r, rb + i]) * wcorr[q, wc + i, c]
//
// hi, lo = split_hi_lo(x) (JAX's rule, csrc/bf16_split.cuh: integer round to
// nearest even on the f32 bits; a non-finite value passes through, so its lo
// is NaN).  Every
// product hi*w is exact in f32, so this is the plain version's arithmetic
// up to the order of the f32 sums.
//
// B4 replaces resampler_tpu/ops/fft_magsplit_kernel.py:288
// magsplit_projector (bodies _kernel :266, _body :248); B5 replaces :332
// magsplit_projector_pool (_kernel_pool :271).  B5 is this kernel with prev
// and cur pointing at two slots of the caller's [P, R, N] pool: one entry
// point serves both wrappers.
//
// Bound on an H100 at the bench shape (8192 stereo streams, 1176 -> 1280:
// R 16384, s 4, rows 1470, wc 882, cols 320): 2*R*(rows + 2*wc)*cols*s =
// 135.6 GFLOP, 0.137 ms at 989 TFLOP/s dense bf16, against 246 MB of
// compulsory traffic (prev + cur + out + weights), 0.074 ms at 3.35 TB/s:
// bound by operations.  Design (a simple tiled kernel; wgmma and TMA are
// later work): a thread block computes 64 rows x 64*NF columns of one group
// with 8 warps (2 x 4, each 32 x 16*NF) of nvcuda::wmma 16x16x16 bf16
// fragments; the K loop walks the pass-1 band and then the hi and lo
// correction bands as ONE axis of rows + 2*wc, 32 at a time.  Each step's
// products are summed on the tensor cores into fresh fragments and added to
// the f32 sums on the CUDA cores, rounding to nearest (tensor-core
// accumulation may truncate; over ~100 steps a bias would cost dB).  Each step
// loads the f32 x tile (element-granular: band starts 294q are not
// 16-aligned) and the bf16 weight tile into registers while the previous
// tile's MMAs run, then splits x in registers and stores hi or lo to shared
// memory.  The weights come from a kernel-side copy [s, k_pad, cols_pad]
// (the two stacks concatenated along K, zero-padded in K to a multiple of
// 32 and in columns to whole tiles), so weight loads are 16 bytes each.
// Rows past R and K past the bands are zero-filled; ragged columns are
// masked at the store.  Offsets are 64-bit (a full-width pool slot is 77 MB).
// The groups of one row tile are neighbouring blocks, so their shared x
// rows are read from L2.

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
constexpr int kAPad = 8;       // shared-memory row padding, in bf16
constexpr int kBPad = 8;

struct Geometry {
  int R, N, M, cols, cols_pad, k_pad, r0_step, b0_off, rows, wc;
};

// x2 column of K index k (k < rows + 2*wc) in group q, and whether k is in
// the lo half of the correction band.
__device__ __forceinline__ int band_col(const Geometry& g, int q, int k,
                                        bool* lo) {
  const int r0 = q * g.r0_step;
  if (k < g.rows) {
    *lo = false;
    return r0 + k;
  }
  int kk = k - g.rows;
  *lo = kk >= g.wc;
  if (*lo) kk -= g.wc;
  return r0 + g.b0_off + kk;
}

template <int NF>
__global__ void __launch_bounds__(kThreads, 1)
magsplit_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                Geometry g) {
  constexpr int kBN = 64 * NF;           // 4 column warps x NF fragments
  constexpr int kAPerThread = kBM * kBK / kThreads;  // 8
  __shared__ __align__(32) __nv_bfloat16 As[kBM][kBK + kAPad];
  __shared__ __align__(32) __nv_bfloat16 Bs[kBK][kBN + kBPad];
  __shared__ __align__(32) float stage[kThreads / 32][16 * 16];

  const int n_ct = g.cols_pad / kBN;
  const int q = blockIdx.x / n_ct;
  const int c0 = (blockIdx.x % n_ct) * kBN;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int ktot = g.rows + 2 * g.wc;
  const int n_k = (ktot + kBK - 1) / kBK;

  // A: thread tid loads column k_local = tid % 32 of rows tid / 32 + 8*i
  const int a_k = tid % kBK;
  const int a_r = tid / kBK;
  float a_raw[kAPerThread];
  uint4 b_raw[NF];
  const __nv_bfloat16* wq = w + static_cast<int64_t>(q) * g.k_pad * g.cols_pad;

  auto load_tile = [&](int t) {
    const int k = t * kBK + a_k;
    bool lo = false;
    const int col = k < ktot ? band_col(g, q, k, &lo) : 0;
#pragma unroll
    for (int i = 0; i < kAPerThread; ++i) {
      const int64_t r = row0 + a_r + 8 * i;
      float x = 0.0f;
      if (k < ktot && r < g.R) {
        x = col < g.N ? prev[r * g.N + col] : cur[r * g.N + (col - g.N)];
      }
      a_raw[i] = x;
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int v = tid + kThreads * j;  // 16-byte vector of the 32 x kBN tile
      const int row = v / (kBN / 8), cv = v % (kBN / 8);
      b_raw[j] = *reinterpret_cast<const uint4*>(
          wq + static_cast<int64_t>(t * kBK + row) * g.cols_pad + c0 + cv * 8);
    }
  };

  auto store_tile = [&](int t) {
    const int k = t * kBK + a_k;
    bool lo = false;
    if (k < ktot) band_col(g, q, k, &lo);
#pragma unroll
    for (int i = 0; i < kAPerThread; ++i) {
      As[a_r + 8 * i][a_k] = bf16_split_part(a_raw[i], lo);
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int v = tid + kThreads * j;
      const int row = v / (kBN / 8), cv = v % (kBN / 8);
      *reinterpret_cast<uint4*>(&Bs[row][cv * 8]) = b_raw[j];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_tile(0);
  for (int t = 0; t < n_k; ++t) {
    store_tile(t);
    __syncthreads();
    if (t + 1 < n_k) load_tile(t + 1);  // in flight during this step's MMAs
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(af[h][i], &As[wm * 32 + i * 16][h * 16], kBK + kAPad);
      }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      // this step's 32 products into fresh fragments, then added to the
      // sums on the CUDA cores (round to nearest): the tensor cores'
      // accumulation may truncate, and the sums run over ~100 steps
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::fill_fragment(part[i], 0.0f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, &Bs[h * 16][wn * NF * 16 + j * 16], kBN + kBPad);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(part[i], af[h][i], bf, part[i]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < part[i].num_elements; ++e) acc[i][j].x[e] += part[i].x[e];
    }
    __syncthreads();
  }

  // each warp's fragments through its own shared-memory stage, masked
  float* st = stage[warp];
  const int64_t out_col0 = static_cast<int64_t>(q) * g.cols;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int64_t r = row0 + wm * 32 + i * 16 + e / 16;
        const int c = c0 + wn * NF * 16 + j * 16 + e % 16;
        if (r < g.R && c < g.cols) out[r * g.M + out_col0 + c] = st[e];
      }
      __syncwarp();
    }
  }
}

template <int NF>
int launch(const float* prev, const float* cur, const __nv_bfloat16* w,
           float* out, const Geometry& g, int s, cudaStream_t stream) {
  constexpr int kBN = 64 * NF;
  if (g.cols_pad % kBN != 0 || g.k_pad % kBK != 0 ||
      g.k_pad < g.rows + 2 * g.wc || g.cols > g.cols_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(s * (g.cols_pad / kBN), (g.R + kBM - 1) / kBM);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  magsplit_kernel<NF><<<grid, kThreads, 0, stream>>>(prev, cur, w, out, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks shapes, contiguity and dtypes; `w` is the kernel-side weight
// copy [s, k_pad, cols_pad] bf16 and `col_frags` (1-5) its column tile,
// 64 * col_frags columns.
extern "C" int fft_magsplit_projector(const float* prev, const float* cur,
                                      const void* w, float* out, int R, int N,
                                      int M, int s, int cols, int cols_pad,
                                      int k_pad, int r0_step, int b0_off,
                                      int rows, int wc, int col_frags,
                                      void* stream) {
  const Geometry g{R, N, M, cols, cols_pad, k_pad, r0_step, b0_off, rows, wc};
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (col_frags) {
    case 1: return launch<1>(prev, cur, wb, out, g, s, st);
    case 2: return launch<2>(prev, cur, wb, out, g, s, st);
    case 3: return launch<3>(prev, cur, wb, out, g, s, st);
    case 4: return launch<4>(prev, cur, wb, out, g, s, st);
    case 5: return launch<5>(prev, cur, wb, out, g, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
