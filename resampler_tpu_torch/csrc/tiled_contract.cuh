// Block-tiled f32 contraction of kernel B2 (fir_farrow_contract.cu):
//
//   out[k, j, r] = sum_{s < width} a_k[j, s] * buffer[row_k + s, r]
//
// for blocks k < K, where
//   B2 (Farrow):    a_k = a + k*M*width (each block's own [q, width] weights),
//                   row_k = base + block_base[k];
//   periodic:       a_k = a (one [M, width] window for every block),
//                   row_k = base + k*L (block_base == nullptr).  Kernel B1
//                   launched this form before it got its own band kernel
//                   (fir_banded_contract.cu); no caller launches it now.
// buffer [ring, R] f32 row-major (frames x stream-channel lanes), out [K, M, R].
// f32 inputs, f32 FMA, f32 accumulation: no TF32, no bf16 (a 3-pass bf16
// contraction already fails the 100 dB alias gate).
//
// Design (simple and right first): one thread block per (256-lane tile,
// 32-row tile of a_k, block k).  The contraction axis s is staged through
// shared memory 16 at a time (so a [64, 192] B2 weight block never has to fit
// at once): the a_k tile transposed, the ring rows as read.  Each thread keeps
// an 8 (j) x 8 (r) register tile, so every value read from shared memory
// feeds 8 FMAs and the loop is FMA-bound, not shared-memory bound.
// Neighbouring threads take neighbouring lanes r, so global loads and stores
// are coalesced; a warp shares one j group, so its a reads broadcast.  Any
// row is addressable (no 8-row alignment, no shifted weights), and ragged
// lane / row / width edges are masked.  Offsets are 64-bit: (row_k + s) * R
// + r is ~1.5e8 at the 1024-stream stereo fleet and grows with the fleet.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tiled {

constexpr int kTJ = 32;            // rows of a_k per block
constexpr int kTR = 256;           // lanes per block
constexpr int kBS = 16;            // contraction depth per shared-memory pass
constexpr int kTX = 32;            // threads across lanes
constexpr int kTY = 4;             // threads across rows of a_k
constexpr int kWJ = kTJ / kTY;     // 8 rows per thread
constexpr int kWR = kTR / kTX;     // 8 lanes per thread
constexpr int kThreads = kTX * kTY;
constexpr int kAPad = kTJ + 4;     // a_s row stride: 16-byte rows, fewer bank conflicts

// block_base == nullptr: row_k = base + k*L and a_k = a (the periodic
// form); otherwise row_k = base + block_base[k] and a_k = a + k*M*width (B2).
__global__ void __launch_bounds__(kThreads)
tiled_contract_kernel(const float* __restrict__ buffer,
                      const float* __restrict__ a,
                      const int64_t* __restrict__ block_base,
                      float* __restrict__ out,
                      int R, int64_t base, int L, int M, int width) {
  __shared__ __align__(16) float a_s[kBS][kAPad];
  __shared__ float b_s[kBS][kTR];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int r0 = blockIdx.x * kTR;
  const int j0 = blockIdx.y * kTJ;
  const int k = blockIdx.z;
  int64_t row0 = base;
  if (block_base != nullptr) {
    row0 += block_base[k];
    a += static_cast<int64_t>(k) * M * width;
  } else {
    row0 += static_cast<int64_t>(k) * L;
  }

  float acc[kWJ][kWR];
#pragma unroll
  for (int p = 0; p < kWJ; ++p)
#pragma unroll
    for (int q = 0; q < kWR; ++q) acc[p][q] = 0.0f;

  for (int s0 = 0; s0 < width; s0 += kBS) {
    // a_k[j0 : j0+kTJ, s0 : s0+kBS] -> a_s[s][j] (global reads run along s)
#pragma unroll
    for (int i = 0; i < (kTJ * kBS) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int jj = idx / kBS;
      const int ss = idx % kBS;
      const int j = j0 + jj;
      const int s = s0 + ss;
      a_s[ss][jj] = (j < M && s < width)
                        ? a[static_cast<int64_t>(j) * width + s]
                        : 0.0f;
    }
    // buffer[row0 + s0 : +kBS, r0 : r0+kTR] -> b_s (coalesced along r)
#pragma unroll
    for (int i = 0; i < (kBS * kTR) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int ss = idx / kTR;
      const int rr = idx % kTR;
      const int s = s0 + ss;
      const int r = r0 + rr;
      b_s[ss][rr] = (s < width && r < R)
                        ? buffer[(row0 + s) * static_cast<int64_t>(R) + r]
                        : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int ss = 0; ss < kBS; ++ss) {
      float av[kWJ];
      float bv[kWR];
      const float4* ap = reinterpret_cast<const float4*>(&a_s[ss][ty * kWJ]);
#pragma unroll
      for (int v = 0; v < kWJ / 4; ++v) {
        const float4 t = ap[v];
        av[4 * v + 0] = t.x;
        av[4 * v + 1] = t.y;
        av[4 * v + 2] = t.z;
        av[4 * v + 3] = t.w;
      }
#pragma unroll
      for (int q = 0; q < kWR; ++q) bv[q] = b_s[ss][tx + q * kTX];
#pragma unroll
      for (int p = 0; p < kWJ; ++p)
#pragma unroll
        for (int q = 0; q < kWR; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kWJ; ++p) {
    const int j = j0 + ty * kWJ + p;
    if (j >= M) continue;
    const int64_t orow = (static_cast<int64_t>(k) * M + j) * R;
#pragma unroll
    for (int q = 0; q < kWR; ++q) {
      const int r = r0 + tx + q * kTX;
      if (r < R) out[orow + r] = acc[p][q];
    }
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
inline int launch_tiled_contract(const float* buffer, const float* a,
                                 const int64_t* block_base, float* out, int R,
                                 int64_t base, int L, int M, int width, int K,
                                 void* stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((R + kTR - 1) / kTR, (M + kTJ - 1) / kTJ, K);
  if (grid.y > 65535u || grid.z > 65535u) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  tiled_contract_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      buffer, a, block_base, out, R, base, L, M, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tiled
