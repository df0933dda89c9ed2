// Kernel B1: banded contraction of the time-major synchronized FIR fleet.
//
// Replaces resampler_tpu/ops/fir_dma_kernel.py:277 dma_banded_contract
// (Pallas body _kernel :58, remainder atlas build_shifted_atlas :50):
//
//   out[k, j, r] = sum_{s < span} a[j, s] * buffer[base + k*L + s, r],  k < K
//
// buffer [ring, R] f32 row-major (frames x stream-channel lanes), a [M, span]
// f32, out [K, M, R] f32.  f32 inputs, f32 FMA, f32 accumulation: no TF32, no
// bf16 (a 3-pass bf16 contraction already fails the 100 dB alias gate).
//
// What bounds it on an H100: f32 FMA on the CUDA cores.  At the headline
// fleet (44.1 -> 48 kHz, Latency.Sample64 = 128 taps, 1024 stereo streams:
// K 28, M 160, span 276, R 2048) one call is 2*K*M*span*R = 5.1 GFLOP
// against ~63 MB of ring rows read (each period block's window; ~35 MB of
// them distinct) and ~37 MB written, ~50 flop/byte -- above the f32 ridge of
// the card (67 TFLOP/s over 3.35 TB/s = 20 flop/byte, data sheet).
//
// Design (simple and right first): one block per (256-lane tile, 32-row atlas
// tile, period block k).  The contraction axis s is staged through shared
// memory 16 at a time: the a tile transposed, the ring rows as read.  Each
// thread keeps an 8 (j) x 8 (r) register tile, so every value read from
// shared memory feeds 8 FMAs and the loop is FMA-bound, not shared-memory
// bound.  Neighbouring threads take neighbouring lanes r, so global loads and
// stores are coalesced; a warp shares one j group, so its a reads broadcast.
// Any base row is addressable (no 8-row alignment, no shifted atlas), and
// ragged lane / atlas-row / span edges are masked.  Offsets are 64-bit:
// (base + k*L + s) * R + r is ~1.5e8 at the headline shape and grows with the
// fleet.  Only taps+1 of each atlas row's span columns are nonzero; skipping
// the zero band (~3.3x less work) is left to later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTJ = 32;            // atlas rows per block
constexpr int kTR = 256;           // lanes per block
constexpr int kBS = 16;            // contraction depth per shared-memory pass
constexpr int kTX = 32;            // threads across lanes
constexpr int kTY = 4;             // threads across atlas rows
constexpr int kWJ = kTJ / kTY;     // 8 atlas rows per thread
constexpr int kWR = kTR / kTX;     // 8 lanes per thread
constexpr int kThreads = kTX * kTY;
constexpr int kAPad = kTJ + 4;     // a_s row stride: 16-byte rows, fewer bank conflicts

__global__ void __launch_bounds__(kThreads)
banded_contract_kernel(const float* __restrict__ buffer,
                       const float* __restrict__ a,
                       float* __restrict__ out,
                       int R, int base, int L, int M, int span) {
  __shared__ __align__(16) float a_s[kBS][kAPad];
  __shared__ float b_s[kBS][kTR];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int r0 = blockIdx.x * kTR;
  const int j0 = blockIdx.y * kTJ;
  const int k = blockIdx.z;
  const int64_t row0 = static_cast<int64_t>(base) + static_cast<int64_t>(k) * L;

  float acc[kWJ][kWR];
#pragma unroll
  for (int p = 0; p < kWJ; ++p)
#pragma unroll
    for (int q = 0; q < kWR; ++q) acc[p][q] = 0.0f;

  for (int s0 = 0; s0 < span; s0 += kBS) {
    // a[j0 : j0+kTJ, s0 : s0+kBS] -> a_s[s][j] (global reads run along s)
#pragma unroll
    for (int i = 0; i < (kTJ * kBS) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int jj = idx / kBS;
      const int ss = idx % kBS;
      const int j = j0 + jj;
      const int s = s0 + ss;
      a_s[ss][jj] = (j < M && s < span)
                        ? a[static_cast<int64_t>(j) * span + s]
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
      b_s[ss][rr] = (s < span && r < R)
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

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks shapes, contiguity and that rows [base, base + (K-1)*L + span)
// lie inside the ring.
extern "C" int fir_banded_contract(const float* buffer, const float* a,
                                   float* out, int R, int base, int L, int M,
                                   int span, int K, void* stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((R + kTR - 1) / kTR, (M + kTJ - 1) / kTJ, K);
  if (grid.y > 65535u || grid.z > 65535u) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  banded_contract_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      buffer, a, out, R, base, L, M, span);
  return static_cast<int>(cudaGetLastError());
}
