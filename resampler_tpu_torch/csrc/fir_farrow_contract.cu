// Kernels B2 and B3: blocked Farrow contraction of the time-major
// synchronized FIR fleet (coprime ratios: the farrow and lerp bases and the
// wide u32 schedule):
//
//   out[k, l, r] = sum_{s < w} a_blk[k, l, s] * buffer[base + block_base[k] + s, r]
//
// buffer [ring, R] f32, a_blk [K, q, w] f32 (each Farrow block's banded
// weights, built per step by the positioning matmul), block_base [K] int64
// (static), out [K, q, R] f32.  f32 FMA and accumulation, as B1.
//
// B2 replaces resampler_tpu/ops/fir_dma_kernel.py:225 dma_farrow_contract
// (body _farrow_kernel :91) for blocks of q >= 8 rows.  Bound on an H100: f32
// FMA.  At 44.1 -> 44.101 kHz, 128 taps, 1024 stereo streams (K 63, q 64,
// w 192, R 2048) a call is 2*K*q*w*R = 3.17 GFLOP, 47.3 us at 67 TFLOP/s,
// against ~67 MB of compulsory traffic (the ~4,150 ring rows the blocks
// cover, read once, plus the 33 MB output), ~20 us at 3.35 TB/s.  Design: the
// tiled kernel of tiled_contract.cuh with a weight block and a row base per
// block k; the 48 KB [64, 192] weight block is staged through
// shared memory 16 columns at a time.
//
// B3 replaces :170 dma_farrow_contract_packed (body _farrow_packed_kernel
// :127) for blocks of q < 8 rows (heavy coprime downsampling).  Bound: bytes.
// At 367500 -> 1601 Hz, 128 taps (K 20, q 1, w 129, R 2048) the blocks lie
// ~230 rows apart and do not overlap: 20 x 129 rows x 8 KB = 21 MB read for
// 0.16 MB written and 10.6 MFLOP, 6.3 us at 3.35 TB/s.  B1's 8 x 8 register
// tile would waste most of itself on q < 8 rows, so B3 is a streaming
// kernel: a thread block takes a group of G = ceil(8/q) Farrow blocks (>= 8
// output rows) over a 32-lane tile; its 256 threads split each block's w rows
// 32 ways, every thread loading 16 bytes of lanes per row (8 threads cover
// one 128-byte row segment, a warp four rows), so many loads are in flight;
// each block's weights sit in shared memory; the 32 partial sums per output
// are added in a fixed order in shared memory (deterministic).  No tensor
// cores: the 100 dB gate needs f32, and the work is bytes, not FMAs.  Ragged
// lane counts (R % 4 != 0) take the one-lane-per-thread instantiation.

#include "tiled_contract.cuh"

namespace {

constexpr int kPTX = 8;                  // threads across lane vectors
constexpr int kPTS = 32;                 // threads across the w rows
constexpr int kPThreads = kPTX * kPTS;   // 256
constexpr size_t kSmemMax = 48 * 1024;   // default dynamic shared memory

template <int Q, int VEC>
__global__ void __launch_bounds__(kPThreads)
farrow_packed_kernel(const float* __restrict__ buffer,
                     const float* __restrict__ a_blk,
                     const int64_t* __restrict__ block_base,
                     float* __restrict__ out, int R, int64_t base, int K,
                     int w) {
  constexpr int G = (8 + Q - 1) / Q;     // Farrow blocks per thread block
  constexpr int kLanes = kPTX * VEC;     // lanes per thread block
  extern __shared__ float smem[];
  float* a_s = smem;                     // [G*Q, w] weights of the group
  float* red = smem + G * Q * w;         // [kPTS, kLanes] partial sums

  const int tx = threadIdx.x;
  const int ts = threadIdx.y;
  const int tid = ts * kPTX + tx;
  const int k0 = blockIdx.y * G;
  const int r = blockIdx.x * kLanes + tx * VEC;

  const int64_t a0 = static_cast<int64_t>(k0) * Q * w;
  const int64_t a_end = static_cast<int64_t>(K) * Q * w;
  for (int i = tid; i < G * Q * w; i += kPThreads) {
    a_s[i] = (a0 + i < a_end) ? a_blk[a0 + i] : 0.0f;
  }
  __syncthreads();

  float acc[G][Q][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int l = 0; l < Q; ++l)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[g][l][v] = 0.0f;

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int k = k0 + g;
    if (k >= K || r >= R) continue;  // VEC 4 implies R % 4 == 0: r+3 < R
    const float* rows =
        buffer + (base + block_base[k]) * static_cast<int64_t>(R) + r;
    const float* ak = a_s + g * Q * w;
#pragma unroll 4
    for (int s = ts; s < w; s += kPTS) {
      float x[VEC];
      if constexpr (VEC == 4) {
        const float4 t = *reinterpret_cast<const float4*>(
            rows + static_cast<int64_t>(s) * R);
        x[0] = t.x;
        x[1] = t.y;
        x[2] = t.z;
        x[3] = t.w;
      } else {
        x[0] = rows[static_cast<int64_t>(s) * R];
      }
#pragma unroll
      for (int l = 0; l < Q; ++l) {
        const float c = ak[l * w + s];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[g][l][v] = fmaf(c, x[v], acc[g][l][v]);
      }
    }
  }

  // one output row at a time: the kPTS partial sums, added in order
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int l = 0; l < Q; ++l) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[ts * kLanes + tx * VEC + v] = acc[g][l][v];
      __syncthreads();
      const int k = k0 + g;
      const int rr = blockIdx.x * kLanes + tid;
      if (tid < kLanes && k < K && rr < R) {
        float sum = 0.0f;
        for (int t = 0; t < kPTS; ++t) sum += red[t * kLanes + tid];
        out[(static_cast<int64_t>(k) * Q + l) * R + rr] = sum;
      }
      __syncthreads();
    }
  }
}

template <int Q, int VEC>
int launch_packed(const float* buffer, const float* a_blk,
                  const int64_t* block_base, float* out, int R, int64_t base,
                  int K, int w, cudaStream_t stream) {
  constexpr int G = (8 + Q - 1) / Q;
  constexpr int kLanes = kPTX * VEC;
  const size_t smem = (static_cast<size_t>(G) * Q * w + kPTS * kLanes) * sizeof(float);
  const dim3 grid((R + kLanes - 1) / kLanes, (K + G - 1) / G);
  if (smem > kSmemMax || grid.y > 65535u) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  farrow_packed_kernel<Q, VEC><<<grid, dim3(kPTX, kPTS), smem, stream>>>(
      buffer, a_blk, block_base, out, R, base, K, w);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int dispatch_q(int q, const float* buffer, const float* a_blk,
               const int64_t* block_base, float* out, int R, int64_t base,
               int K, int w, cudaStream_t stream) {
  switch (q) {
    case 1: return launch_packed<1, VEC>(buffer, a_blk, block_base, out, R, base, K, w, stream);
    case 2: return launch_packed<2, VEC>(buffer, a_blk, block_base, out, R, base, K, w, stream);
    case 3: return launch_packed<3, VEC>(buffer, a_blk, block_base, out, R, base, K, w, stream);
    case 4: return launch_packed<4, VEC>(buffer, a_blk, block_base, out, R, base, K, w, stream);
    case 5: return launch_packed<5, VEC>(buffer, a_blk, block_base, out, R, base, K, w, stream);
    case 6: return launch_packed<6, VEC>(buffer, a_blk, block_base, out, R, base, K, w, stream);
    case 7: return launch_packed<7, VEC>(buffer, a_blk, block_base, out, R, base, K, w, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success).  The
// caller checks shapes and contiguity, that rows [base + block_base[k],
// + w) lie inside the ring for every k, and (B3, vec 4) that R % 4 == 0 and
// the buffer is 16-byte aligned.
extern "C" int fir_farrow_contract(const float* buffer, const float* a_blk,
                                   const int64_t* block_base, float* out,
                                   int R, int64_t base, int K, int q, int w,
                                   void* stream) {
  return tiled::launch_tiled_contract(buffer, a_blk, block_base, out, R, base,
                                      0, q, w, K, stream);
}

extern "C" int fir_farrow_contract_packed(const float* buffer,
                                          const float* a_blk,
                                          const int64_t* block_base,
                                          float* out, int R, int64_t base,
                                          int K, int q, int w, int vec,
                                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return vec == 4
             ? dispatch_q<4>(q, buffer, a_blk, block_base, out, R, base, K, w, s)
             : dispatch_q<1>(q, buffer, a_blk, block_base, out, R, base, K, w, s);
}
