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
//
// The fused epilogue (kBM: B2 in the tm fleet's farrow, lerp and wide step
// with "bm" outputs).  The block stores its tile straight into the fleet's
// output [B, out_cap, C] (lane r = b*C + c, output row o = k*M + j): rows
// below n_out as computed, rows in [n_out, out_cap) as zeros, rows at or
// past out_cap not at all; and folds |x| of every stored row below n_out
// into *peak, an atomic max on the float's bits (|x| is non-negative, so
// the bits order as the values do, and a NaN's, its sign cleared, lie above
// +Inf's: the peak is NaN where any output is, as torch.amax's).  The
// caller zeroes *peak first.  A tile whose first row is at or past n_out
// skips the contraction; the rows kept are the same fmaf chain, in the same
// order, as the time-major form's.  In the target layout a warp's 32 lanes
// are 16 streams x 2 channels (at C 2), out_cap rows apart, so the tile is
// staged through shared memory (the loop's, free after its last barrier)
// as [kTJ rows][kTR lanes] and stored stream by stream: a warp writes one
// stream's 32 rows x C consecutive floats, coalesced.  This replaces the
// mask's fill, the relayout's copy, abs and the peak's reduction over the
// 33 MB output after the kernel.

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
// floats of the contraction loop's shared memory (a_s, b_s)
constexpr int kLoopFloats = kBS * kAPad + kBS * kTR;
// the fused epilogue's staged tile: its row pitch (even, for float2 reads;
// 2 mod 32, so a half-warp's float2 reads down a column meet 32 banks) and
// its floats, the tile's and the warps' peaks
constexpr int kPitch = kTR + 2;
constexpr int kTileFloats = kTJ * kPitch + kTY;
static_assert(kTileFloats >= kLoopFloats, "the staged tile covers the loop's buffers");
static_assert(kTJ <= kTX, "a warp stores a stream's rows of the tile in one pass");

// The fused epilogue's output geometry and peak (out_cap 0: the time-major form).
struct Epilogue {
  int out_cap, C, n_out;
  unsigned* peak;  // the f32 peak's bits
};

// The fused epilogue of one block (see the header): the tile's rows below
// n_out metered into *peak and staged, the other rows staged as zeros, then
// stored stream by stream into out [B, out_cap, C].  o0 is the tile's first
// output row.
__device__ __forceinline__ void store_bm(const float (&acc)[kWJ][kWR], float* smem,
                                         float* __restrict__ out, int R, int M, int r0, int j0,
                                         int o0, const Epilogue& ep) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  // the contraction loop ends on a barrier: every warp is done with a_s, b_s
  unsigned top = 0;
#pragma unroll
  for (int p = 0; p < kWJ; ++p) {
    const int jl = ty * kWJ + p;
    const bool kept = j0 + jl < M && o0 + jl < ep.n_out;
#pragma unroll
    for (int q = 0; q < kWR; ++q) {
      const int rl = tx + q * kTX;
      const float v = kept ? acc[p][q] : 0.0f;
      if (r0 + rl < R) top = max(top, __float_as_uint(fabsf(v)));
      smem[jl * kPitch + rl] = v;
    }
  }
  // the block's peak: each warp's, then one atomic
  unsigned* warp_top = reinterpret_cast<unsigned*>(smem + kTJ * kPitch);
  top = __reduce_max_sync(0xffffffffu, top);
  if (tx == 0) warp_top[ty] = top;
  __syncthreads();
  if (tx == 0 && ty == 0) {
#pragma unroll
    for (int w = 1; w < kTY; ++w) top = max(top, warp_top[w]);
    if (top != 0) atomicMax(ep.peak, top);
  }
  // the tile's rows [o0, o0 + rows) of lanes [r0, r_end): stream b's are
  // rows x C consecutive floats at (b out_cap + o0) C.  A warp takes one
  // stream at a time
  const int C = ep.C;
  const int rows = min(min(kTJ, M - j0), ep.out_cap - o0);
  const int r_end = min(r0 + kTR, R);
  if (C == 2) {
    // stereo: lane i stores row i's two channels as one float2 (8-byte
    // aligned: the stream's offset is even; r0 is, so no stream is split)
    if (tx < rows) {
      for (int b = r0 / 2 + ty; 2 * b < r_end; b += kTY) {
        float2* seg =
            reinterpret_cast<float2*>(out + (static_cast<int64_t>(b) * ep.out_cap + o0) * 2);
        seg[tx] = *reinterpret_cast<const float2*>(smem + (2 * b - r0) + tx * kPitch);
      }
    }
    return;
  }
  // any C: lane i stores the stream's elements i, i + 32, ... (row e / C,
  // channel e % C, stepped without a division); a stream split between two
  // lane tiles stores its lanes from each
  const int n = rows * C;
  const int dj = kTX / C, dc = kTX % C;
  for (int b = r0 / C + ty; b * C < r_end; b += kTY) {
    float* seg = out + (static_cast<int64_t>(b) * ep.out_cap + o0) * C;
    const int rb = b * C - r0;  // the tile lane of the stream's channel 0
    int jl = tx / C, c = tx % C;
    for (int e = tx; e < n; e += kTX) {
      const int rl = rb + c;
      if (rl >= 0 && r0 + rl < r_end) seg[e] = smem[jl * kPitch + rl];
      jl += dj;
      c += dc;
      if (c >= C) {
        c -= C;
        ++jl;
      }
    }
  }
}

// block_base == nullptr: row_k = base + k*L and a_k = a (the periodic
// form); otherwise row_k = base + block_base[k] and a_k = a + k*M*width (B2).
// kBM: the fused epilogue into ep's [B, out_cap, C] output; else out is the
// time-major [K, M, R] and ep is not read.
template <bool kBM>
__global__ void __launch_bounds__(kThreads)
tiled_contract_kernel(const float* __restrict__ buffer,
                      const float* __restrict__ a,
                      const int64_t* __restrict__ block_base,
                      float* __restrict__ out,
                      int R, int64_t base, int L, int M, int width, Epilogue ep) {
  __shared__ __align__(16) float smem[kBM ? kTileFloats : kLoopFloats];
  float(*a_s)[kAPad] = reinterpret_cast<float(*)[kAPad]>(smem);
  float(*b_s)[kTR] = reinterpret_cast<float(*)[kTR]>(smem + kBS * kAPad);

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int r0 = blockIdx.x * kTR;
  const int j0 = blockIdx.y * kTJ;
  const int k = blockIdx.z;
  const int o0 = k * M + j0;  // the tile's first output row
  if (kBM && o0 >= ep.out_cap) return;  // none of its rows is stored
  // a tile whose every stored row is a zero contracts nothing
  const int depth = kBM && o0 >= ep.n_out ? 0 : width;
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

  for (int s0 = 0; s0 < depth; s0 += kBS) {
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

  if constexpr (kBM) {
    store_bm(acc, smem, out, R, M, r0, j0, o0, ep);
  } else {
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
}

// Launches on `stream` and returns cudaGetLastError() (0 on success):
// the fused epilogue where ep.out_cap > 0, else the time-major form.
inline int launch_tiled_contract(const float* buffer, const float* a,
                                 const int64_t* block_base, float* out, int R,
                                 int64_t base, int L, int M, int width, int K,
                                 const Epilogue& ep, void* stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((R + kTR - 1) / kTR, (M + kTJ - 1) / kTJ, K);
  if (grid.y > 65535u || grid.z > 65535u) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (ep.out_cap > 0) {
    tiled_contract_kernel<true><<<grid, block, 0, st>>>(buffer, a, block_base, out, R, base, L,
                                                        M, width, ep);
  } else {
    tiled_contract_kernel<false><<<grid, block, 0, st>>>(buffer, a, block_base, out, R, base, L,
                                                         M, width, ep);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tiled
