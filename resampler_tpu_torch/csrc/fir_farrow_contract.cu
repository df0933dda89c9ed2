// Kernels B2 and B3: blocked Farrow contraction of the time-major
// synchronized FIR fleet (coprime ratios: the farrow and lerp bases and the
// wide u32 schedule):
//
//   out[k, l, r] = sum_{s < w} a_blk[k, l, s] * buffer[base + block_base[k] + s, r]
//
// buffer [ring, R] f32, a_blk [K, q, w] f32 (each Farrow block's banded
// weights, built per step by the weights kernel below), block_base [K] int64
// (static), out [K, q, R] f32.  f32 FMA and accumulation, as B1.
//
// B2 replaces resampler_tpu/ops/fir_dma_kernel.py:225 dma_farrow_contract
// (body _farrow_kernel :91) for blocks of q >= 8 rows.  Bound on an H100: f32
// FMA.  At 44.1 -> 44.101 kHz, 128 taps, 1024 stereo streams (K 63, q 64,
// w 192, R 2048) the full contraction is 2*K*q*w*R = 3.17 GFLOP, 47.3 us at
// 67 TFLOP/s, against ~67 MB of compulsory traffic (the ~4,150 ring rows the
// blocks cover, read once, plus the 33 MB output), ~20 us at 3.35 TB/s.
//
// The band.  Row l of block k is zero outside the taps columns [j_loc[k, l]
// + wrap, + taps), wrap 0 or 1 by the step's residue (the weights kernel
// below).  A tile of TJ consecutive rows l0.. needs only the columns [lo,
// hi) = [min j_loc, min(w, max j_loc + 1 + taps)) over its rows, the same
// at every position; the host computes them once per plan and row tile
// (ops/fir_dma_kernel.py FarrowBandPlan) and the kernel reads `tiles` [K,
// n_tiles, 2].  tiles == nullptr is the full width in every tile (the
// general contraction).  Columns outside [lo, hi) are never read.  At the
// main shape TJ 32 takes 159-160 of the 192 columns: 2.634 GFLOP issued, 1.25x
// the taps-wide work.
//
// Design (kernel B1's, csrc/fir_banded_contract.cu, on per-block weights
// and row bases).  One block of 32 x 4 threads per (row tile t of 32 rows,
// lane tile of 256 lanes, Farrow block k), t fastest, so the blocks that
// read one k's ring rows run together and meet them in L2.  The band's
// columns stream through a kStages-deep ring of slices in shared memory,
// kDepth columns each: the tile's weights [kDepth][kAPitch] (transposed,
// 4-byte cp.async from a_blk's [q, w] rows, 16 columns of a row per 16
// threads) and the ring rows [kDepth][256] (16-byte cp.async.cg along the
// lanes, bypassing L1; 4-byte where R is not a multiple of 4).  The next
// slices' copies are in flight while this one is contracted; columns past
// hi, rows past q and lanes past R are zero-filled, never read.  Each thread
// keeps an 8 (rows) x 8 (lanes) register tile, its lanes two runs of 4
// consecutive lanes 128 apart: per column 2 float4 broadcast weight loads
// and 2 conflict-free float4 ring loads feed 64 FMAs.  Each output sums its
// band's terms in ascending column, one accumulator: the full contraction's
// fmaf chain less the terms whose weight is a structural zero.  Offsets are
// 64-bit: (row) * R + r is ~1.5e8 at the 1024-stream stereo fleet.
//
// The fused epilogue (kBM: the tm fleet's farrow, lerp and wide step with
// "bm" outputs).  The block stores its tile straight into the fleet's
// output [B, out_cap, C] (lane r = b*C + c, output row o = k*q + l): rows
// below n_out as computed, rows in [n_out, out_cap) as zeros, rows at or
// past out_cap not at all; and folds |x| of every stored row below n_out
// into *peak, an atomic max on the float's bits (|x| is non-negative, so
// the bits order as the values do, and a NaN's, its sign cleared, lie above
// +Inf's: the peak is NaN where any output is, as torch.amax's).  The
// caller zeroes *peak first.  A tile whose first row is at or past n_out
// skips the contraction; the rows kept are the same fmaf chain, in the same
// order, as the time-major form's.  In the target layout a warp's 32 lanes
// are 16 streams x 2 channels (at C 2), out_cap rows apart, so the tile is
// staged through shared memory (the stages', free after the last slice) as
// [32 rows][256 lanes] and stored stream by stream: a warp writes one
// stream's rows x C consecutive floats, coalesced.
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
//
// The weights kernel (fir_farrow_weights) builds B2's and B3's a_blk, every
// output row r = k*q + l, on the card from the step's residue word alone.  It
// replaces no TPU kernel: the JAX package forms a_blk with XLA ops
// (resampler_tpu/engine/fir_fleets.py:641-697: residues, basis values, a
// one-hot and one positioning einsum), which the port ran as host numpy, two
// uploads, a one-hot and a GEMM each step.  Per row, from static tables:
//
//   t = word + s_pad[r] (u32), wrap = t < word || t >= M, rem = wrap ? t - M : t
//   jl = j_loc[r] + wrap
//   a_blk[r, s] = sum_d coef_d(rem) * A[d, s - jl]  for 0 <= s - jl < taps, else 0.0f
//
// word is pos % M (narrow) or pos_lo (wide): for word < M < 2^31 the u32 rule
// is the narrow one.  coef_d are the Chebyshev values T_d(2 rem/M - 1) or
// (lerp) the blend of rows p1, p2 of U, in combine_basis' f32 operations and
// order (rounded intrinsics, so nvcc contracts none of them into an FMA).  The
// zeros outside each row's band are exact: the contraction multiplies ring
// rows past the step's end by them.  Bound: the store, 3.1 MB at 44.1 ->
// 44.101 kHz (4032 rows x 192 f32; 8.3 MFLOP in the bands), ~0.9 us at
// 3.35 TB/s; a launch that stores zeros alone takes 1.7 us on an H100.
// Design: a warp takes one row, a block 16; each lane forms the row's offset
// and coefficients in registers while the block stages the basis A in shared
// memory, then the lanes take the row's columns s = lane + 32k, each value's
// d1 products summed by fmaf in the order d = 0, 1, ...  All of a row's loads
// are in flight before the block's one barrier, and a value's 8 basis reads
// go out together: the forms that read them one per product behind a d < d1
// test, or formed a block's coefficients in shared memory first, waited on
// each load in turn (6.5-9.5 us a call against 3.6 us, on an H100 at 44.1 ->
// 44.101 kHz).

#include <cuda_runtime.h>

#include <cstdint>

namespace tiled {

constexpr int kTX = 32;               // threads across lanes: one warp
constexpr int kTY = 4;                // warps across rows
constexpr int kThreads = kTX * kTY;
constexpr int kRuns = 2;              // float4 lane runs per thread
constexpr int kTR = kTX * 4 * kRuns;  // 256 lanes per block
constexpr int kWJ = 8;                // rows per thread
constexpr int kTJ = kWJ * kTY;        // 32 rows per block
constexpr int kDepth = 16;            // band columns per slice
constexpr int kStages = 3;            // slices in flight
// a slice's weight row pitch: 16-byte rows for the float4 broadcasts, and
// 4 mod 32, so a half-warp's copies down one row's 16 columns meet 2-way
constexpr int kAPitch = kTJ + 4;
constexpr int kStageFloats = kDepth * (kAPitch + kTR);
constexpr int kSmem = 4 * kStages * kStageFloats;  // 56,064 B
constexpr int kPitch = kTR + 4;  // floats per row of the fused epilogue's staged tile
static_assert(kTJ * kPitch + kTY <= kStages * kStageFloats, "the staged tile fits the stages");

// The fused epilogue's output geometry and peak (out_cap 0: the time-major form).
struct Epilogue {
  int out_cap, C, n_out;
  unsigned* peak;  // the f32 peak's bits
};

// An asynchronous copy of `bytes` (0 or N) from global to shared memory;
// 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The fused epilogue of one block (see the header): the tile's rows below
// n_out metered into *peak and staged, the other rows staged as zeros, then
// stored stream by stream into out [B, out_cap, C].  o0 is the tile's first
// output row.
__device__ __forceinline__ void store_bm(const float (&acc)[kWJ][4 * kRuns], float* smem,
                                         float* __restrict__ out, int R, int M, int r0, int j0,
                                         int o0, const Epilogue& ep) {
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages
  unsigned top = 0;
#pragma unroll
  for (int p = 0; p < kWJ; ++p) {
    const int jl = ty * kWJ + p;
    const bool kept = j0 + jl < M && o0 + jl < ep.n_out;
#pragma unroll
    for (int q = 0; q < kRuns; ++q) {
      const int rl = q * 4 * kTX + 4 * tx;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = kept ? acc[p][4 * q + e] : 0.0f;
        if (r0 + rl + e < R) top = max(top, __float_as_uint(fabsf(v[e])));
      }
      *reinterpret_cast<float4*>(smem + jl * kPitch + rl) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  // the block's peak: each warp's, then one atomic
  unsigned* warp_top = reinterpret_cast<unsigned*>(smem + kTJ * kPitch);
  top = __reduce_max_sync(0xffffffffu, top);
  if (tx == 0) warp_top[ty] = top;
  __syncthreads();
  if (tid == 0) {
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

// Block k's rows start at base + block_base[k], its weights a_k = a + k*M*w
// ([M, w] row-major; M is the plan's q).  kBM: the fused epilogue into ep's
// [B, out_cap, C] output; else out is the time-major [K, M, R] and ep is
// not read.
template <bool kBM>
__global__ void __launch_bounds__(kThreads)
tiled_contract_kernel(const float* __restrict__ buffer, const float* __restrict__ a,
                      const int64_t* __restrict__ block_base, const int* __restrict__ tiles,
                      float* __restrict__ out, int R, int64_t base, int M, int w, int vec,
                      Epilogue ep) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int t = blockIdx.x;
  const int r0 = blockIdx.y * kTR;
  const int k = blockIdx.z;
  const int j0 = t * kTJ;
  const int o0 = k * M + j0;  // the tile's first output row
  if (kBM && o0 >= ep.out_cap) return;  // none of its rows is stored
  int lo = 0, hi = w;
  if (tiles != nullptr) {
    const int2 band = reinterpret_cast<const int2*>(tiles)[k * gridDim.x + t];
    lo = band.x;
    hi = band.y;
  }
  if (kBM && o0 >= ep.n_out) hi = lo;  // every row it stores is a zero
  const int width = hi - lo;
  const int n_slices = width > 0 ? (width + kDepth - 1) / kDepth : 0;
  const float* a_t = a + (static_cast<int64_t>(k) * M + j0) * w + lo;
  const float* ring = buffer + (base + block_base[k] + lo) * R;

  // slice i (band columns lo + i kDepth ..) into stage i % kStages
  auto stage = [&](int i) {
    float* as = smem + (i % kStages) * kStageFloats;  // [kDepth][kAPitch]
    float* bs = as + kDepth * kAPitch;                // [kDepth][kTR]
    const int s0 = i * kDepth;
#pragma unroll
    for (int n = 0; n < kDepth * kTJ / kThreads; ++n) {
      const int e = tid + n * kThreads;
      const int jj = e / kDepth, ss = e % kDepth;  // a_blk's rows run along the columns
      const bool in = s0 + ss < width && j0 + jj < M;
      cp_async4(as + ss * kAPitch + jj, in ? a_t + jj * w + s0 + ss : a, in ? 4 : 0);
    }
    if (vec) {
#pragma unroll
      for (int n = 0; n < kDepth * kTR / 4 / kThreads; ++n) {
        const int e = tid + n * kThreads;
        const int ss = e / (kTR / 4), r = r0 + 4 * (e % (kTR / 4));
        const bool in = s0 + ss < width && r < R;
        cp_async16(bs + 4 * e, in ? ring + static_cast<int64_t>(s0 + ss) * R + r : buffer,
                   in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kDepth * kTR; e += kThreads) {
        const int ss = e / kTR, r = r0 + e % kTR;
        const bool in = s0 + ss < width && r < R;
        cp_async4(bs + e, in ? ring + static_cast<int64_t>(s0 + ss) * R + r : buffer, in ? 4 : 0);
      }
    }
  };

  float acc[kWJ][4 * kRuns];
#pragma unroll
  for (int p = 0; p < kWJ; ++p)
#pragma unroll
    for (int q = 0; q < 4 * kRuns; ++q) acc[p][q] = 0.0f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_slices) stage(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_slices; ++i) {
    cp_async_wait<kStages - 2>();  // slice i has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and slice i - 1's stage is free
    if (i + kStages - 1 < n_slices) stage(i + kStages - 1);
    cp_async_commit();
    const float* as = smem + (i % kStages) * kStageFloats + ty * kWJ;
    const float* bs = smem + (i % kStages) * kStageFloats + kDepth * kAPitch + 4 * tx;
#pragma unroll
    for (int ss = 0; ss < kDepth; ++ss) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + ss * kAPitch);
      const float4 a1 = *reinterpret_cast<const float4*>(as + ss * kAPitch + 4);
      const float av[kWJ] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[4 * kRuns];
#pragma unroll
      for (int q = 0; q < kRuns; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(bs + ss * kTR + q * 4 * kTX);
        bv[4 * q + 0] = b.x;
        bv[4 * q + 1] = b.y;
        bv[4 * q + 2] = b.z;
        bv[4 * q + 3] = b.w;
      }
#pragma unroll
      for (int p = 0; p < kWJ; ++p)
#pragma unroll
        for (int q = 0; q < 4 * kRuns; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
  }

  if constexpr (kBM) {
    store_bm(acc, smem, out, R, M, r0, j0, o0, ep);
  } else {
#pragma unroll
    for (int p = 0; p < kWJ; ++p) {
      const int j = j0 + ty * kWJ + p;
      if (j >= M) break;
      float* orow = out + (static_cast<int64_t>(k) * M + j) * R;
#pragma unroll
      for (int q = 0; q < kRuns; ++q) {
        const int r = r0 + q * 4 * kTX + 4 * tx;
        const float* v = acc[p] + 4 * q;
        if (vec) {
          if (r < R) *reinterpret_cast<float4*>(orow + r) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (r + e < R) orow[r + e] = v[e];
        }
      }
    }
  }
}

template <bool kBM>
cudaError_t launch(const float* buffer, const float* a, const int64_t* block_base,
                   const int* tiles, float* out, int R, int64_t base, int K, int M, int w,
                   int vec, const Epilogue& ep, cudaStream_t stream) {
  const int64_t lane_tiles = (static_cast<int64_t>(R) + kTR - 1) / kTR;
  if (lane_tiles > 65535 || K > 65535) return cudaErrorInvalidConfiguration;
  const cudaError_t attr = cudaFuncSetAttribute(
      tiled_contract_kernel<kBM>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((M + kTJ - 1) / kTJ, static_cast<unsigned>(lane_tiles), K);
  tiled_contract_kernel<kBM><<<grid, kThreads, kSmem, stream>>>(buffer, a, block_base, tiles, out,
                                                                R, base, M, w, vec, ep);
  return cudaGetLastError();
}

}  // namespace tiled

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

constexpr int kWWarps = 16;              // rows per block, one a warp
constexpr int kWThreads = kWWarps * 32;
constexpr int kWStage = 4;               // basis values a thread loads before the barrier
constexpr int kD1Max = 16;               // basis rows (the wrapper's _WEIGHTS_D1_MAX)

// The combine coefficients of residue rem, c[d] for d < d1 (the rest are
// never read), in combine_basis' f32 operations and order.
template <bool kLerp>
__device__ __forceinline__ void weights_coefs(uint32_t rem, uint32_t M, const float* __restrict__ U,
                                              int phases, int d1, float (&c)[kD1Max]) {
  const float m_f = __uint2float_rn(M);
  if constexpr (kLerp) {
    // pf = rem * phases in int64, p1 = pf // M, p2 = min(p1 + 1, phases - 1)
    const int64_t pf = static_cast<int64_t>(rem) * phases;
    const int64_t p1 = pf / M;
    const int64_t p2 = p1 + 1 < phases ? p1 + 1 : phases - 1;
    const float f = __fdiv_rn(__ll2float_rn(pf - p1 * M), m_f);
    const float* u1 = U + p1 * d1;
    const float* u2 = U + p2 * d1;
#pragma unroll
    for (int d = 0; d < kD1Max; ++d) {
      if (d < d1) c[d] = __fadd_rn(u1[d], __fmul_rn(f, __fsub_rn(u2[d], u1[d])));
    }
  } else {
    // u = 2 (rem / M) - 1; T_{d+1} = (2u) T_d - T_{d-1}
    const float u = __fsub_rn(__fmul_rn(2.0f, __fdiv_rn(__uint2float_rn(rem), m_f)), 1.0f);
    const float u2 = __fmul_rn(2.0f, u);
    c[0] = 1.0f;
    c[1] = u;
#pragma unroll
    for (int d = 2; d < kD1Max; ++d) c[d] = __fsub_rn(__fmul_rn(u2, c[d - 1]), c[d - 2]);
  }
}

template <bool kLerp>
__global__ void __launch_bounds__(kWThreads)
farrow_weights_kernel(uint32_t word, uint32_t M, const uint32_t* __restrict__ s_pad,
                      const int* __restrict__ j_loc, const float* __restrict__ basis,
                      const float* __restrict__ U, int phases, int n_rows, int d1,
                      int taps, int w, float* __restrict__ a_blk) {
  extern __shared__ float4 a_s4[];       // [d1, taps] basis rows
  float* a_s = reinterpret_cast<float*>(a_s4);
  const int n = d1 * taps;
  const int r = blockIdx.x * kWWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;

  // the basis loads, the row's tables and its coefficients all in flight
  // before the one barrier
  float stage[kWStage];
#pragma unroll
  for (int k = 0; k < kWStage; ++k) {
    const int i = threadIdx.x + k * kWThreads;
    stage[k] = i < n ? basis[i] : 0.0f;
  }
  const bool live = r < n_rows;
  const uint32_t t = word + (live ? s_pad[r] : 0u);
  const bool wrap = t < word || t >= M;
  const int jl = (live ? j_loc[r] : 0) + (wrap ? 1 : 0);
  float c[kD1Max];
  weights_coefs<kLerp>(wrap ? t - M : t, M, U, phases, d1, c);
#pragma unroll
  for (int k = 0; k < kWStage; ++k) {
    const int i = threadIdx.x + k * kWThreads;
    if (i < n) a_s[i] = stage[k];
  }
  for (int i = threadIdx.x + kWStage * kWThreads; i < n; i += kWThreads) a_s[i] = basis[i];
  __syncthreads();
  if (!live) return;

  // the row's columns s = lane + 32k: a warp's basis reads fall in distinct
  // banks, its stores on 128 contiguous bytes
  float* out = a_blk + static_cast<int64_t>(r) * w;
  for (int s = lane; s < w; s += 32) {
    const int ts = s - jl;
    float acc = 0.0f;
    if (ts >= 0 && ts < taps) {
      // the basis rows 8 at a time, all 8 read (rows past d1 clamped, their
      // products skipped) so that a group's reads overlap
#pragma unroll
      for (int d0 = 0; d0 < kD1Max; d0 += 8) {
        if (d0 < d1) {
          float a[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) a[k] = a_s[min(d0 + k, d1 - 1) * taps + ts];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (d0 + k < d1) acc = fmaf(c[d0 + k], a[k], acc);
          }
        }
      }
    }
    out[s] = acc;
  }
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success).  The
// caller checks shapes and contiguity, that rows [base + block_base[k],
// + w) lie inside the ring for every k, and (B3, vec 4) that R % 4 == 0 and
// the buffer is 16-byte aligned.  B2's tiles: [K, ceil(q / 32), 2] band
// columns (lo, hi) per block and 32-row tile, or nullptr for the full
// width; vec: R % 4 == 0 and a 16-byte aligned buffer (16-byte ring copies,
// and stores of the time-major output).  out_cap 0: out is the time-major
// [K, q, R]; out_cap > 0: the fused epilogue, out the [R / C, out_cap, C]
// output (out_cap <= K q) with rows past n_out zeroed, and peak the zeroed
// f32 peak of the rows below n_out.
extern "C" int fir_farrow_contract(const float* buffer, const float* a_blk,
                                   const int64_t* block_base, const int* tiles, float* out,
                                   int R, int64_t base, int K, int q, int w, int vec,
                                   int out_cap, int C, int n_out, float* peak,
                                   void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const tiled::Epilogue ep{out_cap, C, n_out, reinterpret_cast<unsigned*>(peak)};
  return static_cast<int>(
      out_cap > 0
          ? tiled::launch<true>(buffer, a_blk, block_base, tiles, out, R, base, K, q, w, vec, ep, st)
          : tiled::launch<false>(buffer, a_blk, block_base, tiles, out, R, base, K, q, w, vec, ep,
                                 st));
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

// The step's weights a_blk [n_rows, w] (n_rows = K*q) for the residue word
// `word`: s_pad [n_rows] u32, j_loc [n_rows] int32, basis [d1, taps] f32,
// U [phases, d1] f32 for the lerp basis or nullptr for Chebyshev.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).  The caller checks
// shapes, contiguity and d1 <= 16; a band that runs past w is cut there.
extern "C" int fir_farrow_weights(unsigned int word, unsigned int M, const uint32_t* s_pad,
                                  const int* j_loc, const float* basis, const float* U,
                                  int phases, int n_rows, int d1, int taps, int w,
                                  float* a_blk, void* stream) {
  // the basis in dynamic shared memory
  const size_t smem = static_cast<size_t>(d1) * taps * sizeof(float);
  if (n_rows < 1 || d1 < 1 || d1 > kD1Max || taps < 1 || w < 1 || smem > kSmemMax ||
      (U != nullptr && phases < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_rows + kWWarps - 1) / kWWarps);
  if (U != nullptr) {
    farrow_weights_kernel<true><<<grid, kWThreads, smem, s>>>(
        word, M, s_pad, j_loc, basis, U, phases, n_rows, d1, taps, w, a_blk);
  } else {
    farrow_weights_kernel<false><<<grid, kWThreads, smem, s>>>(
        word, M, s_pad, j_loc, basis, U, phases, n_rows, d1, taps, w, a_blk);
  }
  return static_cast<int>(cudaGetLastError());
}
