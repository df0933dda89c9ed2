// Kernel B1: banded contraction of the time-major synchronized FIR fleet.
//
// Replaces resampler_tpu/ops/fir_dma_kernel.py:277 dma_banded_contract
// (Pallas body _kernel :58, remainder atlas build_shifted_atlas :50):
//
//   out[k, j, r] = sum_{s < span} a[j, s] * buffer[base + k*L + s, r],  k < K
//
// buffer [ring, R] f32 row-major, a [M, span] f32 at any strides (the fleet
// passes a window of its transposed atlas, read in place), out [K, M, R] f32.
// f32 inputs, f32 FMA, f32 sums: no TF32, no bf16 (a 3-pass bf16
// contraction already fails the 100 dB alias gate).
//
// The band.  Row j of the fleet's atlas window (start phase i0) is zero
// outside the taps columns [off(i0 + j) - off(i0), + taps), off(ii) =
// floor(ii L / M).  A tile of TJ consecutive rows j0.. needs only the columns
// [lo, hi) = [off(i0 + j0) - off(i0), off(i0 + j0 + TJ - 1) - off(i0) + taps)
// (clipped to span); the host computes them per start phase and row tile
// (ops/fir_dma_kernel.py BandPlan) and the kernel reads `tiles` [n_tiles, 2]
// for the step's i0.  tiles == nullptr is the full span in every tile (the
// general contraction).  Columns outside [lo, hi) are never read.
//
// What bounds it on an H100: f32 FMA on the CUDA cores.  At the headline
// fleet (44.1 -> 48 kHz, Latency.Sample64 = 128 taps, 1024 stereo streams:
// K 28, M 160, span 276, R 2048) the work the contraction needs is
// 2*K*M*taps*R = 2.349 GFLOP, 35.1 us at the 67 TFLOP/s f32 peak, against
// ~71.7 MB of compulsory traffic (the 4,245 distinct ring rows read once,
// 34.8 MB, plus the 36.7 MB output), 21.4 us at 3.35 TB/s (data sheet).  The
// span-wide form issues 5.065 GFLOP (75.6 us); the band form at TJ 32
// issues 0.567 of that, 2.87 GFLOP (1.22x the taps-wide work).
//
// Design.  One block of 32 x TY threads per (row tile t of TJ = 8 TY rows,
// lane tile of kTR lanes, period block k), t fastest, so the blocks that read
// one k's ring rows run together and meet them in L2.  The band's columns
// are streamed through a kStages-deep ring of slices in shared memory, each
// slice kDepth columns: the tile's weights [kDepth][TJ] (transposed,
// 4-byte cp.async, j fastest: coalesced from the transposed atlas) and the
// ring rows [kDepth][kTR] (16-byte cp.async.cg along the lanes, bypassing
// L1; 4-byte where R is not a multiple of 4).  Each weight and each ring row
// of the band is copied once per block, and the next slices' copies are in
// flight while this one is contracted; rows past hi, past M and lanes past
// R are zero-filled, never read.  Each thread keeps an 8 (j) x 4 kRuns
// (lanes) register tile; its lanes are kRuns runs of 4 consecutive lanes,
// 128 apart, so a warp's ring loads are 16-byte and conflict-free and its
// weight loads one broadcast: per column 2 + kRuns float4 shared loads feed
// 32 kRuns FMAs.  Counting a broadcast as 16 bytes to every lane, that is
// 1 byte delivered per FMA (the SM's 128 B/clk against its 128 FMA/clk).
// At the main path the kernel issues FMAs at ~48% of the f32 peak on an
// H100 (chip_smoke.py phase 3), 166 registers, 3 blocks of 4 warps per SM.
// Shared memory is not what holds it there: a layout of 4 row groups x 8
// lane groups per warp, whose four loads per column fill one 128-byte
// wavefront each (0.25 B per FMA), measured no faster (it takes more
// registers: 2 blocks per SM), and a 4-block bound (128 registers) spills
// and is slower.  Stores are float4 along the lanes, coalesced.
// Offsets are 64-bit: (row) * R + r is ~1.5e8 at the 1024-stream stereo
// fleet.
//
// The fused epilogue (kBM: the tm fleet's periodic f32 step with "bm"
// outputs).  The block stores its tile straight into the fleet's output
// [B, out_cap, C] (lane r = b*C + c, output row k*M + j): rows below n_out
// as computed, rows in [n_out, out_cap) as zeros, rows at or past out_cap
// not at all; and folds |x| of every stored row below n_out into *peak, an
// atomic max on the float's bits (|x| is non-negative, so the bits order
// as the values do, and a NaN's, its sign cleared, lie above +Inf's: the
// peak is NaN where any output is, as torch.amax's).  The caller zeroes
// *peak first.  A tile whose first row is at or past n_out skips the
// contraction; the rows kept are summed as in the time-major form, in the
// same order.  In the target layout a warp's 32 lanes are 16 streams x 2
// channels (at C 2), out_cap rows apart, so the tile is staged through
// shared memory (the pipeline's, free after the last slice) as [TJ rows]
// [kTR lanes] and stored stream by stream: a warp writes one stream's rows
// x C consecutive floats, coalesced.  This replaces three passes over the
// 35 MB output after the kernel (the relayout's copy, abs and the peak's
// reduction) and the mask's fill.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTX = 32;      // threads across lanes: one warp
constexpr int kRuns = 2;     // float4 lane runs per thread
constexpr int kTR = kTX * 4 * kRuns;  // lanes per block
constexpr int kWJ = 8;       // rows per thread
constexpr int kDepth = 16;   // band columns per slice
constexpr int kStages = 3;   // slices in flight

constexpr int kPitch = kTR + 4;  // floats per row of the fused epilogue's staged tile

template <int kTY>
struct Tile {
  static constexpr int kTJ = kWJ * kTY;
  static constexpr int kThreads = kTX * kTY;
  static constexpr int kStageFloats = kDepth * (kTJ + kTR);
  static constexpr int kSmem = 4 * kStages * kStageFloats;
  static_assert(kTJ * kPitch + kTY <= kStages * kStageFloats, "the staged tile fits the stages");
};

// The fused epilogue's output geometry and peak.
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
// stored stream by stream into out [B, out_cap, C].
template <int kTY>
__device__ __forceinline__ void store_bm(const float (&acc)[kWJ][4 * kRuns], float* smem,
                                         float* __restrict__ out, int R, int M, int r0, int j0,
                                         int row0, const Epilogue& ep) {
  using T = Tile<kTY>;
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages
  unsigned top = 0;
#pragma unroll
  for (int p = 0; p < kWJ; ++p) {
    const int jl = ty * kWJ + p;
    const bool kept = j0 + jl < M && row0 + jl < ep.n_out;
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
  unsigned* warp_top = reinterpret_cast<unsigned*>(smem + T::kTJ * kPitch);
  top = __reduce_max_sync(0xffffffffu, top);
  if (tx == 0) warp_top[ty] = top;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < kTY; ++w) top = max(top, warp_top[w]);
    if (top != 0) atomicMax(ep.peak, top);
  }
  // the tile's rows [row0, row0 + rows) of lanes [r0, r_end): stream b's are
  // rows x C consecutive floats at (b out_cap + row0) C.  A warp takes one
  // stream at a time
  const int C = ep.C;
  const int rows = min(min(T::kTJ, M - j0), ep.out_cap - row0);
  const int r_end = min(r0 + kTR, R);
  if (C == 2) {
    // stereo: lane i stores row i's two channels as one float2 (8-byte
    // aligned: the stream's offset is even; r0 is, so no stream is split)
    for (int b = r0 / 2 + ty; 2 * b < r_end; b += kTY) {
      float2* seg =
          reinterpret_cast<float2*>(out + (static_cast<int64_t>(b) * ep.out_cap + row0) * 2);
      const float* col = smem + (2 * b - r0);
      for (int jl = tx; jl < rows; jl += kTX)
        seg[jl] = *reinterpret_cast<const float2*>(col + jl * kPitch);
    }
    return;
  }
  // any C: lane i stores the stream's elements i, i + 32, ... (row e / C,
  // channel e % C, stepped without a division); a stream split between two
  // lane tiles stores its lanes from each
  const int n = rows * C;
  const int dj = kTX / C, dc = kTX % C;
  for (int b = r0 / C + ty; b * C < r_end; b += kTY) {
    float* seg = out + (static_cast<int64_t>(b) * ep.out_cap + row0) * C;
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

template <int kTY, bool kBM>
__global__ void __launch_bounds__(kTX * kTY)
band_contract_kernel(const float* __restrict__ buffer, const float* __restrict__ a,
                     int64_t a_sj, int64_t a_ss, const int* __restrict__ tiles,
                     float* __restrict__ out, int R, int64_t base, int L, int M, int span,
                     int vec, Epilogue ep) {
  using T = Tile<kTY>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int t = blockIdx.x;
  const int r0 = blockIdx.y * kTR;
  const int k = blockIdx.z;
  const int j0 = t * T::kTJ;
  const int row0 = k * M + j0;  // the tile's first output row
  if (kBM && row0 >= ep.out_cap) return;  // none of its rows is stored
  int lo = 0, hi = span;
  if (tiles != nullptr) {
    lo = tiles[2 * t];
    hi = tiles[2 * t + 1];
  }
  if (kBM && row0 >= ep.n_out) hi = lo;  // every row it stores is a zero
  const int width = hi - lo;
  const int n_slices = width > 0 ? (width + kDepth - 1) / kDepth : 0;
  const float* a_t = a + j0 * a_sj + lo * a_ss;
  const float* ring = buffer + (base + static_cast<int64_t>(k) * L + lo) * R;

  // slice i (band columns lo + i kDepth ..) into stage i % kStages
  auto stage = [&](int i) {
    float* as = smem + (i % kStages) * T::kStageFloats;  // [kDepth][kTJ]
    float* bs = as + kDepth * T::kTJ;                    // [kDepth][kTR]
    const int s0 = i * kDepth;
#pragma unroll
    for (int n = 0; n < kDepth * T::kTJ / T::kThreads; ++n) {
      const int e = tid + n * T::kThreads;
      const int ss = e / T::kTJ, jj = e % T::kTJ;
      const bool in = s0 + ss < width && j0 + jj < M;
      cp_async4(as + e, in ? a_t + jj * a_sj + (s0 + ss) * a_ss : a, in ? 4 : 0);
    }
    if (vec) {
#pragma unroll
      for (int n = 0; n < kDepth * kTR / 4 / T::kThreads; ++n) {
        const int e = tid + n * T::kThreads;
        const int ss = e / (kTR / 4), r = r0 + 4 * (e % (kTR / 4));
        const bool in = s0 + ss < width && r < R;
        cp_async16(bs + 4 * e, in ? ring + static_cast<int64_t>(s0 + ss) * R + r : buffer,
                   in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kDepth * kTR; e += T::kThreads) {
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
    const float* as = smem + (i % kStages) * T::kStageFloats + ty * kWJ;
    const float* bs = smem + (i % kStages) * T::kStageFloats + kDepth * T::kTJ + 4 * tx;
#pragma unroll
    for (int ss = 0; ss < kDepth; ++ss) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + ss * T::kTJ);
      const float4 a1 = *reinterpret_cast<const float4*>(as + ss * T::kTJ + 4);
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
    store_bm<kTY>(acc, smem, out, R, M, r0, j0, row0, ep);
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

template <int kTY, bool kBM>
cudaError_t launch(const float* buffer, const float* a, int64_t a_sj, int64_t a_ss,
                   const int* tiles, float* out, int R, int64_t base, int L, int M, int span,
                   int K, int vec, const Epilogue& ep, cudaStream_t stream) {
  using T = Tile<kTY>;
  const int64_t lane_tiles = (static_cast<int64_t>(R) + kTR - 1) / kTR;
  if (lane_tiles > 65535 || K > 65535) return cudaErrorInvalidConfiguration;
  const cudaError_t attr = cudaFuncSetAttribute(
      band_contract_kernel<kTY, kBM>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((M + T::kTJ - 1) / T::kTJ, static_cast<unsigned>(lane_tiles), K);
  band_contract_kernel<kTY, kBM><<<grid, T::kThreads, T::kSmem, stream>>>(
      buffer, a, a_sj, a_ss, tiles, out, R, base, L, M, span, vec, ep);
  return cudaGetLastError();
}

template <int kTY>
cudaError_t launch(const float* buffer, const float* a, int64_t a_sj, int64_t a_ss,
                   const int* tiles, float* out, int R, int64_t base, int L, int M, int span,
                   int K, int vec, const Epilogue& ep, cudaStream_t stream) {
  return ep.out_cap > 0
             ? launch<kTY, true>(buffer, a, a_sj, a_ss, tiles, out, R, base, L, M, span, K, vec,
                                 ep, stream)
             : launch<kTY, false>(buffer, a, a_sj, a_ss, tiles, out, R, base, L, M, span, K, vec,
                                  ep, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// rows: the tile's TJ, 16 or 32; tiles: [ceil(M / rows), 2] band columns
// (lo, hi) per row tile, or nullptr for the full span; vec: R % 4 == 0
// and a 16-byte aligned buffer (16-byte ring copies, and stores of the
// time-major output).  out_cap 0: out is the time-major [K, M, R]; out_cap
// > 0: the fused epilogue, out the [R / C, out_cap, C] output (out_cap <=
// K M) with rows past n_out zeroed, and peak the zeroed f32 peak of the
// rows below n_out.  The caller checks shapes, the tiles' bounds, and
// that rows [base, base + (K-1)*L + span) lie inside the ring.
extern "C" int fir_banded_contract(const float* buffer, const float* a, int64_t a_sj,
                                   int64_t a_ss, const int* tiles, float* out, int R,
                                   int64_t base, int L, int M, int span, int K, int rows,
                                   int vec, int out_cap, int C, int n_out, float* peak,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epilogue ep{out_cap, C, n_out, reinterpret_cast<unsigned*>(peak)};
  cudaError_t err;
  if (rows == 32) {
    err = launch<4>(buffer, a, a_sj, a_ss, tiles, out, R, base, L, M, span, K, vec, ep, st);
  } else if (rows == 16) {
    err = launch<2>(buffer, a, a_sj, a_ss, tiles, out, R, base, L, M, span, K, vec, ep, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
