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
// w 192, R 2048) a call is 2*K*q*w*R = 3.17 GFLOP, 47.3 us at 67 TFLOP/s,
// against ~67 MB of compulsory traffic (the ~4,150 ring rows the blocks
// cover, read once, plus the 33 MB output), ~20 us at 3.35 TB/s.  Design: the
// tiled kernel of tiled_contract.cuh with a weight block and a row base per
// block k; the 48 KB [64, 192] weight block is staged through
// shared memory 16 columns at a time.  The tm fleet's farrow, lerp and wide
// step with "bm" outputs launches its fused epilogue (tiled_contract.cuh):
// the [B, out_cap, C] output, its rows past n_out zeroed and its peak
// metered by B2's own store.
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
// the buffer is 16-byte aligned.  B2's out_cap 0: out is the time-major
// [K, q, R]; out_cap > 0: the fused epilogue (tiled_contract.cuh), out the
// [R / C, out_cap, C] output (out_cap <= K q) with rows past n_out zeroed,
// and peak the zeroed f32 peak of the rows below n_out.
extern "C" int fir_farrow_contract(const float* buffer, const float* a_blk,
                                   const int64_t* block_base, float* out,
                                   int R, int64_t base, int K, int q, int w,
                                   int out_cap, int C, int n_out, float* peak,
                                   void* stream) {
  const tiled::Epilogue ep{out_cap, C, n_out, reinterpret_cast<unsigned*>(peak)};
  return tiled::launch_tiled_contract(buffer, a_blk, block_base, out, R, base,
                                      0, q, w, K, ep, stream);
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
