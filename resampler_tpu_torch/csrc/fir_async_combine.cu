// Kernel B6: the fused contraction and Chebyshev combine of the ASYNC
// time-major FIR fleet (every stream keeps its own exact phase on one shared
// ring):
//
//   out[n, r] = sum_{d < 8} T_d(u[n, r]) * y[d],   n < n_out   (else 0)
//   y[d]      = sum_{t < taps} A[d, t] * buffer[base0 + off[r] + j[n] + c + t, r]
//
// where, with the lane's residue word res[r] and the static split s[n] =
// (n*L) % M, all in uint32 arithmetic (exact mod 2^32, as the JAX package's
// wide schedule; on narrow pairs nothing wraps):
//
//   t = res + s[n];  c = (t < res) | (t >= M);  rem = c ? t - M : t;
//   u = 2 * (float(rem) / float(M)) - 1      (IEEE division, round to nearest)
//
// buffer [ring, R] f32; a_t [taps, 8] f32 (the Farrow basis A, transposed);
// j [out_cap], s [out_cap] int64 (static tables); lanes [2, R] int64: row 0
// the residue word of each lane (its stream's r_b, or pos_lo when wide), row 1
// its stream's frame skew base_rel, read as off = base_rel where it lies in
// [1, skew] and 0 otherwise (the XLA step's region-select fall-through in
// starved states); out [out_cap, R] f32.
//
// Replaces resampler_tpu/ops/fir_async_kernel.py:294 build_async_combine
// (body _kernel :192, _contract :139, _residues :164, _combine :173).  The
// TPU kernel builds a per-block atlas of the basis rows because Mosaic cannot
// gather, and absorbs the 8-row DMA remainder with a static switch; here any
// ring row is addressable, so each output reads its taps rows directly.  The
// wrap candidate is chosen by SELECT, as the JAX XLA step does (not the TPU
// kernel's blend z0 + w (z1 - z0)), so only the chosen row's responses are
// evaluated: 8 * taps FMAs per output.
//
// Bound on an H100: f32 FMA.  At 44.1 -> 44.101 kHz, 128 taps, 1024 stereo
// streams (R 2048) and ~2050 emitted outputs a call is ~8.6 GFLOP, ~0.13 ms
// at 67 TFLOP/s, against ~19 MB of ring rows and ~18 MB of output, ~0.011 ms
// at 3.35 TB/s.  Design (simple first): a block is 32 consecutive lanes (one
// warp across lanes, so every ring-row load is one coalesced 128-byte
// segment) by 4 warps, each thread owning kNPT = 8 consecutive outputs of
// its lane, whose windows overlap, so the rows come from L1; A sits in
// shared memory as [taps][8] and is read as two broadcast 16-byte loads per
// tap, shared by the thread's 8 outputs.  f32 FMA, no tensor cores.
//
// B6b, the TPU kernel's default precision="bf16x4" (its _contract :139-161,
// weight split :396-413), is the same kernel with kSplit: each ring sample is
// split in registers, x = hi + lo (split_hi_lo, csrc/bf16_split.cuh), the
// basis comes as a_hi = bf16(A) and a_lo = bf16(A - a_hi) (round to nearest
// even on the host, as XLA's astype), and
//
//   y[d] = sum_t a_hi[d, t] hi_t + (d <= dc) * (a_hi[d, t] lo_t + a_lo[d, t] hi_t
//                                               + a_lo[d, t] lo_t)
//
// with the degree cut dc of the TPU kernel (:400-405: the correction
// products of degrees whose rows sit <= 1e-3 of the basis maximum are
// dropped).  Every product of two bf16 values is exact in f32, so CUDA-core
// FMAs compute the TPU kernel's products; only the order of the f32 sums
// differs.  B6b keeps B6's conventions (wrap row by select, IEEE division,
// the starved fall-through), not the TPU kernel's blend z0 + w (z1 - z0) and
// rem * (1/M).  Route: CUDA-core FMA, not tensor cores, because each output
// evaluates only its own row's 8 x taps responses (no shared atlas to feed a
// matrix unit) and B6 already runs on this layout; a tensor-core layout
// (lanes x rows tiles of the per-block atlas) is later perf work.  Work per
// output: (8 + 3 (dc + 1)) x taps products against B6's 8 x taps, each on
// bf16 operands (the bound counts them at the bf16 tensor-core peak, the
// least the card could take for them).

#include <cstdint>
#include <cuda_runtime.h>

#include "bf16_split.cuh"

namespace {

constexpr int kD1 = 8;       // Chebyshev degree 7 + 1
constexpr int kLanes = 32;   // lanes per block (threadIdx.x)
constexpr int kWarps = 4;    // threadIdx.y
constexpr int kNPT = 8;      // consecutive outputs per thread

// kSplit: B6b (a_lo_t and dc are read); else B6 (a_t is A in f32).
template <bool kSplit>
__global__ void __launch_bounds__(kLanes * kWarps)
async_combine_kernel(const float* __restrict__ buffer,
                     const float* __restrict__ a_t,
                     const float* __restrict__ a_lo_t,
                     const int64_t* __restrict__ j_tab,
                     const int64_t* __restrict__ s_tab,
                     const int64_t* __restrict__ lanes,
                     float* __restrict__ out, int R, int64_t base0, int n_out,
                     int out_cap, int taps, uint32_t M, int skew, int dc) {
  // [taps][2]: degrees 0-3, 4-7 of A (B6) or a_hi (B6b); B6b then a_lo
  extern __shared__ float4 a_s[];
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const float4* a_v = reinterpret_cast<const float4*>(a_t);
  for (int i = tid; i < 2 * taps; i += kLanes * kWarps) a_s[i] = a_v[i];
  if (kSplit) {
    const float4* lo_v = reinterpret_cast<const float4*>(a_lo_t);
    for (int i = tid; i < 2 * taps; i += kLanes * kWarps) a_s[2 * taps + i] = lo_v[i];
  }
  __syncthreads();

  const int r = blockIdx.x * kLanes + threadIdx.x;
  const int n0 = (blockIdx.y * kWarps + threadIdx.y) * kNPT;
  if (r >= R || n0 >= out_cap) return;

  if (n0 >= n_out) {  // masked lanes only: the n_out mask, nothing to read
    for (int i = 0; i < kNPT && n0 + i < out_cap; ++i)
      out[static_cast<int64_t>(n0 + i) * R + r] = 0.0f;
    return;
  }

  // ---- per-output residues (the JAX XLA step's arithmetic, rounding as
  // written: no contraction of the Chebyshev products) ----
  const uint32_t res = static_cast<uint32_t>(lanes[r]);
  const int64_t base_rel = lanes[R + r];
  const int64_t off = (base_rel >= 1 && base_rel <= skew) ? base_rel : 0;
  const float m_f = __uint2float_rn(M);
  int64_t row[kNPT];
  float u[kNPT];
#pragma unroll
  for (int i = 0; i < kNPT; ++i) {
    // outputs past n_out read output n0's rows (n0 < n_out) and are zeroed
    const int n = (n0 + i < n_out) ? n0 + i : n0;
    const uint32_t t = res + static_cast<uint32_t>(s_tab[n]);
    const bool wrap = (t < res) || (t >= M);
    const uint32_t rem = wrap ? t - M : t;
    const float frac = __fdiv_rn(__uint2float_rn(rem), m_f);
    u[i] = __fsub_rn(__fmul_rn(2.0f, frac), 1.0f);
    row[i] = base0 + off + j_tab[n] + (wrap ? 1 : 0);
  }

  // ---- basis responses at each output's chosen row ----
  float y[kNPT][kD1];
#pragma unroll
  for (int i = 0; i < kNPT; ++i)
#pragma unroll
    for (int d = 0; d < kD1; ++d) y[i][d] = 0.0f;
  const float* col = buffer + r;
  for (int t = 0; t < taps; ++t) {
    const float4 v0 = a_s[2 * t];
    const float4 v1 = a_s[2 * t + 1];
    const float a[kD1] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    float al[kD1];
    if (kSplit) {
      const float4 w0 = a_s[2 * taps + 2 * t];
      const float4 w1 = a_s[2 * taps + 2 * t + 1];
      const float l[kD1] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int d = 0; d < kD1; ++d) al[d] = l[d];
    }
#pragma unroll
    for (int i = 0; i < kNPT; ++i) {
      const float x = __ldg(col + (row[i] + t) * static_cast<int64_t>(R));
      if (kSplit) {
        const float xh = bf16_split_hi(x);
        const float xl = __bfloat162float(bf16_split_lo(x, xh));
#pragma unroll
        for (int d = 0; d < kD1; ++d) {
          y[i][d] = fmaf(a[d], xh, y[i][d]);
          if (d <= dc) {
            y[i][d] = fmaf(a[d], xl, y[i][d]);
            y[i][d] = fmaf(al[d], xh, y[i][d]);
            y[i][d] = fmaf(al[d], xl, y[i][d]);
          }
        }
      } else {
#pragma unroll
        for (int d = 0; d < kD1; ++d) y[i][d] = fmaf(a[d], x, y[i][d]);
      }
    }
  }

  // ---- Chebyshev recurrence and combine, then the n_out mask ----
#pragma unroll
  for (int i = 0; i < kNPT; ++i) {
    const int n = n0 + i;
    if (n >= out_cap) break;
    float acc = 0.0f;
    if (n < n_out) {
      const float u2 = __fmul_rn(2.0f, u[i]);
      float t_prev = 1.0f, t_cur = u[i];
      acc = y[i][0];
#pragma unroll
      for (int d = 1; d < kD1; ++d) {
        acc = fmaf(t_cur, y[i][d], acc);
        const float t_next = __fsub_rn(__fmul_rn(u2, t_cur), t_prev);
        t_prev = t_cur;
        t_cur = t_next;
      }
    }
    out[static_cast<int64_t>(n) * R + r] = acc;
  }
}

template <bool kSplit>
int launch(const float* buffer, const float* a_t, const float* a_lo_t, const int64_t* j_tab,
           const int64_t* s_tab, const int64_t* lanes, float* out, int R, int64_t base0,
           int n_out, int out_cap, int taps, int64_t M, int skew, int dc, void* stream) {
  const int per_block = kWarps * kNPT;
  const dim3 grid((R + kLanes - 1) / kLanes, (out_cap + per_block - 1) / per_block);
  const size_t smem = static_cast<size_t>(taps) * kD1 * sizeof(float) * (kSplit ? 2 : 1);
  if (grid.y > 65535u || smem > 48 * 1024 || M < 1 || M > 0xFFFFFFFFLL || dc < 0 || dc >= kD1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  async_combine_kernel<kSplit><<<grid, dim3(kLanes, kWarps), smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      buffer, a_t, a_lo_t, j_tab, s_tab, lanes, out, R, base0, n_out, out_cap, taps,
      static_cast<uint32_t>(M), skew, dc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 on success).  The
// caller checks shapes, contiguity, n_out <= out_cap and that every row
// [base0, base0 + skew + j[n_out - 1] + 1 + taps) lies in the ring.

// B6: a_t [taps, 8] f32, the Farrow basis A transposed.
extern "C" int fir_async_combine(const float* buffer, const float* a_t,
                                 const int64_t* j_tab, const int64_t* s_tab,
                                 const int64_t* lanes, float* out, int R,
                                 int64_t base0, int n_out, int out_cap,
                                 int taps, int64_t M, int skew, void* stream) {
  return launch<false>(buffer, a_t, nullptr, j_tab, s_tab, lanes, out, R, base0, n_out,
                       out_cap, taps, M, skew, 0, stream);
}

// B6b: a_hi_t, a_lo_t [taps, 8] f32 holding bf16 values (a_lo zero past
// degree dc); dc the last degree that takes the correction products.
extern "C" int fir_async_combine_bf16x4(const float* buffer, const float* a_hi_t,
                                        const float* a_lo_t, const int64_t* j_tab,
                                        const int64_t* s_tab, const int64_t* lanes,
                                        float* out, int R, int64_t base0, int n_out,
                                        int out_cap, int taps, int64_t M, int skew,
                                        int dc, void* stream) {
  return launch<true>(buffer, a_hi_t, a_lo_t, j_tab, s_tab, lanes, out, R, base0, n_out,
                      out_cap, taps, M, skew, dc, stream);
}
