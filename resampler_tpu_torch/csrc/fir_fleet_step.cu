// Kernels B9 and B8: the fused step of the end-aligned FIR fleets (the
// vmapped fleet with a schedule per stream, and the slide fleet with one
// shared schedule).  One launch does, for every stream b:
//
//   copy-in:  next[b, c, x] = new(b, c, x)                     x < valid_end
//   contract: out[b, i, c]  = sum_{t < taps} w_t[t, rem_i] * new(b, c, x0_i + t)
//                                                               i < n_out, else 0
//
// where new(b, c, x) is the end-aligned buffer after the copy-in, read
// through the copy-in select from the old buffer and the chunk:
//
//   new(x) = old[b, c, x + to_copy]   x < valid_end - to_copy
//          = chunk[b, x - (valid_end - to_copy), c]           x < valid_end
//          = 0                                                 (the zero slack)
//
// so no block depends on another's writes, and chunk frames past to_copy
// are never read (the NaN fence).  p = r + i*L, rem_i = p % M, x0_i = base +
// p / M.  Per stream, sched[b*sched_stride .. +4] = (to_copy, n_out, base, r)
// (the host schedule; stride 0 for the slide fleet's shared one).  old and
// next are [B, C, alloc] f32, distinct; next's columns past valid_end are
// not written (zero in every state).  chunk element (b, f, c) lies at
// b*sb + f*sf + c*sc, so frames-major and channel-major feeds take no
// relayout.  w_t [taps, M] f32 are the blended phase rows, transposed.
// out [B, out_cap, C] f32, frames-major.
//
// Replaces resampler_tpu/ops/fir_kernel.py:116 make_fir_fleet_step_pallas
// (B9) and resampler_tpu/ops/fir_sync_kernel.py:52
// make_fir_fleet_step_sync_pallas (B8).  The TPU kernels roll the whole
// buffer to reach dynamic offsets and contract an atlas window with K
// strided windows, because Mosaic cannot index lanes dynamically; here any
// column is addressable, so each output takes its taps-wide dot with its
// own phase row directly (the atlas's other columns are structural zeros).
//
// Bound on an H100: at 44.1 -> 48 kHz, 128 taps, 1024 stereo streams, chunk
// 4096 (R 2048, out_cap 4321) a step is ~2.27 GFLOP of f32 FMA (0.034 ms at
// 67 TFLOP/s) against ~102 MB of slide, chunk and output traffic (0.031 ms
// at 3.35 TB/s): about balanced.  Design (simple first): blocks of 128
// threads; a block either copies 512 columns of one stream's buffer or
// computes 128 consecutive outputs of one stream, one thread per output and
// kCT channels at once (one phase-row load per tap serves them all).  The
// taps split into the ranges read from the old buffer, from the chunk and
// from the slack, so the inner loops have no select.  Reads go through L1:
// neighbouring outputs read neighbouring columns.  f32 FMA, no tensor
// cores: the 100 dB alias gate needs f32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCopyPerThread = 4;

template <int kCT>
__global__ void __launch_bounds__(kThreads)
fleet_step_kernel(const float* __restrict__ old, const float* __restrict__ chunks,
                  const int* __restrict__ sched, int sched_stride,
                  const float* __restrict__ w_t, float* __restrict__ next,
                  float* __restrict__ out, int C, int alloc, int valid_end,
                  int64_t sb, int64_t sf, int64_t sc, int out_cap, int taps,
                  int L, int M, int copy_blocks) {
  const int b = blockIdx.y;
  const int* s = sched + static_cast<int64_t>(b) * sched_stride;
  const int to_copy = s[0], n_out = s[1], base = s[2], r = s[3];
  const int lim = valid_end - to_copy;  // new columns [0, lim) come from old
  const float* old_b = old + static_cast<int64_t>(b) * C * alloc;
  const float* chunk_b = chunks + static_cast<int64_t>(b) * sb;

  if (static_cast<int>(blockIdx.x) < copy_blocks) {
    // ---- copy-in: the next buffer's valid columns ----
    const int64_t n = static_cast<int64_t>(C) * valid_end;
    float* next_b = next + static_cast<int64_t>(b) * C * alloc;
#pragma unroll
    for (int k = 0; k < kCopyPerThread; ++k) {
      const int64_t e =
          (static_cast<int64_t>(blockIdx.x) * kCopyPerThread + k) * kThreads + threadIdx.x;
      if (e >= n) break;
      const int c = static_cast<int>(e / valid_end);
      const int x = static_cast<int>(e - static_cast<int64_t>(c) * valid_end);
      const float v = x < lim ? old_b[static_cast<int64_t>(c) * alloc + x + to_copy]
                              : chunk_b[(x - lim) * sf + c * sc];
      next_b[static_cast<int64_t>(c) * alloc + x] = v;
    }
    return;
  }

  // ---- contraction: one output of stream b per thread ----
  const int i = (static_cast<int>(blockIdx.x) - copy_blocks) * kThreads + threadIdx.x;
  if (i >= out_cap) return;
  float* out_i = out + (static_cast<int64_t>(b) * out_cap + i) * C;
  if (i >= n_out) {  // the n_out mask; nothing to read
    for (int c = 0; c < C; ++c) out_i[c] = 0.0f;
    return;
  }
  const int64_t p = r + static_cast<int64_t>(i) * L;
  const int rem = static_cast<int>(p % M);
  const int x0 = base + static_cast<int>(p / M);
  // taps [0, t1) read the old buffer, [t1, t2) the chunk, [t2, taps) the
  // zero slack (which adds nothing)
  const int t1 = min(max(lim - x0, 0), taps);
  const int t2 = min(max(valid_end - x0, 0), taps);
  const float* w = w_t + rem;
  for (int c0 = 0; c0 < C; c0 += kCT) {
    float acc[kCT];
#pragma unroll
    for (int k = 0; k < kCT; ++k) acc[k] = 0.0f;
    const float* o = old_b + static_cast<int64_t>(c0) * alloc + x0 + to_copy;
    for (int t = 0; t < t1; ++t) {
      const float wv = __ldg(w + static_cast<int64_t>(t) * M);
#pragma unroll
      for (int k = 0; k < kCT; ++k)
        acc[k] = fmaf(wv, __ldg(o + static_cast<int64_t>(k) * alloc + t), acc[k]);
    }
    const float* ch = chunk_b + static_cast<int64_t>(c0) * sc;
    for (int t = t1; t < t2; ++t) {
      const float wv = __ldg(w + static_cast<int64_t>(t) * M);
      const int64_t f = static_cast<int64_t>(x0 + t - lim) * sf;
#pragma unroll
      for (int k = 0; k < kCT; ++k)
        acc[k] = fmaf(wv, __ldg(ch + f + k * sc), acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kCT; ++k) out_i[c0 + k] = acc[k];
  }
}

template <int kCT>
cudaError_t launch_tile(const float* old, const float* chunks, const int* sched,
                        int sched_stride, const float* w_t, float* next, float* out,
                        int B, int C, int alloc, int valid_end, int64_t sb, int64_t sf,
                        int64_t sc, int out_cap, int taps, int L, int M,
                        cudaStream_t stream) {
  const int64_t per_copy = static_cast<int64_t>(kThreads) * kCopyPerThread;
  const int64_t copy_blocks = (static_cast<int64_t>(C) * valid_end + per_copy - 1) / per_copy;
  const int64_t out_blocks = (out_cap + kThreads - 1) / kThreads;
  if (copy_blocks + out_blocks > 0x7FFFFFFF || B > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(copy_blocks + out_blocks), static_cast<unsigned>(B));
  fleet_step_kernel<kCT><<<grid, kThreads, 0, stream>>>(
      old, chunks, sched, sched_stride, w_t, next, out, C, alloc, valid_end, sb, sf, sc,
      out_cap, taps, L, M, static_cast<int>(copy_blocks));
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks shapes, that next does not overlap old, that the schedule is
// exact and that every emitting stream's reads stay inside its buffer.
extern "C" int fir_fleet_step(const float* old, const float* chunks, const int* sched,
                              int sched_stride, const float* w_t, float* next, float* out,
                              int B, int C, int alloc, int valid_end, int64_t sb,
                              int64_t sf, int64_t sc, int out_cap, int taps, int L, int M,
                              void* stream) {
  if (B < 1 || C < 1 || M < 1 || L < 1 || taps < 1 || valid_end > alloc) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // the widest channel tile that divides C: no masked lanes in the loops
  if (C % 8 == 0) {
    err = launch_tile<8>(old, chunks, sched, sched_stride, w_t, next, out, B, C, alloc,
                         valid_end, sb, sf, sc, out_cap, taps, L, M, st);
  } else if (C % 4 == 0) {
    err = launch_tile<4>(old, chunks, sched, sched_stride, w_t, next, out, B, C, alloc,
                         valid_end, sb, sf, sc, out_cap, taps, L, M, st);
  } else if (C % 2 == 0) {
    err = launch_tile<2>(old, chunks, sched, sched_stride, w_t, next, out, B, C, alloc,
                         valid_end, sb, sf, sc, out_cap, taps, L, M, st);
  } else {
    err = launch_tile<1>(old, chunks, sched, sched_stride, w_t, next, out, B, C, alloc,
                         valid_end, sb, sf, sc, out_cap, taps, L, M, st);
  }
  return static_cast<int>(err);
}
