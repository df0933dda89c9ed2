// Kernel B1: banded contraction of the time-major synchronized FIR fleet.
//
// Replaces resampler_tpu/ops/fir_dma_kernel.py:277 dma_banded_contract
// (Pallas body _kernel :58, remainder atlas build_shifted_atlas :50):
//
//   out[k, j, r] = sum_{s < span} a[j, s] * buffer[base + k*L + s, r],  k < K
//
// buffer [ring, R] f32, a [M, span] f32 (the banded atlas window), out
// [K, M, R] f32.  The tiled f32-FMA kernel it runs is shared with B2
// (tiled_contract.cuh, which holds the design notes).
//
// What bounds it on an H100: f32 FMA on the CUDA cores.  At the headline
// fleet (44.1 -> 48 kHz, Latency.Sample64 = 128 taps, 1024 stereo streams:
// K 28, M 160, span 276, R 2048) one call is 2*K*M*span*R = 5.06 GFLOP, 75.6 us
// at the 67 TFLOP/s f32 peak, against ~71.5 MB of compulsory traffic (the
// 4,245 distinct ring rows read once, 34.8 MB, plus the 36.7 MB output),
// 21.3 us at 3.35 TB/s (data sheet).  Only taps+1 of each atlas row's span
// columns are nonzero; skipping the zero band (~2.1x less work at 128 taps)
// is left to later work.

#include "tiled_contract.cuh"

// The caller checks shapes, contiguity and that rows
// [base, base + (K-1)*L + span) lie inside the ring.
extern "C" int fir_banded_contract(const float* buffer, const float* a,
                                   float* out, int R, int base, int L, int M,
                                   int span, int K, void* stream) {
  return tiled::launch_tiled_contract(buffer, a, nullptr, out, R, base, L, M,
                                      span, K, stream);
}
