// The bf16 hi/lo operand split of resampler_tpu/ops/matmul3.py:39
// split_hi_lo, in registers, bit for bit the port's plain version
// (resampler_tpu_torch/ops/matmul3.py): hi = bf16(a) by integer round to
// nearest even on the f32 bits, a non-finite value passing through (so its
// lo is NaN), and lo = bf16(a - hi) with subnormal operands and results of
// the subtraction treated as zero of the same sign, as XLA does.  Included by
// the magsplit (B4/B5), matmul3 (B7) and async combine (B6b) kernels; B4/B5
// split two values at a time with bf16x2_split_hi / bf16x2_split_lo.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

// Subnormals to zero of the same sign.
__device__ __forceinline__ float bf16_flush(float x) {
  return fabsf(x) < 1.17549435e-38f ? x * 0.0f : x;
}

// hi of split_hi_lo(a) as an f32 value (exactly a bf16 value, or a's
// non-finite value).
__device__ __forceinline__ float bf16_split_hi(float a) {
  const uint32_t u = __float_as_uint(a);
  const bool finite = (u & 0x7F800000u) != 0x7F800000u;
  const uint32_t r = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  return finite ? __uint_as_float(r) : a;
}

// lo of split_hi_lo(a), given its hi, as bf16.
__device__ __forceinline__ __nv_bfloat16 bf16_split_lo(float a, float hi) {
  return __float2bfloat16_rn(bf16_flush(bf16_flush(a) - bf16_flush(hi)));
}

// One part of split_hi_lo(a) as bf16: hi (lo == false) or lo.
__device__ __forceinline__ __nv_bfloat16 bf16_split_part(float a, bool lo) {
  const float hi = bf16_split_hi(a);
  if (lo) return bf16_split_lo(a, hi);
  return __float2bfloat16_rn(hi);
}

// Two values' hi as one packed bf16x2 word (a0 in the low half), by one
// cvt.rn.bf16x2.f32: round to nearest even is the integer rule above for
// every finite value and for +-Inf (overflow rounds to Inf in both); a NaN
// stays a NaN (its payload may differ, which no product sees).
__device__ __forceinline__ uint32_t bf16x2_split_hi(float a0, float a1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(a1), "f"(a0));
  return r;
}

// Their lo, given the packed hi: sub.ftz flushes subnormal operands and a
// subnormal difference to zero of the same sign, as bf16_flush does around
// the subtraction in bf16_split_lo; the difference is then rounded as hi is.
__device__ __forceinline__ uint32_t bf16x2_split_lo(float a0, float a1, uint32_t hi) {
  float d0, d1;
  asm("sub.rn.ftz.f32 %0, %1, %2;\n" : "=f"(d0) : "f"(a0), "f"(__uint_as_float(hi << 16)));
  asm("sub.rn.ftz.f32 %0, %1, %2;\n" : "=f"(d1) : "f"(a1), "f"(__uint_as_float(hi & 0xFFFF0000u)));
  return bf16x2_split_hi(d0, d1);
}
