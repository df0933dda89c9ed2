// Hopper helpers shared by the TMA-fed wgmma kernels B7 (matmul3.cu) and
// B4/B5 (fft_magsplit.cu): shared-memory addresses, mbarriers, TMA tile
// loads, the wgmma descriptor of an MN-major bf16 B operand, and the
// driver's cuTensorMapEncodeTiled, reached through the runtime's driver
// entry point (the libraries link nothing).

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a bf16 B operand, MN-major under the
// 64-byte swizzle, as a TMA load of 32-column boxes of 64 K rows leaves
// it: each box is 64 rows of 64 bytes, boxes 4096 bytes apart (leading
// offset), 8-row k groups 512 bytes apart (stride offset); a k16 step
// moves the start 16 rows (1024 bytes).
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(64 * 32 * 2 >> 4) << 16) |
         (static_cast<uint64_t>(8 * 32 * 2 >> 4) << 32) | (2ull << 62);
}

// cuTensorMapEncodeTiled, from the driver through the runtime
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn load_encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeFn>(fn) : nullptr;
}

// a tensor-map failure returns kMapError + the driver's CUresult
constexpr int kMapError = 10000;

// A tiled map of unit element strides; out-of-bounds elements read as zero.
int encode(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle,
           CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  static const EncodeFn fn = load_encoder();
  if (fn == nullptr) return kMapError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, dtype, rank, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(r);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
