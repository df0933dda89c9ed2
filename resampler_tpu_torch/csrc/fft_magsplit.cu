// Kernels B4 and B5: the FFT engine's banded magnitude-split chunk
// operator, out = [prev | cur] @ T2, as bf16 tensor-core passes with f32
// sums.  With x2 = [prev | cur] (never materialised) and, for each column
// group q < s, r0 = q * bps * lp and rb = r0 + b0 * lp:
//
//   out[r, q*cols + c] = sum_{i < rows} hi(x2[r, r0 + i]) * wh[q, i, c]
//                      + sum_{i < wc}   hi(x2[r, rb + i]) * wcorr[q, i, c]
//                      + sum_{i < wc}   lo(x2[r, rb + i]) * wcorr[q, wc + i, c]
//
// hi, lo = split_hi_lo(x) (JAX's rule, csrc/bf16_split.cuh).  Every product
// of two bf16 values is exact in f32, so this is the plain version's
// arithmetic up to the order of the f32 sums.
//
// B4 replaces resampler_tpu/ops/fft_magsplit_kernel.py:288
// magsplit_projector (bodies _kernel :266, _body :248); B5 replaces :332
// magsplit_projector_pool (_kernel_pool :271).  B5 is this kernel with the
// maps of prev and cur encoded over two slots of the caller's [P, R, N]
// pool: one entry point serves both wrappers.
//
// Bound on an H100 at the bench shape (8192 stereo streams, 1176 -> 1280:
// R 16384, s 4, rows 1470, wc 882, cols 320): 2*R*(rows + 2*wc)*cols*s =
// 135.6 GFLOP, 0.1372 ms at 989 TFLOP/s dense bf16, against 246 MB of
// compulsory traffic (prev + cur + out + weights), 0.074 ms at 3.35 TB/s:
// bound by operations, so the design keeps the tensor cores fed and adds
// as little work as it can to what they do.
//
// Design: the host's tile plan (ops/fft_magsplit_kernel.py
// MagsplitTilePlan) walks each group's pass-1 band [r0, r0 + rows) as K
// tiles of 64 columns, the part in prev and the part in cur apart, so a tile
// reads one tensor; a part's first tile starts on a multiple of 4 columns
// (a TMA box's innermost coordinate must sit on 16 bytes), and a tile's
// columns outside [lo, hi) are not in the band.  The correction band [rb, rb + wc) lies inside the pass-1
// band, so each x column is staged once for all three passes, and lo
// multiplies the wh tile already staged: the t2h half of wcorr is bit for
// bit wh's rows b0*lp .. b0*lp + wc (the wrapper checks it) and is never
// streamed.  Per tile the packed weights hold the wh rows and, where the
// tile meets the correction band, the t2l rows at their columns with zero
// rows elsewhere ([n_wtiles, 64, cols_pad] bf16, columns padded to whole
// 160-column tiles).
//
// A block computes 128 rows x 160 columns of one group with 384 threads
// (B7's structure, csrc/matmul3.cu): a producer warpgroup whose first
// thread keeps a ring of 3 stages full with TMA (setmaxnreg 40): the x tile
// as f32 [128 x 64] in two 32-column boxes (128-byte swizzle) from a 2-D map
// over prev or cur [R, N] (rows past R and columns past N read as zero),
// the wh tile [64 x 160] and, where the tile meets the correction band, the
// t2l tile (64-byte swizzle, 32-column boxes), 72 KB a stage, full and
// empty mbarriers per stage; and two consumer warpgroups (setmaxnreg 232),
// 64 rows each.  Per k16 step of a tile a consumer thread reads its 8 f32
// values of the wgmma A fragment from the swizzled stage, selects to zero
// the columns outside [lo, hi) (never a multiply: a tile's ends may hold
// another group's columns, and 0 * Inf must not reach a sum), splits them in
// registers (two values per cvt), and issues wgmma.mma_async m64n160k16
// with A from registers and B from shared memory: hi * wh on every step, and
// on the steps that meet the correction band hi * t2l and lo * wh, hi and lo
// selected to zero outside it.  Two steps' wgmma groups stay in flight
// while the next step is split; a step's fragments sit in one of three
// register sets, kept alive until a wait retires the step (a wgmma reads
// its registers after it issues, which neither the compiler nor ptxas
// accounts for).  Steps wholly past hi or outside the correction band are
// skipped: the tensor cores run 3,288 k per output at the bench shape for
// the 3,234 the bound counts.  Each tile's products start a fresh
// accumulator that is added to the f32 sums in registers (B7's promotion:
// the tensor cores' own accumulation truncates, and the sums run over ~50
// tiles).  The epilogue writes each thread's sums from its registers, rows
// < R and columns < cols, four threads to 32 contiguous bytes of a row.
// Offsets into out are 64-bit.

#include <cstdint>
#include <cstring>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_split.cuh"
#include "hopper_tma.cuh"

namespace {

constexpr int kBM = 128;       // rows per block: two consumer warpgroups of 64
constexpr int kBN = 160;       // columns per block
constexpr int kBK = 64;        // x columns (K) per tile
constexpr int kStages = 3;
constexpr int kThreads = 384;  // the producer warpgroup, then two consumers
constexpr int kXBoxCols = 32;  // f32 x columns per TMA box: 128 bytes
constexpr int kWBoxCols = 32;  // bf16 weight columns per TMA box: 64 bytes
constexpr int kXBox = kBM * kXBoxCols * 4;      // 16 KB
constexpr int kX = kBK / kXBoxCols * kXBox;     // 32 KB: the x tile
constexpr int kWBox = kBK * kWBoxCols * 2;      // 4 KB
constexpr int kW = kBN / kWBoxCols * kWBox;     // 20 KB: one weight tile
constexpr int kStage = kX + 2 * kW;             // 72 KB
constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
constexpr int kWait = 2;      // k16 steps' wgmma groups left in flight while the next is split
constexpr int kSets = kWait + 1;  // A-fragment register sets: one per step in flight, and the next
constexpr int kTileInts = 8;  // src, col, lo, hi, wh tile, t2l tile (-1: none), corr lo, corr hi
static_assert(kSmem <= 232448, "the ring fits in a block's shared memory");

struct Geometry {
  int R, M, cols, n_ct;
};

// d (+)= A B over one k16 step, m64n160k16: A [64 x 16] bf16 from registers
// (the warp's 16 rows; a[0] rows g cols 2t, 2t+1; a[1] rows g+8; a[2], a[3]
// the same at cols +8), B MN-major from shared memory; scale_d 0 ignores
// d's old value.
__device__ __forceinline__ void wgmma_rs(float (&d)[80], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads of the accumulator above the wait.
__device__ __forceinline__ void fence_operands(float (&d)[80]) {
#pragma unroll
  for (int i = 0; i < 80; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keeps a step's A fragments (hi, hc, lc) alive, in their registers, up to
// this point: a wgmma reads its register operands asynchronously, and
// neither the compiler nor ptxas keeps them from being reused before a
// wait_group retires it (a step written over its predecessor's registers
// while that was still in flight gave wrong sums).
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[3][4]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// A word's two bf16 halves kept where their columns (c, c + 1) are selected.
__device__ __forceinline__ uint32_t half_mask(bool keep0, bool keep1) {
  return (keep0 ? 0x0000FFFFu : 0u) | (keep1 ? 0xFFFF0000u : 0u);
}

__global__ void __launch_bounds__(kThreads, 1)
magsplit_kernel(const __grid_constant__ CUtensorMap map_prev, const __grid_constant__ CUtensorMap map_cur,
                const __grid_constant__ CUtensorMap map_w, const int* __restrict__ tiles,
                const int* __restrict__ starts, float* __restrict__ out, const Geometry g) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1024-byte alignment
  const uint8_t* const ring_p = smem_raw + (ring - raw);
  const uint32_t full0 = ring + kStages * kStage;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int q = blockIdx.x / g.n_ct, n0 = (blockIdx.x % g.n_ct) * kBN, m0 = blockIdx.y * kBM;
  const int tile0 = __ldg(starts + q), n_k = __ldg(starts + q + 1) - tile0;
  const int* const tab = tiles + kTileInts * tile0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty0 + 8 * s, ((kt / kStages) & 1) ^ 1);  // the first round passes
        const int* d = tab + kTileInts * kt;
        const int col = __ldg(d + 1), wt = __ldg(d + 4), lt = __ldg(d + 5);
        const CUtensorMap* xm = __ldg(d) ? &map_cur : &map_prev;
        const uint32_t full = full0 + 8 * s, st = ring + s * kStage;
        mbar_expect_tx(full, kX + (lt >= 0 ? 2 : 1) * kW);
#pragma unroll
        for (int j = 0; j < kBK / kXBoxCols; ++j) {
          tma_load_2d(st + j * kXBox, xm, full, col + j * kXBoxCols, m0);
        }
#pragma unroll
        for (int j = 0; j < kBN / kWBoxCols; ++j) {
          tma_load_2d(st + kX + j * kWBox, &map_w, full, n0 + j * kWBoxCols, wt * kBK);
        }
        if (lt >= 0) {
#pragma unroll
          for (int j = 0; j < kBN / kWBoxCols; ++j) {
            tma_load_2d(st + kX + kW + j * kWBox, &map_w, full, n0 + j * kWBoxCols, lt * kBK);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;  // rows 64 cw .. 64 cw + 63 of the tile
    const int warp = t / 32, lane = t % 32, gr = lane / 4, tq = lane % 4;
    // this thread's A rows in a box (128 bytes each; the 128-byte swizzle
    // XORs the 16-byte chunk with the row mod 8, which is gr for both)
    const int row_off = (cw * 64 + warp * 16 + gr) * 128, row8_off = row_off + 8 * 128;
    float acc[kBN / 2], sum[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      acc[i] = 0.0f;
      sum[i] = 0.0f;
    }
    // the A fragments of step kk live in set kk % kSets until the wait that
    // retires the step; set kk % kSets is written again kSets steps later
    uint32_t frag[kSets][3][4] = {};
    // this tile's bounds; the next tile's are loaded while it runs
    int lo = __ldg(tab + 2), hi_end = __ldg(tab + 3), corr = __ldg(tab + 5) >= 0;
    int corr_lo = __ldg(tab + 6), corr_hi = __ldg(tab + 7);
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kStages;
      const int* dn = tab + kTileInts * min(kt + 1, n_k - 1);
      const int n_lo = __ldg(dn + 2), n_hi = __ldg(dn + 3), n_corr = __ldg(dn + 5) >= 0;
      const int n_clo = __ldg(dn + 6), n_chi = __ldg(dn + 7);
      mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
      const uint8_t* xs = ring_p + s * kStage;
      const uint32_t wh = ring + s * kStage + kX, tl = wh + kW;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int k0 = 16 * kk;
        if (k0 >= hi_end) break;  // uniform over the block
        // the fragment's columns c, c + 1 (chunk ch) and c + 8, c + 9 (ch + 2)
        const int c = k0 + 2 * tq;
        const uint8_t* box = xs + (kk / 2) * kXBox + 8 * (tq & 1);
        const int ch = ((k0 % kXBoxCols) + 2 * tq) / 4;
        const float2 v00 = *reinterpret_cast<const float2*>(box + row_off + ((ch ^ gr) << 4));
        const float2 v10 = *reinterpret_cast<const float2*>(box + row8_off + ((ch ^ gr) << 4));
        const float2 v01 = *reinterpret_cast<const float2*>(box + row_off + (((ch + 2) ^ gr) << 4));
        const float2 v11 = *reinterpret_cast<const float2*>(box + row8_off + (((ch + 2) ^ gr) << 4));
        // columns outside the band: selected to zero
        const bool w0 = c >= lo && c < hi_end, w1 = c + 1 >= lo && c + 1 < hi_end;
        const bool w8 = c + 8 >= lo && c + 8 < hi_end, w9 = c + 9 >= lo && c + 9 < hi_end;
        const float x[8] = {w0 ? v00.x : 0.0f, w1 ? v00.y : 0.0f, w0 ? v10.x : 0.0f, w1 ? v10.y : 0.0f,
                            w8 ? v01.x : 0.0f, w9 ? v01.y : 0.0f, w8 ? v11.x : 0.0f, w9 ? v11.y : 0.0f};
        uint32_t(&hi)[4] = frag[kk % kSets][0];
        uint32_t(&hc)[4] = frag[kk % kSets][1];
        uint32_t(&lc)[4] = frag[kk % kSets][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) hi[i] = bf16x2_split_hi(x[2 * i], x[2 * i + 1]);
        const bool meets = corr && k0 < corr_hi && k0 + 16 > corr_lo;  // uniform
        if (meets) {
          const uint32_t m0w = half_mask(c >= corr_lo && c < corr_hi, c + 1 >= corr_lo && c + 1 < corr_hi);
          const uint32_t m8w = half_mask(c + 8 >= corr_lo && c + 8 < corr_hi, c + 9 >= corr_lo && c + 9 < corr_hi);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t m = i < 2 ? m0w : m8w;
            hc[i] = hi[i] & m;
            lc[i] = bf16x2_split_lo(x[2 * i], x[2 * i + 1], hi[i]) & m;
          }
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_rs(acc, hi, desc_b(wh + kk * 16 * kWBoxCols * 2), kk == 0 ? 0 : 1);
        if (meets) {
          wgmma_rs(acc, hc, desc_b(tl + kk * 16 * kWBoxCols * 2), 1);
          wgmma_rs(acc, lc, desc_b(wh + kk * 16 * kWBoxCols * 2), 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // at most kWait steps in flight: step kk - kWait is retired, and
        // its set, which step kk + 1 writes, is free
        asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kWait) : "memory");
        if (kk >= kWait) fence_fragments(frag[(kk - kWait) % kSets]);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
#pragma unroll
      for (int i = 0; i < kSets; ++i) fence_fragments(frag[i]);
      if (t == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sum[i] += acc[i];
      lo = n_lo, hi_end = n_hi, corr = n_corr, corr_lo = n_clo, corr_hi = n_chi;
    }

    // epilogue: each thread writes its outputs from its registers, rows <
    // R and columns < cols; four threads cover 8 columns (32 bytes) of a row
    const int n_cols = min(kBN, g.cols - n0);
    const int r_lo = m0 + cw * 64 + warp * 16 + gr;
    float* const ob = out + static_cast<int64_t>(q) * g.cols + n0;
    const bool pairs = ((g.cols | g.M) & 1) == 0;  // a column pair sits on 8 bytes
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = 8 * j + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h;
        if (r >= g.R || c >= n_cols) continue;
        float* const o = ob + static_cast<int64_t>(r) * g.M + c;
        const float v0 = sum[4 * j + 2 * h], v1 = sum[4 * j + 2 * h + 1];
        if (pairs && c + 1 < n_cols) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (c + 1 < n_cols) o[1] = v1;
        }
      }
    }
  }
}

}  // namespace

// The kernel's dynamic shared memory per block, bytes (ptxas reports only
// static shared memory).
extern "C" int fft_magsplit_smem() { return kSmem; }

// Encodes a tensor map into `map` (128 bytes): kind 0, x f32 [rows = R,
// cols = N] (N a multiple of 4, so rows are 16-byte multiples as TMA needs,
// and a 16-byte aligned base), boxes of 32 columns x 128 rows, 128-byte
// swizzle; kind 1, the packed weights bf16 [rows = n_wtiles * 64, cols =
// cols_pad], boxes of 32 columns x 64 rows, 64-byte swizzle.  Returns 0, a
// CUDA error, or kMapError + a CUresult.
extern "C" int fft_magsplit_encode(const void* base, int kind, int rows, int cols, void* map) {
  if (rows < 1 || cols < 1 || !aligned16(base) || (kind != 0 && kind != 1) ||
      cols % (kind == 0 ? 4 : 8) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int esize = kind == 0 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kind == 0 ? kXBoxCols : kWBoxCols),
                             static_cast<cuuint32_t>(kind == 0 ? kBM : kBK)};
  CUtensorMap m;
  const int err = encode(&m, base, 2, dims, strides, box,
                         kind == 0 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         kind == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (err == 0) std::memcpy(map, &m, sizeof(m));
  return err;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// maps come from fft_magsplit_encode (prev, cur: kind 0; the weights: kind
// 1); `tiles` [n, 8] int32 and `starts` [s + 1] int32 are the host's tile
// plan on the device; out [R, M] f32, group q's columns at q * cols.  The
// caller checks shapes, dtypes and devices.
extern "C" int fft_magsplit_projector(const void* map_prev, const void* map_cur, const void* map_w,
                                      const int* tiles, const int* starts, float* out, int R, int M,
                                      int s, int cols, int cols_pad, void* stream) {
  if (R < 1 || s < 1 || cols < 1 || cols_pad % kBN != 0 || cols > cols_pad || M < s * cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[3];
  std::memcpy(&maps[0], map_prev, sizeof(CUtensorMap));
  std::memcpy(&maps[1], map_cur, sizeof(CUtensorMap));
  std::memcpy(&maps[2], map_w, sizeof(CUtensorMap));
  const cudaError_t err =
      cudaFuncSetAttribute(magsplit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry g{R, M, cols, cols_pad / kBN};
  const dim3 grid(s * g.n_ct, (R + kBM - 1) / kBM);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  magsplit_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], tiles, starts, out, g);
  return static_cast<int>(cudaGetLastError());
}
