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
// js [out_cap] int32 pairs (j, s; static tables); lanes [2, R] int64: row 0
// the residue word of each lane (its stream's r_b, or pos_lo when wide), row 1
// its stream's frame skew base_rel, read as off = base_rel where it lies in
// [1, skew] and 0 otherwise (the XLA step's region-select fall-through in
// starved states); out [out_cap, R] f32.
//
// Replaces resampler_tpu/ops/fir_async_kernel.py:294 build_async_combine
// (body _kernel :192, _contract :139, _residues :164, _combine :173), in
// the form of the function the JAX XLA step computes
// (resampler_tpu/engine/fir_fleets.py:1161-1257): one banded einsum of the
// basis responses at every ring position, then takes at j and j + 1.  The
// TPU kernel's per-block atlas, its 8-row DMA switch and its wrap blend
// z0 + w (z1 - z0) are Mosaic's workarounds and do not carry over: the
// wrap row is picked by SELECT, as the XLA step does.
//
// What bounds B6 on an H100: f32 FMA.  At 44.1 -> 44.101 kHz, 128 taps,
// 1024 stereo streams (R 2048) and 2048 emitted outputs a call needs the
// responses at ~2050 distinct positions per lane, 8.657 GFLOP, 0.129 ms at
// 67 TFLOP/s, against 35.7 MB of rows and output (0.011 ms at 3.35 TB/s).
// The per-output kernel this replaces did 8 x taps FMAs per output with
// eight 64-bit-addressed global loads of ring rows per tap (each sample
// read ~8 times over overlapping windows) at 146 registers: 0.446 ms.
//
// Design.  The host's F32TilePlan (ops/fir_async_kernel.py) cuts the
// outputs into tiles of consecutive outputs and lists each tile's ring
// rows; a persistent block (32 lanes x 4 warps, two per SM) walks its
// tiles, staging the next one's rows and (j, s) with cp.async (16-byte
// along the lanes where R % 4 == 0, else 4-byte; lanes past R zero-filled)
// into the second of two [row][32 lanes] f32 stages while it computes the
// current one.  Two forms, chosen on the host by L/M alone:
//
// - positions (L <= 1.5 M): the tile's outputs read positions p = j[n] +
//   off + c in [j[n_lo], j[n_hi - 1] + skew + 2); the block computes
//   Y[p, d] = sum_t A[d, t] x[p + t] at every one of them once, 32 per
//   pass.  A thread owns one lane x 8 consecutive positions x 8 degrees
//   (64 f32 sums) and slides a register window over the staged rows: one
//   shared load of x per tap, A[:, t] as two broadcast 16-byte loads, 64
//   FMAs, no lane offset in the inner loop (all lanes read one staged
//   row: no bank conflict).  Then every output whose position, for this
//   lane, falls among the thread's 8 (found through the host's pfirst
//   table) takes its 8 responses from the thread's row of a scratch and
//   the Chebyshev combine.  At L/M ~ 1 a position serves ~1 output; at
//   22050 -> 96000 (L/M 147/640) ~4.35, so the work per output falls to
//   ~0.23 of a per-output contraction;
// - outputs (above: a position would serve too few outputs for its cost;
//   at 367500 -> 1601, 1 in 229.5): each output contracts its own window
//   among the staged rows (the union of the tile's windows).
//
// The results go through shared memory, so the stores to out [out_cap, R]
// are whole 128-byte rows; outputs past n_out are selected to zero, rows
// past the computed tiles zero-filled, never multiplied by a mask.  A
// non-finite sample makes non-finite exactly the outputs whose window
// holds it.  f32 FMA on the CUDA cores, IEEE division for u.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 11) the positions
// form takes ~0.25 ms at the case above (0.446 before), ~52% of the peak
// on the 8.925 GFLOP it issues (2112 positions per lane): 161 registers,
// no spill, 109,936 B of shared memory, 2 blocks of 4 warps per SM.  The
// per-output form takes ~0.38 ms there: a position costs ~0.65 of an
// output's own window, hence the forms' crossing at L/M = 1.5.  Variant
// builds timed on the card: the A loads cost the most, then the combine
// (more where a position serves several outputs); 3 blocks per SM, A
// from the constant bank, 16 positions per thread or a fully unrolled
// tap loop were no faster at every ratio.

// Kernel B6b, the TPU kernel's default precision="bf16x4" (its _contract
// :139-161, weight split :396-413), computes the same out[n, r] with the
// degree-banded split contraction: each ring sample split once, x = hi + lo
// (split_hi_lo, csrc/bf16_split.cuh), the basis as a_hi = bf16(A) and a_lo =
// bf16(A - a_hi) (round to nearest even on the host, as XLA's astype), and
//
//   y[d] = sum_t a_hi[d, t] hi_t + (d <= dc) * (a_hi[d, t] lo_t + a_lo[d, t] hi_t
//                                               + a_lo[d, t] lo_t)
//
// with the TPU kernel's degree cut dc (:400-405: the correction products of
// degrees whose rows sit <= 1e-3 of the basis maximum are dropped).  Every
// product of two bf16 values is exact; the sums are f32.  B6b keeps B6's
// conventions (wrap row by select, IEEE division, the starved
// fall-through), not the TPU kernel's blend z0 + w (z1 - z0) and rem * (1/M).
//
// B6b runs on the bf16 tensor cores: mma.sync m16n8k16 (f32 sums), one MMA
// row per lane of one output, 16 taps of that output's window per k-step,
// the 8 basis degrees as N.  Four passes per k-step, each into its own f32
// accumulator: hi * a_hi, lo * a_hi_c (a_hi zeroed past dc), hi * a_lo,
// lo * a_lo (a_lo is zero past dc), so every pass gives all 8 degrees and
// the degrees past dc take zero weights.  The B operand (the three bases,
// 2 x 3 registers per k-step: 48 at 128 taps) stays in registers for the
// whole block, packed on the host in fragment order
// (ops/fir_async_kernel.py b_fragments).  wgmma's 64-row asynchronous form
// buys nothing at N = 8; mma.sync is the simple route.
//
// Bound on an H100: the bound counts the exact bf16 products the function
// needs, (8 + 3 (dc + 1)) x taps per output and lane at the 989 TFLOP/s
// dense bf16 peak: at 44100 -> 44101, 128 taps, R 2048, n_out 2048 that is
// 24.76 GFLOP, 0.0250 ms, against 35.7 MB of compulsory traffic (0.0107
// ms).  The kernel issues 4 x 8 x taps products per output and lane (34.4
// GFLOP there, 1.39x): a pass per k-step carries all 8 degrees.
//
// Design.  A block is 32 lanes (two 16-row MMA groups) by one tile of
// outputs; 8 warps, each one lane group and every fourth output of the
// tile.  Each output reads only its own window, so the host tabulates per
// tile the ring rows the tile's windows cover, in order, and where each
// output's window starts among them (AsyncTilePlan): 128 outputs stage 257
// rows at 44100 -> 44101 (106,048 B of shared memory, 2 blocks per SM),
// while at 367500 -> 1601, whose windows are disjoint, a tile is two
// outputs.  That is why an MMA row is a lane and not an output: 16 lanes
// of one output fill the 16 rows whatever the tile.  No device scan, no
// host sync: the kernel reads its tile's row map by address.  The block
// copies the rows its
// emitted outputs need with cp.async (16-byte along the lanes, coalesced;
// 4-byte where R is no multiple of 4, lanes past R zero-filled) into an f32
// [row][lane] stage, then splits each sample once into lane-major bf16 hi
// and lo arrays.  A fragment register holds two consecutive taps of a row,
// and a 32-bit load needs them to start on an even element, so each array
// is kept twice: copy 0 holds pairs (2w, 2w + 1), copy 1 pairs (2w + 1,
// 2w + 2); a lane's window start picks its copy by parity.  The wrap row
// and the frame skew are folded into that start (win[n] + off + c).  The
// stage pitch (36 floats) and the word pitch (4 mod 8) keep the split's
// and the fragment loads conflict-free.  Epilogue: a thread holds degrees
// 2 tig, 2 tig + 1 of its two lanes (rows g and g + 8), evaluates the
// Chebyshev recurrence there, and two __shfl_xor_sync steps sum the four
// threads of the group; the results go through shared memory so that the
// stores to out [out_cap, R] are whole 128-byte rows.  Outputs past n_out
// are selected to zero, never multiplied by a mask; a lane whose window
// holds a non-finite sample gives a non-finite output, as the plain
// version does (0 x NaN on the zero weights).
//
// On an H100 (chip_smoke.py phase 24) it takes ~0.17 ms at the case above,
// ~20% of the bound on the work it issues: 110 registers, no spill, 2
// blocks of 8 warps per SM.  It is bound by latency, not by the tensor
// cores: a block's copy, split and barriers run before its products, and
// one block per SM ran slower.  Tried on the card and slower or no
// faster: the B operand from shared memory (3 blocks per SM; more shared
// loads), two outputs per warp iteration, tiles of 16, 32 or 64 outputs.
// Overlapping the next tile's staging with this one's products is the
// next lever.

#include <cstdint>
#include <cuda_runtime.h>

#include "bf16_split.cuh"

namespace {

constexpr int kD1 = 8;  // Chebyshev degree 7 + 1

// An asynchronous copy of `bytes` (0 or the size) from global to shared
// memory; 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async8(int2* dst, const int2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The lane's residue at output split sn (the JAX XLA step's arithmetic):
// the wrap bit, and u = 2 rem / M - 1 rounded as written.
__device__ __forceinline__ int residue(uint32_t res, uint32_t sn, uint32_t M, float m_f, float& u) {
  const uint32_t t = res + sn;
  const bool wrap = (t < res) || (t >= M);
  const uint32_t rem = wrap ? t - M : t;
  const float frac = __fdiv_rn(__uint2float_rn(rem), m_f);
  u = __fsub_rn(__fmul_rn(2.0f, frac), 1.0f);
  return wrap ? 1 : 0;
}

// ---------------------------------------------------------------------------
// B6: the f32 kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kLanes = 32;               // lanes per block (one warp across lanes)
constexpr int kWarps = 4;
constexpr int kThreads = kLanes * kWarps;
constexpr int kP = 8;                    // consecutive positions per thread
constexpr int kPass = kP * kWarps;       // positions per pass of a block
constexpr int kYsPitch = kP * kD1 + 4;   // floats per lane of a warp's response scratch

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// sum_d T_d(u) y[d], the recurrence and its rounding as the XLA step
// writes them (no contraction of the Chebyshev products).
__device__ __forceinline__ float cheb(float u, const float (&y)[kD1]) {
  const float u2 = __fmul_rn(2.0f, u);
  float t_prev = 1.0f, t_cur = u;
  float acc = y[0];
#pragma unroll
  for (int d = 1; d < kD1; ++d) {
    acc = fmaf(t_cur, y[d], acc);
    const float t_next = __fsub_rn(__fmul_rn(u2, t_cur), t_prev);
    t_prev = t_cur;
    t_cur = t_next;
  }
  return acc;
}

struct Args {
  const float* buffer;
  const float* a_t;       // [taps][8]
  const int2* js;         // [out_cap]: j, s (u32 bits)
  const int64_t* lanes;   // [2][R]: residue word, frame skew
  const int2* tiles;      // [n_tiles]: n_lo, n_hi
  const int* rowmap;      // [n_tiles][rows_pad]
  const int* aux;         // positions: pfirst [n_aux]; outputs: win [out_cap]
  float* out;             // [out_cap][R]
  int R;
  int64_t base0;
  int n_out, out_cap, taps;
  uint32_t M;
  int skew, n_emit, z0, rows_pad, out_max, n_aux, vec;
};

// The rows tile tt stages for this call: the positions form's passes that
// reach its last emitted output's positions (plus the row past the last
// tap that the sliding window loads), or the per-output form's prefix of
// the windows' union up to the last emitted output's window.
template <bool kPositions>
__device__ __forceinline__ int tile_rows(const Args& a, int tt, int2 tl) {
  const int n_e = min(tl.y, a.n_out) - 1;
  if (kPositions) {
    const int npos = a.js[n_e].x + a.skew + 2 - a.rowmap[static_cast<int64_t>(tt) * a.rows_pad];
    return (npos + kPass - 1) / kPass * kPass + a.taps;
  }
  return a.aux[n_e] + a.taps + a.skew + 1;
}

// Copy tile tt's rows for the lane tile at r0 into `st` [rows][32] f32
// (16-byte copies where R % 4 == 0: four lanes in or out together, else
// 4-byte; lanes past R are zero-filled) and its emitted outputs' (j, s)
// into `jst`.
template <bool kPositions>
__device__ __forceinline__ void stage_tile(const Args& a, int tt, int r0, float* st, int2* jst) {
  const int2 tl = a.tiles[tt];
  const int rows = tile_rows<kPositions>(a, tt, tl);
  const int* rm = a.rowmap + static_cast<int64_t>(tt) * a.rows_pad;
  const int tid = threadIdx.x;
  for (int i = tid; i < min(tl.y, a.n_out) - tl.x; i += kThreads) cp_async8(jst + i, a.js + tl.x + i);
  if (a.vec) {
    for (int e = tid; e < rows * (kLanes / 4); e += kThreads) {
      const int i = e >> 3, q = (e & 7) * 4;
      const bool in = r0 + q < a.R;
      const float* src = in ? a.buffer + (a.base0 + rm[i]) * static_cast<int64_t>(a.R) + r0 + q : a.buffer;
      cp_async16(st + i * kLanes + q, src, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * kLanes; e += kThreads) {
      const int i = e >> 5, q = e & 31;
      const bool in = r0 + q < a.R;
      const float* src = in ? a.buffer + (a.base0 + rm[i]) * static_cast<int64_t>(a.R) + r0 + q : a.buffer;
      cp_async4(st + i * kLanes + q, src, in ? 4 : 0);
    }
  }
}

// The positions form on one staged tile: each pass computes 32 positions
// (warp w: positions pb .. pb + 7 of every lane), the responses
// Y[p, d] = sum_t A[d, t] x[p + t] in 64 f32 sums per thread over a
// sliding window of x (one new shared load per tap); then every output of
// the tile whose position, for this thread's lane, falls among the
// thread's 8 takes its 8 responses (through the thread's row of the
// warp's scratch) and the Chebyshev combine.
__device__ __forceinline__ void positions_tile(const Args& a, int tt, int2 tl, const float* st,
                                               const int2* jst, const float4* a_s, float* yw, float* out_s,
                                               uint32_t res, int off, float m_f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_end = min(tl.y, a.n_out);
  const int p0 = a.rowmap[static_cast<int64_t>(tt) * a.rows_pad];
  const int passes = (jst[n_end - 1 - tl.x].x + a.skew + 2 - p0 + kPass - 1) / kPass;
  for (int pass = 0; pass < passes; ++pass) {
    const int pb = pass * kPass + warp * kP;
    const float* xs = st + pb * kLanes + lane;
    float acc[kP][kD1];
#pragma unroll
    for (int i = 0; i < kP; ++i)
#pragma unroll
      for (int d = 0; d < kD1; ++d) acc[i][d] = 0.0f;
    // xw[m]: row pb + t0 + m; xn[m]: row pb + t0 + kP + m
    float xw[kP], xn[kP];
#pragma unroll
    for (int m = 0; m < kP; ++m) xw[m] = xs[m * kLanes];
#pragma unroll 2
    for (int t0 = 0; t0 < a.taps; t0 += kP) {
#pragma unroll
      for (int m = 0; m < kP; ++m) xn[m] = xs[(t0 + kP + m) * kLanes];
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const float4 v0 = a_s[2 * (t0 + k)];
        const float4 v1 = a_s[2 * (t0 + k) + 1];
        const float c[kD1] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          const float x = (k + i < kP) ? xw[k + i] : xn[k + i - kP];
#pragma unroll
          for (int d = 0; d < kD1; ++d) acc[i][d] = fmaf(c[d], x, acc[i][d]);
        }
      }
#pragma unroll
      for (int m = 0; m < kP; ++m) xw[m] = xn[m];
    }
    // the responses to this thread's own row of the scratch
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      float4* y4 = reinterpret_cast<float4*>(yw + i * kD1);
      y4[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      y4[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    // the outputs whose j lies in [pa - off - 1, pa + kP - off) may read
    // one of positions pa .. pa + kP - 1 (pfirst: the first output whose
    // j reaches a position)
    const int pa = p0 + pb;
    const int n_a = max(tl.x, a.aux[min(max(pa - off - 1, 0), a.n_aux - 1)]);
    const int n_b = min(n_end, a.aux[min(max(pa + kP - off, 0), a.n_aux - 1)]);
    for (int n = n_a; n < n_b; ++n) {
      const int2 e = jst[n - tl.x];
      float u;
      const int q = e.x + off + residue(res, static_cast<uint32_t>(e.y), a.M, m_f, u) - pa;
      if (q >= 0 && q < kP) {
        const float4 y0 = *reinterpret_cast<const float4*>(yw + q * kD1);
        const float4 y1 = *reinterpret_cast<const float4*>(yw + q * kD1 + 4);
        const float y[kD1] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
        out_s[(n - tl.x) * kLanes + lane] = cheb(u, y);
      }
    }
  }
}

// The per-output form on one staged tile: warp w takes the tile's outputs
// w, w + 4, ...; each thread contracts its lane's window (its start among
// the staged rows: win[n] + off + c).
__device__ __forceinline__ void outputs_tile(const Args& a, int2 tl, const float* st, const int2* jst,
                                             const float4* a_s, float* out_s, uint32_t res, int off, float m_f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_end = min(tl.y, a.n_out);
  for (int n = tl.x + warp; n < n_end; n += kWarps) {
    const int2 e = jst[n - tl.x];
    float u;
    const int start = a.aux[n] + off + residue(res, static_cast<uint32_t>(e.y), a.M, m_f, u);
    const float* xs = st + start * kLanes + lane;
    float y[kD1];
#pragma unroll
    for (int d = 0; d < kD1; ++d) y[d] = 0.0f;
#pragma unroll 8
    for (int t = 0; t < a.taps; ++t) {
      const float4 v0 = a_s[2 * t];
      const float4 v1 = a_s[2 * t + 1];
      const float x = xs[t * kLanes];
      y[0] = fmaf(v0.x, x, y[0]);
      y[1] = fmaf(v0.y, x, y[1]);
      y[2] = fmaf(v0.z, x, y[2]);
      y[3] = fmaf(v0.w, x, y[3]);
      y[4] = fmaf(v1.x, x, y[4]);
      y[5] = fmaf(v1.y, x, y[5]);
      y[6] = fmaf(v1.z, x, y[6]);
      y[7] = fmaf(v1.w, x, y[7]);
    }
    out_s[(n - tl.x) * kLanes + lane] = cheb(u, y);
  }
}

// A persistent block walks the work items t = blockIdx.x, + gridDim.x, ...
// (item t: tile t / n_lt of lane tile t % n_lt, the tiles with an output
// below n_out), staging item t + gridDim.x while it computes item t; then
// stores the tile's rows of out whole, outputs past n_out selected to zero.
// Last, the rows [z0, out_cap) past every computed tile are zero-filled.
// Shared memory: A [taps][8], two stages [rows_pad][32], the warps'
// response scratch [4][32][kYsPitch] (positions form), the tile's results
// [out_max][32], two stages of the tile's (j, s) [out_max].
template <bool kPositions>
__global__ void __launch_bounds__(kThreads, 2) combine_kernel(const Args a) {
  extern __shared__ __align__(16) float f32_smem[];
  float4* a_s = reinterpret_cast<float4*>(f32_smem);
  float* stage = f32_smem + a.taps * kD1;
  float* ys = stage + 2 * a.rows_pad * kLanes;
  float* out_s = ys + (kPositions ? kWarps * kLanes * kYsPitch : 0);
  int2* js_s = reinterpret_cast<int2*>(out_s + a.out_max * kLanes);
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < 2 * a.taps; i += kThreads) a_s[i] = reinterpret_cast<const float4*>(a.a_t)[i];
  float* yw = ys + tid * kYsPitch;
  const float m_f = __uint2float_rn(a.M);

  const int n_lt = (a.R + kLanes - 1) / kLanes;
  const int total = n_lt * a.n_emit;
  int t = blockIdx.x;
  if (t < total) stage_tile<kPositions>(a, t / n_lt, (t % n_lt) * kLanes, stage, js_s);
  cp_async_commit();
  for (int k = 0; t < total; ++k, t += gridDim.x) {
    const int tn = t + gridDim.x;
    if (tn < total) {
      const int b = (k + 1) & 1;
      stage_tile<kPositions>(a, tn / n_lt, (tn % n_lt) * kLanes, stage + b * a.rows_pad * kLanes,
                             js_s + b * a.out_max);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const int tt = t / n_lt, r0 = (t % n_lt) * kLanes;
    const int2 tl = a.tiles[tt];
    const int r = r0 + lane;
    uint32_t res = 0;
    int off = 0;
    if (r < a.R) {
      res = static_cast<uint32_t>(a.lanes[r]);
      const int64_t br = a.lanes[a.R + r];
      off = (br >= 1 && br <= a.skew) ? static_cast<int>(br) : 0;
    }
    const float* st = stage + (k & 1) * a.rows_pad * kLanes;
    const int2* jst = js_s + (k & 1) * a.out_max;
    if (kPositions) {
      positions_tile(a, tt, tl, st, jst, a_s, yw, out_s, res, off, m_f);
    } else {
      outputs_tile(a, tl, st, jst, a_s, out_s, res, off, m_f);
    }
    __syncthreads();

    const int nt = tl.y - tl.x, ne = min(tl.y, a.n_out) - tl.x;
    if (a.vec) {
      for (int e = tid; e < nt * (kLanes / 4); e += kThreads) {
        const int i = e >> 3, q = (e & 7) * 4;
        if (r0 + q < a.R) {
          const float4 v = i < ne ? *reinterpret_cast<const float4*>(out_s + i * kLanes + q)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          *reinterpret_cast<float4*>(a.out + static_cast<int64_t>(tl.x + i) * a.R + r0 + q) = v;
        }
      }
    } else {
      for (int e = tid; e < nt * kLanes; e += kThreads) {
        const int i = e >> 5, q = e & 31;
        if (r0 + q < a.R) a.out[static_cast<int64_t>(tl.x + i) * a.R + r0 + q] = i < ne ? out_s[i * kLanes + q] : 0.0f;
      }
    }
  }
  cp_async_wait_all();

  // ---- the rows past every computed tile: zeros ----
  const int64_t first = static_cast<int64_t>(a.z0) * a.R, count = static_cast<int64_t>(a.out_cap - a.z0) * a.R;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  if (a.vec) {
    float4* o = reinterpret_cast<float4*>(a.out + first);
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + tid; e < count / 4; e += stride)
      o[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + tid; e < count; e += stride)
      a.out[first + e] = 0.0f;
  }
}

// The persistent grid of a form at `smem` bytes: every block resident
// (blocks per SM from the occupancy calculator, times the SMs).  Both,
// and the shared-memory attribute, are set once per device and size and
// then reused: the async fleet launches B6 every step.
template <bool kPositions>
cudaError_t resident_blocks(size_t smem, int& blocks) {
  constexpr int kDevices = 16;
  static int cached_smem[kDevices] = {}, cached_blocks[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && cached_smem[dev] == static_cast<int>(smem)) {
    blocks = cached_blocks[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(combine_kernel<kPositions>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, combine_kernel<kPositions>, kThreads,
                                                           smem)) != cudaSuccess) {
    return err;
  }
  blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (dev < kDevices) {
    cached_smem[dev] = static_cast<int>(smem);
    cached_blocks[dev] = blocks;
  }
  return cudaSuccess;
}

template <bool kPositions>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = 4 * (static_cast<size_t>(a.taps) * kD1 + 2 * static_cast<size_t>(a.rows_pad) * kLanes +
                           (kPositions ? kWarps * kLanes * kYsPitch : 0) +
                           static_cast<size_t>(a.out_max) * (kLanes + 4));
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidConfiguration);
  int cap = 0;
  const cudaError_t err = resident_blocks<kPositions>(smem, cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  // no block without work (the zero fill takes at least one)
  const int64_t items = static_cast<int64_t>((a.R + kLanes - 1) / kLanes) * a.n_emit;
  const int64_t fill = (static_cast<int64_t>(a.out_cap - a.z0) * a.R + 4 * kThreads - 1) / (4 * kThreads);
  const int64_t want = items > fill ? items : fill;
  const int grid = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  combine_kernel<kPositions><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// B6b: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kLanes = 32;              // lanes per block: two 16-row MMA groups
constexpr int kWarps = 8;               // 2 lane groups x 4 output slots
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = kWarps / 2;
constexpr int kStagePitch = 36;         // floats per staged f32 row

// d += a * b: one m16n8k16 bf16 product with f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_elem, float hi_elem) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo_elem))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi_elem))) << 16);
}

// T_{2 tig}(u) y0 + T_{2 tig + 1}(u) y1, the recurrence rounded as B6 does.
__device__ __forceinline__ float cheb_pair(float u, int tig, float y0, float y1) {
  const float u2 = __fmul_rn(2.0f, u);
  float t_prev = 1.0f, t_cur = u, t_lo = 1.0f, t_hi = u;
#pragma unroll
  for (int d = 2; d < kD1; ++d) {
    const float t_next = __fsub_rn(__fmul_rn(u2, t_cur), t_prev);
    t_prev = t_cur;
    t_cur = t_next;
    if (d == 2 * tig) t_lo = t_cur;
    if (d == 2 * tig + 1) t_hi = t_cur;
  }
  return fmaf(t_hi, y1, __fmul_rn(t_lo, y0));
}

// One output's A rows for a thread's two lanes: the staged window starts
// (wrap row and frame skew folded in) and the Chebyshev arguments.
struct Rows {
  int a, b;
  float u_a, u_b;
};

// frags [3][kKS][32] uint2: a_hi, a_hi_c, a_lo as B fragments; rowmap
// [n_tiles][rows_pad], win [out_cap]: the tile plan; shared memory: the
// bf16 arrays [4: hi0, hi1, lo0, lo1][kLanes][pitch_w] words, the f32
// stage [rows_pad][kStagePitch] (reused for the tile's results
// [nt][kLanes]), then the tile's win and s [nt] each.
template <int kKS>
__global__ void __launch_bounds__(kThreads, 2)
tc_combine_kernel(const float* __restrict__ buffer, const uint2* __restrict__ frags,
                  const int64_t* __restrict__ s_tab, const int64_t* __restrict__ lanes,
                  const int* __restrict__ rowmap, const int* __restrict__ win,
                  float* __restrict__ out, int R, int64_t base0, int n_out, int out_cap,
                  uint32_t M, int skew, int nt, int rows_pad, int pitch_w, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* arr = smem;
  float* stage = reinterpret_cast<float*>(smem + 4 * kLanes * pitch_w);
  float* res_s = stage;  // [nt][kLanes], after the split
  const int stage_words = rows_pad * kStagePitch > nt * kLanes ? rows_pad * kStagePitch : nt * kLanes;
  int* win_s = reinterpret_cast<int*>(stage) + stage_words;
  uint32_t* s_s = reinterpret_cast<uint32_t*>(win_s + nt);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kLanes;
  const int n0 = blockIdx.y * nt;
  const int n_tile = min(nt, out_cap - n0);
  const int n_emit = min(n_tile, n_out - n0);  // outputs this tile computes (<= 0: none)

  if (n_emit > 0) {
    // ---- stage the rows the emitted outputs read: the prefix [0, need)
    // of the tile's row map, plus the row copy 1's last pair reads ----
    const int* rows = rowmap + static_cast<int64_t>(blockIdx.y) * rows_pad;
    const int need = win[n0 + n_emit - 1] + 16 * kKS + skew + 1;
    const int words = (need + 1) >> 1;
    const int n_rows = 2 * words + 1;
    if (vec) {
      for (int e = tid; e < n_rows * (kLanes / 4); e += kThreads) {
        const int i = e >> 3, q = (e & 7) * 4;
        const bool in = r0 + q < R;  // R % 4 == 0: four lanes in or out together
        const float* src = in ? buffer + (base0 + rows[i]) * static_cast<int64_t>(R) + r0 + q : buffer;
        cp_async16(stage + i * kStagePitch + q, src, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < n_rows * kLanes; e += kThreads) {
        const int i = e >> 5, q = e & 31;
        const bool in = r0 + q < R;
        const float* src = in ? buffer + (base0 + rows[i]) * static_cast<int64_t>(R) + r0 + q : buffer;
        cp_async4(stage + i * kStagePitch + q, src, in ? 4 : 0);
      }
    }
    for (int i = tid; i < n_emit; i += kThreads) {
      win_s[i] = win[n0 + i];
      s_s[i] = static_cast<uint32_t>(s_tab[n0 + i]);
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- split each sample once into the lane-major bf16 arrays: a warp
    // takes 8 lanes x 4 words (conflict-free reads and writes) ----
    const int chunks = (words + 3) >> 2;
    for (int e = tid; e < chunks * 128; e += kThreads) {
      const int lane = ((e >> 5) & 3) * 8 + ((e >> 2) & 7);
      const int w = (e >> 7) * 4 + (e & 3);
      if (w < words) {
        const float* x = stage + 2 * w * kStagePitch + lane;
        float h[3], l[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          h[k] = bf16_split_hi(x[k * kStagePitch]);
          l[k] = __bfloat162float(bf16_split_lo(x[k * kStagePitch], h[k]));
        }
        uint32_t* a = arr + lane * pitch_w + w;
        const int plane = kLanes * pitch_w;
        a[0] = pack_bf16(h[0], h[1]);
        a[plane] = pack_bf16(h[1], h[2]);
        a[2 * plane] = pack_bf16(l[0], l[1]);
        a[3 * plane] = pack_bf16(l[1], l[2]);
      }
    }
    __syncthreads();

    // ---- the four passes per k-step, then the combine ----
    const int warp = tid >> 5, lane_id = tid & 31;
    const int g = lane_id >> 2, tig = lane_id & 3;
    const int la = 16 * (warp & 1) + g, lb = la + 8;  // the tile lanes of rows g, g + 8
    uint32_t res_a = 0, res_b = 0;
    int off_a = 0, off_b = 0;
    if (r0 + la < R) {
      res_a = static_cast<uint32_t>(lanes[r0 + la]);
      const int64_t br = lanes[R + r0 + la];
      off_a = (br >= 1 && br <= skew) ? static_cast<int>(br) : 0;
    }
    if (r0 + lb < R) {
      res_b = static_cast<uint32_t>(lanes[r0 + lb]);
      const int64_t br = lanes[R + r0 + lb];
      off_b = (br >= 1 && br <= skew) ? static_cast<int>(br) : 0;
    }
    uint2 bh[kKS], bc[kKS], bl[kKS];
#pragma unroll
    for (int s = 0; s < kKS; ++s) {
      bh[s] = frags[(0 * kKS + s) * 32 + lane_id];
      bc[s] = frags[(1 * kKS + s) * 32 + lane_id];
      bl[s] = frags[(2 * kKS + s) * 32 + lane_id];
    }
    const float m_f = __uint2float_rn(M);
    const int plane = kLanes * pitch_w;
    const auto rows_of = [&](int i) {
      Rows q;
      q.a = win_s[i] + off_a + residue(res_a, s_s[i], M, m_f, q.u_a);
      q.b = win_s[i] + off_b + residue(res_b, s_s[i], M, m_f, q.u_b);
      return q;
    };
    // the next output's rows are computed ahead, beside this one's products
    Rows next = rows_of(min(warp >> 1, n_emit - 1));
    for (int i = warp >> 1; i < n_emit; i += kSlots) {
      const Rows cur = next;
      if (i + kSlots < n_emit) next = rows_of(i + kSlots);
      const int row_a = cur.a, row_b = cur.b;
      const float u_a = cur.u_a, u_b = cur.u_b;
      // copy (row & 1) holds the pair that starts at row; word row >> 1
      const uint32_t* pa = arr + ((row_a & 1) * kLanes + la) * pitch_w + (row_a >> 1) + tig;
      const uint32_t* pb = arr + ((row_b & 1) * kLanes + lb) * pitch_w + (row_b >> 1) + tig;
      float acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
#pragma unroll
      for (int s = 0; s < kKS; ++s) {
        const uint32_t ah[4] = {pa[8 * s], pb[8 * s], pa[8 * s + 4], pb[8 * s + 4]};
        const uint32_t al[4] = {pa[2 * plane + 8 * s], pb[2 * plane + 8 * s],
                                pa[2 * plane + 8 * s + 4], pb[2 * plane + 8 * s + 4]};
        mma_bf16(acc[0], ah, bh[s]);
        mma_bf16(acc[1], al, bc[s]);
        mma_bf16(acc[2], ah, bl[s]);
        mma_bf16(acc[3], al, bl[s]);
      }
      // c0, c1: row g (lane la), degrees 2 tig, 2 tig + 1; c2, c3: row g + 8
      float y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) y[q] = acc[0][q] + ((acc[1][q] + acc[2][q]) + acc[3][q]);
      float oa = cheb_pair(u_a, tig, y[0], y[1]);
      float ob = cheb_pair(u_b, tig, y[2], y[3]);
      oa += __shfl_xor_sync(0xFFFFFFFFu, oa, 1);
      ob += __shfl_xor_sync(0xFFFFFFFFu, ob, 1);
      oa += __shfl_xor_sync(0xFFFFFFFFu, oa, 2);
      ob += __shfl_xor_sync(0xFFFFFFFFu, ob, 2);
      if (tig == 0) {
        res_s[i * kLanes + la] = oa;
        res_s[i * kLanes + lb] = ob;
      }
    }
    __syncthreads();
  }

  // ---- whole rows of out: emitted outputs from shared memory, the rest
  // selected to zero ----
  if (vec) {
    for (int e = tid; e < n_tile * (kLanes / 4); e += kThreads) {
      const int i = e >> 3, q = (e & 7) * 4;
      if (r0 + q < R) {
        const float4 v = i < n_emit ? *reinterpret_cast<const float4*>(res_s + i * kLanes + q)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        *reinterpret_cast<float4*>(out + static_cast<int64_t>(n0 + i) * R + r0 + q) = v;
      }
    }
  } else {
    for (int e = tid; e < n_tile * kLanes; e += kThreads) {
      const int i = e >> 5, q = e & 31;
      if (r0 + q < R) out[static_cast<int64_t>(n0 + i) * R + r0 + q] = i < n_emit ? res_s[i * kLanes + q] : 0.0f;
    }
  }
}

template <int kKS>
int tc_launch(const float* buffer, const uint2* frags, const int64_t* s_tab, const int64_t* lanes,
              const int* rowmap, const int* win, float* out, int R, int64_t base0, int n_out,
              int out_cap, uint32_t M, int skew, int nt, int rows_pad, int pitch_w, int vec,
              cudaStream_t stream) {
  const size_t stage = static_cast<size_t>(rows_pad) * kStagePitch;
  const size_t smem = 4 * (4 * static_cast<size_t>(kLanes) * pitch_w +
                           (stage > static_cast<size_t>(nt) * kLanes ? stage : static_cast<size_t>(nt) * kLanes) +
                           2 * static_cast<size_t>(nt));
  const dim3 grid((R + kLanes - 1) / kLanes, (out_cap + nt - 1) / nt);
  if (smem > 232448 || grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(tc_combine_kernel<kKS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tc_combine_kernel<kKS><<<grid, kThreads, smem, stream>>>(buffer, frags, s_tab, lanes, rowmap, win, out,
                                                           R, base0, n_out, out_cap, M, skew, nt, rows_pad,
                                                           pitch_w, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 on success).  The
// caller checks shapes, contiguity, n_out <= out_cap and that every row
// [base0, base0 + skew + j[n_out - 1] + 1 + taps) lies in the ring.

// B6: a_t [taps, 8] f32, the Farrow basis A transposed; js [out_cap] int32
// pairs (j, s as u32 bits); tiles [n_tiles][2], rowmap [n_tiles][rows_pad]
// and aux int32, the tile plan (ops/fir_async_kernel.py F32TilePlan) of
// the form `positions` picks (aux: pfirst [n_aux] or win [out_cap]); the
// first n_emit tiles are computed and rows [z0, out_cap) zero-filled;
// vec: R % 4 == 0 and a 16-byte aligned buffer.
extern "C" int fir_async_combine(const float* buffer, const float* a_t, const void* js, const int64_t* lanes,
                                 const void* tiles, const int* rowmap, const int* aux, float* out, int R,
                                 int64_t base0, int n_out, int out_cap, int taps, int64_t M, int skew,
                                 int positions, int n_emit, int z0, int rows_pad, int out_max, int n_aux,
                                 int vec, void* stream) {
  if (M < 1 || M > 0xFFFFFFFFLL || skew < 1 || taps < f32::kP || taps % f32::kP || n_emit < 0 ||
      z0 < 0 || z0 > out_cap || n_aux < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const f32::Args a{buffer, a_t, static_cast<const int2*>(js), lanes, static_cast<const int2*>(tiles),
                    rowmap, aux, out, R, base0, n_out, out_cap, taps, static_cast<uint32_t>(M), skew,
                    n_emit, z0, rows_pad, out_max, n_aux, vec};
  const auto st = static_cast<cudaStream_t>(stream);
  return positions ? f32::launch<true>(a, st) : f32::launch<false>(a, st);
}

// B6b: frags [3][taps / 16][32][2] uint32, the B fragments of a_hi, a_hi_c
// and a_lo (ops/fir_async_kernel.py b_fragments); s [out_cap] int64; rowmap
// [n_tiles][rows_pad], win [out_cap] int32 (AsyncTilePlan: nt outputs per
// tile, pitch_w words per lane of each bf16 array); vec: R % 4 == 0 and a
// 16-byte aligned buffer.
extern "C" int fir_async_combine_bf16x4(const float* buffer, const void* frags,
                                        const int64_t* s_tab, const int64_t* lanes,
                                        const int* rowmap, const int* win, float* out, int R,
                                        int64_t base0, int n_out, int out_cap, int taps,
                                        int64_t M, int skew, int nt, int rows_pad, int pitch_w,
                                        int vec, void* stream) {
  if (M < 1 || M > 0xFFFFFFFFLL || nt < 1 || skew < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* f = static_cast<const uint2*>(frags);
  const auto st = static_cast<cudaStream_t>(stream);
  const uint32_t m = static_cast<uint32_t>(M);
  switch (taps) {
    case 16:
      return tc::tc_launch<1>(buffer, f, s_tab, lanes, rowmap, win, out, R, base0, n_out, out_cap, m, skew,
                              nt, rows_pad, pitch_w, vec, st);
    case 32:
      return tc::tc_launch<2>(buffer, f, s_tab, lanes, rowmap, win, out, R, base0, n_out, out_cap, m, skew,
                              nt, rows_pad, pitch_w, vec, st);
    case 64:
      return tc::tc_launch<4>(buffer, f, s_tab, lanes, rowmap, win, out, R, base0, n_out, out_cap, m, skew,
                              nt, rows_pad, pitch_w, vec, st);
    case 128:
      return tc::tc_launch<8>(buffer, f, s_tab, lanes, rowmap, win, out, R, base0, n_out, out_cap, m, skew,
                              nt, rows_pad, pitch_w, vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
}
