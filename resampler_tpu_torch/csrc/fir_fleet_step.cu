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
// column is addressable, so the atlas's structural zeros are skipped: the
// band form keeps narrow bands of it, the per-output form each output's
// taps-wide phase row.
//
// Bound on an H100: at 44.1 -> 48 kHz, 128 taps, 1024 stereo streams, chunk
// 4096 (R 2048, out_cap 4321) a step is ~2.27 GFLOP of f32 FMA (0.034 ms at
// 67 TFLOP/s) against ~102 MB of slide, chunk and output traffic (0.031 ms
// at 3.35 TB/s): about balanced.  f32 FMA on the CUDA cores, no tensor
// cores: the 100 dB alias gate needs f32.
//
// Design, the band form (fir_fleet_step_band): two launches on one stream.
// The copy-in (blocks of 128 threads, 512 columns of one stream's buffer
// each, coalesced) writes next.  The contraction is the JAX package's
// banded atlas cut into narrow bands, its zero band skipped.  Output i of
// stream b is the canonical q = i0_b + i, with i0_b = r_b * L^-1 mod M and
// m_b = (i0_b L - r_b) / M; it reads columns base_b - m_b + d(q) + t with
// phase row (q L) mod M, d(q) = floor(q L / M), and d(q + M) = d(q) + L, so
// all but base_b - m_b depends on q mod M alone: the host builds the d
// table and, per start phase, the band of R consecutive outputs (bands [M,
// band_w, Rp], G[s, r] = W[ph_r][s - off_r], zeros written in).  A thread
// keeps a register tile of R consecutive q of one row (b, c), so each input
// it loads feeds R FMAs (the work grows by band_w / taps, 135/128 at 44.1
// -> 48 kHz).  The 32 lanes of a warp take 32 rows at the same q0, so they
// read the same band: broadcast 16-byte shared loads, where the per-output
// form spread a warp's weight loads over a 640-byte phase-table row and
// issued 1.5 loads per FMA.  A block is 32 rows x `warps` warps, each warp
// the next R outputs.  It copies its warps' bands once (cp.async, 16
// bytes), then for each of `groups` row groups stages the 32 rows' windows
// of the new buffer with 4-byte cp.async through the copy-in select
// (columns outside [0, valid_end) are zero-filled, chunk frames past
// to_copy never read) at an odd pitch, and contracts.  The q tiles run over
// [i0, i0 + out_cap) on one shared schedule, else over [0, M - 1 +
// out_cap); a row whose range misses q is masked at the store (its junk is
// never multiplied into an output), and a group whose rows all miss the
// tile is skipped.  Every output in [0, out_cap) is written once.  What
// bounds it: the shared-memory loads of the inner loop (two broadcast
// 16-byte band loads and one input load per 8 FMAs), then the staging and
// the epilogue's strided stores.
//
// The per-output form (fir_fleet_step), for a band tile whose shared
// memory would pass 227 KB (heavy downsampling: the window grows by
// q_tile L / M columns): one launch of blocks of 128 threads; a block
// either copies or computes 128 consecutive outputs of one stream, one
// thread per output and kCT channels at once, the taps split into the
// ranges read from the old buffer, from the chunk and from the slack.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCopyPerThread = 4;

// The copy-in of stream b's block `blk`: next[c, x] = new(c, x) for x <
// valid_end, kCopyPerThread * kThreads columns per block.
__device__ __forceinline__ void copy_in(const float* __restrict__ old_b,
                                        const float* __restrict__ chunk_b,
                                        float* __restrict__ next_b, int blk, int C, int alloc,
                                        int valid_end, int lim, int to_copy, int64_t sf,
                                        int64_t sc) {
  const int64_t n = static_cast<int64_t>(C) * valid_end;
#pragma unroll
  for (int k = 0; k < kCopyPerThread; ++k) {
    const int64_t e = (static_cast<int64_t>(blk) * kCopyPerThread + k) * kThreads + threadIdx.x;
    if (e >= n) break;
    const int c = static_cast<int>(e / valid_end);
    const int x = static_cast<int>(e - static_cast<int64_t>(c) * valid_end);
    const float v = x < lim ? old_b[static_cast<int64_t>(c) * alloc + x + to_copy]
                            : chunk_b[(x - lim) * sf + c * sc];
    next_b[static_cast<int64_t>(c) * alloc + x] = v;
  }
}

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
    copy_in(old_b, chunk_b, next + static_cast<int64_t>(b) * C * alloc, blockIdx.x, C, alloc,
            valid_end, lim, to_copy, sf, sc);
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


// ---- the band form ----

__global__ void __launch_bounds__(kThreads)
copy_in_kernel(const float* __restrict__ old, const float* __restrict__ chunks,
               const int* __restrict__ sched, int sched_stride, float* __restrict__ next,
               int C, int alloc, int valid_end, int64_t sb, int64_t sf, int64_t sc) {
  const int b = blockIdx.y;
  const int to_copy = sched[static_cast<int64_t>(b) * sched_stride];
  copy_in(old + static_cast<int64_t>(b) * C * alloc, chunks + static_cast<int64_t>(b) * sb,
          next + static_cast<int64_t>(b) * C * alloc, blockIdx.x, C, alloc, valid_end,
          valid_end - to_copy, to_copy, sf, sc);
}

constexpr int kRows = 32;     // rows (b, c) of a band group: one per lane
constexpr int kMaxWarps = 8;  // warps of a band block

// Stream b's schedule as the band tile reads it: its canonical start i0
// and the read start of canonical output 0, base - m (so output q reads
// from base - m + d(q)).
struct RowSched {
  int to_copy, n_out;
  int64_t i0, x_q0;
};

__device__ __forceinline__ RowSched row_sched(const int* __restrict__ sched, int sched_stride,
                                              int b, int L, int M, int l_inv) {
  const int* s = sched + static_cast<int64_t>(b) * sched_stride;
  RowSched rs;
  rs.to_copy = s[0];
  rs.n_out = s[1];
  const int64_t r = s[3];
  rs.i0 = r * l_inv % M;
  rs.x_q0 = s[2] - (rs.i0 * L - r) / M;
  return rs;
}

// A 4-byte asynchronous copy from global to shared memory; `bytes` 0
// writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d(q) = floor(q L / M) for q >= 0, through the start-phase table.
__device__ __forceinline__ int64_t d_of(const int* __restrict__ d_tab, int64_t q, int L, int M) {
  return (q / M) * L + d_tab[q % M];
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

template <int R>
__global__ void __launch_bounds__(kRows * kMaxWarps)
band_step_kernel(const float* __restrict__ old, const float* __restrict__ chunks,
                 const int* __restrict__ sched, int sched_stride, const float* __restrict__ bands,
                 const int* __restrict__ d_tab, float* __restrict__ out, int B, int C, int alloc,
                 int valid_end, int64_t sb, int64_t sf, int64_t sc, int out_cap, int L, int M,
                 int l_inv, int groups, int band_w, int win, int pitch) {
  constexpr int kRp = (R + 3) / 4 * 4;  // band row padded for 16-byte loads
  extern __shared__ float4 smem4[];
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the group's row table: each row's window start, the end of its old
  // columns (lim), and its old and chunk offsets
  int* t_start = reinterpret_cast<int*>(smem4);
  int* t_lim = t_start + kRows;
  int64_t* t_old = reinterpret_cast<int64_t*>(t_lim + kRows);
  int64_t* t_chunk = t_old + kRows;
  float* band = reinterpret_cast<float*>(t_chunk + kRows);  // [warps][band_w][kRp]
  float* xs = band + warps * band_w * kRp;                   // [kRows][pitch]

  const int64_t q_base =
      sched_stride == 0 ? row_sched(sched, 0, 0, L, M, l_inv).i0 : 0;
  const int64_t q_first = q_base + static_cast<int64_t>(blockIdx.x) * warps * R;
  const int64_t q_end = q_first + warps * R;
  const int d_first = static_cast<int>(d_of(d_tab, q_first, L, M));

  // ---- the block's bands: warp g's is the host's band of start phase
  // (q_first + g R) mod M, copied 16 bytes at a time
  const int n16 = band_w * kRp / 4;
  for (int e = threadIdx.x; e < warps * n16; e += blockDim.x) {
    const int g = e / n16, i = e - g * n16;
    const int64_t ph0 = (q_first + g * R) % M;
    cp_async16(band + 4 * static_cast<int64_t>(e), bands + (ph0 * n16 + i) * 4);
  }

  const int64_t q0 = q_first + warp * R;  // this warp's first output
  const int wst = static_cast<int>(d_of(d_tab, q0, L, M)) - d_first;
  const int n_groups = (B * C + kRows - 1) / kRows;
  const int grp_end = min(n_groups, static_cast<int>(blockIdx.y + 1) * groups);
  for (int grp = blockIdx.y * groups; grp < grp_end; ++grp) {
    // this lane's row
    const int row = grp * kRows + lane;
    const int b = row / C, c = row - b * C;
    int n_out = 0;
    int64_t i0 = 0;
    if (b < B) {
      const int* sb_row = sched + static_cast<int64_t>(b) * sched_stride;
      n_out = sb_row[1];
      i0 = static_cast<int64_t>(sb_row[3]) * l_inv % M;
    }
    const bool hit = b < B && q_first < i0 + out_cap && q_end > i0;
    const bool emit = b < B && q_first < i0 + n_out && q_end > i0;
    if (threadIdx.x < kRows) {  // the row table (the last group's staging is done)
      int start = -(1 << 30), lim = 0;  // a row past B reads zeros
      int64_t o = 0, ch = 0;
      if (b < B) {
        const RowSched rs = row_sched(sched, sched_stride, b, L, M, l_inv);
        start = static_cast<int>(rs.x_q0) + d_first;
        lim = valid_end - rs.to_copy;  // new columns [0, lim) come from old
        o = static_cast<int64_t>(row) * alloc + rs.to_copy;
        ch = static_cast<int64_t>(b) * sb + c * sc;
      }
      t_start[lane] = start;
      t_lim[lane] = lim;
      t_old[lane] = o;
      t_chunk[lane] = ch;
    }
    // the barriers also order the table and the last group's reads of xs
    // before the staging below
    if (!__syncthreads_or(hit)) continue;  // no output of these rows in the tile
    const bool compute = __syncthreads_or(emit);

    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    if (compute) {
      // ---- stage the rows' windows of the new buffer through the copy-in
      // select, a row per warp at a time, every copy in flight at once
      for (int j = warp; j < kRows; j += warps) {
        const int start = t_start[j], lim = t_lim[j];
        const float* o = old + t_old[j];
        const float* ch = chunks + t_chunk[j] - lim * sf;
        float* xrow = xs + j * pitch;
        for (int k = lane; k < win; k += 32) {
          const int x = start + k;
          const bool in = x >= 0 && x < valid_end;
          cp_async4(xrow + k, in ? (x < lim ? o + x : ch + x * sf) : old, in ? 4 : 0);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      // ---- contract: R outputs of this lane's row; per step one band
      // column (broadcast to the warp) and one input
      const float* xr = xs + lane * pitch + wst;
      const float4* bw = reinterpret_cast<const float4*>(band + warp * band_w * kRp);
#pragma unroll 4
      for (int s = 0; s < band_w; ++s) {
        const float xv = xr[s];
#pragma unroll
        for (int q = 0; q < kRp / 4; ++q) {
          const float4 wv = bw[s * (kRp / 4) + q];
          const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (4 * q + i < R) acc[4 * q + i] = fmaf(wq[i], xv, acc[4 * q + i]);
        }
      }
    }
    // ---- the row's outputs in [0, out_cap): emitted, or the n_out mask's 0
    if (b < B) {
      float* out_row = out + static_cast<int64_t>(b) * out_cap * C + c;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t i = q0 + r - i0;
        if (i >= 0 && i < out_cap) out_row[i * C] = i < n_out ? acc[r] : 0.0f;
      }
    }
  }
  cp_async_wait_all();  // a block that staged nothing still drains its band copies
}

template <int R>
cudaError_t launch_band(const float* old, const float* chunks, const int* sched,
                        int sched_stride, const float* bands, const int* d_tab, float* out, int B,
                        int C, int alloc, int valid_end, int64_t sb, int64_t sf, int64_t sc,
                        int out_cap, int L, int M, int l_inv, int warps, int groups, int band_w,
                        int win, int pitch, int q_tiles, cudaStream_t stream) {
  constexpr int kRp = (R + 3) / 4 * 4;
  const int64_t smem = 24 * kRows + 4 * (static_cast<int64_t>(warps) * kRp * band_w +
                                         static_cast<int64_t>(kRows) * pitch);
  const int64_t n_groups = (static_cast<int64_t>(B) * C + kRows - 1) / kRows;
  const int64_t grid_y = (n_groups + groups - 1) / groups;
  if (smem > 232448 || grid_y > 65535 || q_tiles < 1) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      band_step_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(grid_y));
  band_step_kernel<R><<<grid, 32 * warps, static_cast<size_t>(smem), stream>>>(
      old, chunks, sched, sched_stride, bands, d_tab, out, B, C, alloc, valid_end, sb, sf, sc,
      out_cap, L, M, l_inv, groups, band_w, win, pitch);
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

// The band form: the copy-in, then the band contraction, on `stream`;
// returns the first launch's error (0 on success).  bands [M, band_w, Rp]
// are the tile's bands per start phase and d_tab [M] its d table
// (ops/fir_kernel.py BandTile); win and pitch its window and row pitch;
// q_tiles its blocks along q.  The caller checks what fir_fleet_step's
// caller checks, and that the tile fits in shared memory.
extern "C" int fir_fleet_step_band(const float* old, const float* chunks, const int* sched,
                                   int sched_stride, const float* bands, const int* d_tab,
                                   float* next, float* out, int B, int C, int alloc,
                                   int valid_end, int64_t sb, int64_t sf, int64_t sc, int out_cap,
                                   int L, int M, int l_inv, int R, int warps, int groups,
                                   int band_w, int win, int pitch, int q_tiles, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || M < 1 || L < 1 || valid_end > alloc || warps < 1 ||
      warps > kMaxWarps || groups < 1 || band_w < 1 || win < band_w || pitch < win) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t per_copy = static_cast<int64_t>(kThreads) * kCopyPerThread;
  const int64_t copy_blocks = (static_cast<int64_t>(C) * valid_end + per_copy - 1) / per_copy;
  if (copy_blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  copy_in_kernel<<<dim3(static_cast<unsigned>(copy_blocks), static_cast<unsigned>(B)), kThreads,
                   0, st>>>(old, chunks, sched, sched_stride, next, C, alloc, valid_end, sb, sf,
                            sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
#define FLEET_BAND(RR)                                                                      \
  case RR:                                                                                  \
    err = launch_band<RR>(old, chunks, sched, sched_stride, bands, d_tab, out, B, C, alloc,  \
                          valid_end, sb, sf, sc, out_cap, L, M, l_inv, warps, groups, band_w, \
                          win, pitch, q_tiles, st);                                          \
    break;
  switch (R) {
    FLEET_BAND(1)
    FLEET_BAND(2)
    FLEET_BAND(3)
    FLEET_BAND(4)
    FLEET_BAND(5)
    FLEET_BAND(6)
    FLEET_BAND(7)
    FLEET_BAND(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLEET_BAND
  return static_cast<int>(err);
}
