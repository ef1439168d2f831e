// ADA two-pass affine warp W and its transpose W^T for Hopper (sm_90a).
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// brushstroke_engine_tpu/ops/pallas_warp.py (spec: `_affine_warp_twopass` of
// train/augment.py).  Per sample, with the eight pass scalars
// (A1, B1, c1, s1, D2, E2, c2, s2) of `_twopass_prep`:
//
//   pass 1 (horizontal): u(r, j) = reflect101((B1*r + A1*j) + c1, N-1)
//     i1[r, j, c]  = sum_k w1[r, j, k] * x[r, k, c]
//   pass 2 (vertical):   v(i, j) = reflect101((E2*i + D2*j) + c2, N-1)
//     out[i, j, c] = sum_r w2[i, j, r] * i1[r, j, c]
//
// where w(., t) = max(0, 1 - |t - centre| / s) divided by its sum over the
// in-range taps t in [0, N-1] (floored at 1e-8).  W^T applies the transposed
// passes in reverse order:
//   i1b[r, j, c]  = sum_i w2[i, j, r] * g[i, j, c]
//   xbar[r, k, c] = sum_j w1[r, j, k] * i1b[r, j, c]
// Images are NHWC [B, N, N, C] f32, contiguous, with any C and any N (the
// TPU kernel's N % 128 == 0 and C <= 8 were Mosaic tiling limits) up to the
// N whose column of i1 still fits W's shared memory (7264 at C >= 8) and
// whose line still fits W^T's tile (about 5800).
//
// Design.  Not carried over block by block: the TPU kernel builds dense
// [8, N, N] weight tiles for the matrix unit; here a triangle of half-width
// s has at most 2s+1 non-zero taps, so the forward passes GATHER only those
// taps per output pixel.  The interpolation weights never reach global
// memory.
//
// W is one launch with no global intermediate.  Pass 2 is vertical, so a
// band of output columns J needs only i1[:, J], and i1[r, j] needs only row
// r of x: a block that owns (column band, sample) needs no halo from any
// other block.  It computes i1 for every row of its band into shared memory
// (phase 1, horizontal taps gathered from x through L1/L2), syncs, and
// gathers pass 2's vertical taps from there (phase 2), writing each output
// pixel once.  The band is picked per shape (`fused_band`) so that the grid
// fills the card: [64,128,128,3] takes bands of 16 columns, 512 blocks of
// 24 KB.  Indices come from blockIdx / threadIdx in 32-bit ints (64-bit only
// in pointers), and a pixel's normaliser is one reciprocal.
//
// W^T is a gather too, which keeps it deterministic (no atomicAdd, a fixed
// summation order): a block computes the centre and the normaliser of each
// source pixel of its tile once, into shared memory, and each output tap
// then visits only the few sources whose triangle can reach it, in
// ascending order (see "Transposed passes" below).  Its intermediate i1b
// goes through a global scratch tensor between its two launches (at
// [64,128,128,3] it is 12.6 MB and stays in the 50 MB L2).
//
// Bound: memory.  Each direction must read one image batch and write one
// (2 * B*N*N*C*4 bytes: 25.2 MB, 7.5 us at 3.35 TB/s for [64,128,128,3]);
// the forward does about (2*s1+1 + 2*s2+1) * C multiply-adds per output and
// the transposed about as many, both far below the f32 roof.  What bounds
// the kernels at this size is instruction issue and latency: little work
// per thread, with trip counts that depend on the data.
// Measured on an H100 80GB HBM3 at 700 W at [64,128,128,3] (ADA 'bgc'
// matrices at p = 1, antialias; chip_smoke.py and tools/tune_kernels.py):
// W one launch of 13.7 us device time (1.8x the bound); the first W, two
// gather launches through a scratch tensor, 24.2 + 20.6 us.  W^T
// 0.083-0.085 ms per call, 79 us device time (40 + 39); the first W^T, a
// dense N-step loop per output, 0.707 ms.  PERF.md has the tables and the
// steps between.
//
// The centre arithmetic is written with __fmul_rn/__fadd_rn so that it is
// not contracted into FMAs and equals the plain version's separate multiply
// and add bit for bit: the centre of a pixel near column 100 has an ulp of
// 7.6e-6, which a different rounding would turn into a weight error of the
// same size.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;   // channels held in registers at a time

// Reflect-101 into [0, nm1]; floor-mod as jnp.mod and torch.remainder.
__device__ __forceinline__ float reflect101(float v, float nm1) {
  const float period = 2.f * nm1;
  float r = fmodf(v, period);
  if (r < 0.f) r += period;
  return r > nm1 ? period - r : r;
}

struct PassScalars {
  float p;     // d centre / d row
  float q;     // d centre / d col
  float c;     // offset
  float s;     // triangle half-width (>= 1 with antialias, else 1)
  float inv;   // 1 / s
};

// kVertical = false: pass 1 (A1, B1, c1, s1); true: pass 2 (D2, E2, c2, s2).
template <bool kVertical>
__device__ __forceinline__ PassScalars load_scalars(const float* sc) {
  PassScalars ps;
  if (kVertical) {
    ps.p = sc[5]; ps.q = sc[4]; ps.c = sc[6]; ps.s = sc[7];
  } else {
    ps.p = sc[1]; ps.q = sc[0]; ps.c = sc[2]; ps.s = sc[3];
  }
  ps.inv = 1.0f / ps.s;
  return ps;
}

__device__ __forceinline__ float centre(const PassScalars& ps, int row,
                                        int col, float nm1) {
  const float lin = __fadd_rn(
      __fadd_rn(__fmul_rn(ps.p, (float)row), __fmul_rn(ps.q, (float)col)),
      ps.c);
  return reflect101(lin, nm1);
}

__device__ __forceinline__ float tri(float t, float ctr, float inv) {
  return fmaxf(0.f, 1.f - fabsf(t - ctr) * inv);
}

__device__ __forceinline__ void tap_range(float ctr, float s, int n, int* lo,
                                          int* hi) {
  *lo = max(0, (int)ceilf(ctr - s));
  *hi = min(n - 1, (int)floorf(ctr + s));
}

__device__ __forceinline__ float normaliser(float ctr, const PassScalars& ps,
                                            int n) {
  int lo, hi;
  tap_range(ctr, ps.s, n, &lo, &hi);
  float sum = 0.f;
  for (int t = lo; t <= hi; ++t) sum += tri((float)t, ctr, ps.inv);
  return fmaxf(sum, 1e-8f);
}

// W, fused.  A (band, rows) block owns columns j0 .. j0 + band - 1 of one
// sample (blockIdx.y = band index, blockIdx.x = sample); thread (jj, y)
// owns column j0 + jj and rows y, y + rows, ...  Columns are the fast
// index, so a warp's loads and stores run along image rows.  Channels are
// held kNC = min(C, kChunk) at a time; kWhole (C <= kChunk) makes the pixel
// stride a constant, so a tap's channels load at fixed offsets from one
// pointer; a larger C takes its channels in chunks, one chunk's i1 band in
// shared memory at a time.  Dynamic shared memory: i1[N][band][kNC] floats.
//
// What bounds it is instruction issue and the latency of the gathers, not
// bytes: each output pixel costs a centre, a tap range, a normaliser and
// (2s+1) * C multiply-adds per pass.  So the taps' loads go out in groups
// of kTapGroup from one pointer with a tap past the range predicated off
// (weight 0, no load: the sums equal the tap-by-tap loop's bit for bit),
// and rows advance by pointer increments (no 64-bit multiply per pixel).

constexpr int kTapGroup = 4;

// acc[c] = sum over taps t = lo..hi of w(t) * px[(t - lo) * stride + c],
// in ascending t; returns the sum of the weights w(t) = tri(t, ctr).
template <int kNC>
__device__ __forceinline__ float gather_taps(const float* px, int stride,
                                             int lo, int hi, float ctr,
                                             float inv, int nc, float* acc) {
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kNC; ++c) acc[c] = 0.f;
  for (int t0 = lo; t0 <= hi; t0 += kTapGroup, px += kTapGroup * stride) {
    float v[kTapGroup][kNC], w[kTapGroup];
#pragma unroll
    for (int g = 0; g < kTapGroup; ++g) {
      const bool ok = t0 + g <= hi;
#pragma unroll
      for (int c = 0; c < kNC; ++c)
        v[g][c] = (ok && c < nc) ? px[g * stride + c] : 0.f;
      w[g] = ok ? tri((float)(t0 + g), ctr, inv) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kTapGroup; ++g) {
      sum += w[g];
#pragma unroll
      for (int c = 0; c < kNC; ++c)
        if (c < nc) acc[c] += w[g] * v[g][c];
    }
  }
  return sum;
}

template <int kNC, bool kWhole>
__global__ void __launch_bounds__(kThreads) warp_fused(
    const float* __restrict__ x, float* __restrict__ out,
    const float* __restrict__ scalars, int N, int C) {
  extern __shared__ float i1[];
  const int band = blockDim.x, rows = blockDim.y;
  const int jj = threadIdx.x;
  const int j = blockIdx.y * band + jj;
  const bool active = j < N;                  // the last band may be ragged
  const float* sc = scalars + 8 * blockIdx.x;
  const PassScalars p1 = load_scalars<false>(sc);
  const PassScalars p2 = load_scalars<true>(sc);
  const float nm1 = (float)(N - 1);
  const int stride = kWhole ? kNC : C;          // floats per pixel
  const size_t image = (size_t)blockIdx.x * N * N * C;
  const size_t row_step = (size_t)rows * N * C;

  for (int c0 = 0; c0 < C; c0 += kNC) {
    const int nc = kWhole ? kNC : min(kNC, C - c0);
    if (c0 > 0) __syncthreads();              // the last chunk's i1 is read
    // Phase 1 (horizontal): i1[r, j] = sum_t w1(r, j, t) * x[r, t].
    const float* row = x + image + (size_t)threadIdx.y * N * C + c0;
    float* cell = i1 + (threadIdx.y * band + jj) * kNC;
    for (int r = active ? threadIdx.y : N; r < N;
         r += rows, row += row_step, cell += rows * band * kNC) {
      const float ctr = centre(p1, r, j, nm1);
      int lo, hi;
      tap_range(ctr, p1.s, N, &lo, &hi);
      float acc[kNC];
      const float rn = 1.f / fmaxf(
          gather_taps<kNC>(row + lo * stride, stride, lo, hi, ctr, p1.inv,
                           nc, acc), 1e-8f);
#pragma unroll
      for (int c = 0; c < kNC; ++c)
        if (c < nc) cell[c] = acc[c] * rn;
    }
    __syncthreads();
    // Phase 2 (vertical): out[i, j] = sum_t w2(i, j, t) * i1[t, j].
    float* o = out + image + ((size_t)threadIdx.y * N + j) * C + c0;
    for (int i = active ? threadIdx.y : N; i < N; i += rows, o += row_step) {
      const float ctr = centre(p2, i, j, nm1);
      int lo, hi;
      tap_range(ctr, p2.s, N, &lo, &hi);
      float acc[kNC];
      const float rn = 1.f / fmaxf(
          gather_taps<kNC>(i1 + (lo * band + jj) * kNC, band * kNC, lo, hi,
                           ctr, p2.inv, nc, acc), 1e-8f);
#pragma unroll
      for (int c = 0; c < kNC; ++c)
        if (c < nc) o[c] = acc[c] * rn;
    }
  }
}

// ---------------------------------------------------------------------------
// Transposed passes.
//
// A transposed pass is a gather over SOURCE pixels: output tap t of a line
// (a column in the vertical pass, a row in the horizontal one) sums
//   tri(t, ctr[m]) / norm[m] * src[m]
// over the sources m = 0..N-1 of that line, in ascending m.  ctr and norm
// depend on the source pixel only, so a block first fills a table
// (ctr, 1 / norm) for every source pixel of its tile of lines in shared
// memory -- each centre (one fmodf) and each normaliser (one loop over the
// taps under the triangle) is computed once per block -- and the gather
// reads two shared floats per visited source.  The block's source pixels
// are staged in shared memory too (one coalesced read of the tile), because
// the gather's trip count depends on the data and its loads would otherwise
// wait for device memory one after the other.
//
// It visits only the sources that can reach the tap.  Along a line the
// unreflected centre lin(m) = base + slope * m is affine in m, and its
// reflection equals t exactly where lin(m) = +-t + k * period.  The sources
// whose triangle covers t therefore lie in a few index intervals
// (lin(m) within reach of one of those targets).  The targets are walked so
// that m ascends, each interval is widened by a margin that covers the f32
// rounding of lin, of the reflection and of the weight test, and clipped to
// start after the previous one; every visited source still gets the exact
// weight test from the table.  The set is a superset of the non-zero
// weights and the order is ascending whatever the schedule, so the sum is
// bit-identical to the dense loop's.  ops/warp.py:source_intervals is the
// same enumeration in Python; the CPU tests hold it against dense weights.
// A slope too flat to divide by, or one that would give more targets than
// sources, takes the dense loop over the table.

constexpr int kLines = 8;       // lines (columns or rows) per block

// What the walk knows of one line (tap-independent; set once per thread).
struct LineWalk {
  double base, reach, period, inv_slope, inv_period;
  double lin_lo, lin_hi;   // range of lin over the line, widened by reach
  int n;
  bool rising;             // slope > 0
  bool dense;              // no walk on this line: visit every source
};

// One tap's walk along a line.
struct SourceWalk {
  double tap;
  bool dense;
  int q, q_end, q_step;   // target index: k = q >> 1, sign = q & 1 ? + : -
  int next;               // first source index not yet visited
};

__device__ __forceinline__ LineWalk line_begin(float slope, float coef,
                                               float line, float c, float s,
                                               int n) {
  LineWalk lw;
  const double nm1 = (double)(n - 1);
  const double sl = (double)slope;
  lw.base = (double)coef * (double)line + (double)c;
  lw.period = 2.0 * nm1;
  lw.inv_period = 1.0 / lw.period;
  lw.n = n;
  lw.rising = sl > 0.0;
  // Margin: three f32 roundings in lin, the reflection's two, the weight
  // test's two; 1e-6 relative to every magnitude involved is > 8 ulp.
  const double mag = fabs(sl) * nm1 + fabs(lw.base) + fabs((double)c) +
                     lw.period + (double)s;
  lw.reach = (double)s + 1e-6 * mag + 1e-6;
  lw.dense = !(fabs(sl) * nm1 >= 1.0);
  lw.inv_slope = lw.dense ? 0.0 : 1.0 / sl;
  const double end = lw.base + sl * nm1;
  lw.lin_lo = fmin(lw.base, end) - lw.reach;
  lw.lin_hi = fmax(lw.base, end) + lw.reach;
  return lw;
}

__device__ __forceinline__ SourceWalk walk_begin(const LineWalk& lw,
                                                 float tap) {
  SourceWalk w;
  w.tap = (double)tap;
  w.next = 0;
  w.dense = lw.dense;
  w.q = w.q_end = 0;
  w.q_step = 1;
  if (!w.dense) {
    // Targets within reach of the line: k of +tap + k * period, and of
    // -tap + k * period.
    const double kp_lo = ceil((lw.lin_lo - w.tap) * lw.inv_period);
    const double kp_hi = floor((lw.lin_hi - w.tap) * lw.inv_period);
    const double km_lo = ceil((lw.lin_lo + w.tap) * lw.inv_period);
    const double km_hi = floor((lw.lin_hi + w.tap) * lw.inv_period);
    // As q = 2k + 1 and q = 2k they interleave in ascending order; a q
    // between the two ranges that belongs to neither is only an extra
    // interval.
    double q_lo = 1.0, q_hi = 0.0;            // empty
    if (kp_lo <= kp_hi) { q_lo = 2.0 * kp_lo + 1.0; q_hi = 2.0 * kp_hi + 1.0; }
    if (km_lo <= km_hi) {
      const bool none = q_lo > q_hi;
      q_lo = none ? 2.0 * km_lo : fmin(q_lo, 2.0 * km_lo);
      q_hi = none ? 2.0 * km_hi : fmax(q_hi, 2.0 * km_hi);
    }
    // Too many targets for the walk to pay (or indices beyond int range).
    if (q_hi - q_lo > 0.5 * (double)lw.n || fabs(q_lo) > 1e8 ||
        fabs(q_hi) > 1e8) {
      w.dense = true;
    } else if (q_lo <= q_hi) {
      if (lw.rising) { w.q = (int)q_lo; w.q_end = (int)q_hi + 1; }
      else { w.q = (int)q_hi; w.q_end = (int)q_lo - 1; w.q_step = -1; }
    }
  }
  return w;
}

// The next interval [lo, hi] of sources to visit; false when none is left.
__device__ __forceinline__ bool walk_next(const LineWalk& lw, SourceWalk& w,
                                          int* lo, int* hi) {
  if (w.dense) {
    if (w.next > 0) return false;
    *lo = 0; *hi = lw.n - 1; w.next = lw.n;
    return true;
  }
  while (w.q != w.q_end && w.next < lw.n) {
    const int q = w.q;
    w.q += w.q_step;
    const double target =
        (double)(q >> 1) * lw.period + ((q & 1) ? w.tap : -w.tap) - lw.base;
    const double m0 = (target - lw.reach) * lw.inv_slope;
    const double m1 = (target + lw.reach) * lw.inv_slope;
    const double first = fmax(floor(fmin(m0, m1)) - 1.0, (double)w.next);
    const double last = fmin(ceil(fmax(m0, m1)) + 1.0, (double)(lw.n - 1));
    if (first <= last) {
      *lo = (int)first; *hi = (int)last; w.next = *hi + 1;
      return true;
    }
  }
  return false;
}

// One transposed pass.  Vertical: dst[r, j] = sum_i w2[i, j, r] * src[i, j]
// (source pixel (i, j), tap r; a line is a column).  Horizontal:
// dst[r, k] = sum_j w1[r, j, k] * src[r, j] (source pixel (r, j), tap k; a
// line is a row).  A block owns `lines` lines of one sample; a thread owns
// one line and every (kThreads / lines)-th tap.  In the vertical pass the
// lines are the fast thread index, so a warp stores runs of neighbouring
// columns; in the horizontal pass the taps are.  Dynamic shared memory:
// N * lines * (2 + min(C, kChunk)) floats (centres, 1 / normalisers, pixels).
template <bool kVertical>
__global__ void __launch_bounds__(kThreads) resample_gather_t(
    const float* __restrict__ src, float* __restrict__ dst,
    const float* __restrict__ scalars, int N, int C, int lines) {
  extern __shared__ float shared[];
  const int cells = N * lines;
  float* tctr = shared;                  // [cells] reflected centre
  float* tinv = shared + cells;          // [cells] 1 / normaliser
  float* tpix = shared + 2 * cells;      // [cells][nc] source pixels
  const long long b = blockIdx.y;
  const int line0 = blockIdx.x * lines;
  const PassScalars ps = load_scalars<kVertical>(scalars + b * 8);
  const float nm1 = (float)(N - 1);
  const float* img = src + b * N * N * C;
  float* out = dst + b * N * N * C;

  // Cell of source m of line l: vertical m * lines + l, horizontal
  // l * N + m -- the order of the pixels in memory, so the tile loads run
  // along it.
  for (int e = threadIdx.x; e < cells; e += kThreads) {
    const int l = kVertical ? e % lines : e / N;
    const int m = kVertical ? e / lines : e % N;
    if (line0 + l < N) {
      const int srow = kVertical ? m : line0 + l;
      const int scol = kVertical ? line0 + l : m;
      const float ctr = centre(ps, srow, scol, nm1);
      tctr[e] = ctr;
      tinv[e] = 1.f / normaliser(ctr, ps, N);
    }
  }

  const int l = kVertical ? threadIdx.x % lines
                          : threadIdx.x / (kThreads / lines);
  const int t_first = kVertical ? threadIdx.x / lines
                                : threadIdx.x % (kThreads / lines);
  const int t_step = kThreads / lines;
  const bool active = line0 + l < N;
  // lin(m) = slope * m + coef * line + c along the line.
  const LineWalk lw = line_begin(kVertical ? ps.p : ps.q,
                                 kVertical ? ps.q : ps.p,
                                 (float)(line0 + l), ps.c, ps.s, N);

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int nc = min(kChunk, C - c0);
    __syncthreads();          // the table is filled; the last chunk is read
    if (nc == C) {
      // Whole pixels: the tile is `lines * C` consecutive floats per source
      // row (vertical) or one run of `lines` whole rows (horizontal).
      const int run = kVertical ? lines * C : cells * C;
      const int valid = kVertical ? min(lines, N - line0) * C
                                  : min(lines, N - line0) * N * C;
      for (int e = threadIdx.x; e < cells * C; e += kThreads) {
        const int m = e / run, r = e - m * run;
        if (r < valid)
          tpix[e] = __ldg(img + ((long long)m * N * (kVertical ? 1 : 0) +
                                 (kVertical ? line0 : (long long)line0 * N)) *
                                    C + r);
      }
    } else {
      for (int e = threadIdx.x; e < cells * nc; e += kThreads) {
        const int cell = e / nc, c = e % nc;
        const int ll = kVertical ? cell % lines : cell / N;
        const int m = kVertical ? cell / lines : cell % N;
        if (line0 + ll < N) {
          const long long pixel = kVertical
              ? (long long)m * N + line0 + ll
              : (long long)(line0 + ll) * N + m;
          tpix[e] = __ldg(img + pixel * C + c0 + c);
        }
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int t = t_first; t < N; t += t_step) {
      const float tap = (float)t;
      float acc[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) acc[c] = 0.f;
      SourceWalk w = walk_begin(lw, tap);
      int lo, hi;
      while (walk_next(lw, w, &lo, &hi)) {
        for (int m = lo; m <= hi; ++m) {
          const int e = kVertical ? m * lines + l : l * N + m;
          const float wt = tri(tap, tctr[e], ps.inv);
          if (wt > 0.f) {
            const float wn = wt * tinv[e];
            const float* px = tpix + (size_t)e * nc;
#pragma unroll
            for (int c = 0; c < kChunk; ++c)
              if (c < nc) acc[c] += wn * px[c];
          }
        }
      }
      float* o = out + (kVertical ? ((long long)t * N + line0 + l)
                                  : ((long long)(line0 + l) * N + t)) * C +
                 c0;
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (c < nc) o[c] = acc[c];
    }
  }
}

// Shared memory a block may use (the opt-in maximum on sm_90).
constexpr size_t kMaxShared = 227 * 1024;

// Launch one transposed pass; `lines` per block shrinks until the tile fits.
template <bool kVertical>
cudaError_t launch_t(const float* src, float* dst, const float* scalars,
                     int B, int N, int C, cudaStream_t s) {
  const size_t per_line = (size_t)N * (2 + (C < kChunk ? C : kChunk)) *
                          sizeof(float);
  int lines = kLines;
  while (lines > 1 && per_line * lines > 64 * 1024) lines /= 2;
  const size_t shared = per_line * lines;
  if (shared > kMaxShared || B > 65535) return cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        resample_gather_t<kVertical>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + lines - 1) / lines, B);
  resample_gather_t<kVertical><<<grid, kThreads, shared, s>>>(
      src, dst, scalars, N, C, lines);
  return cudaGetLastError();
}

bool shape_ok(int B, int N, int C, long long* total, unsigned* blocks) {
  if (B <= 0 || N < 2 || C <= 0) return false;
  *total = (long long)B * N * N;
  const long long nb = (*total + kThreads - 1) / kThreads;
  if (nb > 0x7fffffffLL) return false;
  *blocks = (unsigned)nb;
  return true;
}

size_t fused_shared(int N, int C, int band) {
  return (size_t)N * band * (C < kChunk ? C : kChunk) * sizeof(float);
}

// W's column band at [B, N, N, C]: the widest power of two up to kMaxBand
// whose grid still has kWantBlocks blocks (one per SM) and whose i1 band
// fits in 48 KB, else one column, so that small batches spread over the
// SMs.  0 when not even one column of i1 fits in shared memory.  From the
// sweep in tools/tune_kernels.py (H100): [64,128,128,3] is fastest at 16
// (512 blocks; 8 and 32 are 15-25% slower), [8,64,64,3] at 4 (128 blocks).
constexpr int kMaxBand = 16;
constexpr long long kWantBlocks = 128;

int fused_band(int B, int N, int C) {
  if (B <= 0 || N < 2 || C <= 0) return 0;
  for (int band = kMaxBand; band > 1; band /= 2)
    if ((long long)B * ((N + band - 1) / band) >= kWantBlocks &&
        fused_shared(N, C, band) <= 48 * 1024)
      return band;
  return fused_shared(N, C, 1) <= kMaxShared ? 1 : 0;
}

template <int kNC, bool kWhole>
cudaError_t launch_fused(const float* x, float* out, const float* scalars,
                         int B, int N, int C, int band, cudaStream_t s) {
  const size_t shared = fused_shared(N, C, band);
  if (shared > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        warp_fused<kNC, kWhole>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (err != cudaSuccess) return err;
  }
  const int rows = kThreads / band < N ? kThreads / band : N;
  const dim3 block(band, rows);
  const dim3 grid(B, (N + band - 1) / band);
  warp_fused<kNC, kWhole><<<grid, block, shared, s>>>(x, out, scalars, N, C);
  return cudaGetLastError();
}

}  // namespace

// The column band W takes at [B, N, N, C] (0: the shape does not fit).
extern "C" int warp_twopass_band(int B, int N, int C) {
  return fused_band(B, N, C);
}

// W: x [B, N, N, C] -> out, in one launch.  All pointers are device
// pointers to contiguous f32; `scalars` is [B, 8].  `band` > 0 overrides
// the column band (at most kThreads; wider than N means one band).  N is
// limited by one column of i1 in shared memory (N * min(C, 8) floats <=
// 227 KB: N <= 7264 at C >= 8, 19370 at C = 3); beyond it the call returns
// cudaErrorInvalidValue.  Returns the CUDA error code of the launch
// (0 = success).
extern "C" int warp_twopass_launch(const float* x, float* out,
                                   const float* scalars, int B, int N, int C,
                                   int band, void* stream) {
  if (band <= 0) band = fused_band(B, N, C);
  else if (band > N) band = N;
  if (B <= 0 || N < 2 || C <= 0 || band <= 0 || band > kThreads ||
      fused_shared(N, C, band) > kMaxShared || (N + band - 1) / band > 65535)
    return (int)cudaErrorInvalidValue;
  using Launch = cudaError_t (*)(const float*, float*, const float*, int,
                                 int, int, int, cudaStream_t);
  static const Launch kWholePixels[kChunk] = {
      launch_fused<1, true>, launch_fused<2, true>, launch_fused<3, true>,
      launch_fused<4, true>, launch_fused<5, true>, launch_fused<6, true>,
      launch_fused<7, true>, launch_fused<8, true>};
  const Launch launch =
      C <= kChunk ? kWholePixels[C - 1] : launch_fused<kChunk, false>;
  return (int)launch(x, out, scalars, B, N, C, band,
                     static_cast<cudaStream_t>(stream));
}

// W^T: g [B, N, N, C] -> out, through `scratch` (holds i1b).  N is limited
// by one line's tile in shared memory (N * (2 + min(C, 8)) floats <= 227 KB,
// N <= 5800 at C >= 8) and B by the grid's y extent (65535); beyond either
// the call returns cudaErrorInvalidValue.
extern "C" int warp_twopass_t_launch(const float* g, float* scratch,
                                     float* out, const float* scalars, int B,
                                     int N, int C, void* stream) {
  long long total;
  unsigned blocks;
  if (!shape_ok(B, N, C, &total, &blocks)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_t<true>(g, scratch, scalars, B, N, C, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_t<false>(scratch, out, scalars, B, N, C, s);
}

extern "C" const char* warp_twopass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
