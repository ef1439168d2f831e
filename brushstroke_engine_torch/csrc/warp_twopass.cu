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
// Images are NHWC [B, N, N, C] f32, contiguous; there is no limit on N or C
// (the TPU kernel's N % 128 == 0 and C <= 8 were Mosaic tiling limits).
//
// Design.  Not carried over block by block: the TPU kernel builds dense
// [8, N, N] weight tiles for the matrix unit; here a triangle of half-width
// s has at most 2s+1 non-zero taps, so the forward passes GATHER only those
// taps per output pixel (one thread per (b, row, col), all C channels in
// registers, col fastest so a warp's loads and stores run along a row).  The
// transposed passes are gathers too, which keeps them deterministic (no
// atomicAdd): each output loops densely over all N source pixels of its row
// or column, recomputes that pixel's centre, and where its triangle covers
// the output recomputes its normaliser and accumulates.  The interpolation
// weights never reach global memory.  The intermediate i1 / i1b goes through
// a global scratch tensor between the two launches of an entry point (at
// [64,128,128,3] it is 12.6 MB and stays in the 50 MB L2), which keeps every
// SM busy; one block per sample with i1 in shared memory would use 64 of 132.
//
// Bound: memory.  Each direction must read one image batch and write one
// (2 * B*N*N*C*4 bytes: 25.2 MB, 7.5 us at 3.35 TB/s for [64,128,128,3]);
// the forward does about (2*s1+1 + 2*s2+1) * C multiply-adds per output and
// the transposed 2*N centre evaluations, both far below the f32 roof.
// Measured on an H100 80GB HBM3 at 700 W (torch.profiler, training batch):
// W 41 us for its two launches, W^T 633 us -- the dense N-step loop with an
// fmodf per step is W^T's cost, and visiting only the source pixels whose
// triangle can reach the output is the next step (PERF.md has the table).
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

// One forward pass: dst[row, col, :] = sum_t w(row, col, t) * src[tap pixel].
// Horizontal taps run along the row (src[row, t]), vertical ones along the
// column (src[t, col]).
template <bool kVertical>
__global__ void __launch_bounds__(kThreads) resample_gather(
    const float* __restrict__ src, float* __restrict__ dst,
    const float* __restrict__ scalars, int N, int C, long long total) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int col = (int)(idx % N);
  const int row = (int)((idx / N) % N);
  const long long b = idx / ((long long)N * N);
  const PassScalars ps = load_scalars<kVertical>(scalars + b * 8);
  const float ctr = centre(ps, row, col, (float)(N - 1));
  int lo, hi;
  tap_range(ctr, ps.s, N, &lo, &hi);
  const float* img = src + b * N * N * C;
  float* out = dst + idx * C;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int nc = min(kChunk, C - c0);
    float acc[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) acc[c] = 0.f;
    float sum = 0.f;
    for (int t = lo; t <= hi; ++t) {
      const float w = tri((float)t, ctr, ps.inv);
      sum += w;
      const float* px = img +
          (kVertical ? ((long long)t * N + col) : ((long long)row * N + t)) *
              C + c0;
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (c < nc) acc[c] += w * __ldg(px + c);
    }
    const float norm = fmaxf(sum, 1e-8f);
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (c < nc) out[c0 + c] = acc[c] / norm;
  }
}

// One transposed pass in gather form.  Vertical: dst[r, j] = sum_i
// w2[i, j, r] * src[i, j] (centre of source pixel (i, j), tap index r);
// horizontal: dst[r, k] = sum_j w1[r, j, k] * src[r, j] (centre of source
// pixel (r, j), tap index k).
template <bool kVertical>
__global__ void __launch_bounds__(kThreads) resample_gather_t(
    const float* __restrict__ src, float* __restrict__ dst,
    const float* __restrict__ scalars, int N, int C, long long total) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int col = (int)(idx % N);
  const int row = (int)((idx / N) % N);
  const long long b = idx / ((long long)N * N);
  const PassScalars ps = load_scalars<kVertical>(scalars + b * 8);
  const float nm1 = (float)(N - 1);
  const float tap = (float)(kVertical ? row : col);
  const float* img = src + b * N * N * C;
  float* out = dst + idx * C;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int nc = min(kChunk, C - c0);
    float acc[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) acc[c] = 0.f;
    for (int m = 0; m < N; ++m) {
      const int srow = kVertical ? m : row;
      const int scol = kVertical ? col : m;
      const float ctr = centre(ps, srow, scol, nm1);
      const float w = tri(tap, ctr, ps.inv);
      if (w > 0.f) {
        const float wn = w / normaliser(ctr, ps, N);
        const float* px = img + ((long long)srow * N + scol) * C + c0;
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (c < nc) acc[c] += wn * __ldg(px + c);
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (c < nc) out[c0 + c] = acc[c];
  }
}

bool shape_ok(int B, int N, int C, long long* total, unsigned* blocks) {
  if (B <= 0 || N < 2 || C <= 0) return false;
  *total = (long long)B * N * N;
  const long long nb = (*total + kThreads - 1) / kThreads;
  if (nb > 0x7fffffffLL) return false;
  *blocks = (unsigned)nb;
  return true;
}

}  // namespace

// W: x [B, N, N, C] -> out, through `scratch` (same shape, holds i1).  All
// pointers are device pointers to contiguous f32; `scalars` is [B, 8].
// Returns the CUDA error code of the first launch that failed (0 = success).
extern "C" int warp_twopass_launch(const float* x, float* scratch, float* out,
                                   const float* scalars, int B, int N, int C,
                                   void* stream) {
  long long total;
  unsigned blocks;
  if (!shape_ok(B, N, C, &total, &blocks)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  resample_gather<false><<<blocks, kThreads, 0, s>>>(x, scratch, scalars, N, C,
                                                     total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resample_gather<true><<<blocks, kThreads, 0, s>>>(scratch, out, scalars, N,
                                                    C, total);
  return (int)cudaGetLastError();
}

// W^T: g [B, N, N, C] -> out, through `scratch` (holds i1b).
extern "C" int warp_twopass_t_launch(const float* g, float* scratch,
                                     float* out, const float* scalars, int B,
                                     int N, int C, void* stream) {
  long long total;
  unsigned blocks;
  if (!shape_ok(B, N, C, &total, &blocks)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  resample_gather_t<true><<<blocks, kThreads, 0, s>>>(g, scratch, scalars, N,
                                                      C, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resample_gather_t<false><<<blocks, kThreads, 0, s>>>(scratch, out, scalars,
                                                       N, C, total);
  return (int)cudaGetLastError();
}

extern "C" const char* warp_twopass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
