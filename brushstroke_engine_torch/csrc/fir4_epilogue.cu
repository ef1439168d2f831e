// Fused 4x4 FIR + modulated-conv epilogue for the up-sampling synthesis
// layers (the tail of every `conv0` at res >= 8), for Hopper (sm_90a).
//
// Replaces the TPU kernel `fir4_epilogue` of
// brushstroke_engine_tpu/ops/pallas_fir.py (spec: fir4_epilogue_reference).
// Per output element (b, y, x, c), in this order:
//   acc = sum_{i,j<4} taps[i][j] * x[b, y+i, x+j, c]     (taps already
//         flipped and scaled by the FIR gain; VALID, full 4x4, no
//         separability assumed)
//   v = acc * dcoefs[b, c]  (+ noise[b, y, x], broadcast over c)  + bias[c]
//   v = (v >= 0 ? v : alpha * v) * act_gain,  clamped to [-clamp, clamp]
// Input x is NHWC [B, H+3, W+3, C] in f32 or bf16; accumulation is f32; the
// output [B, H, W, C] is written in the input's dtype.  Unlike the TPU kernel this
// one takes the per-pixel noise, which the render always has.
//
// Bound: memory.  Each call must read x once and write out once, plus the
// noise plane: at B=16, H=W=256, C=64 in f32 that is
// 16*259*259*64*4 + 16*256*256*64*4 + 16*256*256*4 = 0.547 GB, about
// 0.163 ms at 3.35 TB/s; the 16 FMAs per output are far below the compute
// roof.  Design: one thread per (b, x, c) and a strip of ROWS output rows;
// neighbouring threads take neighbouring channels so every load of a warp is
// one contiguous run of the NHWC row.  Input rows are streamed once per strip
// and each feeds up to four row accumulators in registers, so a strip of 8
// rows issues 11 * 4 loads instead of 8 * 16; the horizontal reuse (each
// input read by 4 neighbouring x) is left to L1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRows = 8;
constexpr int kThreads = 256;

struct Taps {
  float t[16];
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) fir4_epilogue_kernel(
    const Tin* __restrict__ x, Tout* __restrict__ out,
    const float* __restrict__ dcoefs, const float* __restrict__ noise,
    long long noise_bstride, const float* __restrict__ bias, Taps taps,
    int H, int W, int C, float alpha, float act_gain, float clamp) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= W * C) return;
  const int c = idx % C;
  const int ox = idx / C;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kRows;
  const int hp = H + 3;
  const size_t row_stride = (size_t)(W + 3) * C;
  const Tin* xp = x + ((size_t)b * hp + y0) * row_stride + (size_t)ox * C + c;

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;

#pragma unroll
  for (int r = 0; r < kRows + 3; ++r) {
    if (y0 + r < hp) {
      const Tin* rp = xp + (size_t)r * row_stride;
      const float v0 = load_f32(rp);
      const float v1 = load_f32(rp + C);
      const float v2 = load_f32(rp + 2 * C);
      const float v3 = load_f32(rp + 3 * C);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = r - i;  // output row that input row r reaches via tap row i
        if (y >= 0 && y < kRows) {
          acc[y] += taps.t[i * 4 + 0] * v0 + taps.t[i * 4 + 1] * v1 +
                    taps.t[i * 4 + 2] * v2 + taps.t[i * 4 + 3] * v3;
        }
      }
    }
  }

  const float d = dcoefs[(size_t)b * C + c];
  const float bc = bias[c];
#pragma unroll
  for (int y = 0; y < kRows; ++y) {
    const int oy = y0 + y;
    if (oy < H) {
      float v = acc[y] * d;
      if (noise != nullptr) v += noise[b * noise_bstride + (size_t)oy * W + ox];
      v += bc;
      v = (v >= 0.f ? v : alpha * v) * act_gain;
      // Comparisons (not fminf/fmaxf) keep NaN as NaN; clamp=+inf is a no-op.
      v = v < -clamp ? -clamp : (v > clamp ? clamp : v);
      store_f32(out + (((size_t)b * H + oy) * W + ox) * C + c, v);
    }
  }
}

template <typename Tin, typename Tout>
void launch(const void* x, void* out, const float* dcoefs, const float* noise,
            long long noise_bstride, const float* bias, const Taps& taps,
            int B, int H, int W, int C, float alpha, float act_gain,
            float clamp, cudaStream_t stream) {
  const dim3 grid((W * C + kThreads - 1) / kThreads, (H + kRows - 1) / kRows,
                  B);
  fir4_epilogue_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(out), dcoefs, noise,
      noise_bstride, bias, taps, H, W, C, alpha, act_gain, clamp);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Supported (in, out) pairs:
// (f32, f32) and (bf16, bf16).  `noise` may be null; its batch
// stride is 0 when one plane serves the whole batch.  `taps` is a host
// pointer to 16 floats, row-major [4][4].  Returns the CUDA error code of the
// launch (0 = success).
extern "C" int fir4_epilogue_launch(
    const void* x, void* out, const float* dcoefs, const float* noise,
    long long noise_bstride, const float* bias, const float* taps, int B,
    int H, int W, int C, int in_dtype, int out_dtype, float alpha,
    float act_gain, float clamp, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 ||
      (long long)W * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < 16; ++i) t.t[i] = taps[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) {
    launch<float, float>(x, out, dcoefs, noise, noise_bstride, bias, t, B, H,
                         W, C, alpha, act_gain, clamp, s);
  } else if (in_dtype == 1 && out_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, out, dcoefs, noise, noise_bstride,
                                         bias, t, B, H, W, C, alpha, act_gain,
                                         clamp, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fir4_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
