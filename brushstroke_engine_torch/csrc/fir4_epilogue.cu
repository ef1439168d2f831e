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
// roof.  What held the first version (one thread per (b, x, c), 44 scalar
// loads for 8 outputs) at twice that bound was not the bytes but the loads:
// three of every four hit L1, so a thread kept only a few new bytes in
// flight, and the bf16 instantiation moved half the bytes in the same time.
//
// Design.  A thread owns kVec adjacent channels (16 bytes: 4 in f32, 8 in
// bf16), kXw adjacent output columns and a strip of output rows, and walks
// down the strip.  Per input row it makes kXw + 3 loads of 16 bytes -- the
// window of input columns that its kXw outputs share -- so each input
// element is fetched once per thread walk, and it fetches the next row's
// window before it accumulates this one's, so a whole window of loads is
// always outstanding.  A row is added into the (at most four) output rows
// it reaches; the accumulators rotate through four register slots, so the
// strip's height costs no registers and is a launch parameter.  An output
// row is finished, run through the epilogue and stored (16 bytes per
// column) three input rows after it began.  The noise value is loaded once
// per pixel for all of a thread's channels; dcoefs and bias are vector
// loads.  kXw and the strip height are picked per shape (`dispatch`): tall
// strips read the fewest rows twice, small launches (8-32 px at B = 1) get
// short strips and one-warp blocks so that they spread over the SMs.  A C
// that is not a multiple of the vector, or a pointer that is not 16-byte
// aligned, takes the kVec = 1 instantiation of the same body.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py): 1.31x the byte bound at
// [16,256,256,64] f32 (0.213 ms; the first version 0.340), 1.75-1.96x in
// bf16 (0.144-0.161 ms; 0.321), 1.29x at the trainer's [64,128,128,128] f32
// (0.424 ms; 0.668).  bf16 stays further from its bound because its 16
// FMAs, unpacking and epilogue per output already fill most instruction
// slots at that rate.
// Every shape: PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Taps {
  float t[16];
};

struct Epilogue {
  float alpha, act_gain, clamp;
};

// kVec channels of one pixel: fetched as one Raw value (16 bytes on the
// vector paths), unpacked to kVec floats where it is used, stored packed.
template <typename T, int kVec>
struct Pixel;

template <>
struct Pixel<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw fetch(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ Raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pixel<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw fetch(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // A bf16 is the upper half of its f32.
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Pixel<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw fetch(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ Raw zero() { return 0.f; }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    v[0] = q;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

template <>
struct Pixel<__nv_bfloat16, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw fetch(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ Raw zero() { return 0.f; }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    v[0] = q;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// kVec f32 values of dcoefs / bias (16-byte aligned when kVec > 1).
template <int kVec>
__device__ __forceinline__ void load_floats(const float* p, float* v) {
  if (kVec == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  }
}

// One input row's window: kXw + 3 pixels from column ox0 on, zero beyond
// the row's end.
template <typename T, int kVec, int kXw>
__device__ __forceinline__ void fetch_row(
    const T* xp, int C, int ox0, int wp,
    typename Pixel<T, kVec>::Raw (&row)[kXw + 3]) {
#pragma unroll
  for (int j = 0; j < kXw + 3; ++j)
    row[j] = ox0 + j < wp ? Pixel<T, kVec>::fetch(xp + (size_t)j * C)
                          : Pixel<T, kVec>::zero();
}

template <typename T, int kVec, int kXw>
__global__ void __launch_bounds__(kThreads) fir4_epilogue_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const float* __restrict__ dcoefs, const float* __restrict__ noise,
    long long noise_bstride, const float* __restrict__ bias, Taps taps,
    int H, int W, int C, int strip, Epilogue ep) {
  using Px = Pixel<T, kVec>;
  const int cvecs = C / kVec;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int xgroups = (W + kXw - 1) / kXw;
  if (idx >= xgroups * cvecs) return;
  const int c0 = (idx % cvecs) * kVec;
  const int ox0 = (idx / cvecs) * kXw;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * strip;
  const int y1 = min(y0 + strip, H);
  const int rows_end = y1 + 3;               // input rows y0 .. y1 + 2
  const int wp = W + 3;
  const size_t row_stride = (size_t)wp * C;
  // xp: the next input row to fetch.
  const T* xp = x + ((size_t)b * (H + 3) + y0) * row_stride +
                (size_t)ox0 * C + c0;
  T* op = out + (((size_t)b * H + y0) * W + ox0) * C + c0;
  const float* np = noise == nullptr
      ? nullptr : noise + b * noise_bstride + (size_t)y0 * W + ox0;

  // One row in flight: input row y0 + k waits in ring[k & 1] (packed, as
  // fetched) while the row before it is accumulated, so a thread always has
  // a whole window of loads outstanding.
  typename Px::Raw ring[2][kXw + 3];
  fetch_row<T, kVec, kXw>(xp, C, ox0, wp, ring[0]);
  xp += row_stride;

  float d[kVec], bc[kVec];
  load_floats<kVec>(dcoefs + (size_t)b * C + c0, d);
  load_floats<kVec>(bias + c0, bc);

  // acc[slot][column][channel]: output row y lives in slot (y - y0) & 3.
  float acc[4][kXw][kVec];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < kXw; ++j)
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[s][j][v] = 0.f;

  // Four input rows per trip, so that every slot index is a compile-time
  // constant.
  for (int r0 = y0; r0 < rows_end; r0 += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int ir = r0 + u;
      if (ir < rows_end) {
        if (ir + 1 < rows_end) {
          fetch_row<T, kVec, kXw>(xp, C, ox0, wp, ring[(u + 1) & 1]);
          xp += row_stride;
        }
        // The noise of the output row this input row completes, asked for
        // before the row's arithmetic (read under the same condition).
        float nz[kXw];
        if (ir - 3 >= y0) {
#pragma unroll
          for (int j = 0; j < kXw; ++j)
            nz[j] = (np != nullptr && ox0 + j < W) ? __ldg(np + j) : 0.f;
        }
        float win[kXw + 3][kVec];
#pragma unroll
        for (int j = 0; j < kXw + 3; ++j)
          Px::unpack(ring[u & 1][j], win[j]);
        // Input row ir is tap row i of output row ir - i.  Rows before y0
        // or from y1 on collect sums too; they are never stored.
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = (u - i) & 3;
#pragma unroll
          for (int j = 0; j < kXw; ++j)
#pragma unroll
            for (int v = 0; v < kVec; ++v)
              acc[s][j][v] += taps.t[i * 4 + 0] * win[j][v] +
                              taps.t[i * 4 + 1] * win[j + 1][v] +
                              taps.t[i * 4 + 2] * win[j + 2][v] +
                              taps.t[i * 4 + 3] * win[j + 3][v];
        }
        // Output row ir - 3 is complete (slot (u + 1) & 3).
        const int s = (u + 1) & 3;
        if (ir - 3 >= y0) {
#pragma unroll
          for (int j = 0; j < kXw; ++j) {
            if (ox0 + j < W) {
              float o[kVec];
#pragma unroll
              for (int v = 0; v < kVec; ++v) {
                float val = acc[s][j][v] * d[v];
                if (np != nullptr) val += nz[j];
                val += bc[v];
                val = (val >= 0.f ? val : ep.alpha * val) * ep.act_gain;
                // Comparisons (not fminf/fmaxf) keep NaN as NaN;
                // clamp = +inf is a no-op.
                o[v] = val < -ep.clamp ? -ep.clamp
                                       : (val > ep.clamp ? ep.clamp : val);
              }
              Px::store(op + (size_t)j * C, o);
            }
          }
          op += (size_t)W * C;
          if (np != nullptr) np += W;
        }
#pragma unroll
        for (int j = 0; j < kXw; ++j)
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc[s][j][v] = 0.f;
      }
    }
  }
}

struct Args {
  const void* x;
  void* out;
  const float* dcoefs;
  const float* noise;
  long long noise_bstride;
  const float* bias;
  Taps taps;
  int B, H, W, C;
  Epilogue ep;
  cudaStream_t stream;
};

template <typename T, int kVec, int kXw>
void launch(const Args& a, int strip, int threads) {
  const int threads_x = ((a.W + kXw - 1) / kXw) * (a.C / kVec);
  const dim3 grid((threads_x + threads - 1) / threads,
                  (a.H + strip - 1) / strip, a.B);
  fir4_epilogue_kernel<T, kVec, kXw><<<grid, threads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.out), a.dcoefs, a.noise,
      a.noise_bstride, a.bias, a.taps, a.H, a.W, a.C, strip, a.ep);
}

// Thread blocks a launch has with `xw` columns per thread, `strip` rows per
// strip and `threads` per block.
long long blocks_of(const Args& a, int vec, int xw, int strip, int threads) {
  const long long tx = (long long)((a.W + xw - 1) / xw) * (a.C / vec);
  return ((tx + threads - 1) / threads) * ((a.H + strip - 1) / strip) * a.B;
}

// Columns per thread, rows per strip and threads per block for this shape,
// from the sweep of tools/tune_kernels.py on an H100: two columns per
// thread in f32 and one in bf16 (whose eight channels fill the registers),
// and the tallest strip -- the fewest rows read twice -- that still leaves
// about four blocks per SM.  Launches too small for that (8-32 px at B = 1)
// fall to one column, one row and one-warp blocks, so that they spread over
// the SMs.  `xw` / `strip` > 0 override the choice (for tuning runs).
template <typename T, int kVec>
int dispatch(const Args& a, int xw, int strip) {
  constexpr int kSms = 132;
  constexpr int kWantBlocks = 512;
  if (xw <= 0)
    xw = (kVec == 8 || blocks_of(a, kVec, 2, 1, kThreads) < kSms) ? 1 : 2;
  if (strip <= 0) {
    strip = 1;
    for (int cand = 256; cand > 1; cand /= 2)
      if (cand < 2 * a.H &&
          blocks_of(a, kVec, xw, cand, kThreads) >= kWantBlocks) {
        strip = cand;
        break;
      }
  }
  const int threads =
      blocks_of(a, kVec, xw, strip, kThreads) >= 2 * kSms ? kThreads : 32;
  if (blocks_of(a, kVec, xw, strip, threads) > 0x7fffffffLL ||
      (a.H + strip - 1) / strip > 65535)
    return (int)cudaErrorInvalidValue;
  if (xw == 1) launch<T, kVec, 1>(a, strip, threads);
  else if (xw == 2) launch<T, kVec, 2>(a, strip, threads);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Supported (in, out) pairs:
// (f32, f32) and (bf16, bf16).  `noise` may be null; its batch
// stride is 0 when one plane serves the whole batch.  `taps` is a host
// pointer to 16 floats, row-major [4][4].  `xw` (columns per thread: 1 or
// 2) and `strip` (output rows per thread) are chosen per shape when 0.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int fir4_epilogue_launch(
    const void* x, void* out, const float* dcoefs, const float* noise,
    long long noise_bstride, const float* bias, const float* taps, int B,
    int H, int W, int C, int in_dtype, int out_dtype, float alpha,
    float act_gain, float clamp, int xw, int strip, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 ||
      (long long)W * C > 0x7fffffffLL || in_dtype != out_dtype)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.out = out; a.dcoefs = dcoefs; a.noise = noise;
  a.noise_bstride = noise_bstride; a.bias = bias;
  for (int i = 0; i < 16; ++i) a.taps.t[i] = taps[i];
  a.B = B; a.H = H; a.W = W; a.C = C;
  a.ep.alpha = alpha; a.ep.act_gain = act_gain; a.ep.clamp = clamp;
  a.stream = static_cast<cudaStream_t>(stream);
  const bool ptrs_ok = aligned16(x) && aligned16(out) && aligned16(dcoefs) &&
                       aligned16(bias);
  if (in_dtype == 0) {
    if (ptrs_ok && C % 4 == 0) return dispatch<float, 4>(a, xw, strip);
    return dispatch<float, 1>(a, xw, strip);
  }
  if (in_dtype == 1) {
    if (ptrs_ok && C % 8 == 0) return dispatch<__nv_bfloat16, 8>(a, xw, strip);
    return dispatch<__nv_bfloat16, 1>(a, xw, strip);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fir4_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
