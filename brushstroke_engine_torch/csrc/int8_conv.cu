// Direct int8 convolution with an int32 accumulator and a fused dequantizing
// epilogue, for Hopper (sm_90a).  The static int8 serving path
// (ops/quant.py:quantized_conv) runs every stride-1 dense conv through it.
//
// It has no Pallas counterpart: the JAX package runs the same function as
// an XLA conv_general_dilated on int8 operands with an int32 accumulator
// (brushstroke_engine_tpu/ops/quant.py:170, quantized_conv).
//
// Per output element (b, y, x, o):
//   acc = sum_{ky<kh, kx<kw, c<I} xq[b, y+ky, x+kx, c] * wq[o, ky, kx, c]
//   out = (float)acc * (s_x[b or 0] * s_w[o])      (in f32, then the output
//                                                   dtype, f32 or bf16)
// a VALID, stride-1, undilated, ungrouped correlation of NHWC int8
// activations (already padded) with int8 weights in [O, kh, kw, I] order.
// Both operands come with I padded to I4, a multiple of 4, with zeros
// (exact).  The accumulator is exact: |acc| <= 127^2 * kh * kw * I, below
// 2^31 for every layer of the engine.  `acc` (int32) and `out` are each
// written when their pointer is not null.
//
// Design (simple and correct first; IMMA mma.sync.m16n8k32.s8 or wgmma s8
// is the redesign).  A block owns a tile of kTh x kTw output pixels of one
// image and kOt output channels; a thread owns one pixel and kOt int32
// accumulators.  The input channels go in chunks of kCk bytes: the block
// stages the chunk's (kTh + kh - 1) x (kTw + kw - 1) input window and its
// kOt x kh x kw weight slices in shared memory, the window laid out channel
// word major so that the 32 threads of a warp read 32 adjacent words, the
// weights tap and channel word major with the kOt outputs innermost, so
// that every thread reads the same 16 bytes (a broadcast) for four
// __dp4a (int8 x 4 dot product, int32 accumulate) per activation word.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTw = 16;          // output columns per block
constexpr int kTh = 8;           // output rows per block
constexpr int kOt = 16;          // output channels per block (per thread)
constexpr int kCk = 32;          // input channels per staged chunk (bytes)
constexpr int kCw = kCk / 4;     // ... in 32-bit words
constexpr int kThreads = kTw * kTh;

struct Args {
  const int* x;       // [B, Hp, Wp, I4 / 4] words
  const int* w;       // [O, kh, kw, I4 / 4] words
  const float* sx;    // [B] (sx_stride 1) or [1] (sx_stride 0)
  const float* sw;    // [O]
  int* acc;           // [B, Ho, Wo, O] or null
  void* out;          // [B, Ho, Wo, O] f32 / bf16 or null
  int B, Hp, Wp, I4w, O, kh, kw, Ho, Wo, sx_stride, out_bf16, tiles_x;
};

__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const Args a) {
  extern __shared__ __align__(16) int smem[];
  const int win_w = kTw + a.kw - 1, win_h = kTh + a.kh - 1;
  const int win = win_w * win_h;                   // pixels of the window
  const int taps = a.kh * a.kw;
  int* ws = smem;                                  // [taps][kCw][kOt]
  int* xs = smem + taps * kCw * kOt;               // [kCw][win]

  const int tid = threadIdx.x;
  const int tx = tid % kTw, ty = tid / kTw;
  const int tile_x = blockIdx.x % a.tiles_x, tile_y = blockIdx.x / a.tiles_x;
  const int x0 = tile_x * kTw, y0 = tile_y * kTh;
  const int o0 = blockIdx.y * kOt;
  const int b = blockIdx.z;

  int acc[kOt];
#pragma unroll
  for (int i = 0; i < kOt; ++i) acc[i] = 0;

  const long long img = (long long)b * a.Hp * a.Wp;
  for (int c0 = 0; c0 < a.I4w; c0 += kCw) {
    __syncthreads();
    // The input window of this chunk; zero outside the image and past I4.
    for (int i = tid; i < win * kCw; i += kThreads) {
      const int c = i % kCw, p = i / kCw;
      const int gy = y0 + p / win_w, gx = x0 + p % win_w;
      int v = 0;
      if (gy < a.Hp && gx < a.Wp && c0 + c < a.I4w)
        v = a.x[(img + (long long)gy * a.Wp + gx) * a.I4w + c0 + c];
      xs[c * win + p] = v;
    }
    // The weights of this chunk for the block's kOt outputs.
    for (int i = tid; i < taps * kCw * kOt; i += kThreads) {
      const int o = i % kOt, c = (i / kOt) % kCw, t = i / (kOt * kCw);
      int v = 0;
      if (o0 + o < a.O && c0 + c < a.I4w)
        v = a.w[((long long)(o0 + o) * taps + t) * a.I4w + c0 + c];
      ws[i] = v;
    }
    __syncthreads();
    for (int t = 0; t < taps; ++t) {
      const int ky = t / a.kw, kx = t - ky * a.kw;
      const int* xp = xs + (ty + ky) * win_w + tx + kx;
      const int4* wp = reinterpret_cast<const int4*>(ws + t * kCw * kOt);
#pragma unroll
      for (int c = 0; c < kCw; ++c) {
        const int xv = xp[c * win];
#pragma unroll
        for (int q = 0; q < kOt / 4; ++q) {
          const int4 w4 = wp[c * (kOt / 4) + q];
          acc[4 * q + 0] = __dp4a(xv, w4.x, acc[4 * q + 0]);
          acc[4 * q + 1] = __dp4a(xv, w4.y, acc[4 * q + 1]);
          acc[4 * q + 2] = __dp4a(xv, w4.z, acc[4 * q + 2]);
          acc[4 * q + 3] = __dp4a(xv, w4.w, acc[4 * q + 3]);
        }
      }
    }
  }

  const int oy = y0 + ty, ox = x0 + tx;
  if (oy >= a.Ho || ox >= a.Wo) return;
  const long long base = (((long long)b * a.Ho + oy) * a.Wo + ox) * a.O;
  const float sx = a.out ? a.sx[b * a.sx_stride] : 0.f;
#pragma unroll
  for (int i = 0; i < kOt; ++i) {
    const int o = o0 + i;
    if (o >= a.O) break;
    if (a.acc) a.acc[base + o] = acc[i];
    if (a.out) {
      // (float)acc * (s_x * s_w): the plain version's order, no FMA.
      const float v = __fmul_rn(__int2float_rn(acc[i]), __fmul_rn(sx, a.sw[o]));
      if (a.out_bf16)
        static_cast<__nv_bfloat16*>(a.out)[base + o] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(a.out)[base + o] = v;
    }
  }
}

}  // namespace

// Shared memory one block needs for a kh x kw kernel (bytes).
extern "C" int int8_conv_smem_bytes(int kh, int kw) {
  return (kh * kw * kCw * kOt + kCw * (kTw + kw - 1) * (kTh + kh - 1)) * 4;
}

extern "C" int int8_conv_launch(
    const void* x, const void* w, int B, int Hp, int Wp, int I4, int O,
    int kh, int kw, const float* sx, int sx_stride, const float* sw,
    void* acc, void* out, int out_bf16, void* stream) {
  if (B <= 0 || B > 65535 || kh <= 0 || kw <= 0 || Hp < kh || Wp < kw ||
      I4 <= 0 || I4 % 4 || O <= 0 || (!acc && !out))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const int*>(x);
  a.w = static_cast<const int*>(w);
  a.sx = sx; a.sw = sw;
  a.acc = static_cast<int*>(acc);
  a.out = out;
  a.B = B; a.Hp = Hp; a.Wp = Wp; a.I4w = I4 / 4; a.O = O;
  a.kh = kh; a.kw = kw; a.Ho = Hp - kh + 1; a.Wo = Wp - kw + 1;
  a.sx_stride = sx_stride; a.out_bf16 = out_bf16;
  a.tiles_x = (a.Wo + kTw - 1) / kTw;
  const int tiles_y = (a.Ho + kTh - 1) / kTh;
  const int smem = int8_conv_smem_bytes(kh, kw);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid(a.tiles_x * tiles_y, (O + kOt - 1) / kOt, B);
  int8_conv_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* int8_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
