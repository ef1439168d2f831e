// The int8 convolution of the static int8 serving path, as an implicit GEMM
// on Hopper's int8 tensor cores (sm_90a), with the activation's
// quantization fused into its load and the dequantizing epilogue fused into
// its store.  ops/quant.py:quantized_conv runs every stride-1 dense conv of
// an int8 render through it.
//
// It replaces no Pallas kernel: the JAX package runs the same function as
// an XLA conv_general_dilated on int8 operands with an int32 accumulator
// (brushstroke_engine_tpu/ops/quant.py:170, quantized_conv).
//
// Per output element (b, y, x, o), with (Hp, Wp) the padded input:
//   xq[b, y, x, c] = clamp(rint(x[b, y - py0, x - px0, c] / s_x[b or 0]),
//                          -127, 127)        (0 outside the image: padding)
//   acc = sum_{ky<kh, kx<kw, c<I} xq[b, y+ky, x+kx, c] * wq[o, ky, kx, c]
//   out = (float)acc * (s_x[b or 0] * s_w[o])  (f32, then f32 or bf16)
// a stride-1, undilated, ungrouped correlation.  Two entries share the
// kernel: the int8 entry reads xq itself (already padded, py0 = px0 = 0);
// the quantizing entry reads the float activation x (f32 or bf16,
// unpadded; bf16 widens exactly) and quantizes it on its way to shared
// memory to the plain version's bits: the quotient x / s_x as an IEEE
// division rounds it (see quant_byte), rounding half to even, then the
// clamp.  The padding may be negative (a crop).  The weights come packed
// once per site (ops/int8_conv.py:pack_weight): [O8][kh * kw * I32] int8,
// the taps outer and the input channels inner, I padded to I32 (a multiple
// of 32) and O to O8 (a multiple of 8) with zeros.  The accumulator is
// exact (|acc| <= 127^2 * kh * kw * I < 2^31 for every layer of the
// engine), so the summation order does not matter and the kernel is
// bit-equal to its plain version.  `acc` (int32) and `out` are each
// written when not null.
//
// What bounds it.  At the flagship's largest sites ([16, 130, 130, 128] ->
// 128 and [16, 258, 258, 64] -> 64, 3x3) an int8 product does ~4.6 int8
// operations per byte moved at f32 output, far below the ~590 at which the
// H100's int8 tensor cores (1979 TOP/s) and not its memory (3.35 TB/s)
// would be the limit: the bound is bytes, most of them the f32 (or bf16)
// output and, on the quantizing entry, the float input.  What holds the
// kernel above that bound (measured on an H100 by removing one part at a
// time, [16, 130, 130, 128] -> 128): the products with their barriers
// (~0.07 ms), the loads (~0.055) and the epilogue's stores (~0.055) add up
// instead of overlapping, since a block runs them in turn and two to four
// blocks share an SM.  The SIMT __dp4a kernel this replaces ran at 23.5x
// the bound, its dot products the limit.
//
// Design.  M = a block's 8 x 16 output pixels of one image (each warp one
// row of 16, two warpgroups of 64), N = 128, 64, 32 or 8 output channels
// (8 for the O = 3 toRGB site), K = the taps x the input channels, walked
// as chunks of 32 channels (outer) feeding all kh * kw taps (inner): each
// chunk's (8 + kh - 1) x (16 + kw - 1) x 32-byte halo window is read from
// device memory once and reused by every tap.  The products are
// wgmma.mma_async.m64nNk32.s32.s8.s8 (IGMMA) with A from registers: each
// warp loads its 16 x 32 A fragment of a tap by ldmatrix, whose 32 lanes
// each name their own 16-byte row, so a tap's shifted window is just other
// row addresses; B, the tap's N x 32 weight tile, is read from shared
// memory by descriptor.  A shared-memory descriptor for A was not taken: it
// describes a tile by two fixed strides, which a tap's shifted window
// only fits with 8-pixel-wide tiles and no swizzle.  The window and the
// weight rows are stored 32 bytes a pixel (an output channel) with the two
// 16-byte halves swapped on every other group of four rows -- wgmma's
// 32-byte swizzle, under which the 8 rows of any ldmatrix phase fall in 8
// different bank groups.  (mma.sync.m16n8k32 on the same layout took 0.20
// ms at the largest site against 0.18 for wgmma; blocks that stay resident
// and walk many tiles with their weights kept, with or without a producer
// warpgroup, were slower still on an H100.)  Two stages: chunk c + 1's
// loads are in flight while chunk c's products run -- cp.async
// (zero-filled outside the image and past I or O) for the int8 window and
// the weights, and for the float window vector loads into registers,
// quantized and stored to shared memory after the products.
// Above 48 KB of dynamic shared memory the kernel is given the H100's
// 227 KB by cudaFuncSetAttribute.  The epilogue scales in the plain
// version's order without FMA and stores each thread's two adjacent
// channels (every 32-byte sector of f32 output written whole).
//
// Built for sm_90a with CUDA 12.8 (ptxas -v): 64-128 registers per
// variant, no static shared memory (two dynamic stages, 87,040 bytes at a
// 3x3 site with N = 128), spills of 4-84 bytes in 4 of the 12 variants;
// cuobjdump -sass finds 84 IGMMA and no IMMA or IDP.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTh = 8;              // output rows per block (one warp each)
constexpr int kTw = 16;             // output columns per block
constexpr int kCk = 32;             // input channels per chunk (one MMA k)
constexpr int kThreads = 256;       // 8 warps, 2 warpgroups of 4 rows each
constexpr int kStaged = 3;          // float-window units in registers / thread
constexpr int kMaxSmem = 232448;    // the H100's per-block maximum
constexpr int kAlign = 1024;        // stage alignment (the B tiles' swizzle)

enum { kInInt8 = 0, kInF32 = 1, kInBF16 = 2 };

struct Args {
  const void* x;      // int8 [B, H, W, I] padded, or f32 / bf16 unpadded
  const int8_t* w;    // packed [O8][kh * kw * Ip]
  const float* sx;    // [B] (sx_stride 1) or [1] (sx_stride 0)
  const float* sw;    // [O]
  int* acc;           // [B, Ho, Wo, O] or null
  void* out;          // [B, Ho, Wo, O] f32 / bf16 or null
  int H, W, I, Ip, O, O8, kh, kw, py0, px0, Ho, Wo, sx_stride, out_bf16;
  int tiles_x, vec, stage;
};

// Byte offset of half `h` (16 bytes) of 32-byte row `r`: the halves swap
// on every other group of 4 rows (the 32-byte swizzle of a wgmma operand),
// so 8 consecutive rows read by one ldmatrix phase hit 8 different 16-byte
// bank groups.
__device__ __forceinline__ int swz(int r, int h) {
  return r * 32 + ((h ^ ((r >> 2) & 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Make this thread's shared-memory writes (cp.async included) visible to
// the asynchronous proxy that wgmma reads its B operand through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
__device__ __forceinline__ void hold(int& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// The shared-memory descriptor of a B tile (N rows of 32 bytes, K-major,
// the 32-byte swizzle, 8-row groups 256 bytes apart) at `addr`, which is
// 256-byte aligned.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

// acc (64 x N, int32, 4 warps x 16 rows) += A (64 x 32, int8, registers:
// each warp its 16 rows in the m16n8k32 A-fragment layout) * B (32 x N,
// int8, shared memory by descriptor): wgmma.mma_async ... s32.s8.s8.
template <int N> struct Wgmma;

template <> struct Wgmma<8> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
  }
};

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
  }
};

// clamp(rint(v / s), -127, 127) as the plain version computes it, with
// v / s rounded to nearest as an IEEE division rounds it but from y =
// RN(1 / s), made once per block: q = RN(v y) is within an ulp of v / s,
// and one correction step with the exact residual v - s q (an FMA) makes it
// the correctly rounded quotient (Markstein's theorem) wherever v and the
// residual are normal numbers, which covers every |v / s| >= 0.5 at the
// scales a site has (s >= 1e-12); below that the quotient rounds to 0
// either way, and where |q| >= 128 the clamp decides.  Then half to even,
// then the clamp.  An IEEE division costs several times more, and the
// float entry quantizes every window pixel once per block.
// int8_conv_quant_check holds this against __fdiv_rn over every finite v.
__device__ __forceinline__ uint32_t quant_byte(float v, float s, float y) {
  float q = __fmul_rn(v, y);
  if (fabsf(q) < 128.f) q = __fmaf_rn(__fmaf_rn(-s, q, v), y, q);
  int n = __float2int_rn(q);
  n = max(-127, min(127, n));
  return static_cast<uint32_t>(n) & 0xffu;
}

// One float-window unit: 8 channels of one window pixel, as loaded.
template <int In> struct Unit;
template <> struct alignas(16) Unit<kInF32> { float v[8]; };
template <> struct alignas(16) Unit<kInBF16> { __nv_bfloat16 v[8]; };
template <> struct Unit<kInInt8> { int dummy; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Blocks resident per SM: the narrower the N tile, the fewer accumulators
// a thread holds and the more blocks can hide each other's loads (the
// toRGB site, N = 8, is bound by its loads' latency).
template <int BN>
constexpr int min_blocks() { return BN <= 8 ? 4 : BN <= 64 ? 3 : 2; }

template <int In, int BN>
__global__ void __launch_bounds__(kThreads, min_blocks<BN>())
int8_conv_kernel(const Args a) {
  constexpr int kNt = BN / 8;         // n8 column groups of a warp's rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Stages at kAlign: [B tiles: taps x BN rows x 32 B][window: win x 32 B].
  const uint32_t mis = smem_addr(smem_raw) & (kAlign - 1);
  unsigned char* smem = smem_raw + ((kAlign - mis) & (kAlign - 1));
  const int win_w = kTw + a.kw - 1, win_h = kTh + a.kh - 1;
  const int win = win_w * win_h;
  const int taps = a.kh * a.kw;
  const int wtile = taps * BN * kCk;                  // B tiles of a stage
  const int stage = a.stage;
  const uint32_t s0 = smem_addr(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile_x = blockIdx.x % a.tiles_x, tile_y = blockIdx.x / a.tiles_x;
  const int x0 = tile_x * kTw, y0 = tile_y * kTh;
  const int o0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const float s_x = (In != kInInt8 || a.out) ? a.sx[b * a.sx_stride] : 1.f;
  const float y_x = __frcp_rn(s_x);          // RN(1 / s_x), IEEE
  const int chunks = a.Ip / kCk;
  const long long ktot = (long long)taps * a.Ip;

  // The window pixel p's source (y, x) in x, or false outside the image.
  auto source = [&](int p, int& gy, int& gx) {
    gy = y0 + p / win_w - a.py0;
    gx = x0 + p % win_w - a.px0;
    return gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
  };

  // The chunk's weights: BN rows x taps, 32 bytes each, by cp.async.
  auto load_weights = [&](int c, int buf) {
    const uint32_t ws = s0 + buf * stage;
    for (int u = tid; u < taps * BN * 2; u += kThreads) {
      const int h = u & 1, n = (u >> 1) % BN, t = (u >> 1) / BN;
      const bool ok = o0 + n < a.O8;
      const int8_t* src = a.w + (ok ? (long long)(o0 + n) * ktot
                                          + (long long)t * a.Ip + c * kCk
                                          + h * 16 : 0);
      cp16(ws + t * BN * kCk + swz(n, h), src, ok);
    }
  };

  // The int8 window of chunk c: 16 bytes per cp.async where the rows are
  // 16-byte aligned, else byte by byte.
  auto load_window_int8 = [&](int c, int buf) {
    const int8_t* x = static_cast<const int8_t*>(a.x);
    if (a.vec) {
      const uint32_t xs = s0 + buf * stage + wtile;
      for (int u = tid; u < win * 2; u += kThreads) {
        const int p = u >> 1, h = u & 1, ch = c * kCk + h * 16;
        int gy, gx;
        const bool ok = source(p, gy, gx) && ch < a.I;
        const int8_t* src = x + (ok ? ((long long)(b * a.H + gy) * a.W + gx)
                                      * a.I + ch : 0);
        cp16(xs + swz(p, h), src, ok);
      }
    } else {
      unsigned char* xsp = smem + buf * stage + wtile;
      for (int u = tid; u < win * 8; u += kThreads) {
        const int p = u >> 3, q = u & 7, ch = c * kCk + q * 4;
        int gy, gx;
        uint32_t word = 0;
        if (source(p, gy, gx)) {
          const int8_t* src = x + ((long long)(b * a.H + gy) * a.W + gx)
                              * a.I;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (ch + j < a.I)
              word |= (static_cast<uint32_t>(src[ch + j]) & 0xffu) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(xsp + swz(p, q >> 2) + (q & 3) * 4) =
            word;
      }
    }
  };

  // The float window, unit u = (pixel u / 4, channels 8 (u % 4) .. + 8).
  using Elem = typename std::conditional<In == kInBF16, __nv_bfloat16,
                                         float>::type;
  auto load_unit = [&](Unit<In>& r, int c, int u) {
    if constexpr (In != kInInt8) {
      const int p = u >> 2, ch = c * kCk + (u & 3) * 8;
      int gy, gx;
      const bool ok = source(p, gy, gx) && ch < a.I;
      const Elem* src = static_cast<const Elem*>(a.x)
          + (ok ? ((long long)(b * a.H + gy) * a.W + gx) * a.I + ch : 0);
      if (ok && a.vec && ch + 8 <= a.I) {
        if constexpr (In == kInF32) {
          const float4 v0 = __ldg(reinterpret_cast<const float4*>(src));
          const float4 v1 = __ldg(reinterpret_cast<const float4*>(src) + 1);
          r.v[0] = v0.x; r.v[1] = v0.y; r.v[2] = v0.z; r.v[3] = v0.w;
          r.v[4] = v1.x; r.v[5] = v1.y; r.v[6] = v1.z; r.v[7] = v1.w;
        } else {
          *reinterpret_cast<uint4*>(r.v) =
              __ldg(reinterpret_cast<const uint4*>(src));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          r.v[j] = (ok && ch + j < a.I) ? src[j] : Elem(0.f);
      }
    }
  };
  auto store_unit = [&](const Unit<In>& r, int buf, int u) {
    if constexpr (In != kInInt8) {
      const int p = u >> 2, g = u & 3;
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo |= quant_byte(widen(r.v[j]), s_x, y_x) << (8 * j);
        hi |= quant_byte(widen(r.v[j + 4]), s_x, y_x) << (8 * j);
      }
      *reinterpret_cast<uint2*>(smem + buf * stage + wtile + swz(p, g >> 1)
                                + (g & 1) * 8) = make_uint2(lo, hi);
    }
  };

  Unit<In> staged[kStaged];
  auto load_float = [&](int c) {
#pragma unroll
    for (int k = 0; k < kStaged; ++k)
      if (tid + k * kThreads < win * 4)
        load_unit(staged[k], c, tid + k * kThreads);
  };
  auto store_float = [&](int c, int buf) {
#pragma unroll
    for (int k = 0; k < kStaged; ++k)
      if (tid + k * kThreads < win * 4)
        store_unit(staged[k], buf, tid + k * kThreads);
    // Units past the staged ones (windows above 192 pixels) go directly.
    for (int u = tid + kStaged * kThreads; u < win * 4; u += kThreads) {
      Unit<In> r;
      load_unit(r, c, u);
      store_unit(r, buf, u);
    }
  };

  int acc[kNt * 4];
#pragma unroll
  for (int i = 0; i < kNt * 4; ++i) acc[i] = 0;

  // Prologue: chunk 0 into stage 0.
  if constexpr (In == kInInt8) {
    load_window_int8(0, 0);
  } else {
    load_float(0);
    store_float(0, 0);
  }
  load_weights(0, 0);
  cp_commit();

  // The lane's ldmatrix row of the A fragment: pixel r_a of the warp's
  // output row, half h_a of the 32 channels.
  const int r_a = (lane & 7) + ((lane >> 3) & 1) * 8, h_a = lane >> 4;

  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    const bool next = c + 1 < chunks;
    if constexpr (In != kInInt8) {
      if (next) load_float(c + 1);        // in flight during the products
    }
    cp_wait_all();
    fence_async_smem();
    __syncthreads();                      // stage `buf` complete; the other
                                          // stage's readers are done
    if (next) {
      if constexpr (In == kInInt8) load_window_int8(c + 1, buf ^ 1);
      load_weights(c + 1, buf ^ 1);
      cp_commit();
    }

    // The taps: A by ldmatrix from the window shifted by (ky, kx), B the
    // tap's weight tile; tap t's A loads while tap t - 1's product runs.
    const uint32_t ws = s0 + buf * stage;
    const uint32_t xs = ws + wtile;
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < kNt * 4; ++i) hold(acc[i]);
    for (int t = 0; t < taps; ++t) {
      const int ky = t / a.kw, kx = t - ky * a.kw;
      uint32_t* A = af[t & 1];
      ldsm_x4(xs + swz((warp + ky) * win_w + r_a + kx, h_a), A);
      wg_fence();
      Wgmma<BN>::run(acc, A, b_desc(ws + t * BN * kCk));
      wg_commit();
      wg_wait<1>();                       // tap t - 1 done: its A is free
    }
    wg_wait<0>();                         // before the stage is refilled
#pragma unroll
    for (int i = 0; i < kNt * 4; ++i) hold(acc[i]);

    if constexpr (In != kInInt8) {
      if (next) store_float(c + 1, buf ^ 1);   // quantized on the way in
    }
  }

  // Epilogue: thread (g, tig) of warp w holds output row w, columns g and
  // g + 8, at channels 2 tig, 2 tig + 1 of each n8 group.
  const int g = lane >> 2, tig = lane & 3;
  const int oy = y0 + warp;
  if (oy >= a.Ho) return;
  const bool pair = (a.O & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    const int n = o0 + nt * 8 + 2 * tig;
    if (n >= a.O) continue;
    const bool two = n + 1 < a.O;
    const float sc0 = a.out ? __fmul_rn(s_x, a.sw[n]) : 0.f;
    const float sc1 = (a.out && two) ? __fmul_rn(s_x, a.sw[n + 1]) : 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int ox = x0 + g + hf * 8;
      if (ox >= a.Wo) continue;
      const long long e = (((long long)b * a.Ho + oy) * a.Wo + ox) * a.O + n;
      const int v0 = acc[nt * 4 + 2 * hf], v1 = acc[nt * 4 + 2 * hf + 1];
      if (a.acc) {
        if (two && pair) {
          *reinterpret_cast<int2*>(a.acc + e) = make_int2(v0, v1);
        } else {
          a.acc[e] = v0;
          if (two) a.acc[e + 1] = v1;
        }
      }
      if (a.out) {
        // (float)acc * (s_x * s_w): the plain version's order, no FMA.
        const float f0 = __fmul_rn(__int2float_rn(v0), sc0);
        const float f1 = __fmul_rn(__int2float_rn(v1), sc1);
        if (a.out_bf16) {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) + e;
          if (two && pair) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(f0, f1);
          } else {
            o[0] = __float2bfloat16_rn(f0);
            if (two) o[1] = __float2bfloat16_rn(f1);
          }
        } else {
          float* o = static_cast<float*>(a.out) + e;
          if (two && pair) {
            *reinterpret_cast<float2*>(o) = make_float2(f0, f1);
          } else {
            o[0] = f0;
            if (two) o[1] = f1;
          }
        }
      }
    }
  }
}

int stage_bytes(int bn, int kh, int kw) {
  const int bytes = kh * kw * bn * kCk + (kTh + kh - 1) * (kTw + kw - 1) * kCk;
  return (bytes + kAlign - 1) / kAlign * kAlign;
}

int pick_bn(int O) { return O <= 8 ? 8 : O <= 32 ? 32 : O <= 64 ? 64 : 128; }

template <int In, int BN>
int launch(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  auto kernel = int8_conv_kernel<In, BN>;
  if (smem > 48 * 1024) {
    // Once per device: the attribute is the H100's maximum, and each
    // launch asks for its own size below it.
    static bool done[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!done[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return (int)e;
      done[dev] = true;
    }
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int In>
int launch_in(int bn, const Args& a, dim3 grid, int smem, cudaStream_t s) {
  switch (bn) {
    case 8: return launch<In, 8>(a, grid, smem, s);
    case 32: return launch<In, 32>(a, grid, smem, s);
    case 64: return launch<In, 64>(a, grid, smem, s);
    default: return launch<In, 128>(a, grid, smem, s);
  }
}

}  // namespace

// x: int8 [B, H, W, I] (in_kind 0; padding must be 0) or f32 (1) / bf16
// (2) [B, H, W, I]; w: packed int8 [ceil8(O)][kh * kw * ceil32(I)]; the
// output [B, H + py0 + py1 - kh + 1, W + px0 + px1 - kw + 1, O].
extern "C" int int8_conv_launch(
    const void* x, int in_kind, const void* w, int B, int H, int W, int I,
    int O, int kh, int kw, int py0, int py1, int px0, int px1,
    const float* sx, int sx_stride, const float* sw, void* acc, void* out,
    int out_bf16, void* stream) {
  Args a;
  a.H = H; a.W = W; a.I = I; a.O = O; a.kh = kh; a.kw = kw;
  a.Ip = (I + kCk - 1) / kCk * kCk;
  a.O8 = (O + 7) / 8 * 8;
  a.py0 = py0; a.px0 = px0;
  a.Ho = H + py0 + py1 - kh + 1;
  a.Wo = W + px0 + px1 - kw + 1;
  if (B <= 0 || B > 65535 || kh <= 0 || kw <= 0 || I <= 0 || O <= 0
      || a.Ho <= 0 || a.Wo <= 0 || in_kind < 0 || in_kind > 2
      || (in_kind == kInInt8 && (py0 || py1 || px0 || px1))
      || (in_kind != kInInt8 && !sx) || (out && (!sx || !sw))
      || (!acc && !out) || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const int bn = pick_bn(O);
  a.stage = stage_bytes(bn, kh, kw);
  const int smem = 2 * a.stage + kAlign;        // two stages, aligned
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
  a.sx = sx; a.sw = sw;
  a.acc = static_cast<int*>(acc);
  a.out = out;
  a.sx_stride = sx_stride; a.out_bf16 = out_bf16;
  a.tiles_x = (a.Wo + kTw - 1) / kTw;
  const long long tiles = (long long)a.tiles_x * ((a.Ho + kTh - 1) / kTh);
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  // Vector loads where every pixel row starts on a 16-byte boundary.
  const int per16 = in_kind == kInInt8 ? 16 : (in_kind == kInF32 ? 4 : 8);
  a.vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && I % per16 == 0;
  dim3 grid((unsigned)tiles, (O + bn - 1) / bn, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_kind) {
    case kInInt8: return launch_in<kInInt8>(bn, a, grid, smem, s);
    case kInF32: return launch_in<kInF32>(bn, a, grid, smem, s);
    default: return launch_in<kInBF16>(bn, a, grid, smem, s);
  }
}

namespace {

// For each scale s[i]: every finite float v quantized by quant_byte and by
// an IEEE division; the number of v whose int8 value differs goes to
// mismatches[i] (device memory).  A check of the kernel's arithmetic.
__global__ void quant_check_kernel(const float* s, int n,
                                   unsigned long long* mismatches) {
  for (int i = 0; i < n; ++i) {
    const float si = s[i], yi = __frcp_rn(si);
    unsigned long long bad = 0;
    for (unsigned long long u = blockIdx.x * (unsigned long long)blockDim.x
                                + threadIdx.x;
         u < (1ull << 32); u += (unsigned long long)gridDim.x * blockDim.x) {
      const float v = __uint_as_float(static_cast<uint32_t>(u));
      if (!isfinite(v)) continue;
      const int want = max(-127, min(127, __float2int_rn(__fdiv_rn(v, si))));
      bad += (quant_byte(v, si, yi) & 0xffu)
             != (static_cast<uint32_t>(want) & 0xffu);
    }
    if (bad) atomicAdd(mismatches + i, bad);
  }
}

}  // namespace

extern "C" int int8_conv_quant_check(const float* s, int n,
                                     unsigned long long* mismatches,
                                     void* stream) {
  if (n <= 0 || !s || !mismatches) return (int)cudaErrorInvalidValue;
  quant_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      s, n, mismatches);
  return (int)cudaGetLastError();
}

extern "C" const char* int8_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
