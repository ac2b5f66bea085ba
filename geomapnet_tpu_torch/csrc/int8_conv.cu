// int8 x int8 -> int32 implicit-GEMM convolution with a float32 epilogue,
// for sm_90a.
//
// Replaces the XLA lowering of geomapnet_tpu/models/quant.py::_conv_acc
// (lax.conv_general_dilated with preferred_element_type=int32) chained with
// _deq and _q8, as _fused_basic_block (quant.py:370-395) and the stem of
// _trunk_forward_fused (quant.py:413-428) chain them, and the int8 branch of
// the unfused _conv_site (quant.py:215-229). PyTorch has no int8
// convolution on CUDA.
//
// GEMM view: rows are output pixels (M = N*OH*OW), columns are output
// channels (O), depth is K = KH*KW*C in (kh, kw, c) order. The activation is
// NHWC int8; the weight is packed by the wrapper to (O, Kpad) int8, K padded
// with zeros to a multiple of 64.
//
// Bound: tensor-core operations. A 60-frame ResNet-34 window is ~788 GOP
// against ~0.2 GB of activations and weights, far above the card's
// operations-per-byte balance. Design (simple, correct first): one block of
// 4 warps per 64x64 output tile; per step of 64 in K the block gathers a
// 64x64 activation tile (16-byte loads when C is a multiple of 16, 4-byte
// or byte loads for the 3- and 12-channel stems) and a 64x64 weight tile
// into shared memory (rows padded to 80 bytes, so fragment loads hit 32
// distinct banks), prefetching the next step's tiles into registers while
// each warp runs mma.sync.m16n8k32 s8 over its 32x32 sub-tile. The int32
// accumulator is exact (|acc| < 127^2 * 4608 < 2^31).
//
// Epilogue, in registers, in XLA's operation order on the CPU (the JAX
// package's reference): acc -> float (round to nearest even), ms = m[o] *
// s_in, y = fma(acc, ms, b[o]) (XLA contracts the dequant into one FMA),
// then optionally y += residual (f32) or y = fma(q_res, s_res, y) (int8
// shortcut, contracted the same way), relu, and the store: int32 (the raw
// accumulator), f32, bf16 (round to nearest even) or int8 at s_out
// (rint(y / s_out) clamped to +-127, a true division). Every operation is
// an explicitly rounded intrinsic; never build with --use_fast_math.
//
// Scales (s_in, s_out, s_res) are read from device memory, so a
// dynamic-scale caller never waits on the host.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (geomapnet_tpu_torch/ops/_nvcc.py does this at
//        first use); plain C entry point, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;      // output pixels per block
constexpr int BN = 64;      // output channels per block
constexpr int BK = 64;      // depth per shared-memory step
constexpr int SROW = 80;    // bytes per shared row: 64 data + 16 pad
constexpr int THREADS = 128;

enum OutKind { OUT_I32 = 0, OUT_F32 = 1, OUT_BF16 = 2, OUT_I8 = 3 };
enum ResKind { RES_NONE = 0, RES_F32 = 1, RES_I8 = 2 };

struct Conv {
  const int8_t* x;
  const int8_t* w;
  const float* m;
  const float* b;
  const float* s_in;
  const float* s_out;
  const float* s_res;
  const void* res;
  void* out;
  int N, H, W, C, O, KH, KW, SH, SW, PT, PL, OH, OW, K, Kpad;
  int out_kind, res_kind, relu;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 consecutive depth entries [k0, k0 + 16) of one output pixel's
// receptive field; zero outside the image and past K.
template <int VEC>
__device__ __forceinline__ int4 gather16(const Conv& p, const int8_t* img,
                                         int ih0, int iw0, int k0) {
  int4 v = make_int4(0, 0, 0, 0);
  if (VEC == 16) {
    // C % 16 == 0: the 16 entries share one (kh, kw)
    if (k0 < p.K) {
      int pos = k0 / p.C;
      int c = k0 - pos * p.C;
      int kh = pos / p.KW;
      int ih = ih0 + kh;
      int iw = iw0 + (pos - kh * p.KW);
      if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
        v = *reinterpret_cast<const int4*>(
            img + ((long long)ih * p.W + iw) * p.C + c);
    }
  } else {
    int8_t* bytes = reinterpret_cast<int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; j += VEC) {
      int k = k0 + j;
      if (k < p.K) {
        int pos = k / p.C;
        int c = k - pos * p.C;
        int kh = pos / p.KW;
        int ih = ih0 + kh;
        int iw = iw0 + (pos - kh * p.KW);
        if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W) {
          const int8_t* src = img + ((long long)ih * p.W + iw) * p.C + c;
          if (VEC == 4) {
            *reinterpret_cast<int*>(bytes + j) =
                *reinterpret_cast<const int*>(src);
          } else {
            bytes[j] = *src;
          }
        }
      }
    }
  }
  return v;
}

__device__ __forceinline__ void emit(const Conv& p, float s_in, float s_out,
                                     float s_res, int acc, long long row,
                                     int col) {
  long long at = row * p.O + col;
  if (p.out_kind == OUT_I32) {
    reinterpret_cast<int*>(p.out)[at] = acc;
    return;
  }
  float ms = __fmul_rn(p.m[col], s_in);
  float y = __fmaf_rn(__int2float_rn(acc), ms, p.b[col]);
  if (p.res_kind == RES_F32) {
    y = __fadd_rn(y, reinterpret_cast<const float*>(p.res)[at]);
  } else if (p.res_kind == RES_I8) {
    float q = static_cast<float>(reinterpret_cast<const int8_t*>(p.res)[at]);
    y = __fmaf_rn(q, s_res, y);
  }
  if (p.relu) y = fmaxf(y, 0.0f);
  if (p.out_kind == OUT_F32) {
    reinterpret_cast<float*>(p.out)[at] = y;
  } else if (p.out_kind == OUT_BF16) {
    reinterpret_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16_rn(y);
  } else {
    float q = rintf(__fdiv_rn(y, s_out));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    reinterpret_cast<int8_t*>(p.out)[at] = static_cast<int8_t>(q);
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    int8_conv_kernel(const Conv p) {
  __shared__ __align__(16) int8_t sA[BM * SROW];
  __shared__ __align__(16) int8_t sB[BN * SROW];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;     // mma groupID
  const int tig = lane & 3;    // mma thread in group
  const int wm = warp >> 1;    // warp's 32-row half of the tile
  const int wn = warp & 1;     // warp's 32-column half
  const long long M = (long long)p.N * p.OH * p.OW;
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  // this thread stages row (tid >> 1) of both tiles, depth half (tid & 1)
  const int lr = tid >> 1;
  const int kh0 = (tid & 1) * 32;
  const long long grow = row0 + lr;
  const bool row_ok = grow < M;
  const int8_t* img = p.x;
  int ih0 = 0, iw0 = 0;
  if (row_ok) {
    long long n = grow / ((long long)p.OH * p.OW);
    int rem = static_cast<int>(grow - n * p.OH * p.OW);
    int oh = rem / p.OW;
    int ow = rem - oh * p.OW;
    img = p.x + n * p.H * p.W * p.C;
    ih0 = oh * p.SH - p.PT;
    iw0 = ow * p.SW - p.PL;
  }
  const int gcol = col0 + lr;
  const bool col_ok = gcol < p.O;
  const int8_t* wrow = p.w + (long long)gcol * p.Kpad;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  int4 ra[2], rb[2];
  auto stage = [&](int k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int kk = k + kh0 + h * 16;
      ra[h] = row_ok ? gather16<VEC>(p, img, ih0, iw0, kk)
                     : make_int4(0, 0, 0, 0);
      rb[h] = col_ok ? *reinterpret_cast<const int4*>(wrow + kk)
                     : make_int4(0, 0, 0, 0);
    }
  };

  stage(0);
  for (int k = 0; k < p.Kpad; k += BK) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<int4*>(sA + lr * SROW + kh0 + h * 16) = ra[h];
      *reinterpret_cast<int4*>(sB + lr * SROW + kh0 + h * 16) = rb[h];
    }
    __syncthreads();
    if (k + BK < p.Kpad) stage(k + BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* base = sA + (wm * 32 + i * 16 + g) * SROW + ks + tig * 4;
        a[i][0] = *reinterpret_cast<const unsigned*>(base);
        a[i][1] = *reinterpret_cast<const unsigned*>(base + 8 * SROW);
        a[i][2] = *reinterpret_cast<const unsigned*>(base + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(base + 8 * SROW + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* base = sB + (wn * 32 + j * 8 + g) * SROW + ks + tig * 4;
        b[j][0] = *reinterpret_cast<const unsigned*>(base);
        b[j][1] = *reinterpret_cast<const unsigned*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  const float s_in = p.s_in ? *p.s_in : 0.0f;
  const float s_out = p.s_out ? *p.s_out : 0.0f;
  const float s_res = p.s_res ? *p.s_res : 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      long long r = row0 + wm * 32 + i * 16 + g;
      int c = col0 + wn * 32 + j * 8 + tig * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        long long rr = r + (e >> 1) * 8;
        int cc = c + (e & 1);
        if (rr < M && cc < p.O) emit(p, s_in, s_out, s_res, acc[i][j][e], rr, cc);
      }
    }
  }
}

}  // namespace

extern "C" int gm_int8_conv(
    const void* x, const void* w, const void* m, const void* b,
    const void* s_in, const void* s_out, const void* s_res, const void* res,
    void* out, int n, int h, int wd, int c, int o, int kh, int kw, int sh,
    int sw, int pt, int pl, int oh, int ow, int kpad, int out_kind,
    int res_kind, int relu, int vec, void* stream) {
  Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.m = static_cast<const float*>(m);
  p.b = static_cast<const float*>(b);
  p.s_in = static_cast<const float*>(s_in);
  p.s_out = static_cast<const float*>(s_out);
  p.s_res = static_cast<const float*>(s_res);
  p.res = res;
  p.out = out;
  p.N = n; p.H = h; p.W = wd; p.C = c; p.O = o; p.KH = kh; p.KW = kw;
  p.SH = sh; p.SW = sw; p.PT = pt; p.PL = pl; p.OH = oh; p.OW = ow;
  p.K = kh * kw * c; p.Kpad = kpad;
  p.out_kind = out_kind; p.res_kind = res_kind; p.relu = relu;
  long long M = (long long)n * oh * ow;
  if (M <= 0 || o <= 0) return 0;
  if (kpad % BK != 0 || kpad < p.K) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (o + BN - 1) / BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 16) {
    int8_conv_kernel<16><<<grid, THREADS, 0, st>>>(p);
  } else if (vec == 4) {
    int8_conv_kernel<4><<<grid, THREADS, 0, st>>>(p);
  } else {
    int8_conv_kernel<1><<<grid, THREADS, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
