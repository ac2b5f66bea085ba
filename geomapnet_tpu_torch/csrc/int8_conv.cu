// int8 x int8 -> int32 implicit-GEMM convolution with a float32 epilogue,
// for sm_90a (kernel K1 of the port).
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
// with zeros to a multiple of 64. Both operands are K-major, the only order
// Hopper's 8-bit wgmma takes: nothing is transposed.
//
// Three routes, chosen by the wrapper (ops/cuda_quant.py::conv_plan) by
// channel count, each with its own C entry point and launch counter:
//
// 1. body (C a multiple of 16: every conv after the stem). Bound by tensor-
//    core operations: a 3x3 body conv of a 60-frame window is ~24 GOP
//    against a few MB. Two warpgroups per block own a 128 x BN output tile
//    (BN = 64, 128 or 256 by the wrapper's tile plan) and run
//    wgmma.mma_async m64nBNk32 s8 with both operands read from shared memory
//    through matrix descriptors (128-byte swizzle, K-major). The depth runs
//    in steps of 128 bytes through a ring of 3 or 4 shared-memory stages
//    that every thread fills two steps ahead with 16-byte cp.async copies:
//    the im2col gather of A (a source size of 0 zero-fills padding taps,
//    depth past K and rows past M) and the weight rows of B. The tap and
//    channel of each copy are running counters, so the depth loop divides
//    nothing. The epilogue stages the tile through shared memory (in the
//    output's own type when there is no residual) and writes it, and reads
//    the residual, as 16-byte vectors. What holds it back on an H100 is the
//    traffic from L2: each block gathers its A rows and loads its B
//    columns anew, ~200 MB for a 3x3 conv of the window (PERF.md).
// 2. s2d (C = 12: the 4x4 stride-1 space-to-depth stem). Bound by bytes
//    (~100 MB of input and output against 32 GOP). A persistent block keeps
//    the weight in registers and walks pairs of output rows: for each it
//    loads the 5 input rows they need once, as 16-byte loads of the aligned
//    chunks that cover each row (a row is 4-byte aligned only), zero-pads
//    them in shared memory, and reads mma.sync m16n8k32 fragments straight
//    from those rows (a 4x4 tap row is 48 contiguous bytes). The int8
//    output leaves through shared memory in 16-byte stores.
// 3. simple (any other C: the loader path's 3-channel 7x7 stem): PR 3's
//    kernel, 64x64 tiles of mma.sync m16n8k32 over a register-staged
//    gather of 16, 4 or 1 bytes.
//
// Epilogue, the same intrinsics in the same order in every route, in XLA's
// operation order on the CPU (the JAX package's reference): acc -> float
// (round to nearest even), ms = m[o] * s_in, y = fma(acc, ms, b[o]) (XLA
// contracts the dequant into one FMA), then optionally y += residual (f32)
// or y = fma(q_res, s_res, y) (int8 shortcut, contracted the same way),
// relu, and the store: int32 (the raw accumulator), f32, bf16 (round to
// nearest even) or int8 at s_out (rint of the correctly rounded y / s_out,
// clamped to +-127: a true division in route 3, the same quotient without
// a division in routes 1 and 2, see requant_quotient). Every operation is
// an explicitly rounded intrinsic; never build with --use_fast_math. The
// int32 accumulator is exact (|acc| < 127^2 * 4608 < 2^31).
//
// Scales (s_in, s_out, s_res) are read from device memory, so a
// dynamic-scale caller never waits on the host.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (geomapnet_tpu_torch/ops/_nvcc.py does this at
//        first use); plain C entry points, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  long long M;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}


// ------------------------------------------ route 3: PR 3's simple kernel

namespace simple {

constexpr int BM = 64;      // output pixels per block
constexpr int BN = 64;      // output channels per block
constexpr int BK = 64;      // depth per shared-memory step
constexpr int SROW = 80;    // bytes per shared row: 64 data + 16 pad
constexpr int THREADS = 128;

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

}  // namespace simple

// ------------------------------------------------ the epilogue's second half

// RN(y / s) wherever it can change the int8 that rint and the clamp make
// of it, without a division: with r = RN(1/s), q0 = RN(y * r) is within an
// ulp of y / s, and Markstein's correction q0 + RN(y - q0 * s) * r (two
// FMAs; the remainder is exact) is the correctly rounded quotient. It is
// taken for 0.25 <= |q0| < 2^24 and s in [2^-100, 2^100] (no underflow or
// overflow on the way); below, rint gives 0 and above the clamp gives
// +-127 from q0 as from y / s, and NaN stays NaN. The caller checks s's
// range once and divides with __fdiv_rn outside it.
__device__ __forceinline__ float requant_quotient(float y, float s, float r) {
  const float q0 = __fmul_rn(y, r);
  const float a = fabsf(q0);
  if (!(a >= 0.25f && a < 16777216.0f)) return q0;
  return __fmaf_rn(__fmaf_rn(-q0, s, y), r, q0);
}

// the requant to int8: rint(RN(y / s)) clamped to +-127, with r = RN(1/s).
// EXACT: s lies in [2^-100, 2^100] (see requant_quotient); callers test
// that once and run a whole tile with one or the other, since a branch per
// element would keep the compiler from interleaving the elements' chains.
template <bool EXACT>
__device__ __forceinline__ uint32_t requant_i8(float y, float s, float r) {
  float q = rintf(EXACT ? requant_quotient(y, s, r) : __fdiv_rn(y, s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
}
//
// Routes 1 and 2 first write y = fma(acc, ms, b) (or the raw accumulator's
// bits for an int32 output) into a float tile in shared memory, row stride
// `sst` floats. store_tile then walks the tile in units of 16 columns, so
// neighbouring threads read and write neighbouring 16-byte vectors: the
// residual, relu and the store. Needs O % 16 == 0 and 16-byte aligned
// out / residual (the wrapper checks both).
template <int UPR, bool EXACT>   // UPR: 16-column units per tile row
__device__ __forceinline__ void store_units(const Conv& p, const float* stg,
                                            int sst, int rows, long long row0,
                                            int col0, int tid, int nthreads,
                                            float s_out, float r_out) {
  const float s_res = p.s_res ? *p.s_res : 0.0f;
  for (int u = tid; u < rows * UPR; u += nthreads) {
    const int r = u / UPR;   // UPR is a power of two: a shift
    const int cu = u - r * UPR;
    const int gcol = col0 + cu * 16;
    if (gcol >= p.O) continue;
    const long long at = (row0 + r) * p.O + gcol;
    const float4* src = reinterpret_cast<const float4*>(stg + r * sst + cu * 16);
    float y[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = src[q];
      y[4 * q] = v.x; y[4 * q + 1] = v.y; y[4 * q + 2] = v.z; y[4 * q + 3] = v.w;
    }
    if (p.out_kind == OUT_I32) {
      int4* dst = reinterpret_cast<int4*>(static_cast<int*>(p.out) + at);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[q] = make_int4(__float_as_int(y[4 * q]), __float_as_int(y[4 * q + 1]),
                           __float_as_int(y[4 * q + 2]),
                           __float_as_int(y[4 * q + 3]));
      continue;
    }
    if (p.res_kind == RES_F32) {
      const float4* rs =
          reinterpret_cast<const float4*>(static_cast<const float*>(p.res) + at);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = rs[q];
        y[4 * q] = __fadd_rn(y[4 * q], v.x);
        y[4 * q + 1] = __fadd_rn(y[4 * q + 1], v.y);
        y[4 * q + 2] = __fadd_rn(y[4 * q + 2], v.z);
        y[4 * q + 3] = __fadd_rn(y[4 * q + 3], v.w);
      }
    } else if (p.res_kind == RES_I8) {
      const int4 v = *reinterpret_cast<const int4*>(
          static_cast<const int8_t*>(p.res) + at);
      const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int8_t q = static_cast<int8_t>(words[e >> 2] >> (8 * (e & 3)));
        y[e] = __fmaf_rn(static_cast<float>(q), s_res, y[e]);
      }
    }
    if (p.relu) {
#pragma unroll
      for (int e = 0; e < 16; ++e) y[e] = fmaxf(y[e], 0.0f);
    }
    if (p.out_kind == OUT_F32) {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(p.out) + at);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
    } else if (p.out_kind == OUT_BF16) {
      uint32_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(y[2 * e], y[2 * e + 1]);
        h[e] = *reinterpret_cast<const uint32_t*>(&v);
      }
      uint4* dst = reinterpret_cast<uint4*>(
          static_cast<__nv_bfloat16*>(p.out) + at);
      dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
      dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
    } else {
      uint32_t wq[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        wq[e >> 2] |= requant_i8<EXACT>(y[e], s_out, r_out) << (8 * (e & 3));
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) + at) =
          make_uint4(wq[0], wq[1], wq[2], wq[3]);
    }
  }
}

template <int UPR>
__device__ __forceinline__ void store_tile(const Conv& p, const float* stg,
                                           int sst, int rows, long long row0,
                                           int col0, int tid, int nthreads) {
  const float s_out = p.s_out ? *p.s_out : 0.0f;
  const float r_out = __frcp_rn(s_out);
  if (s_out >= 0x1p-100f && s_out <= 0x1p100f)
    store_units<UPR, true>(p, stg, sst, rows, row0, col0, tid, nthreads,
                           s_out, r_out);
  else
    store_units<UPR, false>(p, stg, sst, rows, row0, col0, tid, nthreads,
                            s_out, r_out);
}

// ------------------------------------------ an epilogue without a residual
//
// With no residual to read, the whole epilogue runs on the accumulator
// fragment (two neighbouring columns a thread), and the staged tile holds
// the output's own type, rows of BN * size + 16 bytes; copy_tile then moves
// it out in 16-byte vectors.
template <int OUT>
struct OutSize {
  static constexpr int value = OUT == OUT_I8 ? 1 : OUT == OUT_BF16 ? 2 : 4;
};

template <int OUT, bool EXACT>
__device__ __forceinline__ void stage_pair(const Conv& p, uint8_t* at, int v0,
                                           int v1, float ms0, float ms1,
                                           float b0, float b1, float s_out,
                                           float r_out) {
  if constexpr (OUT == OUT_I32) {
    *reinterpret_cast<int2*>(at) = make_int2(v0, v1);
  } else {
    float y0 = __fmaf_rn(__int2float_rn(v0), ms0, b0);
    float y1 = __fmaf_rn(__int2float_rn(v1), ms1, b1);
    if (p.relu) {
      y0 = fmaxf(y0, 0.0f);
      y1 = fmaxf(y1, 0.0f);
    }
    if constexpr (OUT == OUT_F32) {
      *reinterpret_cast<float2*>(at) = make_float2(y0, y1);
    } else if constexpr (OUT == OUT_BF16) {
      *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(y0, y1);
    } else {
      *reinterpret_cast<uint16_t*>(at) = static_cast<uint16_t>(
          requant_i8<EXACT>(y0, s_out, r_out) |
          (requant_i8<EXACT>(y1, s_out, r_out) << 8));
    }
  }
}

// rows x BN staged values of OUT's size -> out[row0 + r, col0 ...]
template <int BN, int OUT>
__device__ __forceinline__ void copy_tile(const Conv& p, const uint8_t* stg,
                                          int rows, long long row0, int col0,
                                          int tid, int nthreads) {
  constexpr int ES = OutSize<OUT>::value;
  constexpr int ROW = BN * ES + 16;
  constexpr int UPR = BN * ES / 16;   // 16-byte units per row
  for (int u = tid; u < rows * UPR; u += nthreads) {
    const int r = u / UPR;   // a power of two: a shift
    const int cu = u - r * UPR;
    if (col0 + cu * (16 / ES) >= p.O) continue;
    *reinterpret_cast<int4*>(static_cast<uint8_t*>(p.out) +
                             ((row0 + r) * p.O + col0) * ES + cu * 16) =
        *reinterpret_cast<const int4*>(stg + r * ROW + cu * 16);
  }
}

// ------------------------------------------- route 1: the wgmma body kernel

constexpr int BODY_BM = 128;      // output pixels per block: 2 warpgroups x 64
constexpr int BODY_BK = 128;      // depth bytes per ring stage: one swizzle row
constexpr int BODY_THREADS = 256;

// BN: output channels per block; S: ring stages. Every thread both copies
// and multiplies. With 4 stages or more, one step's wgmmas stay in flight
// while the next is issued (IN_FLIGHT = 1) and the copies run S - 2 steps
// ahead; with 3, each step's wgmmas retire before the next (a second block
// on the SM fills the gap) and the copies run 2 steps ahead.
template <int BN, int S>
struct BodyCfg {
  static constexpr int A_BYTES = BODY_BM * BODY_BK;
  static constexpr int B_BYTES = BN * BODY_BK;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = S * STAGE;
  static constexpr int IN_FLIGHT = S >= 4 ? 1 : 0;
  static constexpr int AHEAD = S - 1 - IN_FLIGHT;
  static constexpr int SST = BN + 4;   // staged tile's row stride, floats
  static constexpr int STAGING = BODY_BM * SST * 4;
  static constexpr int MAIN = RING > STAGING ? RING : STAGING;
  // 1024 bytes of slack to align the ring to the 128-byte swizzle's
  // 1024-byte atom, then the ring (later the staged tile), then ms and b
  static constexpr int SMEM = 1024 + MAIN + 2 * BN * 4;
};

// The ring depth of each width, and the blocks an SM holds: 3 stages keep
// three 64-wide or two 128-wide blocks on an SM, which timed faster on an
// H100 than fewer blocks with deeper rings; the 256-wide tile takes an SM
// alone, with 4 stages.
template <int BN>
struct BodyStages {
  static constexpr int value = BN == 256 ? 4 : 3;
  static constexpr int blocks = BN == 64 ? 3 : BN == 128 ? 2 : 1;
};

// 16-byte global -> shared copy; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma matrix descriptor of a K-major tile in the 128-byte swizzle: rows
// of 128 bytes, 8-row atoms of 1024 bytes (the stride byte offset); the
// leading byte offset is unused for swizzled K-major operands
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  uint64_t d = static_cast<uint64_t>((saddr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across the asynchronous
// wgmma (it sees the asm statements as synchronous)
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 64) wgmma_n64(d, da, db);
  else if constexpr (BN == 128) wgmma_n128(d, da, db);
  else wgmma_n256(d, da, db);
}

// the no-residual epilogue of a body tile's accumulators into its staged
// tile (see stage_pair)
template <int BN, int OUT, bool EXACT>
__device__ __forceinline__ void body_stage(const Conv& p,
                                           const int (&acc)[BN / 2],
                                           uint8_t* stg, const float* s_ms,
                                           const float* s_b, int rbase, int t4,
                                           float s_out, float r_out) {
  constexpr int ES = OutSize<OUT>::value;
  constexpr int ROW = BN * ES + 16;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    const float ms0 = s_ms[col], ms1 = s_ms[col + 1];
    const float b0 = s_b[col], b1 = s_b[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      stage_pair<OUT, EXACT>(p, stg + (rbase + 8 * h) * ROW + col * ES,
                             acc[j * 4 + 2 * h], acc[j * 4 + 2 * h + 1], ms0,
                             ms1, b0, b1, s_out, r_out);
  }
}

template <int BN, int S>
__global__ void __launch_bounds__(BODY_THREADS, BodyStages<BN>::blocks)
    int8_conv_body(const Conv p) {
  using Cfg = BodyCfg<BN, S>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (sbase - raw);
  float* s_ms = reinterpret_cast<float*>(gbase + Cfg::MAIN);
  float* s_b = s_ms + BN;

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * BODY_BM;
  const int col0 = blockIdx.y * BN;
  {
    const float s_in = p.s_in ? *p.s_in : 0.0f;
    for (int c = tid; c < BN; c += BODY_THREADS) {
      const int gc = col0 + c;
      s_ms[c] = gc < p.O ? __fmul_rn(p.m[gc], s_in) : 0.0f;
      s_b[c] = gc < p.O ? p.b[gc] : 0.0f;
    }
  }

  // Copies: thread tid moves 16-byte chunk `ch` of rows rsub + 32*i of A
  // (i < 4) and of B (i < BN/32) in every stage. Its chunk lands at
  // row*128 + ((ch ^ (row & 7)) << 4): the 128-byte swizzle, and row & 7 is
  // rsub & 7 for all its rows.
  const int ch = tid & 7;
  const int rsub = tid >> 3;
  const uint32_t swz = static_cast<uint32_t>(rsub * BODY_BK) +
                       (static_cast<uint32_t>(ch ^ (rsub & 7)) << 4);
  long long a_base[4];
  int a_ih[4], a_iw[4];
  {
    const long long ohw = static_cast<long long>(p.OH) * p.OW;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long grow = row0 + rsub + 32 * i;
      a_base[i] = 0;
      a_ih[i] = -(1 << 30);   // a row past M: every tap out of the image
      a_iw[i] = 0;
      if (grow < p.M) {
        const long long n = grow / ohw;
        const int rem = static_cast<int>(grow - n * ohw);
        const int oh = rem / p.OW;
        const int ow = rem - oh * p.OW;
        a_ih[i] = oh * p.SH - p.PT;
        a_iw[i] = ow * p.SW - p.PL;
        a_base[i] = ((n * p.H + a_ih[i]) * p.W + a_iw[i]) * p.C;
      }
    }
  }
  // the running depth position of this thread's chunk: depth kabs is tap
  // (kh, kw), channel c; divided once here, then advanced by adds
  int kabs = ch * 16;
  int c = kabs % p.C;
  int kh = (kabs / p.C) / p.KW;
  int kw = (kabs / p.C) - kh * p.KW;

  auto load_step = [&](int stage) {
    const uint32_t sa = sbase + stage * Cfg::STAGE + swz;
    const uint32_t sb = sa + Cfg::A_BYTES;
    const long long tap = (static_cast<long long>(kh) * p.W + kw) * p.C + c;
    const bool k_ok = kabs < p.K;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = a_ih[i] + kh;
      const int iw = a_iw[i] + kw;
      const bool ok = k_ok && static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(p.W);
      cp_async16(sa + i * 32 * BODY_BK, ok ? p.x + a_base[i] + tap : p.x, ok);
    }
    const bool kb_ok = kabs < p.Kpad;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int n = col0 + rsub + 32 * j;
      const bool ok = kb_ok && n < p.O;
      cp_async16(sb + j * 32 * BODY_BK,
                 ok ? p.w + static_cast<long long>(n) * p.Kpad + kabs : p.w, ok);
    }
    kabs += BODY_BK;
    c += BODY_BK;
    while (c >= p.C) {
      c -= p.C;
      if (++kw == p.KW) {
        kw = 0;
        ++kh;
      }
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  fence_regs(acc);

  constexpr int D = Cfg::AHEAD;
  const int nsteps = (p.Kpad + BODY_BK - 1) / BODY_BK;
#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (s < nsteps) load_step(s);
    cp_async_commit();
  }
  const int wg = tid >> 7;
  int stage = 0, fill = D % S;
  for (int ks = 0; ks < nsteps; ++ks) {
    // this step's copies have landed (D - 1 younger groups may still fly);
    // make them visible to the tensor cores' async proxy, then to all
    cp_async_wait<D - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // every warpgroup has retired the wgmmas of step ks + D - S: refill
    // its stage with step ks + D
    if (ks + D < nsteps) load_step(fill);
    cp_async_commit();
    if (++fill == S) fill = 0;
    const uint32_t sa = sbase + stage * Cfg::STAGE;
    const uint32_t sb = sa + Cfg::A_BYTES;
    wgmma_fence();
    // a last half step (Kpad % 128 == 64) multiplies zero-filled depth
#pragma unroll
    for (int kk = 0; kk < BODY_BK / 32; ++kk)
      wgmma_tile<BN>(acc, sw128_desc(sa + wg * 64 * BODY_BK + kk * 32),
                     sw128_desc(sb + kk * 32));
    wgmma_commit();
    wgmma_wait<Cfg::IN_FLIGHT>();
    fence_regs(acc);
    if (++stage == S) stage = 0;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();   // the ring is free: it becomes the staged tile

  // accumulator fragment: warp wq of the warpgroup holds rows wq*16 + g and
  // + 8; n8 block j holds columns j*8 + 2*t4 and + 1
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rbase = wg * 64 + ((tid >> 5) & 3) * 16 + g;
  const long long left = p.M - row0;
  const int rows = left < BODY_BM ? static_cast<int>(left) : BODY_BM;
  if (p.res_kind == RES_NONE) {
    const float s_out = p.s_out ? *p.s_out : 0.0f;
    const float r_out = __frcp_rn(s_out);
    const bool exact = s_out >= 0x1p-100f && s_out <= 0x1p100f;
    switch (p.out_kind) {
      case OUT_I32:
        body_stage<BN, OUT_I32, true>(p, acc, gbase, s_ms, s_b, rbase, t4,
                                      s_out, r_out);
        __syncthreads();
        copy_tile<BN, OUT_I32>(p, gbase, rows, row0, col0, tid, BODY_THREADS);
        break;
      case OUT_F32:
        body_stage<BN, OUT_F32, true>(p, acc, gbase, s_ms, s_b, rbase, t4,
                                      s_out, r_out);
        __syncthreads();
        copy_tile<BN, OUT_F32>(p, gbase, rows, row0, col0, tid, BODY_THREADS);
        break;
      case OUT_BF16:
        body_stage<BN, OUT_BF16, true>(p, acc, gbase, s_ms, s_b, rbase, t4,
                                       s_out, r_out);
        __syncthreads();
        copy_tile<BN, OUT_BF16>(p, gbase, rows, row0, col0, tid, BODY_THREADS);
        break;
      default:
        if (exact)
          body_stage<BN, OUT_I8, true>(p, acc, gbase, s_ms, s_b, rbase, t4,
                                       s_out, r_out);
        else
          body_stage<BN, OUT_I8, false>(p, acc, gbase, s_ms, s_b, rbase, t4,
                                        s_out, r_out);
        __syncthreads();
        copy_tile<BN, OUT_I8>(p, gbase, rows, row0, col0, tid, BODY_THREADS);
    }
    return;
  }
  // with a residual: y = fma(acc, ms, b) as floats; store_tile reads the
  // residual in 16-byte vectors
  float* stg = reinterpret_cast<float*>(gbase);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    const float ms0 = s_ms[col], ms1 = s_ms[col + 1];
    const float b0 = s_b[col], b1 = s_b[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v0 = acc[j * 4 + 2 * h], v1 = acc[j * 4 + 2 * h + 1];
      float2 y;
      if (p.out_kind == OUT_I32) {
        y = make_float2(__int_as_float(v0), __int_as_float(v1));
      } else {
        y = make_float2(__fmaf_rn(__int2float_rn(v0), ms0, b0),
                        __fmaf_rn(__int2float_rn(v1), ms1, b1));
      }
      *reinterpret_cast<float2*>(stg + (rbase + 8 * h) * Cfg::SST + col) = y;
    }
  }
  __syncthreads();
  store_tile<BN / 16>(p, stg, Cfg::SST, rows, row0, col0, tid, BODY_THREADS);
}

// ------------------------------------ route 2: the space-to-depth stem kernel

constexpr int S2D_C = 12;                      // 2x2 space-to-depth of RGB
constexpr int S2D_TAPS = 4;                    // 4x4 taps, stride 1
constexpr int S2D_SEG = S2D_TAPS * S2D_C;      // 48 bytes: one tap row
constexpr int S2D_K = S2D_TAPS * S2D_SEG;      // 192
constexpr int S2D_O = 64;
constexpr int S2D_PT = 2, S2D_PL = 2;          // pad ((2, 1), (2, 1))
constexpr int S2D_ROWS = 2;                    // output rows per block
constexpr int S2D_IN_ROWS = S2D_ROWS + S2D_TAPS - 1;
constexpr int S2D_THREADS = 128;
constexpr int S2D_SST = S2D_O + 4;             // staged float row, floats
constexpr int S2D_I8ROW = S2D_O + 16;          // staged int8 row, bytes
constexpr int S2D_BROW = S2D_K + 16;           // weight row in shared memory

// One input row in shared memory: 32 bytes, then the 16-byte chunks that
// cover the row (its first byte lands at 32 + its address % 16), and room
// for the right padding and the masked pixels of the last 16-row m-tile.
__host__ __device__ constexpr int s2d_row_bytes(int ow) {
  return (48 + (((ow + 15) & ~15) + 2) * S2D_C + 16 + 15) & ~15;
}
// the input rows, the weight, the rows' offsets (8 ints), ms and b, and
// one output row staged: as int8 for the stem's own epilogue (`direct`),
// else as floats
__host__ __device__ constexpr int s2d_smem(int ow, bool direct) {
  return S2D_IN_ROWS * s2d_row_bytes(ow) + S2D_O * S2D_BROW + 32 +
         2 * S2D_O * 4 +
         ((ow + 15) & ~15) * (direct ? S2D_I8ROW : S2D_SST * 4);
}

// An m-tile's accumulators (rows row, row + 8; columns col + j*8, + 1) into
// the staged row: y = fma(acc, ms, b) as floats (the raw accumulator's bits
// for an int32 output) for store_tile ...
__device__ __forceinline__ void s2d_stage_floats(const Conv& p,
                                                 const int (&acc)[4][4],
                                                 float* stg, const float* s_ms,
                                                 const float* s_b, int row,
                                                 int col) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col + j * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 y;
      if (p.out_kind == OUT_I32) {
        y = make_float2(__int_as_float(acc[j][2 * h]),
                        __int_as_float(acc[j][2 * h + 1]));
      } else {
        y = make_float2(
            __fmaf_rn(__int2float_rn(acc[j][2 * h]), s_ms[c], s_b[c]),
            __fmaf_rn(__int2float_rn(acc[j][2 * h + 1]), s_ms[c + 1], s_b[c + 1]));
      }
      *reinterpret_cast<float2*>(stg + (row + 8 * h) * S2D_SST + c) = y;
    }
  }
}

// ... or, for the stem's own epilogue (no residual, int8 out), the whole
// epilogue here, into int8 rows of S2D_I8ROW bytes
template <bool EXACT>
__device__ __forceinline__ void s2d_stage_i8(const Conv& p,
                                             const int (&acc)[4][4], float* stg,
                                             const float* s_ms,
                                             const float* s_b, int row,
                                             int col, float s_out,
                                             float r_out) {
  uint8_t* out = reinterpret_cast<uint8_t*>(stg);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col + j * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y0 = __fmaf_rn(__int2float_rn(acc[j][2 * h]), s_ms[c], s_b[c]);
      float y1 =
          __fmaf_rn(__int2float_rn(acc[j][2 * h + 1]), s_ms[c + 1], s_b[c + 1]);
      if (p.relu) {
        y0 = fmaxf(y0, 0.0f);
        y1 = fmaxf(y1, 0.0f);
      }
      *reinterpret_cast<uint16_t*>(out + (row + 8 * h) * S2D_I8ROW + c) =
          static_cast<uint16_t>(requant_i8<EXACT>(y0, s_out, r_out) |
                                (requant_i8<EXACT>(y1, s_out, r_out) << 8));
    }
  }
}

__global__ void __launch_bounds__(S2D_THREADS)
    int8_conv_s2d(const Conv p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int rb = s2d_row_bytes(p.OW);
  int8_t* strip = reinterpret_cast<int8_t*>(smem);
  int8_t* s_w = strip + S2D_IN_ROWS * rb;
  int* s_row = reinterpret_cast<int*>(s_w + S2D_O * S2D_BROW);
  float* s_ms = reinterpret_cast<float*>(s_row + 8);
  float* s_b = s_ms + S2D_O;
  float* stg = s_b + S2D_O;

  const int tid = threadIdx.x;
  const int row_blocks = (p.OH + S2D_ROWS - 1) / S2D_ROWS;
  const long long row_bytes = static_cast<long long>(p.W) * S2D_C;
  const int8_t* x_end = p.x + static_cast<long long>(p.N) * p.H * row_bytes;

  if (tid < S2D_O) {
    const float s_in = p.s_in ? *p.s_in : 0.0f;
    s_ms[tid] = __fmul_rn(p.m[tid], s_in);
    s_b[tid] = p.b[tid];
  }
  // the weight, 16 bytes a load, into rows of 208 bytes (fragment reads
  // then hit 32 distinct banks)
  for (int i = tid; i < S2D_O * (S2D_K / 16); i += S2D_THREADS) {
    const int o = i / (S2D_K / 16), q = i - o * (S2D_K / 16);
    *reinterpret_cast<int4*>(s_w + o * S2D_BROW + q * 16) = __ldg(
        reinterpret_cast<const int4*>(p.w + static_cast<long long>(o) * p.Kpad +
                                      q * 16));
  }
  __syncthreads();

  // warp (mh, nh): 16-row m-tiles mh, mh + 2, ...; columns nh*32 .. +32.
  // Its B fragments (4 n8 blocks x 6 k32 steps) stay in registers for all
  // of the block's rows.
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nh = warp & 1, mh = warp >> 1;
  unsigned bf[S2D_K / 32][4][2];
#pragma unroll
  for (int ks = 0; ks < S2D_K / 32; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* wp = s_w + (nh * 32 + j * 8 + g) * S2D_BROW + ks * 32 + t4 * 4;
      bf[ks][j][0] = *reinterpret_cast<const unsigned*>(wp);
      bf[ks][j][1] = *reinterpret_cast<const unsigned*>(wp + 16);
    }
  const bool direct = p.res_kind == RES_NONE && p.out_kind == OUT_I8;
  const float s_out = p.s_out ? *p.s_out : 0.0f;
  const float r_out = __frcp_rn(s_out);
  const bool exact_rcp = s_out >= 0x1p-100f && s_out <= 0x1p100f;
  const int nmt = (p.OW + 15) >> 4;

  // a persistent grid: each block walks pairs of output rows (n, oh0)
  for (int item = blockIdx.x; item < p.N * row_blocks; item += gridDim.x) {
  const int n = item / row_blocks;
  const int oh0 = (item - n * row_blocks) * S2D_ROWS;
  // the input rows oh0 - 2 .. oh0 + S2D_ROWS, as 16-byte loads of their
  // aligned chunks (an address past the tensor's end is read word by word)
  int delta[S2D_IN_ROWS];
#pragma unroll
  for (int r = 0; r < S2D_IN_ROWS; ++r) {
    const int ih = oh0 - S2D_PT + r;
    delta[r] = 0;
    if (static_cast<unsigned>(ih) >= static_cast<unsigned>(p.H)) continue;
    const int8_t* row = p.x + (static_cast<long long>(n) * p.H + ih) * row_bytes;
    delta[r] = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
    const int8_t* from = row - delta[r];
    const int nchunks = static_cast<int>((delta[r] + row_bytes + 15) >> 4);
    int8_t* dst = strip + r * rb + 32;
    for (int i = tid; i < nchunks; i += S2D_THREADS) {
      const int8_t* src = from + 16 * i;
      if (src + 16 <= x_end) {
        *reinterpret_cast<int4*>(dst + 16 * i) =
            __ldg(reinterpret_cast<const int4*>(src));
      } else {
        for (int q = 0; q < 4; ++q)
          if (src + 4 * q < x_end)
            *reinterpret_cast<int*>(dst + 16 * i + 4 * q) =
                __ldg(reinterpret_cast<const int*>(src + 4 * q));
      }
    }
  }
  if (tid < S2D_IN_ROWS) {
    // byte offset of pixel iw = -2 of row tid (its 24 bytes of left pad)
    s_row[tid] = tid * rb + 32 + delta[tid] - S2D_PL * S2D_C;
  }
  __syncthreads();
  // zero the padding: rows outside the image whole, the 24 bytes left of a
  // row and everything right of it
  const int words = rb >> 2;
#pragma unroll
  for (int r = 0; r < S2D_IN_ROWS; ++r) {
    const int ih = oh0 - S2D_PT + r;
    int* rw = reinterpret_cast<int*>(strip + r * rb);
    const int first = 32 + delta[r];
    if (static_cast<unsigned>(ih) >= static_cast<unsigned>(p.H)) {
      for (int i = tid; i < words; i += S2D_THREADS) rw[i] = 0;
    } else {
      const int lo = (first - S2D_PL * S2D_C) >> 2, mid = first >> 2;
      const int hi = (first + static_cast<int>(row_bytes)) >> 2;
      for (int i = lo + tid; i < mid; i += S2D_THREADS) rw[i] = 0;
      for (int i = hi + tid; i < words; i += S2D_THREADS) rw[i] = 0;
    }
  }
  __syncthreads();

  for (int j0 = 0; j0 < S2D_ROWS && oh0 + j0 < p.OH; ++j0) {
    // A fragment words: depth k = ks*32 + 4*t4 (+16) is tap row kh = k / 48
    // (a constant divisor) of output row j0, byte k % 48 of its window
    int koff[S2D_K / 32][2];
#pragma unroll
    for (int ks = 0; ks < S2D_K / 32; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = ks * 32 + t4 * 4 + h * 16;
        const int kh = k / S2D_SEG;
        koff[ks][h] = s_row[j0 + kh] + (k - kh * S2D_SEG);
      }
    for (int mt = mh; mt < nmt; mt += 2) {
      int acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;
      const int8_t* r0 = strip + (mt * 16 + g) * S2D_C;
      const int8_t* r1 = r0 + 8 * S2D_C;
#pragma unroll
      for (int ks = 0; ks < S2D_K / 32; ++ks) {
        const unsigned a[4] = {
            *reinterpret_cast<const unsigned*>(r0 + koff[ks][0]),
            *reinterpret_cast<const unsigned*>(r1 + koff[ks][0]),
            *reinterpret_cast<const unsigned*>(r0 + koff[ks][1]),
            *reinterpret_cast<const unsigned*>(r1 + koff[ks][1])};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[j], a, bf[ks][j]);
      }
      if (!direct)
        s2d_stage_floats(p, acc, stg, s_ms, s_b, mt * 16 + g, nh * 32 + t4 * 2);
      else if (exact_rcp)
        s2d_stage_i8<true>(p, acc, stg, s_ms, s_b, mt * 16 + g, nh * 32 + t4 * 2,
                           s_out, r_out);
      else
        s2d_stage_i8<false>(p, acc, stg, s_ms, s_b, mt * 16 + g,
                            nh * 32 + t4 * 2, s_out, r_out);
    }
    __syncthreads();
    const long long row0 = (static_cast<long long>(n) * p.OH + oh0 + j0) * p.OW;
    if (direct) {
      // the output row is OW * 64 contiguous bytes
      int4* dst = reinterpret_cast<int4*>(static_cast<int8_t*>(p.out) + row0 * S2D_O);
      for (int u = tid; u < p.OW * (S2D_O / 16); u += S2D_THREADS) {
        const int r = u >> 2, q = u & 3;
        dst[u] = *reinterpret_cast<const int4*>(
            reinterpret_cast<const uint8_t*>(stg) + r * S2D_I8ROW + q * 16);
      }
    } else {
      store_tile<S2D_O / 16>(p, stg, S2D_SST, p.OW, row0, 0, tid, S2D_THREADS);
    }
    __syncthreads();   // the staged row is free for the next
  }
  }
}

}  // namespace

// The three C entry points take the same arguments: 9 pointers (x, w, m,
// b, s_in, s_out, s_res, res, out; a null scale or residual is unused),
// 18 ints (n, h, w, c, o, kh, kw, sh, sw, pt, pl, oh, ow, kpad, out_kind,
// res_kind, relu, tile) and the stream; `tile` is the body route's BN (64,
// 128 or 256), the simple route's gather width (16, 4 or 1), unused by the
// s2d route. The arrays are read before the call returns. Each returns the
// launch's cudaError_t.
#define GM_CONV_ARGS const void* const* ptr, const int* a, void* stream

static Conv make_conv(const void* const* ptr, const int* a) {
  Conv p;
  p.x = static_cast<const int8_t*>(ptr[0]);
  p.w = static_cast<const int8_t*>(ptr[1]);
  p.m = static_cast<const float*>(ptr[2]);
  p.b = static_cast<const float*>(ptr[3]);
  p.s_in = static_cast<const float*>(ptr[4]);
  p.s_out = static_cast<const float*>(ptr[5]);
  p.s_res = static_cast<const float*>(ptr[6]);
  p.res = ptr[7];
  p.out = const_cast<void*>(ptr[8]);
  p.N = a[0]; p.H = a[1]; p.W = a[2]; p.C = a[3]; p.O = a[4]; p.KH = a[5];
  p.KW = a[6]; p.SH = a[7]; p.SW = a[8]; p.PT = a[9]; p.PL = a[10];
  p.OH = a[11]; p.OW = a[12]; p.Kpad = a[13]; p.K = p.KH * p.KW * p.C;
  p.out_kind = a[14]; p.res_kind = a[15]; p.relu = a[16];
  p.M = static_cast<long long>(p.N) * p.OH * p.OW;
  return p;
}

// route 3: PR 3's kernel
extern "C" int gm_int8_conv(GM_CONV_ARGS) {
  const Conv p = make_conv(ptr, a);
  const int tile = a[17];
  if (p.M <= 0 || p.O <= 0) return 0;
  if (p.Kpad % simple::BK != 0 || p.Kpad < p.K) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>((p.M + simple::BM - 1) / simple::BM),
            (p.O + simple::BN - 1) / simple::BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 16) {
    simple::int8_conv_kernel<16><<<grid, simple::THREADS, 0, st>>>(p);
  } else if (tile == 4) {
    simple::int8_conv_kernel<4><<<grid, simple::THREADS, 0, st>>>(p);
  } else {
    simple::int8_conv_kernel<1><<<grid, simple::THREADS, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
static int launch_body(const Conv& p, cudaStream_t st) {
  constexpr int S = BodyStages<BN>::value;
  constexpr int smem = BodyCfg<BN, S>::SMEM;
  // above 48 KB of shared memory only after this, once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_conv_body<BN, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(static_cast<unsigned>((p.M + BODY_BM - 1) / BODY_BM),
            (p.O + BN - 1) / BN);
  int8_conv_body<BN, S><<<grid, BODY_THREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// route 1
extern "C" int gm_int8_conv_body(GM_CONV_ARGS) {
  const Conv p = make_conv(ptr, a);
  const int tile = a[17];
  if (p.M <= 0 || p.O <= 0) return 0;
  if (p.C % 16 != 0 || p.O % 16 != 0 || p.Kpad % 64 != 0 || p.Kpad < p.K)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 64) return launch_body<64>(p, st);
  if (tile == 128) return launch_body<128>(p, st);
  if (tile == 256) return launch_body<256>(p, st);
  return cudaErrorInvalidValue;
}

// route 2
extern "C" int gm_int8_conv_s2d(GM_CONV_ARGS) {
  const Conv p = make_conv(ptr, a);
  if (p.M <= 0) return 0;
  if (p.C != S2D_C || p.O != S2D_O || p.KH != S2D_TAPS ||
      p.KW != S2D_TAPS || p.SH != 1 || p.SW != 1 || p.PT != S2D_PT ||
      p.PL != S2D_PL || p.OH != p.H || p.OW != p.W || p.Kpad < S2D_K ||
      p.Kpad % 64 != 0)
    return cudaErrorInvalidValue;
  const int smem = s2d_smem(
      p.OW, p.res_kind == RES_NONE && p.out_kind == OUT_I8);
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_conv_s2d, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (smem > 232448) return cudaErrorInvalidValue;
  // a persistent grid: as many blocks as the card holds at once (the
  // occupancy of the last size asked for is kept)
  static int sms = 0, last_smem = -1, per_sm = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (smem != last_smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int8_conv_s2d,
                                                  S2D_THREADS, smem);
    last_smem = smem;
  }
  const long long items =
      static_cast<long long>(p.N) * ((p.OH + S2D_ROWS - 1) / S2D_ROWS);
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  int8_conv_s2d<<<static_cast<unsigned>(items < slots ? items : slots),
                  S2D_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
