// Fused GBRG demosaic at half resolution + per-channel normalize, for sm_90a.
//
// Replaces the Pallas TPU kernel geomapnet_tpu/ops/pallas_image.py
// (demosaic_half_normalize, body _kernel). For each 2x2 Bayer quad
//     row 2y   : G B
//     row 2y+1 : R G
// it writes one pixel: R = the quad's red sample, G = (g0 + g1) * 0.5,
// B = its blue sample, each channel as (v * (1/255) - mean_c) / std_c, in
// f32 or bf16, channel-planar (N, 3, H/2, W/2) or NHWC (N, H/2, W/2, 3).
//
// Bound: device memory. Per quad it reads 4 bytes and writes 3 values
// (12 bytes at f32); there are 4 flops per value and no reuse, so the
// kernel is a streaming copy at about 4x expansion. Design: one thread per
// run of 4 output pixels of one row; it loads 8 bytes of the even and 8 of
// the odd input row (one uint2 each, when the width is a multiple of 8 and
// the mosaic is 8-byte aligned) and, planar, stores 4 values per channel
// plane with one vector store (float4 at f32, 8 bytes at bf16). The ragged
// tail of a row and unaligned inputs take the byte-wise path.
//
// Rounding matches the plain PyTorch version bit for bit: the normalize is
// written with __fmul_rn / __fsub_rn / __fdiv_rn so no multiply-subtract is
// contracted into an FMA, in the JAX order (multiply by the f32 constant
// 1/255, subtract the mean, divide by the std); bf16 is round-to-nearest-even.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (geomapnet_tpu_torch/ops/cuda_image.py does this
//        at first use); plain C entry point, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Norm {
  float mean[3];
  float std[3];
};

// float32(1/255), the constant the JAX kernel multiplies by
constexpr float kInv255 = 0x1.010102p-8f;

__device__ __forceinline__ float normalize(float v, float mean, float std) {
  return __fdiv_rn(__fsub_rn(__fmul_rn(v, kInv255), mean), std);
}

template <typename T>
__device__ __forceinline__ T convert(float v);

template <>
__device__ __forceinline__ float convert<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four values of one channel plane at out[0..3]; out is 16-byte (f32) or
// 8-byte (bf16) aligned on the vector path
__device__ __forceinline__ void store4(float* out, const float* v) {
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, const float* v) {
  __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                         __float2bfloat16_rn(v[1]));
  __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v[2]),
                                         __float2bfloat16_rn(v[3]));
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = packed;
}

template <typename T, bool kPlanar>
__global__ void demosaic_half_normalize_kernel(const uint8_t* __restrict__ raw,
                                               T* __restrict__ out,
                                               int64_t n, int64_t h, int64_t w,
                                               Norm norm, bool vec) {
  const int64_t ho = h / 2, wo = w / 2;
  const int64_t groups = (wo + 3) / 4;  // runs of 4 output pixels per row
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * ho * groups) return;
  const int64_t g = t % groups;
  const int64_t y = (t / groups) % ho;
  const int64_t img = t / (groups * ho);
  const int64_t x0 = g * 4;                     // first output column
  const int count = static_cast<int>(wo - x0 < 4 ? wo - x0 : 4);

  const uint8_t* even = raw + (img * h + 2 * y) * w + 2 * x0;
  const uint8_t* odd = even + w;
  uint8_t e[8], o[8];
  if (vec && count == 4) {
    *reinterpret_cast<uint2*>(e) = *reinterpret_cast<const uint2*>(even);
    *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(odd);
  } else {
    for (int k = 0; k < 2 * count; ++k) {
      e[k] = even[k];
      o[k] = odd[k];
    }
  }

  float r[4], gr[4], b[4];
  for (int k = 0; k < count; ++k) {
    const float g0 = static_cast<float>(e[2 * k]);      // (even row, even col)
    const float bb = static_cast<float>(e[2 * k + 1]);  // (even row, odd col)
    const float rr = static_cast<float>(o[2 * k]);      // (odd row, even col)
    const float g1 = static_cast<float>(o[2 * k + 1]);  // (odd row, odd col)
    r[k] = normalize(rr, norm.mean[0], norm.std[0]);
    gr[k] = normalize(__fmul_rn(__fadd_rn(g0, g1), 0.5f), norm.mean[1],
                      norm.std[1]);
    b[k] = normalize(bb, norm.mean[2], norm.std[2]);
  }

  if (kPlanar) {
    const int64_t plane = ho * wo;
    T* dst = out + img * 3 * plane + y * wo + x0;
    if (vec && count == 4) {
      store4(dst, r);
      store4(dst + plane, gr);
      store4(dst + 2 * plane, b);
    } else {
      for (int k = 0; k < count; ++k) {
        dst[k] = convert<T>(r[k]);
        dst[plane + k] = convert<T>(gr[k]);
        dst[2 * plane + k] = convert<T>(b[k]);
      }
    }
  } else {
    T* dst = out + ((img * ho + y) * wo + x0) * 3;
    for (int k = 0; k < count; ++k) {
      dst[3 * k] = convert<T>(r[k]);
      dst[3 * k + 1] = convert<T>(gr[k]);
      dst[3 * k + 2] = convert<T>(b[k]);
    }
  }
}

template <typename T, bool kPlanar>
void launch(const uint8_t* raw, void* out, int64_t n, int64_t h, int64_t w,
            const Norm& norm, bool vec, cudaStream_t stream) {
  const int64_t threads = n * (h / 2) * ((w / 2 + 3) / 4);
  const int block = 256;
  const int64_t grid = (threads + block - 1) / block;
  demosaic_half_normalize_kernel<T, kPlanar>
      <<<static_cast<unsigned int>(grid), block, 0, stream>>>(
          raw, static_cast<T*>(out), n, h, w, norm, vec);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The caller checks
// shapes, types and contiguity; `vec` is nonzero only when w % 8 == 0 and
// raw is 8-byte aligned.
extern "C" int gm_demosaic_half_normalize(
    const void* raw, void* out, int64_t n, int64_t h, int64_t w,
    float mean0, float mean1, float mean2, float std0, float std1, float std2,
    int out_bf16, int planar, int vec, void* stream) {
  if (n * h * w == 0) return static_cast<int>(cudaSuccess);
  Norm norm = {{mean0, mean1, mean2}, {std0, std1, std2}};
  const uint8_t* src = static_cast<const uint8_t*>(raw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    if (planar)
      launch<__nv_bfloat16, true>(src, out, n, h, w, norm, vec != 0, s);
    else
      launch<__nv_bfloat16, false>(src, out, n, h, w, norm, vec != 0, s);
  } else {
    if (planar)
      launch<float, true>(src, out, n, h, w, norm, vec != 0, s);
    else
      launch<float, false>(src, out, n, h, w, norm, vec != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}
