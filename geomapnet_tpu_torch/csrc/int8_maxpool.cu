// 3x3 stride-2 max-pool over NHWC int8, padding 1 filled with -127, for
// sm_90a.
//
// Replaces the XLA lowering of lax.reduce_window(max, init -127) in
// geomapnet_tpu/models/quant.py::_trunk_forward_fused (quant.py:429-432):
// the stem's pool runs on the int8 requantized activation (max commutes
// with the monotone quantization). PyTorch's CUDA max-pool is not known to
// take int8.
//
// Bound: device memory. Per output it reads a 3x3 window of a
// stride-2 input (each input byte about 2.25 times, mostly from L1/L2) and
// writes one byte; the least traffic is the input read once plus the
// output written once. Design: one thread per 16 channels of one output
// pixel; each of the up to 9 window taps is one 16-byte load, reduced with
// the byte-wise signed max __vmaxs4; one 16-byte store. The padding never
// wins: every real value is >= -127, the pad value.
//
// Build: as int8_conv.cu (geomapnet_tpu_torch/ops/_nvcc.py); plain C entry
// point, bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void int8_maxpool3x3s2_kernel(const int8_t* __restrict__ x,
                                         int8_t* __restrict__ y, int n,
                                         int h, int w, int c, int oh,
                                         int ow) {
  const int groups = c / 16;
  const long long total = (long long)n * oh * ow * groups;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int cg = static_cast<int>(t % groups);
  long long p = t / groups;
  const int ox = static_cast<int>(p % ow);
  p /= ow;
  const int oy = static_cast<int>(p % oh);
  const long long img = p / oh;
  const unsigned pad = 0x81818181u;  // -127 in every byte
  uint4 best = make_uint4(pad, pad, pad, pad);
  for (int dy = 0; dy < 3; ++dy) {
    int iy = oy * 2 - 1 + dy;
    if (iy < 0 || iy >= h) continue;
    for (int dx = 0; dx < 3; ++dx) {
      int ix = ox * 2 - 1 + dx;
      if (ix < 0 || ix >= w) continue;
      uint4 v = *reinterpret_cast<const uint4*>(
          x + ((img * h + iy) * w + ix) * c + cg * 16);
      best.x = __vmaxs4(best.x, v.x);
      best.y = __vmaxs4(best.y, v.y);
      best.z = __vmaxs4(best.z, v.z);
      best.w = __vmaxs4(best.w, v.w);
    }
  }
  *reinterpret_cast<uint4*>(y + ((img * oh + oy) * ow + ox) * c + cg * 16) =
      best;
}

}  // namespace

extern "C" int gm_int8_maxpool3x3s2(const void* x, void* y, int n, int h,
                                    int w, int c, int oh, int ow,
                                    void* stream) {
  if (c % 16 != 0) return cudaErrorInvalidValue;
  long long total = (long long)n * oh * ow * (c / 16);
  if (total <= 0) return 0;
  const int threads = 256;
  unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  int8_maxpool3x3s2_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(y), n, h, w, c, oh,
      ow);
  return static_cast<int>(cudaGetLastError());
}
