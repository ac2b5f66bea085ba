// One-layer LSTM over a whole window as one persistent kernel, for sm_90a:
// every step of both directions in one launch, each CTA's rows of W_hh
// held in registers for all T steps and its rows of the window's input
// projection in shared memory.
//
// Replaces cuDNN's standard RNN (torch.lstm) as the CUDA body of the
// geomapnet::lstm operator (geomapnet_tpu_torch/ops/library.py), the
// recurrence of a VidLoc streaming session. There is no TPU kernel behind
// it: the JAX package's LSTM is Flax's nn.RNN, which XLA lowers to a loop
// of matmuls. cuDNN's path launches a GEMV and a cell kernel per step and
// direction (4 T launches a window) and reads the direction's whole W_hh
// (4.2 MB at H = 512) from L2 again at every step.
//
// Bound: latency. A direction's work is T x 4H x (F + H) multiply-adds
// (1.68 GFLOP for both directions at T = 200, H = F = 512: 25 us at the
// card's 67 TFLOP/s float32), but step t needs every unit's h_{t-1}, so the
// floor is T dependent exchanges of h between the CTAs of a direction,
// each at least one round trip through L2.
//
// Design:
//  - grid D x H/U CTAs, U warps a CTA and one a unit, launched
//    cooperatively so that every CTA is resident: they wait on each other;
//  - prologue: the CTA computes x_t W_ih^T of its units' 4U gate rows
//    (gates i, f, g, o) for every t into shared memory (T x 4U floats,
//    25.6 KB at T = 200, U = 8), 32 features at a time: each thread holds
//    32 weights of a row in registers and sums them against x's 32
//    columns, staged in shared memory for all T (another 25.6 KB). So F is
//    not bounded and no step waits on the input projection (a warp's 4
//    rows of W_ih held in registers beside W_hh, its dot product in each
//    step, took 0.26 instead of 0.29-0.30 ms a window on an H100, but
//    bound F by 512);
//  - then each warp loads its unit's 4 rows of W_hh into registers, each
//    lane 16 floats a row (so H <= 512): rows read from shared memory every
//    step cost a CTA's bandwidth on the critical path (with W_ih's rows
//    there too, 0.372 against 0.322 ms a window on an H100);
//  - step i (forward t = i, backward t = T - 1 - i): each thread spins on
//    its pair of the direction's exchange words of h_{i-1} and puts them
//    into shared memory; after one barrier each warp reduces its unit's
//    recurrent dot products (6 shuffles leave each 8 lanes with one gate's
//    sum), each lane adds its gate's input projection and applies the
//    gate's function, every lane gathers the four (c stays in a register)
//    and lane 0 writes h_t to the output and to the exchange. Nothing
//    stands between a CTA's write and its next spin, so no poll waits
//    behind arithmetic;
//  - exchange: h_t is published as 64-bit words (value, i + 1), one a
//    unit, in two slots by step parity; a thread reads its two words until
//    both tags read the step it waits for. Value and flag travel in one
//    store, so a step costs one L2 round trip and no fence or atomic. A
//    slot is written again two steps later, after every CTA of the
//    direction has read it (none could have written h_{i+1} before). The
//    caller zeroes the slots before each launch (tag 0: not written);
//  - determinism: a fixed reduction order and no atomics, so two launches
//    give the same bits, eager or replayed from a CUDA graph.
//
// Float32 on CUDA cores: no TF32, expf and tanhf (no fast-math
// intrinsics); multiply-adds are explicit fmaf. The plain PyTorch version
// (geomapnet_tpu_torch/ops/cuda_rnn.py::lstm_reference) computes the same
// equations, with sums in another order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (geomapnet_tpu_torch/ops/cuda_rnn.py does this at
//        first use); a plain C entry point, bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads a CTA: at most 8 units, a warp each
constexpr int kMaxThreads = 32 * 8;
// float4s of a row of W_hh a lane holds: H <= kWidth
constexpr int kChunks = 4;
constexpr int kWidth = 128 * kChunks;
// features of x a step of the prologue stages and a thread's W_ih holds
constexpr int kStage = 32;
// polls before the kernel gives up on a CTA that never writes (a deadlock
// traps instead of hanging the card): seconds, where a step takes about a
// microsecond
constexpr long long kSpinLimit = 1ll << 24;

struct Direction {
  const float* w_ih;  // (4H, F)
  const float* w_hh;  // (4H, H)
  const float* b_ih;  // (4H)
  const float* b_hh;  // (4H)
};

struct Args {
  Direction dir[2];
  const float* x;            // (T, F)
  float* out;                // (T, D * H)
  unsigned long long* xch;   // (D, 2, H) exchange words, zeroed
  int T, F, H, D, U;
};

// two exchange words; volatile, so every poll reads L2 and not a copy
__device__ __forceinline__ void load_words(const unsigned long long* p,
                                           unsigned long long& a,
                                           unsigned long long& b) {
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(a), "=l"(b)
               : "l"(p)
               : "memory");
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.volatile.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned tag(unsigned long long w) {
  return static_cast<unsigned>(w >> 32);
}

__device__ __forceinline__ float value(unsigned long long w) {
  return __uint_as_float(static_cast<unsigned>(w));
}

// lane l's part of a row of n floats: v[m] = row[4l + 128m, +4), zeros
// past n
__device__ __forceinline__ void load_row(float4 (&v)[kChunks],
                                         const float* row, int n, int lane) {
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const int k = 4 * lane + 128 * m;
    v[m] = k < n ? __ldg(reinterpret_cast<const float4*>(row + k))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// the warp's partial sums of its four gate rows (acc[g] in every lane)
// reduced so that lane l ends with the whole sum of gate (l >> 3) & 3: the
// lanes trade halves of what they hold (xor 16, then 8), then a butterfly
// over the 8 lanes of a gate, which all end with the same bits (a + b ==
// b + a). 6 shuffles, where a butterfly a gate takes 20.
__device__ __forceinline__ float gate_sum(const float acc[4], int lane) {
  const bool hi = lane & 16, mid = lane & 8;
  float k0 = hi ? acc[2] : acc[0], k1 = hi ? acc[3] : acc[1];
  k0 += __shfl_xor_sync(0xffffffffu, hi ? acc[0] : acc[2], 16);
  k1 += __shfl_xor_sync(0xffffffffu, hi ? acc[1] : acc[3], 16);
  float v = mid ? k1 : k0;
  v += __shfl_xor_sync(0xffffffffu, mid ? k0 : k1, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum_k w_g[k] v[k] of the lane's gate (gate_sum) over the warp's four
// gate rows, w[g] and v as load_row gives them; even and odd chunks in two
// sums a gate
__device__ __forceinline__ float gate_dot(const float4 (&w)[4][kChunks],
                                          const float4 (&v)[kChunks],
                                          int lane) {
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    float* a = acc[m & 1];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      a[g] = fmaf(w[g][m].x, v[m].x, a[g]);
      a[g] = fmaf(w[g][m].y, v[m].y, a[g]);
      a[g] = fmaf(w[g][m].z, v[m].z, a[g]);
      a[g] = fmaf(w[g][m].w, v[m].w, a[g]);
    }
  }
  float sum[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) sum[g] = acc[0][g] + acc[1][g];
  return gate_sum(sum, lane);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    lstm_persistent_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int T = a.T, F = a.F, H = a.H, U = a.U;
  const int ctas = H / U;  // a direction's
  const int dir = blockIdx.x / ctas;
  const int unit0 = (blockIdx.x - dir * ctas) * U;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int j = unit0 + warp;
  const Direction d = a.dir[dir];
  unsigned long long* xch = a.xch + (size_t)dir * 2 * H;

  // h_{i-1} by step parity, (2, kWidth), zero past H
  float* hbuf = reinterpret_cast<float*>(smem4);
  for (int q = tid; q < 2 * kWidth; q += nthreads) hbuf[q] = 0.f;
  // the lane's gate after gate_sum: i, f, g, o in lanes 0-7, 8-15, ...
  const int gate = (lane >> 3) & 3;
  // prologue: x_t W_ih^T of the CTA's 4U rows (row 4w + g: unit
  // unit0 + w, gate g), (T, 4U), 32 features at a time; thread tid holds
  // row tid % 4U's 32 weights and sums it at t = tid / 4U, + 8, + 16, ...
  // against x's 32 columns, staged in shared memory (T, 32)
  const int R = 4 * U;
  float* xw = hbuf + 2 * kWidth;
  float4* xs = reinterpret_cast<float4*>(xw + (size_t)T * R);
  const int row = tid % R;
  const float* w_row =
      d.w_ih + (size_t)((row & 3) * H + unit0 + (row >> 2)) * F;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int f0 = 0; f0 < F; f0 += kStage) {
    float4 w[kStage / 4];
#pragma unroll
    for (int c = 0; c < kStage / 4; ++c)
      w[c] = f0 + 4 * c < F ? __ldg(reinterpret_cast<const float4*>(
                                  w_row + f0 + 4 * c))
                            : zero;
    for (int q = tid; q < T * (kStage / 4); q += nthreads) {
      const int t = q / (kStage / 4), c = q % (kStage / 4);
      xs[q] = f0 + 4 * c < F ? __ldg(reinterpret_cast<const float4*>(
                                   a.x + (size_t)t * F + f0 + 4 * c))
                             : zero;
    }
    __syncthreads();
    for (int t = tid / R; t < T; t += nthreads / R) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kStage / 4; ++c) {
        const float4 v = xs[t * (kStage / 4) + c];
        float& sum = acc[c & 3];
        sum = fmaf(w[c].x, v.x, sum);
        sum = fmaf(w[c].y, v.y, sum);
        sum = fmaf(w[c].z, v.z, sum);
        sum = fmaf(w[c].w, v.w, sum);
      }
      const float part = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      float* p = xw + t * R + row;
      *p = f0 == 0 ? part : *p + part;
    }
    __syncthreads();  // xs is staged again
  }
  float4 whh[4][kChunks];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    load_row(whh[g], d.w_hh + (size_t)(g * H + j) * H, H, lane);
  const float b_hh = d.b_hh[gate * H + j], b_ih = d.b_ih[gate * H + j];
  const int DH = a.D * H;
  __syncthreads();

  float c = 0.f;
  for (int i = 0; i < T; ++i) {
    const int t = dir == 0 ? i : T - 1 - i;
    const float px = xw[t * R + warp * 4 + gate];
    float* h_prev = hbuf + ((i - 1) & 1) * kWidth;
    if (i > 0) {
      const unsigned want = static_cast<unsigned>(i);
      const unsigned long long* slot = xch + (size_t)((i - 1) & 1) * H;
      for (int p = tid; 2 * p < H; p += nthreads) {
        unsigned long long w0, w1;
        long long spins = 0;
        do {
          if (++spins > kSpinLimit) __trap();
          load_words(slot + 2 * p, w0, w1);
        } while (tag(w0) != want || tag(w1) != want);
        reinterpret_cast<float2*>(h_prev)[p] =
            make_float2(value(w0), value(w1));
      }
      __syncthreads();  // h_{i-1} is in shared memory
    }
    float ph = 0.f;
    if (i > 0) {
      float4 hv[kChunks];
#pragma unroll
      for (int m = 0; m < kChunks; ++m)
        hv[m] = *reinterpret_cast<const float4*>(h_prev + 4 * lane + 128 * m);
      ph = gate_dot(whh, hv, lane);
    }
    // PyTorch's cell: (h W_hh^T + b_hh) + (x W_ih^T + b_ih), gates i, f, g,
    // o; each lane applies its gate's function, then every lane takes all
    // four
    const float pre = (ph + b_hh) + (px + b_ih);
    const float act = gate == 2 ? tanhf(pre) : sigmoid(pre);
    const float gi = __shfl_sync(0xffffffffu, act, 0);
    const float gf = __shfl_sync(0xffffffffu, act, 8);
    const float gg = __shfl_sync(0xffffffffu, act, 16);
    const float go = __shfl_sync(0xffffffffu, act, 24);
    c = fmaf(gf, c, gi * gg);
    const float h = go * tanhf(c);
    if (lane == 0) {
      a.out[(size_t)t * DH + dir * H + j] = h;
      store_word(xch + (size_t)(i & 1) * H + j,
                 (static_cast<unsigned long long>(i + 1) << 32) |
                     __float_as_uint(h));
    }
  }
}

}  // namespace

extern "C" {

// out (T, D*H) of one sequence x (T, F): direction k's weights are
// w_ih[k] (4H, F), w_hh[k] (4H, H), b_ih[k], b_hh[k] (4H); xch holds
// D * 2 * H zeroed 64-bit words; U units (warps) a CTA (H % U == 0, U <= 8;
// H <= 512; H, F multiples of 4), so the grid is D * H / U CTAs, each with
// (2 * 512 + (4 * U + 32) * T) floats of shared memory. Returns a
// cudaError_t.
int gm_lstm_persistent(const float* x, const float* w_ih0, const float* w_hh0,
                       const float* b_ih0, const float* b_hh0,
                       const float* w_ih1, const float* w_hh1,
                       const float* b_ih1, const float* b_hh1, float* out,
                       unsigned long long* xch, int T, int F, int H, int D,
                       int U, void* stream) {
  Args a;
  a.dir[0] = Direction{w_ih0, w_hh0, b_ih0, b_hh0};
  a.dir[1] = Direction{w_ih1, w_hh1, b_ih1, b_hh1};
  a.x = x;
  a.out = out;
  a.xch = xch;
  a.T = T;
  a.F = F;
  a.H = H;
  a.D = D;
  a.U = U;
  const size_t smem =
      (2 * kWidth + (size_t)(4 * U + kStage) * T) * sizeof(float);
  cudaError_t err = cudaSuccess;
  // above the default 48 KB of dynamic shared memory a kernel opts in (a
  // window of T > 176 at U = 8)
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(lstm_persistent_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D * (H / U));
  cfg.blockDim = dim3(32 * U);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lstm_persistent_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
