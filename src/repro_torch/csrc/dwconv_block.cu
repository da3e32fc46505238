// Fused depthwise-separable conv block on Hopper (sm_90a): depthwise 3x3
// -> pointwise 1x1 (a GEMM over channels) -> LayerNorm over F -> gamma /
// beta -> ReLU, with the intermediate planes never in device memory.
//
// Replaces: repro/kernels/dwconv_block.py::dwconv_block (_dwconv_kernel),
// the paper's depthwise-separable block (Sec. V-C, Fig. 9): x pre-padded
// (B, H+2, W+2, C), dw (3, 3, C), pw (C, F), gamma and beta (F,), out
// (B, H, W, F) in x's dtype; LayerNorm as the reference's, mean over F,
// var = mean((acc - mu)^2), (acc - mu) * rsqrt(var + eps).
//
// What bounds it: operations.  The paper's block (H = 32, W = 16,
// C = F = 512, batch 1) is 268 MFLOP of pointwise GEMM and 4.7 MFLOP of
// depthwise stencil (4.1 us at 67 TFLOP/s fp32) against 3.2 MB of
// operands and output (0.9 us of HBM time).
//
// Design: a block owns BP = 8 output pixels of one image and all F
// output channels: 4 warps, each owning 2 pixels, each lane owning the
// channels lane, lane + 32, ..., lane + 32 * (NJ - 1), so a pixel's F
// accumulators lie in one warp's registers (NJ = 16: F <= 512, 32 fp32
// accumulators a thread; NJ = 32: F <= 1024, 64).  C is walked in slices
// of BC = 16 channels (8 for NJ = 32):
// the block's threads first compute the depthwise 3x3 of the slice (one
// (pixel, channel) each, 9 taps in the reference's order) into a
// (BC x BP) plane in shared memory, stage the (BC x F) slice of pw
// beside it (up to 32 KB), and then every lane accumulates the pointwise
// product into its registers.  After the last slice each warp takes the
// mean and the variance of each pixel's F values by shuffles, normalises,
// applies gamma / beta and ReLU, and stores once.  Pixels past H*W,
// channels past C and outputs past F are masked: any H, W, C and B work,
// and F above 1024 is refused.  The reference walks C in blocks of 128
// that must divide it; the port masks the last slice instead.  x is
// fp32 or bf16; the filters arrive in fp32.  wgmma for the pointwise
// product is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int TM = 2;  // pixels per warp
constexpr int BP = WARPS * TM;
constexpr int BC = 16;
constexpr int NT = WARPS * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(NT)
dwconv_block_kernel(const T* __restrict__ x, const float* __restrict__ dw,
                    const float* __restrict__ pw,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ out,
                    int h, int w, int c, int f, float eps) {
  constexpr int BN = 32 * NJ;
  constexpr int KB = NJ > 16 ? BC / 2 : BC;  // channels a slice: pws 32 KB
  __shared__ float ys[KB][BP];  // depthwise output slice: ys[ch][pixel]
  __shared__ float pws[KB][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * BP;
  const int hw = h * w;
  const int wp = w + 2;
  const T* xb = x + (size_t)b * (h + 2) * wp * c;

  float acc[TM][NJ];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < c; c0 += KB) {
    for (int i = tid; i < BP * KB; i += NT) {
      const int cc = i % KB, pp = i / KB;
      const int p = p0 + pp, ch = c0 + cc;
      float y = 0.f;
      if (p < hw && ch < c) {
        const int hh = p / w, ww = p % w;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
            y += to_f32(xb[((size_t)(hh + di) * wp + ww + dj) * c + ch]) *
                 dw[(di * 3 + dj) * c + ch];
      }
      ys[cc][pp] = y;
    }
    for (int i = tid; i < KB * BN; i += NT) {
      const int r = i / BN, col = i % BN;
      const int ch = c0 + r;
      pws[r][col] = (ch < c && col < f) ? pw[(size_t)ch * f + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ys[kk][warp * TM + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float pv = pws[kk][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] += a[i] * pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = p0 + warp * TM + i;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (lane + 32 * j < f) sum += acc[i][j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum / (float)f;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (lane + 32 * j < f) {
        const float d = acc[i][j] - mu;
        sq += d * d;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float inv = rsqrtf(sq / (float)f + eps);
    if (p >= hw) continue;
    T* o_row = out + ((size_t)b * hw + p) * f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      if (col < f) {
        const float z = (acc[i][j] - mu) * inv * gamma[col] + beta[col];
        o_row[col] = from_f32<T>(fmaxf(z, 0.f));
      }
    }
  }
}

template <typename T, int NJ>
int launch(const void* x, const float* dw, const float* pw,
           const float* gamma, const float* beta, void* out, int b, int h,
           int w, int c, int f, float eps, cudaStream_t stream) {
  const dim3 grid((h * w + BP - 1) / BP, b);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  dwconv_block_kernel<T, NJ><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), dw, pw, gamma, beta, static_cast<T*>(out), h,
      w, c, f, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* dw, const float* pw,
             const float* gamma, const float* beta, void* out, int b, int h,
             int w, int c, int f, float eps, cudaStream_t s) {
  if (f <= 128)
    return launch<T, 4>(x, dw, pw, gamma, beta, out, b, h, w, c, f, eps, s);
  if (f <= 256)
    return launch<T, 8>(x, dw, pw, gamma, beta, out, b, h, w, c, f, eps, s);
  if (f <= 512)
    return launch<T, 16>(x, dw, pw, gamma, beta, out, b, h, w, c, f, eps, s);
  if (f <= 1024)
    return launch<T, 32>(x, dw, pw, gamma, beta, out, b, h, w, c, f, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (b, h+2, w+2, c) pre-padded, contiguous, dtype 0 = float32, 1 =
// bfloat16; dw (3, 3, c), pw (c, f), gamma and beta (f,) fp32; out
// (b, h, w, f) in x's dtype; f <= 1024.  Returns the launch's cudaError_t.
extern "C" int dwconv_block_launch(const void* x, const void* dw,
                                   const void* pw, const void* gamma,
                                   const void* beta, void* out, int b, int h,
                                   int w, int c, int f, float eps, int dtype,
                                   void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || f <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* d = static_cast<const float*>(dw);
  const float* p = static_cast<const float*>(pw);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (dtype == 0)
    return dispatch<float>(x, d, p, g, be, out, b, h, w, c, f, eps, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, d, p, g, be, out, b, h, w, c, f, eps,
                                   s);
  return (int)cudaErrorInvalidValue;
}
