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
// channels past C and outputs past F are masked: any H, W, C and B work.
// F above 1024 is split over a thread-block cluster of ceil(F / 1024) <= 8
// blocks, each holding an equal slab (<= 1024 channels) of the same 8
// pixels; the LayerNorm meets through distributed shared memory in two
// exchanges, the reference's two passes: the slabs' partial sums give mu,
// then their partial sums of (acc - mu)^2 give var.  F above 8192 is
// refused.  The reference walks C in blocks of 128
// that must divide it; the port masks the last slice instead.  x is
// fp32 or bf16; the filters arrive in fp32.  wgmma for the pointwise
// product is later work.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int MAX_CLUSTER = 8;  // blocks a row of F is split over
constexpr int SLAB = 1024;      // channels a block holds at most
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

// CL: one of a cluster's blocks, owning output channels [f0, f0 + fw)
template <typename T, int NJ, bool CL>
__global__ void __launch_bounds__(NT)
dwconv_block_kernel(const T* __restrict__ x, const float* __restrict__ dw,
                    const float* __restrict__ pw,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ out,
                    int h, int w, int c, int f, int fw, float eps) {
  constexpr int BN = 32 * NJ;
  constexpr int KB = NJ > 16 ? BC / 2 : BC;  // channels a slice: pws 32 KB
  __shared__ float ys[KB][BP];  // depthwise output slice: ys[ch][pixel]
  __shared__ float pws[KB][BN];
  __shared__ float part[2][BP];  // CL: a slab's sum, then sum of squares

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  int tile = blockIdx.x, f0 = 0;
  if constexpr (CL) {
    tile = blockIdx.x / cg::this_cluster().num_blocks();
    f0 = (int)cg::this_cluster().block_rank() * fw;
  }
  const int fend = min(f, f0 + fw);  // this block's channels end
  const int p0 = tile * BP;
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
      pws[r][col] =
          (ch < c && f0 + col < fend) ? pw[(size_t)ch * f + f0 + col] : 0.f;
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

  // LayerNorm over F: each pixel's sum, then its sum of (acc - mu)^2, each
  // within a warp and, for a cluster, over every block's slab
  float mu[TM], inv[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (f0 + lane + 32 * j < fend) sum += acc[i][j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    mu[i] = sum;
    if (CL && lane == 0) part[0][warp * TM + i] = sum;
  }
  if constexpr (CL) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float sum = 0.f;
      for (unsigned r = 0; r < cl.num_blocks(); ++r)
        sum += cl.map_shared_rank(&part[0][0], r)[warp * TM + i];
      mu[i] = sum;
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    mu[i] /= (float)f;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (f0 + lane + 32 * j < fend) {
        const float d = acc[i][j] - mu[i];
        sq += d * d;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    inv[i] = sq;
    if (CL && lane == 0) part[1][warp * TM + i] = sq;
  }
  if constexpr (CL) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float sq = 0.f;
      for (unsigned r = 0; r < cl.num_blocks(); ++r)
        sq += cl.map_shared_rank(&part[1][0], r)[warp * TM + i];
      inv[i] = sq;
    }
    hopper::cluster_arrive();  // this block has read every partial it needs
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = p0 + warp * TM + i;
    inv[i] = rsqrtf(inv[i] / (float)f + eps);
    if (p >= hw) continue;
    T* o_row = out + ((size_t)b * hw + p) * f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = f0 + lane + 32 * j;
      if (col < fend) {
        const float z = (acc[i][j] - mu[i]) * inv[i] * gamma[col] + beta[col];
        o_row[col] = from_f32<T>(fmaxf(z, 0.f));
      }
    }
  }
  // no block leaves while another may read its partials
  if constexpr (CL) hopper::cluster_wait();
}

template <typename T, int NJ>
int launch(const void* x, const float* dw, const float* pw,
           const float* gamma, const float* beta, void* out, int b, int h,
           int w, int c, int f, float eps, cudaStream_t stream) {
  const dim3 grid((h * w + BP - 1) / BP, b);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  dwconv_block_kernel<T, NJ, false><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), dw, pw, gamma, beta, static_cast<T*>(out), h,
      w, c, f, f, eps);
  return (int)cudaGetLastError();
}

// F > SLAB: a cluster of ceil(F / SLAB) blocks per 8 pixels, each holding
// an equal slab of F (a multiple of 32 channels)
template <typename T>
int launch_cluster(const void* x, const float* dw, const float* pw,
                   const float* gamma, const float* beta, void* out, int b,
                   int h, int w, int c, int f, float eps,
                   cudaStream_t stream) {
  const int cs = (f + SLAB - 1) / SLAB;
  const int fw = ((f + cs - 1) / cs + 31) / 32 * 32;
  const long long tiles = (h * (long long)w + BP - 1) / BP;
  if (b > 65535 || tiles * cs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * cs), b);
  cfg.blockDim = dim3(NT);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dwconv_block_kernel<T, 32, true>, static_cast<const T*>(x), dw,
      pw, gamma, beta, static_cast<T*>(out), h, w, c, f, fw, eps);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
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
  if (f <= SLAB)
    return launch<T, 32>(x, dw, pw, gamma, beta, out, b, h, w, c, f, eps, s);
  if (f <= SLAB * MAX_CLUSTER)
    return launch_cluster<T>(x, dw, pw, gamma, beta, out, b, h, w, c, f, eps,
                             s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (b, h+2, w+2, c) pre-padded, contiguous, dtype 0 = float32, 1 =
// bfloat16; dw (3, 3, c), pw (c, f), gamma and beta (f,) fp32; out
// (b, h, w, f) in x's dtype; f <= 8192.  Returns the launch's cudaError_t.
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
