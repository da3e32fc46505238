// TE GEMM with a fused epilogue on Hopper (sm_90a): out = epi(X @ W + b).
//
// Replaces: repro/kernels/te_gemm.py::te_gemm (_te_gemm_kernel), the
// paper's RedMulE tensor engine: (M, K) @ (K, N) with an fp32 accumulator,
// + bias, then none / relu / silu / row-softmax, stored in X's dtype.
//
// What bounds it: on the neural receivers' shapes, bytes.  DeepRx's block
// conv (M = 28,672 im2col rows, K = 288, N = 32) is 0.53 GFLOP against
// ~37 MB of fp32 operands: about 11 us of HBM time and 8 us of fp32 FMA
// time at the card's 67 TFLOP/s.  CE-ViT's GEMMs (M = 512, K and N <= 192)
// are a few microseconds of work and so bound by the launch.
//
// Design: a plain tiled SIMT GEMM, full fp32 on the CUDA cores (no tensor
// cores, hence no TF32: the reference accumulates in full fp32).  A block
// owns a BM x BN output tile; K is walked in slices of 16, each slice of
// X (stored transposed) and of W staged through shared memory, and each
// thread keeps a 4 x 4 register micro-tile of accumulators.  Every load
// and store is masked, so any M, N, K works (K = 54, N = 2 included) with
// no padding of the operands.  Bias and the epilogue are applied to the
// registers before the single store; for the row-softmax the tile goes
// through shared memory and one thread per row takes max, exp and sum, so
// the block must hold the whole row (N <= BN, the widest instance being
// 256).  Operands are fp32 or bf16 (converted to fp32 on the way into
// shared memory); the output is rounded once, to X's dtype.  Instances:
// BN = 32 for N <= 32 (DeepRx's convs), 64 otherwise, and 16 x 256 tiles
// for a softmax row wider than 64.  FMA contraction is allowed in this
// source (the product is not claimed bit-exact against cuBLAS), so the
// kernel holds its plain twin to rtol 1e-4 in fp32.  wgmma, TMA and an
// implicit-GEMM conv that never writes the im2col plane are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;

enum Epilogue { kNone = 0, kRelu = 1, kSilu = 2, kSoftmax = 3 };

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

template <typename T, int BM, int BN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
te_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ bias, T* __restrict__ out, int m, int n,
               int k, int epilogue) {
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ float xs[BK][BM];  // X slice, transposed: xs[kk][row]
  __shared__ float ws[BK][BN];
  __shared__ float cs[BM][BN + 1];  // the tile, for the row-softmax

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gr = m0 + r, gc = k0 + c;
      xs[c][r] = (gr < m && gc < k) ? to_f32(x[(size_t)gr * k + gc]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = n0 + c;
      ws[r][c] = (gr < k && gc < n) ? to_f32(w[(size_t)gr * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + tx * TN + j;
    const float bv = (bias != nullptr && col < n) ? to_f32(bias[col]) : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v = acc[i][j] + bv;
      if (epilogue == kRelu) {
        v = fmaxf(v, 0.f);
      } else if (epilogue == kSilu) {
        v = v * (1.f / (1.f + expf(-v)));
      }
      acc[i][j] = v;
    }
  }

  if (epilogue == kSoftmax) {  // gridDim.x == 1: the block holds each row
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) cs[ty * TM + i][tx * TN + j] = acc[i][j];
    __syncthreads();
    for (int r = tid; r < BM; r += NT) {
      float mx = -CUDART_INF_F;
      for (int c = 0; c < n; ++c) mx = fmaxf(mx, cs[r][c]);
      float sum = 0.f;
      for (int c = 0; c < n; ++c) {
        const float e = expf(cs[r][c] - mx);
        cs[r][c] = e;
        sum += e;
      }
      const float inv = 1.f / sum;
      for (int c = 0; c < n; ++c) cs[r][c] *= inv;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = cs[ty * TM + i][tx * TN + j];
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col < n) out[(size_t)row * n + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN>
int launch(const void* x, const void* w, const void* bias, void* out, int m,
           int n, int k, int epilogue, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  te_gemm_kernel<T, BM, BN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), m, n, k, epilogue);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const void* bias, void* out,
             int m, int n, int k, int epilogue, cudaStream_t stream) {
  if (epilogue == kSoftmax) {
    if (n <= 32) return launch<T, 64, 32>(x, w, bias, out, m, n, k, epilogue, stream);
    if (n <= 64) return launch<T, 64, 64>(x, w, bias, out, m, n, k, epilogue, stream);
    if (n <= 256) return launch<T, 16, 256>(x, w, bias, out, m, n, k, epilogue, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 32) return launch<T, 64, 32>(x, w, bias, out, m, n, k, epilogue, stream);
  return launch<T, 64, 64>(x, w, bias, out, m, n, k, epilogue, stream);
}

}  // namespace

// x (m, k), w (k, n), bias (n,) or null, out (m, n), all row-major and of
// one dtype: dtype 0 = float32, 1 = bfloat16.  epilogue: 0 none, 1 relu,
// 2 silu, 3 row-softmax (n <= 256).  Returns the launch's cudaError_t.
extern "C" int te_gemm_launch(const void* x, const void* w, const void* bias,
                              void* out, int m, int n, int k, int epilogue,
                              int dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || epilogue < 0 || epilogue > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(x, w, bias, out, m, n, k, epilogue, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, bias, out, m, n, k, epilogue, s);
  return (int)cudaErrorInvalidValue;
}
