// Fused FC + row softmax on Hopper (sm_90a): out = softmax(X @ W + b).
//
// Replaces: repro/kernels/fc_softmax.py::fc_softmax (_fc_softmax_kernel),
// the paper's FC block (Sec. V-C, Fig. 9): (M, K) @ (K, N) accumulated in
// fp32, + b, then a softmax over the whole output row (z - max, exp,
// p / sum) before the tile leaves the chip, stored in X's dtype.
//
// What bounds it: operations.  The paper's 512 x 512 x 512 block is 268
// MFLOP (4.0 us at the card's 67 TFLOP/s fp32 outside the tensor cores)
// against 3.1 MB of fp32 operands and output (0.9 us of HBM time).
//
// Design: the row softmax needs the whole row in one block, so a block
// owns BM = 8 rows and all N columns: 4 warps, each owning 2 rows, each
// lane owning the columns lane, lane + 32, ..., lane + 32 * (NJ - 1) of
// them, so a row's N values lie in one warp's registers (NJ = 16 gives
// N <= 512, 32 fp32 accumulators a thread).  K is walked in slices of 16
// through shared memory (X slice transposed, W slice 16 x 32 * NJ, up to
// 32 KB); lanes read consecutive W columns (no bank conflicts) and one
// broadcast X value per row.  No tensor cores, hence no TF32: the
// reference accumulates in full fp32.  After the last slice each warp
// adds the bias, takes the row max and the sum of exp by shuffles, and
// stores p / sum once.  Columns past N and rows past M are masked, so
// any M and K work; N above 512 is refused.  A wider N needs the row
// split over blocks (a two-pass softmax), and wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 4;
constexpr int TM = 2;  // rows per warp
constexpr int BM = WARPS * TM;
constexpr int BK = 16;
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
fc_softmax_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int m,
                  int n, int k) {
  constexpr int BN = 32 * NJ;
  __shared__ float xs[BK][BM];  // X slice, transposed: xs[kk][row]
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * BM;

  float acc[TM][NJ];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gr = m0 + r, gc = k0 + c;
      xs[c][r] = (gr < m && gc < k) ? to_f32(x[(size_t)gr * k + gc]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r;
      ws[r][c] = (gr < k && c < n) ? to_f32(w[(size_t)gr * n + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][warp * TM + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float b = ws[kk][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] += a[i] * b;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + warp * TM + i;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      float z = -CUDART_INF_F;  // past the row: not part of the softmax
      if (col < n) z = acc[i][j] + (bias != nullptr ? bias[col] : 0.f);
      acc[i][j] = z;
      mx = fmaxf(mx, z);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float e = (lane + 32 * j < n) ? expf(acc[i][j] - mx) : 0.f;
      acc[i][j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      if (col < n) out[(size_t)row * n + col] = from_f32<T>(acc[i][j] / sum);
    }
  }
}

template <typename T, int NJ>
int launch(const void* x, const void* w, const float* bias, void* out, int m,
           int n, int k, cudaStream_t stream) {
  const unsigned grid = (m + BM - 1) / BM;
  fc_softmax_kernel<T, NJ><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(out), m, n, k);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const float* bias, void* out,
             int m, int n, int k, cudaStream_t s) {
  if (n <= 128) return launch<T, 4>(x, w, bias, out, m, n, k, s);
  if (n <= 256) return launch<T, 8>(x, w, bias, out, m, n, k, s);
  if (n <= 512) return launch<T, 16>(x, w, bias, out, m, n, k, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (m, k), w (k, n), out (m, n), row-major and of one dtype: dtype 0 =
// float32, 1 = bfloat16; bias (n,) fp32 or null; n <= 512.  Returns the
// launch's cudaError_t.
extern "C" int fc_softmax_launch(const void* x, const void* w,
                                 const void* bias, void* out, int m, int n,
                                 int k, int dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return dispatch<float>(x, w, b, out, m, n, k, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, w, b, out, m, n, k, s);
  return (int)cudaErrorInvalidValue;
}
