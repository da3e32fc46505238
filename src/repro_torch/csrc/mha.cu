// Flash multi-head attention on Hopper (sm_90a).
//
// Replaces: repro/kernels/mha.py::mha (_mha_kernel), the paper's MHA block:
// q, k, v (BH, S, D), scores q * D^-0.5 @ k^T with an optional causal mask
// (q_pos >= k_pos on absolute positions, -1e30 fill), online softmax in
// fp32 over key tiles, out = acc / max(l, 1e-30), in q's dtype.
//
// What bounds it: on CE-ViT's shape (BH = 32, S = 64, D = 16) it moves
// 0.5 MB and does 8.4 MFLOP (0.16 us of HBM time, 0.13 us at the card's
// 67 TFLOP/s fp32), so in practice the launch; at (16, 256, 64) it is
// 0.27 GFLOP against 4.2 MB, so fp32 operations (4.0 us vs 1.3 us).
//
// Design: one block per (bh, 64-row query tile; 32 rows at D = 256); grid
// (BH, ceil(Sq/64)).
// TPR = max(1, D/32) adjacent threads own one query row, each holding
// D/TPR of its dims of q (pre-scaled, as the reference does) and of the
// fp32 output accumulator in registers; a score's partial dot products
// meet through warp shuffles, so every thread of a row holds the whole
// score tile.  K and V tiles (64 keys, 32 for D = 128; 32 KB together)
// are staged through shared memory, where all threads of a warp read the
// same key row (a broadcast).  Per tile, as the reference: the tile's max
// against the running max, p = exp(s - m_new), corr = exp(m - m_new),
// l = l * corr + sum(p), acc = acc * corr + p @ V.  Keys past Sk (a ragged
// last tile) are left out of the softmax; with the causal mask, key tiles
// wholly after the query tile are skipped, which changes nothing (each of
// their p is exactly 0 and their corr exactly 1 in the reference).
// Instances: D in {16, 32, 64, 128, 256}, fp32 and bf16 (loaded as fp32);
// the wrapper zero-pads any other D <= 256 to the next one and passes the
// true D's scale, so the padded dims add nothing to a score.  D = 256
// takes 16-key tiles (32 KB of K and V) and 32-row query tiles (256
// threads, so a thread may hold 255 registers: no spill).
// wgmma for QK^T and PV is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kMaskFill = -1e30f;

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

template <int D>
struct Shape {
  static constexpr int TPR = D <= 32 ? 1 : D / 32;  // threads per row
  static constexpr int DT = D / TPR;                // dims per thread
  // keys per tile
  static constexpr int BKV = D <= 64 ? 64 : (D <= 128 ? 32 : 16);
  // query rows a block: 32 at D = 256, so 256 threads of 255 registers
  // hold a row's 32 dims of q and of the accumulator with no spill
  static constexpr int BQ = D > 128 ? 32 : 64;
  static constexpr int NT = BQ * TPR;
};

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::NT)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
           int causal, float scale) {
  using S = Shape<D>;
  __shared__ float ks[S::BKV][D];
  __shared__ float vs[S::BKV][D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * S::BQ;
  const int row = threadIdx.x / S::TPR;
  const int d0 = (threadIdx.x % S::TPR) * S::DT;
  const int q_pos = q0 + row;
  const bool live = q_pos < sq;

  float qr[S::DT], acc[S::DT];
#pragma unroll
  for (int d = 0; d < S::DT; ++d) {
    qr[d] = live ? to_f32(q[((size_t)bh * sq + q_pos) * D + d0 + d]) * scale
                 : 0.f;
    acc[d] = 0.f;
  }
  float m = kMaskFill, l = 0.f;

  const int kv_end = causal ? min(sk, q0 + S::BQ) : sk;
  for (int kv0 = 0; kv0 < kv_end; kv0 += S::BKV) {
    for (int i = threadIdx.x; i < S::BKV * D; i += S::NT) {
      const int j = i / D, d = i % D;
      const bool in = kv0 + j < sk;
      const size_t at = ((size_t)bh * sk + kv0 + j) * D + d;
      ks[j][d] = in ? to_f32(k[at]) : 0.f;
      vs[j][d] = in ? to_f32(v[at]) : 0.f;
    }
    __syncthreads();

    float s[S::BKV];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < S::BKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < S::DT; ++d) dot += qr[d] * ks[j][d0 + d];
#pragma unroll
      for (int o = S::TPR / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int k_pos = kv0 + j;
      if (k_pos >= sk) {
        dot = -CUDART_INF_F;  // past the keys: not part of the softmax
      } else if (causal && q_pos < k_pos) {
        dot = kMaskFill;
      }
      s[j] = dot;
      mx = fmaxf(mx, dot);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < S::BKV; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < S::DT; ++d) {
      float pv = 0.f;
#pragma unroll
      for (int j = 0; j < S::BKV; ++j) pv += s[j] * vs[j][d0 + d];
      acc[d] = acc[d] * corr + pv;
    }
    m = m_new;
    __syncthreads();
  }

  if (live) {
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < S::DT; ++d)
      out[((size_t)bh * sq + q_pos) * D + d0 + d] = from_f32<T>(acc[d] * inv_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int causal, float scale, cudaStream_t stream) {
  const dim3 grid(bh, (sq + Shape<D>::BQ - 1) / Shape<D>::BQ);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  mha_kernel<T, D><<<grid, Shape<D>::NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int sk, int d, int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, bh, sq, sk, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, bh, sq, sk, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, bh, sq, sk, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, bh, sq, sk, causal, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, bh, sq, sk, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), out (bh, sq, d), contiguous and of one
// dtype: dtype 0 = float32, 1 = bfloat16; d in {16, 32, 64, 128, 256};
// scale is the true head dimension's ^-0.5 as the caller rounds it.
// Returns the launch's cudaError_t.
extern "C" int mha_launch(const void* q, const void* k, const void* v,
                          void* out, int bh, int sq, int sk, int d,
                          int causal, float scale, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(q, k, v, out, bh, sq, sk, d, causal, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, bh, sq, sk, d, causal, scale,
                                   s);
  return (int)cudaErrorInvalidValue;
}
