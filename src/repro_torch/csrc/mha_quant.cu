// Flash multi-head attention over quantized q, k, v on Hopper (sm_90a).
//
// Replaces: repro/kernels/mha.py::mha_quant (_mha_quant_kernel): q, k, v
// (BH, S, D) as int8 or e4m3 codes with one fp32 scale per (batch*head)
// row each (qs, ks, vs).  q is dequantized on load as
// q * (qs * ks * D^-0.5), so the scores come out in real units; the
// causal mask (q_pos >= k_pos, -1e30 fill) and the online softmax run in
// fp32 over key tiles; P @ V accumulates the raw v codes in fp32 and the
// result is scaled by vs / l once at the end, stored as fp32 or bf16.
//
// What bounds it: at (4, 256, 64) causal it moves 0.26 MB of codes plus
// the fp32 output (0.6 MB, 0.2 us of HBM time) against ~17 MFLOP of
// useful work (0.01 us at the 1,979 TOP/s 8-bit tensor-core peak):
// bytes, and in practice the launch; at CE-ViT's (32, 64, 16) likewise.
//
// Design: mha.cu's flash kernel over 1-byte loads.  One block per
// (bh, 64-row query tile; 32 rows and 16-key tiles at D = 256); max(1,
// D/32) adjacent threads own one query
// row, holding their slice of the pre-scaled q and of the fp32
// accumulator in registers, and meet through warp shuffles for each
// score.  K and V
// tiles are converted to fp32 on the way into shared memory.  Keys past
// Sk are left out of the softmax; with the causal mask, key tiles wholly
// after the query tile are skipped (their p would be exactly 0).  The
// code type (int8 or e4m3) and the output type are runtime flags read
// at the loads and the store, so the source has one instance per head
// dimension, D in {16, 32, 64, 128, 256} (any other D <= 256 zero-padded
// by the wrapper, with the true D's scale), and builds in its own nvcc
// process beside mha.cu.  A D above 256 runs mha_quant_kernel_wide: a
// grid axis over output slabs of 256 columns, each slab's block computing
// the scores over the whole D from chunks of 256 dims of q and k staged
// (dequantized) in shared memory in place of registers, and reading its
// slab of V.  8-bit wgmma for QK^T and PV is later work.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr float kMaskFill = -1e30f;

// every e4m3 value is exact in fp16, and so in fp32
__device__ __forceinline__ float decode(uint8_t b, int fp8) {
  return fp8 ? __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)))
             : (float)(int8_t)b;
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

template <int D>
__global__ void __launch_bounds__(Shape<D>::NT)
mha_quant_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ k,
                 const uint8_t* __restrict__ v, const float* __restrict__ qs,
                 const float* __restrict__ ks, const float* __restrict__ vs,
                 void* __restrict__ out, int sq, int sk, int causal,
                 float scale, int fp8, int out_bf16) {
  using S = Shape<D>;
  __shared__ float ksh[S::BKV][D];
  __shared__ float vsh[S::BKV][D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * S::BQ;
  const int row = threadIdx.x / S::TPR;
  const int d0 = (threadIdx.x % S::TPR) * S::DT;
  const int q_pos = q0 + row;
  const bool live = q_pos < sq;
  const float q_scale = qs[bh] * ks[bh] * scale;

  float qr[S::DT], acc[S::DT];
#pragma unroll
  for (int d = 0; d < S::DT; ++d) {
    qr[d] = live ? decode(q[((size_t)bh * sq + q_pos) * D + d0 + d], fp8) *
                       q_scale
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
      ksh[j][d] = in ? decode(k[at], fp8) : 0.f;
      vsh[j][d] = in ? decode(v[at], fp8) : 0.f;
    }
    __syncthreads();

    float s[S::BKV];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < S::BKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < S::DT; ++d) dot += qr[d] * ksh[j][d0 + d];
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
      for (int j = 0; j < S::BKV; ++j) pv += s[j] * vsh[j][d0 + d];
      acc[d] = acc[d] * corr + pv;
    }
    m = m_new;
    __syncthreads();
  }

  if (live) {
    const float post = vs[bh] / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < S::DT; ++d) {
      const size_t at = ((size_t)bh * sq + q_pos) * D + d0 + d;
      if (out_bf16) {
        static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(acc[d] * post);
      } else {
        static_cast<float*>(out)[at] = acc[d] * post;
      }
    }
  }
}

// D > 256: blockIdx.z is the output slab [dv0, dv0 + WD); the block's
// rows and threads as the D = 256 instance's
constexpr int WD = 256;

__global__ void __launch_bounds__(Shape<WD>::NT)
mha_quant_kernel_wide(const uint8_t* __restrict__ q,
                      const uint8_t* __restrict__ k,
                      const uint8_t* __restrict__ v,
                      const float* __restrict__ qs,
                      const float* __restrict__ ks,
                      const float* __restrict__ vs, void* __restrict__ out,
                      int sq, int sk, int d, int causal, float scale, int fp8,
                      int out_bf16) {
  using S = Shape<WD>;
  extern __shared__ float wide_smem[];
  float* qsh = wide_smem;         // S::BQ x WD: a chunk of pre-scaled q
  float* ksh = qsh + S::BQ * WD;  // S::BKV x WD: the same chunk of k
  float* vsh = ksh + S::BKV * WD;  // S::BKV x WD: the slab of v

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * S::BQ;
  const int dv0 = blockIdx.z * WD;
  const int row = threadIdx.x / S::TPR;
  const int d0 = (threadIdx.x % S::TPR) * S::DT;
  const int q_pos = q0 + row;
  const bool live = q_pos < sq;
  const float q_scale = qs[bh] * ks[bh] * scale;
  const uint8_t* qb = q + (size_t)bh * sq * d;
  const uint8_t* kb = k + (size_t)bh * sk * d;
  const uint8_t* vb = v + (size_t)bh * sk * d;

  float acc[S::DT];
#pragma unroll
  for (int i = 0; i < S::DT; ++i) acc[i] = 0.f;
  float m = kMaskFill, l = 0.f;

  const int kv_end = causal ? min(sk, q0 + S::BQ) : sk;
  for (int kv0 = 0; kv0 < kv_end; kv0 += S::BKV) {
    float s[S::BKV];
#pragma unroll
    for (int j = 0; j < S::BKV; ++j) s[j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += WD) {
      __syncthreads();  // the last chunk's reads are done
      for (int i = threadIdx.x; i < S::BQ * WD; i += S::NT) {
        const int r = i / WD, dd = c0 + i % WD;
        qsh[i] = q0 + r < sq && dd < d
                     ? decode(qb[(size_t)(q0 + r) * d + dd], fp8) * q_scale
                     : 0.f;
      }
      for (int i = threadIdx.x; i < S::BKV * WD; i += S::NT) {
        const int j = i / WD, dd = c0 + i % WD;
        ksh[i] = kv0 + j < sk && dd < d
                     ? decode(kb[(size_t)(kv0 + j) * d + dd], fp8) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < S::BKV; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int dd = 0; dd < S::DT; ++dd)
          dot += qsh[row * WD + d0 + dd] * ksh[j * WD + d0 + dd];
        s[j] += dot;
      }
    }
    for (int i = threadIdx.x; i < S::BKV * WD; i += S::NT) {
      const int j = i / WD, dd = dv0 + i % WD;
      vsh[i] = kv0 + j < sk && dd < d
                   ? decode(vb[(size_t)(kv0 + j) * d + dd], fp8) : 0.f;
    }
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < S::BKV; ++j) {
      float dot = s[j];
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
    __syncthreads();  // the v slab is in
#pragma unroll
    for (int dd = 0; dd < S::DT; ++dd) {
      float pv = 0.f;
#pragma unroll
      for (int j = 0; j < S::BKV; ++j) pv += s[j] * vsh[j * WD + d0 + dd];
      acc[dd] = acc[dd] * corr + pv;
    }
    m = m_new;
  }

  if (live) {
    const float post = vs[bh] / fmaxf(l, 1e-30f);
#pragma unroll
    for (int dd = 0; dd < S::DT; ++dd) {
      const int col = dv0 + d0 + dd;
      if (col >= d) break;
      const size_t at = ((size_t)bh * sq + q_pos) * d + col;
      if (out_bf16) {
        static_cast<__nv_bfloat16*>(out)[at] =
            __float2bfloat16(acc[dd] * post);
      } else {
        static_cast<float*>(out)[at] = acc[dd] * post;
      }
    }
  }
}

int launch_wide(const void* q, const void* k, const void* v, const float* qs,
                const float* ks, const float* vs, void* out, int bh, int sq,
                int sk, int d, int causal, float scale, int fp8,
                int out_bf16, cudaStream_t stream) {
  using S = Shape<WD>;
  constexpr int smem = sizeof(float) * WD * (S::BQ + 2 * S::BKV);  // 64 KB
  static std::atomic<unsigned long long> smem_set{0};  // per device
  const cudaError_t attr = hopper::allow_dynamic_smem(
      mha_quant_kernel_wide, smem, smem_set, hopper::current_device());
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(bh, (sq + S::BQ - 1) / S::BQ, (d + WD - 1) / WD);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  mha_quant_kernel_wide<<<grid, S::NT, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), qs, ks, vs, out, sq, sk, d, causal,
      scale, fp8, out_bf16);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* qs,
           const float* ks, const float* vs, void* out, int bh, int sq,
           int sk, int causal, float scale, int fp8, int out_bf16,
           cudaStream_t stream) {
  const dim3 grid(bh, (sq + Shape<D>::BQ - 1) / Shape<D>::BQ);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  mha_quant_kernel<D><<<grid, Shape<D>::NT, 0, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), qs, ks, vs, out, sq, sk, causal, scale,
      fp8, out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d): contiguous codes of one type, qtype
// 0 = int8, 1 = e4m3; qs, ks, vs (bh,) fp32 scales; out (bh, sq, d) fp32
// (out_bf16 = 0) or bf16 (1); d in {16, 32, 64, 128, 256} or above 256
// (split into output slabs); scale is the
// true head dimension's ^-0.5 as the caller rounds it.  Returns the
// launch's cudaError_t.
extern "C" int mha_quant_launch(const void* q, const void* k, const void* v,
                                const void* qs, const void* ks,
                                const void* vs, void* out, int bh, int sq,
                                int sk, int d, int causal, float scale,
                                int qtype, int out_bf16, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || qtype < 0 || qtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = static_cast<const float*>(qs);
  const float* b = static_cast<const float*>(ks);
  const float* c = static_cast<const float*>(vs);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, a, b, c, out, bh, sq, sk, causal, scale,
                        qtype, out_bf16, s);
    case 32:
      return launch<32>(q, k, v, a, b, c, out, bh, sq, sk, causal, scale,
                        qtype, out_bf16, s);
    case 64:
      return launch<64>(q, k, v, a, b, c, out, bh, sq, sk, causal, scale,
                        qtype, out_bf16, s);
    case 128:
      return launch<128>(q, k, v, a, b, c, out, bh, sq, sk, causal, scale,
                         qtype, out_bf16, s);
    case 256:
      return launch<256>(q, k, v, a, b, c, out, bh, sq, sk, causal, scale,
                         qtype, out_bf16, s);
    default:
      if (d > WD)
        return launch_wide(q, k, v, a, b, c, out, bh, sq, sk, d, causal,
                           scale, qtype, out_bf16, s);
      return (int)cudaErrorInvalidValue;
  }
}
