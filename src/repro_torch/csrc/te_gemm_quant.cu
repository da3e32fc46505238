// Quantized TE GEMM with a dequant epilogue on Hopper (sm_90a):
// out = epi((Xq @ Wq) * xs * ws + b).
//
// Replaces: repro/kernels/te_gemm.py::te_gemm_quant
// (_te_gemm_quant_kernel): (M, K) int8 or e4m3 codes times (K, N) codes
// of the same type, per-row activation scales xs (M, 1) and per-column
// weight scales ws (1, N) in fp32, an int32 accumulator for int8 and an
// fp32 one for e4m3 (dequant on load), then acc * xs * ws, + bias, then
// none / relu / silu / row-softmax, stored as fp32 or bf16.
//
// What bounds it: bytes at the shapes it serves.  At 256^3 it moves
// 0.39 MB (0.12 us of HBM time) against 34 MOP (0.02 us at the card's
// 1,979 TOP/s int8 / fp8 tensor-core peak); at DeepRx's block conv
// (M = 28,672, K = 288, N = 32) 11.9 MB (3.6 us) against 0.53 GOP.
//
// Design: te_gemm.cu's tiled SIMT GEMM over 1-byte codes.  A
// block owns a BM x BN output tile and walks K in slices through shared
// memory; each thread keeps a 4 x 4 register micro-tile.  int8: each
// slice is 32 codes deep, packed on load into 32-bit words of 4
// consecutive K codes (an X row's run and a W column's run), and the
// product is __dp4a, four signed 8-bit multiplies summed exactly into an
// int32 accumulator.  e4m3: each slice is 16 codes deep, converted to
// fp32 on the way into shared memory, and accumulated in fp32; a product
// of two e4m3 values has at most 8 significant bits, so it is exact in
// fp32 and only the sums round.  Edges are masked with zero codes, so any
// M, N, K works.  The epilogue rounds where the plain twin does:
// float(acc) * xs, then * ws, then + b, each a separate IEEE operation
// (the source is built with -fmad=false), so for int8 with epilogue none
// or relu the result equals the twin's bit for bit.  The row-softmax
// needs the whole row in one block: N <= 256 (a 16 x 256 tile).  The
// output type (fp32 or bf16) is a runtime flag at the single store.
// int8 / fp8 wgmma with TMA is later work.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TM = 4;
constexpr int TN = 4;

enum Epilogue { kNone = 0, kRelu = 1, kSilu = 2, kSoftmax = 3 };

// every e4m3 value is exact in fp16, and so in fp32
__device__ __forceinline__ float e4m3_to_f32(uint8_t b) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
}

// kInt8: codes are int8, packed 4 to a word, __dp4a into int32.
// otherwise: codes are e4m3, converted to fp32, fp32 accumulate.
template <bool kInt8>
struct Codes {
  using Word = float;
  static constexpr int BK = 16;  // K codes per slice
  static constexpr int KW = 16;  // words per slice
};
template <>
struct Codes<true> {
  using Word = int;
  static constexpr int BK = 32;
  static constexpr int KW = 8;
};

template <bool kInt8, int BM, int BN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
te_gemm_quant_kernel(const uint8_t* __restrict__ xq,
                     const uint8_t* __restrict__ wq,
                     const float* __restrict__ xs,
                     const float* __restrict__ ws,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int m, int n, int k, int epilogue, int out_bf16) {
  using C = Codes<kInt8>;
  using Word = typename C::Word;
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ Word xsh[C::KW][BM];  // X slice, transposed: xsh[kw][row]
  __shared__ Word wsh[C::KW][BN];
  __shared__ float cs[BM][BN + 1];  // the tile, for the row-softmax

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  Word acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += C::BK) {
    for (int i = tid; i < BM * C::KW; i += NT) {
      const int r = i / C::KW, c = i % C::KW;
      const int gr = m0 + r;
      if constexpr (kInt8) {
        uint32_t word = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int gk = k0 + 4 * c + t;
          const uint32_t b =
              (gr < m && gk < k) ? xq[(size_t)gr * k + gk] : 0u;
          word |= b << (8 * t);
        }
        xsh[c][r] = (int)word;
      } else {
        const int gk = k0 + c;
        xsh[c][r] = (gr < m && gk < k) ? e4m3_to_f32(xq[(size_t)gr * k + gk])
                                       : 0.f;
      }
    }
    for (int i = tid; i < C::KW * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      const int gc = n0 + c;
      if constexpr (kInt8) {
        uint32_t word = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int gk = k0 + 4 * r + t;
          const uint32_t b =
              (gk < k && gc < n) ? wq[(size_t)gk * n + gc] : 0u;
          word |= b << (8 * t);
        }
        wsh[r][c] = (int)word;
      } else {
        const int gk = k0 + r;
        wsh[r][c] = (gk < k && gc < n) ? e4m3_to_f32(wq[(size_t)gk * n + gc])
                                       : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < C::KW; ++kw) {
      Word a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xsh[kw][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = wsh[kw][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if constexpr (kInt8) {
            acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
          } else {
            acc[i][j] += a[i] * b[j];
          }
        }
    }
    __syncthreads();
  }

  // dequant + bias + activation, in the twin's order
  float z[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    const float sx = row < m ? xs[row] : 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      const float sw = col < n ? ws[col] : 0.f;
      float v = (float)acc[i][j] * sx;
      v = v * sw;
      if (bias != nullptr && col < n) v = v + bias[col];
      if (epilogue == kRelu) {
        v = fmaxf(v, 0.f);
      } else if (epilogue == kSilu) {
        v = v * (1.f / (1.f + expf(-v)));
      }
      z[i][j] = v;
    }
  }

  if (epilogue == kSoftmax) {  // gridDim.x == 1: the block holds each row
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) cs[ty * TM + i][tx * TN + j] = z[i][j];
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
      for (int j = 0; j < TN; ++j) z[i][j] = cs[ty * TM + i][tx * TN + j];
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col >= n) continue;
      const size_t at = (size_t)row * n + col;
      if (out_bf16) {
        static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(z[i][j]);
      } else {
        static_cast<float*>(out)[at] = z[i][j];
      }
    }
  }
}

template <bool kInt8, int BM, int BN>
int launch(const void* xq, const void* wq, const float* xs, const float* ws,
           const float* bias, void* out, int m, int n, int k, int epilogue,
           int out_bf16, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  te_gemm_quant_kernel<kInt8, BM, BN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const uint8_t*>(xq), static_cast<const uint8_t*>(wq),
          xs, ws, bias, out, m, n, k, epilogue, out_bf16);
  return (int)cudaGetLastError();
}

template <bool kInt8>
int dispatch(const void* xq, const void* wq, const float* xs,
             const float* ws, const float* bias, void* out, int m, int n,
             int k, int epilogue, int out_bf16, cudaStream_t s) {
  if (epilogue == kSoftmax) {
    if (n <= 32)
      return launch<kInt8, 64, 32>(xq, wq, xs, ws, bias, out, m, n, k,
                                   epilogue, out_bf16, s);
    if (n <= 64)
      return launch<kInt8, 64, 64>(xq, wq, xs, ws, bias, out, m, n, k,
                                   epilogue, out_bf16, s);
    if (n <= 256)
      return launch<kInt8, 16, 256>(xq, wq, xs, ws, bias, out, m, n, k,
                                    epilogue, out_bf16, s);
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 32)
    return launch<kInt8, 64, 32>(xq, wq, xs, ws, bias, out, m, n, k,
                                 epilogue, out_bf16, s);
  return launch<kInt8, 64, 64>(xq, wq, xs, ws, bias, out, m, n, k, epilogue,
                               out_bf16, s);
}

}  // namespace

// xq (m, k) and wq (k, n) codes, row-major, of one type: qtype 0 = int8,
// 1 = e4m3 (float8_e4m3fn); xs (m,) and ws (n,) fp32 scales; bias (n,)
// fp32 or null; out (m, n) fp32 (out_bf16 = 0) or bf16 (1).  epilogue:
// 0 none, 1 relu, 2 silu, 3 row-softmax (n <= 256).  Returns the
// launch's cudaError_t.
extern "C" int te_gemm_quant_launch(const void* xq, const void* wq,
                                    const void* xs, const void* ws,
                                    const void* bias, void* out, int m,
                                    int n, int k, int epilogue, int qtype,
                                    int out_bf16, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || epilogue < 0 || epilogue > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* sx = static_cast<const float*>(xs);
  const float* sw = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  if (qtype == 0)
    return dispatch<true>(xq, wq, sx, sw, b, out, m, n, k, epilogue,
                          out_bf16, s);
  if (qtype == 1)
    return dispatch<false>(xq, wq, sx, sw, b, out, m, n, k, epilogue,
                           out_bf16, s);
  return (int)cudaErrorInvalidValue;
}
