// Fused MMSE equalize -> max-log demap on Hopper (sm_90a).
//
// Replaces: repro/kernels/rx_fused.py::_detect_demap_kernel over
// _detect_demap_core (mmse_detect_demap_pallas / _demap_pallas): per RE
// the regularized Gram H^H H + nv I, the augmented RHS [H^H y | G], an
// unpivoted complex Gauss elimination whose solution gives both the filter
// output and the bias diagonal mu = Re diag(A^-1 G), unbiasing with mu
// clipped to [1e-6, 1 - 1e-6], and per-axis max-log LLRs (real-axis bits
// first, log P(1)/P(0)).
//
// What bounds it: at 4x8 / 16 levels, operations (a few thousand fp32
// flops per RE against ~100 bytes of I/O); on the small SISO and 2x2
// grids, bytes (the LLR plane written out).  fp32 outside the tensor cores
// either way: the per-RE systems are 1x1 to 4x4.
//
// Design: one thread per RE (b, sym, sc), templated on <N_RX, N_TX, NB>
// (NB bits per axis, 2^NB levels) so every antenna/level loop unrolls and
// the whole chain (Gram, solve, demap) lives in registers; nothing but y,
// H and the three outputs touches memory.  The operation order is the
// reference core's, and the library is built with -fmad=false, so each
// product and sum rounds where the plain PyTorch twin's does.  noise_var
// is read through a device pointer (no host read on the hot path), and
// x_hat, nv_eff and the LLRs are written in the port's final layouts.
#include <cuda_runtime.h>

namespace {

struct cf {
  float r, i;
};

__device__ __forceinline__ cf cmul(float ar, float ai, float br, float bi) {
  return {ar * br - ai * bi, ar * bi + ai * br};
}

template <int NR, int NT, int NB>
__global__ void detect_demap_kernel(const float2* __restrict__ y,
                                    const float2* __restrict__ h,
                                    const float* __restrict__ nv_ptr,
                                    const float* __restrict__ levels_g,
                                    float norm, float scale,
                                    float2* __restrict__ x_hat,
                                    float* __restrict__ nv_eff,
                                    float* __restrict__ llr, int n_re,
                                    int n_sym, int n_sc) {
  constexpr int NL = 1 << NB;
  constexpr int NRHS = 1 + NT;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_re) return;
  const int sc = i % n_sc;
  const int b = i / (n_sym * n_sc);
  const float nv = *nv_ptr;
  float lv[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) lv[j] = levels_g[j];

  float yr[NR], yi[NR], hr[NR][NT], hi[NR][NT];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float2 v = y[(size_t)i * NR + r];
    yr[r] = v.x;
    yi[r] = v.y;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float2 w = h[((size_t)b * n_sc + sc) * NR * NT + r * NT + t];
      hr[r][t] = w.x;
      hi[r][t] = w.y;
    }
  }

  // Gram G = H^H H
  float gr[NT][NT], gi[NT][NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const cf p = cmul(hr[r][t], -hi[r][t], hr[r][u], hi[r][u]);
        sr = sr + p.r;
        si = si + p.i;
      }
      gr[t][u] = sr;
      gi[t][u] = si;
    }
  }

  // A = G + nv I; augmented RHS [H^H y | G]
  float ar[NT][NT], ai[NT][NT], br[NT][NRHS], bi[NT][NRHS];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      ar[t][u] = t == u ? gr[t][u] + nv : gr[t][u] + 0.f;
      ai[t][u] = gi[t][u] + 0.f;
      br[t][1 + u] = gr[t][u];
      bi[t][1 + u] = gi[t][u];
    }
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const cf p = cmul(hr[r][t], -hi[r][t], yr[r], yi[r]);
      sr = sr + p.r;
      si = si + p.i;
    }
    br[t][0] = sr;
    bi[t][0] = si;
  }

  // Gauss elimination, no pivoting (A is Hermitian positive definite)
#pragma unroll
  for (int kd = 0; kd < NT; ++kd) {
    const float dr = ar[kd][kd], di = ai[kd][kd];
    const float den = dr * dr + di * di;
    const float ivr = dr / den, ivi = -di / den;
#pragma unroll
    for (int r = kd + 1; r < NT; ++r) {
      const cf f = cmul(ar[r][kd], ai[r][kd], ivr, ivi);
#pragma unroll
      for (int u = kd; u < NT; ++u) {
        const cf p = cmul(f.r, f.i, ar[kd][u], ai[kd][u]);
        ar[r][u] = ar[r][u] - p.r;
        ai[r][u] = ai[r][u] - p.i;
      }
#pragma unroll
      for (int j = 0; j < NRHS; ++j) {
        const cf p = cmul(f.r, f.i, br[kd][j], bi[kd][j]);
        br[r][j] = br[r][j] - p.r;
        bi[r][j] = bi[r][j] - p.i;
      }
    }
  }
  float zr[NT][NRHS], zi[NT][NRHS];
#pragma unroll
  for (int kd = NT - 1; kd >= 0; --kd) {
    const float dr = ar[kd][kd], di = ai[kd][kd];
    const float den = dr * dr + di * di;
    const float ivr = dr / den, ivi = -di / den;
#pragma unroll
    for (int j = 0; j < NRHS; ++j) {
      float sr = br[kd][j], si = bi[kd][j];
#pragma unroll
      for (int u = kd + 1; u < NT; ++u) {
        const cf p = cmul(ar[kd][u], ai[kd][u], zr[u][j], zi[u][j]);
        sr = sr - p.r;
        si = si - p.i;
      }
      const cf z = cmul(sr, si, ivr, ivi);
      zr[kd][j] = z.r;
      zi[kd][j] = z.i;
    }
  }

  // unbias (mu_t = Re[A^-1 G]_tt) + per-axis max-log LLRs
  const float mu_lo = 1e-6f;
  const float mu_hi = (float)(1.0 - 1e-6);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const float mu = fminf(fmaxf(zr[t][1 + t], mu_lo), mu_hi);
    const float ux = zr[t][0] / mu, uy = zi[t][0] / mu;
    const float ne = (1.0f - mu) / mu;
    const float nvs = fmaxf(ne * norm, 1e-6f);
    x_hat[(size_t)i * NT + t] = make_float2(ux, uy);
    nv_eff[(size_t)i * NT + t] = ne;
    float* out = llr + ((size_t)i * NT + t) * (2 * NB);
#pragma unroll
    for (int axis = 0; axis < 2; ++axis) {
      const float v = (axis == 0 ? ux : uy) * scale;
      float d[NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const float e = v - lv[j];
        d[j] = e * e;
      }
#pragma unroll
      for (int p = 0; p < NB; ++p) {
        float d0 = 0.f, d1 = 0.f;
        bool have0 = false, have1 = false;
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          if ((j >> (NB - 1 - p)) & 1) {
            d1 = have1 ? fminf(d1, d[j]) : d[j];
            have1 = true;
          } else {
            d0 = have0 ? fminf(d0, d[j]) : d[j];
            have0 = true;
          }
        }
        out[axis * NB + p] = (d0 - d1) / nvs;
      }
    }
  }
}

template <int NR, int NT, int NB>
int launch(const void* y, const void* h, const float* nv, const float* lv,
           float norm, float scale, void* x_hat, float* nv_eff, float* llr,
           int n_re, int n_sym, int n_sc, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n_re + threads - 1) / threads;
  detect_demap_kernel<NR, NT, NB><<<blocks, threads, 0, stream>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(h), nv, lv,
      norm, scale, static_cast<float2*>(x_hat), nv_eff, llr, n_re, n_sym,
      n_sc);
  return (int)cudaGetLastError();
}

template <int NR, int NT>
int launch_nb(int nb, const void* y, const void* h, const float* nv,
              const float* lv, float norm, float scale, void* x_hat,
              float* nv_eff, float* llr, int n_re, int n_sym, int n_sc,
              cudaStream_t s) {
  switch (nb) {
    case 1: return launch<NR, NT, 1>(y, h, nv, lv, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
    case 2: return launch<NR, NT, 2>(y, h, nv, lv, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
    case 3: return launch<NR, NT, 3>(y, h, nv, lv, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
    case 4: return launch<NR, NT, 4>(y, h, nv, lv, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// y (B, n_sym, n_sc, n_rx) complex64; h (B, n_sc, n_rx, n_tx) complex64;
// nv a device float; levels (2^nb,) float; outputs x_hat (B, n_sym, n_sc,
// n_tx) complex64, nv_eff (B, n_sym, n_sc, n_tx) float, llr (B, n_sym,
// n_sc, n_tx, 2*nb) float.  (n_rx, n_tx) in {(1,1), (2,2), (4,4), (8,4)},
// nb in 1..4.  Returns the launch's cudaError_t.
extern "C" int detect_demap_launch(const void* y, const void* h,
                                   const float* nv, const float* levels,
                                   float norm, float scale, void* x_hat,
                                   float* nv_eff, float* llr, int batch,
                                   int n_sym, int n_sc, int n_rx, int n_tx,
                                   int nb, void* stream) {
  const int n_re = batch * n_sym * n_sc;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rx == 1 && n_tx == 1)
    return launch_nb<1, 1>(nb, y, h, nv, levels, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
  if (n_rx == 2 && n_tx == 2)
    return launch_nb<2, 2>(nb, y, h, nv, levels, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
  if (n_rx == 4 && n_tx == 4)
    return launch_nb<4, 4>(nb, y, h, nv, levels, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
  if (n_rx == 8 && n_tx == 4)
    return launch_nb<8, 4>(nb, y, h, nv, levels, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
  return (int)cudaErrorInvalidValue;
}
