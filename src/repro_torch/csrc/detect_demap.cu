// Fused MMSE equalize -> max-log demap on Hopper (sm_90a): the joint
// receiver and successive interference cancellation.
//
// detect_demap_kernel replaces repro/kernels/rx_fused.py::
// _detect_demap_kernel over _detect_demap_core (mmse_detect_demap_pallas /
// _demap_pallas): per RE the regularized Gram H^H H + nv I, the augmented
// RHS [H^H y | G], an unpivoted complex Gauss elimination whose solution
// gives both the filter output and the bias diagonal mu = Re diag(A^-1 G),
// unbiasing with mu clipped to [1e-6, 1 - 1e-6], and per-axis max-log LLRs
// (real-axis bits first, log P(1)/P(0)).
//
// sic_demap_kernel replaces the same Pallas kernel over _sic_core and
// _hard_axis (sic_detect_demap_pallas): n_tx cancellation stages.  Stage k
// solves the MMSE system over the not-yet-cancelled streams k..n_tx-1,
// keeps stream k's unbiased estimate, effective noise variance and LLRs,
// hard-remodulates stream k to its nearest level on each axis, and
// subtracts h[:, k] * x_k (the original channel column) from the residual
// before stage k + 1.  Streams cancel in index order (the MU-MIMO
// scenarios register their users strongest-first).
//
// What bounds them: bytes, narrowly at the larger shapes.  A RE moves
// 100-230 bytes (y, its share of H, x_hat, nv_eff and the LLR plane) and
// costs up to a few thousand fp32 flops (SIC at 4x4 16-QAM ~2.3 kflop,
// ~15 flop/byte, under the card's 20 flop/byte balance of 67 TFLOP/s over
// 3.35 TB/s); on the small SISO and 2x2 grids the bytes dominate.  fp32
// outside the tensor cores either way: the per-RE systems are 1x1 to 4x4.
//
// Design: one thread per RE (b, sym, sc), templated on <N_RX, N_TX, NB>
// (NB bits per axis, 2^NB levels) so every antenna/level loop unrolls and
// the whole chain lives in registers; nothing but y, H and the three
// outputs touches memory.  Both kernels run one solve (mmse_solve): the
// joint kernel once over all streams with every bias column; SIC once per
// stage, unrolled by template recursion on k, at the compile-time size
// n_tx - k with the two columns that stage keeps.  SIC's hard decision is
// _hard_axis's: levels in the modem's order, a strict < so the first level
// wins a tie, v = comp * scale and a true division best / scale.  A
// decision at a level boundary changes every later stage's residual, so
// the operation order is the reference core's throughout and the library
// is built with -fmad=false: each product and sum rounds where the plain
// PyTorch twin's does.  noise_var is read through a device pointer (no
// host read on the hot path), and x_hat, nv_eff and the LLRs are written
// in the port's final layouts.
#include <cuda_runtime.h>

namespace {

struct cf {
  float r, i;
};

__device__ __forceinline__ cf cmul(float ar, float ai, float br, float bi) {
  return {ar * br - ai * bi, ar * bi + ai * br};
}

// The regularized MMSE system over streams K..NT-1 of the channel (hr, hi)
// [NR][NT] for one RE's received samples (yr, yi) [NR]: A = G + nv I with
// G = H^H H, solved by unpivoted complex Gauss elimination (A is Hermitian
// positive definite) for the augmented right-hand side [H^H y | G].  Only
// the first NRHS columns are solved: column 0 gives the filter output,
// column 1 + u the column u of A^-1 G (the bias diagonal of stream u is
// Re z[u][1 + u]).  A column's elimination reads only A and itself, so a
// narrower NRHS leaves the solved columns' values unchanged.
template <int NR, int NT, int K, int NRHS>
__device__ __forceinline__ void mmse_solve(const float (&yr)[NR],
                                           const float (&yi)[NR],
                                           const float (&hr)[NR][NT],
                                           const float (&hi)[NR][NT],
                                           float nv,
                                           float (&zr)[NT - K][NRHS],
                                           float (&zi)[NT - K][NRHS]) {
  constexpr int M = NT - K;
  float gr[M][M], gi[M][M];
#pragma unroll
  for (int t = 0; t < M; ++t) {
#pragma unroll
    for (int u = 0; u < M; ++u) {
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const cf p = cmul(hr[r][K + t], -hi[r][K + t], hr[r][K + u],
                          hi[r][K + u]);
        sr = sr + p.r;
        si = si + p.i;
      }
      gr[t][u] = sr;
      gi[t][u] = si;
    }
  }

  float ar[M][M], ai[M][M], br[M][NRHS], bi[M][NRHS];
#pragma unroll
  for (int t = 0; t < M; ++t) {
#pragma unroll
    for (int u = 0; u < M; ++u) {
      ar[t][u] = t == u ? gr[t][u] + nv : gr[t][u] + 0.f;
      ai[t][u] = gi[t][u] + 0.f;
      if (1 + u < NRHS) {
        br[t][1 + u] = gr[t][u];
        bi[t][1 + u] = gi[t][u];
      }
    }
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const cf p = cmul(hr[r][K + t], -hi[r][K + t], yr[r], yi[r]);
      sr = sr + p.r;
      si = si + p.i;
    }
    br[t][0] = sr;
    bi[t][0] = si;
  }

#pragma unroll
  for (int kd = 0; kd < M; ++kd) {
    const float dr = ar[kd][kd], di = ai[kd][kd];
    const float den = dr * dr + di * di;
    const float ivr = dr / den, ivi = -di / den;
#pragma unroll
    for (int r = kd + 1; r < M; ++r) {
      const cf f = cmul(ar[r][kd], ai[r][kd], ivr, ivi);
#pragma unroll
      for (int u = kd; u < M; ++u) {
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
#pragma unroll
  for (int kd = M - 1; kd >= 0; --kd) {
    const float dr = ar[kd][kd], di = ai[kd][kd];
    const float den = dr * dr + di * di;
    const float ivr = dr / den, ivi = -di / den;
#pragma unroll
    for (int j = 0; j < NRHS; ++j) {
      float sr = br[kd][j], si = bi[kd][j];
#pragma unroll
      for (int u = kd + 1; u < M; ++u) {
        const cf p = cmul(ar[kd][u], ai[kd][u], zr[u][j], zi[u][j]);
        sr = sr - p.r;
        si = si - p.i;
      }
      const cf z = cmul(sr, si, ivr, ivi);
      zr[kd][j] = z.r;
      zi[kd][j] = z.i;
    }
  }
}

// Unbias one stream (mu clipped to [1e-6, 1 - 1e-6]) and write its
// estimate, effective noise variance and 2*NB max-log LLRs (real-axis bits
// first, log P(1)/P(0)); the unbiased estimate is returned in (ux, uy).
template <int NB>
__device__ __forceinline__ void unbias_demap(float z_r, float z_i, float z_mu,
                                             const float (&lv)[1 << NB],
                                             float norm, float scale,
                                             float2* x_hat, float* nv_eff,
                                             float* llr, float& ux,
                                             float& uy) {
  constexpr int NL = 1 << NB;
  const float mu_lo = 1e-6f;
  const float mu_hi = (float)(1.0 - 1e-6);
  const float mu = fminf(fmaxf(z_mu, mu_lo), mu_hi);
  ux = z_r / mu;
  uy = z_i / mu;
  const float ne = (1.0f - mu) / mu;
  const float nvs = fmaxf(ne * norm, 1e-6f);
  *x_hat = make_float2(ux, uy);
  *nv_eff = ne;
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
      llr[axis * NB + p] = (d0 - d1) / nvs;
    }
  }
}

// y and H of RE i (b, sym, sc) into registers
template <int NR, int NT>
__device__ __forceinline__ void load_re(const float2* __restrict__ y,
                                        const float2* __restrict__ h, int i,
                                        int n_sym, int n_sc,
                                        float (&yr)[NR], float (&yi)[NR],
                                        float (&hr)[NR][NT],
                                        float (&hi)[NR][NT]) {
  const int sc = i % n_sc;
  const int b = i / (n_sym * n_sc);
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
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_re) return;
  const float nv = *nv_ptr;
  float lv[1 << NB];
#pragma unroll
  for (int j = 0; j < (1 << NB); ++j) lv[j] = levels_g[j];
  float yr[NR], yi[NR], hr[NR][NT], hi[NR][NT];
  load_re<NR, NT>(y, h, i, n_sym, n_sc, yr, yi, hr, hi);

  float zr[NT][1 + NT], zi[NT][1 + NT];
  mmse_solve<NR, NT, 0, 1 + NT>(yr, yi, hr, hi, nv, zr, zi);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float ux, uy;
    unbias_demap<NB>(zr[t][0], zi[t][0], zr[t][1 + t], lv, norm, scale,
                     x_hat + (size_t)i * NT + t, nv_eff + (size_t)i * NT + t,
                     llr + ((size_t)i * NT + t) * (2 * NB), ux, uy);
  }
}

// nearest per-axis level of comp (unit-power domain), back in that domain
template <int NB>
__device__ __forceinline__ float hard_axis(float comp,
                                           const float (&lv)[1 << NB],
                                           float scale) {
  const float v = comp * scale;
  float best = lv[0] + 0.0f * v;
  float e = v - lv[0];
  float best_d = e * e;
#pragma unroll
  for (int j = 1; j < (1 << NB); ++j) {
    e = v - lv[j];
    const float d = e * e;
    if (d < best_d) best = lv[j];
    best_d = fminf(d, best_d);
  }
  return best / scale;
}

// SIC stage K and, recursively, the stages after it
template <int NR, int NT, int NB, int K>
__device__ __forceinline__ void sic_stage(float (&yr)[NR], float (&yi)[NR],
                                          const float (&hr)[NR][NT],
                                          const float (&hi)[NR][NT],
                                          float nv,
                                          const float (&lv)[1 << NB],
                                          float norm, float scale,
                                          float2* x_hat, float* nv_eff,
                                          float* llr) {
  float zr[NT - K][2], zi[NT - K][2];
  mmse_solve<NR, NT, K, 2>(yr, yi, hr, hi, nv, zr, zi);
  float ux, uy;
  unbias_demap<NB>(zr[0][0], zi[0][0], zr[0][1], lv, norm, scale, x_hat + K,
                   nv_eff + K, llr + K * 2 * NB, ux, uy);
  if constexpr (K + 1 < NT) {
    const float hx = hard_axis<NB>(ux, lv, scale);
    const float hy = hard_axis<NB>(uy, lv, scale);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const cf c = cmul(hr[r][K], hi[r][K], hx, hy);
      yr[r] = yr[r] - c.r;
      yi[r] = yi[r] - c.i;
    }
    sic_stage<NR, NT, NB, K + 1>(yr, yi, hr, hi, nv, lv, norm, scale, x_hat,
                                 nv_eff, llr);
  }
}

template <int NR, int NT, int NB>
__global__ void sic_demap_kernel(const float2* __restrict__ y,
                                 const float2* __restrict__ h,
                                 const float* __restrict__ nv_ptr,
                                 const float* __restrict__ levels_g,
                                 float norm, float scale,
                                 float2* __restrict__ x_hat,
                                 float* __restrict__ nv_eff,
                                 float* __restrict__ llr, int n_re,
                                 int n_sym, int n_sc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_re) return;
  const float nv = *nv_ptr;
  float lv[1 << NB];
#pragma unroll
  for (int j = 0; j < (1 << NB); ++j) lv[j] = levels_g[j];
  float yr[NR], yi[NR], hr[NR][NT], hi[NR][NT];
  load_re<NR, NT>(y, h, i, n_sym, n_sc, yr, yi, hr, hi);
  sic_stage<NR, NT, NB, 0>(yr, yi, hr, hi, nv, lv, norm, scale,
                           x_hat + (size_t)i * NT, nv_eff + (size_t)i * NT,
                           llr + (size_t)i * NT * 2 * NB);
}

template <bool SIC, int NR, int NT, int NB>
int launch(const void* y, const void* h, const float* nv, const float* lv,
           float norm, float scale, void* x_hat, float* nv_eff, float* llr,
           int n_re, int n_sym, int n_sc, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n_re + threads - 1) / threads;
  auto kernel = SIC ? sic_demap_kernel<NR, NT, NB>
                    : detect_demap_kernel<NR, NT, NB>;
  kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(h), nv, lv,
      norm, scale, static_cast<float2*>(x_hat), nv_eff, llr, n_re, n_sym,
      n_sc);
  return (int)cudaGetLastError();
}

template <bool SIC, int NR, int NT>
int launch_nb(int nb, const void* y, const void* h, const float* nv,
              const float* lv, float norm, float scale, void* x_hat,
              float* nv_eff, float* llr, int n_re, int n_sym, int n_sc,
              cudaStream_t s) {
  switch (nb) {
    case 1: return launch<SIC, NR, NT, 1>(y, h, nv, lv, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
    case 2: return launch<SIC, NR, NT, 2>(y, h, nv, lv, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
    case 3: return launch<SIC, NR, NT, 3>(y, h, nv, lv, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
    case 4: return launch<SIC, NR, NT, 4>(y, h, nv, lv, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool SIC>
int dispatch(const void* y, const void* h, const float* nv,
             const float* levels, float norm, float scale, void* x_hat,
             float* nv_eff, float* llr, int batch, int n_sym, int n_sc,
             int n_rx, int n_tx, int nb, void* stream) {
  const int n_re = batch * n_sym * n_sc;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rx == 1 && n_tx == 1)
    return launch_nb<SIC, 1, 1>(nb, y, h, nv, levels, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
  if (n_rx == 2 && n_tx == 2)
    return launch_nb<SIC, 2, 2>(nb, y, h, nv, levels, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
  if (n_rx == 4 && n_tx == 4)
    return launch_nb<SIC, 4, 4>(nb, y, h, nv, levels, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
  if (n_rx == 8 && n_tx == 4)
    return launch_nb<SIC, 8, 4>(nb, y, h, nv, levels, norm, scale, x_hat, nv_eff, llr, n_re, n_sym, n_sc, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y (B, n_sym, n_sc, n_rx) complex64; h (B, n_sc, n_rx, n_tx) complex64;
// nv a device float; levels (2^nb,) float in the modem's order; outputs
// x_hat (B, n_sym, n_sc, n_tx) complex64, nv_eff (B, n_sym, n_sc, n_tx)
// float, llr (B, n_sym, n_sc, n_tx, 2*nb) float, per original stream.
// (n_rx, n_tx) in {(1,1), (2,2), (4,4), (8,4)}, nb in 1..4.  Each returns
// the launch's cudaError_t.
extern "C" int detect_demap_launch(const void* y, const void* h,
                                   const float* nv, const float* levels,
                                   float norm, float scale, void* x_hat,
                                   float* nv_eff, float* llr, int batch,
                                   int n_sym, int n_sc, int n_rx, int n_tx,
                                   int nb, void* stream) {
  return dispatch<false>(y, h, nv, levels, norm, scale, x_hat, nv_eff, llr,
                         batch, n_sym, n_sc, n_rx, n_tx, nb, stream);
}

extern "C" int sic_demap_launch(const void* y, const void* h, const float* nv,
                                const float* levels, float norm, float scale,
                                void* x_hat, float* nv_eff, float* llr,
                                int batch, int n_sym, int n_sc, int n_rx,
                                int n_tx, int nb, void* stream) {
  return dispatch<true>(y, h, nv, levels, norm, scale, x_hat, nv_eff, llr,
                        batch, n_sym, n_sc, n_rx, n_tx, nb, stream);
}
