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
// outside the tensor cores either way: the per-RE systems are small.
//
// The joint kernel factors once per subcarrier and applies per symbol, as
// the TPU kernel broadcasts H over the symbols of its tile.  Everything
// but the right-hand side H^H y depends on (b, sc) and nv alone, so a
// block owns one batch row's tile of SCT subcarriers x all n_sym symbols
// (subcarriers fastest, so y loads and output stores coalesce):
//   1a. one thread per subcarrier forms the Gram (nv on its diagonal) and
//       eliminates it in place: the multipliers f[r][kd] below the
//       diagonal, the eliminated upper rows above it, and the pivots'
//       reciprocals beside; meanwhile every thread's y loads are in
//       flight;
//   1b. one thread per (subcarrier, stream u) solves bias column u (the
//       Gram's column u, independent of the other columns) with those
//       factors, down to row u, and keeps mu_u, ne_u and its noise scale
//       (column 0 by the thread of 1a);
//   2.  one thread per RE forms H^H y, forward-eliminates it with the
//       stored f, back-substitutes, unbiases and demaps.  Where an RE's
//       LLR row is wider than one 16-byte store, the block stages x_hat,
//       nv_eff and the LLR rows in shared memory and writes each symbol's
//       run of subcarriers with 16-byte stores; else each thread stores
//       its row whole (neighbouring threads, neighbouring rows).
// Every value is the per-RE chain's: the same operations on the same
// operands in the same order (a column's elimination reads only A and
// itself), so the factors are those each RE would recompute.
//
// Shapes: <N_RX, N_TX, NB> instances for the registered antenna shapes
// (1x1, 2x2, 4x4, 8x4) x 1..4 bits per axis keep every loop unrolled and
// the per-RE vector in registers, with the factors in shared memory.  Any
// other (n_rx, n_tx) runs the <0, 0, 0> instance of the same kernel with
// runtime loop bounds, its factors and per-RE vectors in shared memory
// (in a workspace the wrapper allocates, sized by detect_demap_workspace,
// where a block's would not fit), and its outputs stored directly.  SIC
// keeps one thread per RE (every stage in registers, unrolled by template
// recursion on k) for the registered shapes, and sic_demap_kernel_any
// runs any other shape with each RE's stage system in shared memory (or
// the workspace).  SIC's hard decision is _hard_axis's: levels in
// the modem's order, a strict < so the first level wins a tie,
// v = comp * scale and a true division best / scale.  A decision at a
// level boundary changes every later stage's residual, so the operation
// order is the reference core's throughout and the library is built with
// -fmad=false: each product and sum rounds where the plain PyTorch twin's
// does.  noise_var is read through a device pointer (no host read on the
// hot path), and x_hat, nv_eff and the LLRs are written in the port's
// final layouts.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int SCT = 16;       // subcarriers a joint block
constexpr int THREADS = 256;  // threads a joint block
constexpr int SIC_THREADS = 128;
constexpr int MAX_LEVELS = 16;
// the runtime-sized routes keep a block's state in shared memory up to
// this many bytes, else in the wrapper's workspace
constexpr int kSharedRoute = 160 * 1024;

struct cf {
  float r, i;
};

__device__ __forceinline__ cf cmul(float ar, float ai, float br, float bi) {
  return {ar * br - ai * bi, ar * bi + ai * br};
}

struct DemapArgs {
  const float2* y;      // (B, n_sym, n_sc, n_rx)
  const float2* h;      // (B, n_sc, n_rx, n_tx)
  const float* nv;      // one device float
  const float* levels;  // (2^nb,) in the modem's order
  float norm, scale;
  float2* x_hat;        // (B, n_sym, n_sc, n_tx)
  float* nv_eff;        // (B, n_sym, n_sc, n_tx)
  float* llr;           // (B, n_sym, n_sc, n_tx, 2 nb)
  float* ws;            // runtime-sized routes' workspace, else null
  int batch, n_sym, n_sc, n_rx, n_tx, nb;
};

// ---- shared pieces -------------------------------------------------------

// The 2^nb levels: in registers for a compile-time NB, else in memory
template <int NB>
struct Levels {
  float v[1 << NB];
  __device__ __forceinline__ float operator[](int j) const { return v[j]; }
};
template <>
struct Levels<0> {
  const float* p;
  __device__ __forceinline__ float operator[](int j) const { return p[j]; }
};

// A complex vector: in registers for a compile-time N (indices known after
// unrolling), else in memory at p
template <int N>
struct CVec {
  float2 v[N];
  __device__ __forceinline__ float2& operator[](int k) { return v[k]; }
};
template <>
struct CVec<0> {
  float2* p;
  __device__ __forceinline__ float2& operator[](int k) { return p[k]; }
};

// The 2*nb max-log LLRs of one unbiased estimate (ux, uy) with noise scale
// nvs, real-axis bits first, into llr[0 .. 2 nb).  Each bit's distance
// d_j = (v - lv_j)^2 is recomputed per bit (the same value every time).
template <class LV>
__device__ __forceinline__ void demap(float ux, float uy, const LV& lv,
                                      int nb, float scale, float nvs,
                                      float* llr) {
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {
    const float v = (axis == 0 ? ux : uy) * scale;
#pragma unroll
    for (int p = 0; p < nb; ++p) {
      float d0 = 0.f, d1 = 0.f;
      bool have0 = false, have1 = false;
#pragma unroll
      for (int j = 0; j < (1 << nb); ++j) {
        const float e = v - lv[j];
        const float d = e * e;
        if ((j >> (nb - 1 - p)) & 1) {
          d1 = have1 ? fminf(d1, d) : d;
          have1 = true;
        } else {
          d0 = have0 ? fminf(d0, d) : d;
          have0 = true;
        }
      }
      llr[axis * nb + p] = (d0 - d1) / nvs;
    }
  }
}

// mu clipped to [1e-6, 1 - 1e-6], then ne = (1 - mu) / mu and the LLRs'
// noise scale max(ne * norm, 1e-6)
__device__ __forceinline__ void bias_terms(float z_mu, float norm, float& mu,
                                           float& ne, float& nvs) {
  const float mu_lo = 1e-6f;
  const float mu_hi = (float)(1.0 - 1e-6);
  mu = fminf(fmaxf(z_mu, mu_lo), mu_hi);
  ne = (1.0f - mu) / mu;
  nvs = fmaxf(ne * norm, 1e-6f);
}

// Unbias one stream and write its estimate, effective noise variance and
// 2*nb LLRs; the unbiased estimate is returned in (ux, uy).
template <class LV>
__device__ __forceinline__ void unbias_demap(float z_r, float z_i, float z_mu,
                                             const LV& lv, int nb, float norm,
                                             float scale, float2* x_hat,
                                             float* nv_eff, float* llr,
                                             float& ux, float& uy) {
  float mu, ne, nvs;
  bias_terms(z_mu, norm, mu, ne, nvs);
  ux = z_r / mu;
  uy = z_i / mu;
  *x_hat = make_float2(ux, uy);
  *nv_eff = ne;
  demap(ux, uy, lv, nb, scale, nvs, llr);
}

// nearest per-axis level of comp (unit-power domain), back in that domain
template <class LV>
__device__ __forceinline__ float hard_axis(float comp, const LV& lv, int nl,
                                           float scale) {
  const float v = comp * scale;
  float best = lv[0] + 0.0f * v;
  float e = v - lv[0];
  float best_d = e * e;
#pragma unroll
  for (int j = 1; j < nl; ++j) {
    e = v - lv[j];
    const float d = e * e;
    if (d < best_d) best = lv[j];
    best_d = fminf(d, best_d);
  }
  return best / scale;
}

// ---- the joint receiver: factor per subcarrier, apply per RE -------------

// floats of one subcarrier's factors: H copy [nr][m], A [m][m] (f below
// the diagonal, eliminated rows above), G [m][m] (bias columns, solved in
// place), the pivots' reciprocals [m] (complex), mu, ne, nvs [m] each;
// rounded to 16 bytes
__host__ __device__ __forceinline__ int factor_floats(int nr, int m) {
  return (2 * nr * m + 4 * m * m + 2 * m + 3 * m + 3) & ~3;
}

struct Factors {
  float2* hs;  // [nr][m]
  float2* a;   // [m][m]
  float2* g;   // [m][m]
  float2* iv;  // [m]
  float* mu;   // [m], then ne [m], nvs [m]
  __device__ __forceinline__ Factors(float* base, int nr, int m) {
    hs = reinterpret_cast<float2*>(base);
    a = hs + nr * m;
    g = a + m * m;
    iv = g + m * m;
    mu = reinterpret_cast<float*>(iv + m);
  }
};

// 1a: the Gram of H (b, sc) with nv on its diagonal, eliminated in place
__device__ __forceinline__ void factor(const float2* __restrict__ hg,
                                      Factors f, int nr, int m, float nv,
                                      bool copy_h) {
#pragma unroll
  for (int t = 0; t < m; ++t) {
#pragma unroll
    for (int u = 0; u < m; ++u) {
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int r = 0; r < nr; ++r) {
        const float2 ht = hg[r * m + t], hu = hg[r * m + u];
        const cf p = cmul(ht.x, -ht.y, hu.x, hu.y);
        sr = sr + p.r;
        si = si + p.i;
      }
      f.g[t * m + u] = make_float2(sr, si);
      f.a[t * m + u] = make_float2(t == u ? sr + nv : sr + 0.f, si + 0.f);
    }
  }
  if (copy_h) {
#pragma unroll
    for (int i = 0; i < nr * m; ++i) f.hs[i] = hg[i];
  }
#pragma unroll
  for (int kd = 0; kd < m; ++kd) {
    const float2 d = f.a[kd * m + kd];
    const float den = d.x * d.x + d.y * d.y;
    const float ivr = d.x / den, ivi = -d.y / den;
    f.iv[kd] = make_float2(ivr, ivi);
#pragma unroll
    for (int r = kd + 1; r < m; ++r) {
      const float2 x = f.a[r * m + kd];
      const cf fr = cmul(x.x, x.y, ivr, ivi);
#pragma unroll
      for (int u = kd; u < m; ++u) {
        const float2 w = f.a[kd * m + u];
        const cf p = cmul(fr.r, fr.i, w.x, w.y);
        const float2 o = f.a[r * m + u];
        f.a[r * m + u] = make_float2(o.x - p.r, o.y - p.i);
      }
      f.a[r * m + kd] = make_float2(fr.r, fr.i);  // the multiplier
    }
  }
}

// 1b: bias column u, solved in place down to row u -> mu_u, ne_u, nvs_u
__device__ __forceinline__ void bias_column(Factors f, int m, int u,
                                            float norm) {
#pragma unroll
  for (int kd = 0; kd < m; ++kd) {
    const float2 bk = f.g[kd * m + u];
#pragma unroll
    for (int r = kd + 1; r < m; ++r) {
      const float2 fr = f.a[r * m + kd];
      const cf p = cmul(fr.x, fr.y, bk.x, bk.y);
      const float2 o = f.g[r * m + u];
      f.g[r * m + u] = make_float2(o.x - p.r, o.y - p.i);
    }
  }
  for (int kd = m - 1; kd >= u; --kd) {
    const float2 s0 = f.g[kd * m + u];
    float sr = s0.x, si = s0.y;
    for (int v = kd + 1; v < m; ++v) {
      const float2 w = f.a[kd * m + v], z = f.g[v * m + u];
      const cf p = cmul(w.x, w.y, z.x, z.y);
      sr = sr - p.r;
      si = si - p.i;
    }
    const float2 iv = f.iv[kd];
    const cf z = cmul(sr, si, iv.x, iv.y);
    f.g[kd * m + u] = make_float2(z.r, z.i);
  }
  float mu, ne, nvs;
  bias_terms(f.g[u * m + u].x, norm, mu, ne, nvs);
  f.mu[u] = mu;
  f.mu[m + u] = ne;
  f.mu[2 * m + u] = nvs;
}

// 2: one RE: H^H y, forward elimination with the stored multipliers, back
// substitution, unbias and demap; outputs at xo [m], no [m], lo [m][2 nb]
template <int NT, class LV>
__device__ __forceinline__ void apply(const float2* __restrict__ yre,
                                      const float2* hs, Factors f, CVec<NT>& z,
                                      int nr, int m, const LV& lv, int nb,
                                      float scale, float2* xo, float* no,
                                      float* lo) {
#pragma unroll
  for (int t = 0; t < m; ++t) {
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int r = 0; r < nr; ++r) {
      const float2 ht = hs[r * m + t], yv = yre[r];
      const cf p = cmul(ht.x, -ht.y, yv.x, yv.y);
      sr = sr + p.r;
      si = si + p.i;
    }
    z[t] = make_float2(sr, si);
  }
#pragma unroll
  for (int kd = 0; kd < m; ++kd) {
    const float2 bk = z[kd];
#pragma unroll
    for (int r = kd + 1; r < m; ++r) {
      const float2 fr = f.a[r * m + kd];
      const cf p = cmul(fr.x, fr.y, bk.x, bk.y);
      const float2 o = z[r];
      z[r] = make_float2(o.x - p.r, o.y - p.i);
    }
  }
#pragma unroll
  for (int kd = m - 1; kd >= 0; --kd) {
    const float2 s0 = z[kd];
    float sr = s0.x, si = s0.y;
#pragma unroll
    for (int v = kd + 1; v < m; ++v) {
      const float2 w = f.a[kd * m + v], zv = z[v];
      const cf p = cmul(w.x, w.y, zv.x, zv.y);
      sr = sr - p.r;
      si = si - p.i;
    }
    const float2 iv = f.iv[kd];
    const cf zz = cmul(sr, si, iv.x, iv.y);
    z[kd] = make_float2(zz.r, zz.i);
  }
#pragma unroll
  for (int t = 0; t < m; ++t) {
    const float mu = f.mu[t];
    const float2 zt = z[t];
    const float ux = zt.x / mu, uy = zt.y / mu;
    xo[t] = make_float2(ux, uy);
    no[t] = f.mu[m + t];
    demap(ux, uy, lv, nb, scale, f.mu[2 * m + t], lo + t * 2 * nb);
  }
}

// rows of `len` floats from shared memory (pitch sp) to device memory
// (pitch gp), 16 bytes a store where every row start is 16-byte aligned
__device__ __forceinline__ void store_rows(float* g, int gp, const float* s,
                                           int sp, int rows, int len) {
  const bool vec = (len | gp | sp) % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  if (vec) {
    const int q = len / 4;
    for (int i = threadIdx.x; i < rows * q; i += blockDim.x) {
      const int r = i / q, c = 4 * (i % q);
      *reinterpret_cast<float4*>(g + (size_t)r * gp + c) =
          *reinterpret_cast<const float4*>(s + r * sp + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * len; i += blockDim.x) {
      const int r = i / len, c = i % len;
      g[(size_t)r * gp + c] = s[r * sp + c];
    }
  }
}

// n floats of a register row to device memory, 16 (or 8) bytes a store
// where n allows (dst is then aligned to it: rows of n floats)
template <int N>
__device__ __forceinline__ void store_row(float* dst, const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      *reinterpret_cast<float2*>(dst + i) = make_float2(src[i], src[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

// An RE's LLR row wider than one 16-byte store is staged in shared memory
// so that each symbol's run of subcarriers leaves in 16-byte stores
template <int NT, int NB>
__host__ __device__ constexpr bool staged() {
  return NT > 0 && NT * 2 * NB > 4;
}

// A block: batch row b, subcarriers [sc0, sc0 + SCT), every symbol.
// <N_RX, N_TX, NB> > 0: a registered shape, factors (and where staged(),
// the outputs) in shared memory, y and the per-RE vector in registers;
// <0, 0, 0>: runtime sizes, factors and per-RE vectors in the workspace,
// outputs stored directly.
template <int NR, int NT, int NB>
__global__ void __launch_bounds__(THREADS) detect_demap_kernel(DemapArgs a) {
  constexpr bool RT = NT == 0;
  constexpr bool STAGE = staged<NT, NB>();
  extern __shared__ float4 smem4[];
  __shared__ float lv_s[MAX_LEVELS];
  const int nr = RT ? a.n_rx : NR;
  const int m = RT ? a.n_tx : NT;
  const int nb = RT ? a.nb : NB;
  const int tid = threadIdx.x;
  const int tiles = (a.n_sc + SCT - 1) / SCT;
  const int b = blockIdx.x / tiles;
  const int sc0 = (blockIdx.x % tiles) * SCT;
  const int nsc = min(SCT, a.n_sc - sc0);
  const int ff = factor_floats(nr, m);
  float* fbase = reinterpret_cast<float*>(smem4);
  if (RT && a.ws != nullptr)
    fbase = a.ws + (size_t)blockIdx.x * (SCT * ff + THREADS * 2 * m);
  const size_t row0 = (size_t)b * a.n_sym;  // (b, sym) rows
  // a registered shape's y of this thread's RE of a chunk, in registers;
  // the first chunk's loads are in flight while the factors are formed
  float2 y_r[RT ? 1 : NR];
  auto load_y = [&](int c0) {
    const int i = c0 + tid, sym = i / SCT, scl = i % SCT;
    if (sym < a.n_sym && scl < nsc) {
      const float2* yre = a.y + ((row0 + sym) * a.n_sc + sc0 + scl) * NR;
#pragma unroll
      for (int r = 0; r < NR; ++r) y_r[r] = yre[r];
    }
  };
  if constexpr (!RT) load_y(0);
  const float nv = *a.nv;
  if (RT && tid < (1 << nb)) lv_s[tid] = a.levels[tid];
  Levels<NB> lv;
  if constexpr (RT) {
    lv.p = lv_s;
  } else {
#pragma unroll
    for (int j = 0; j < (1 << NB); ++j) lv.v[j] = a.levels[j];
  }
  const float2* hb = a.h + ((size_t)b * a.n_sc + sc0) * nr * m;

  if (tid < nsc) {  // 1a, and bias column 0 by the same thread
    const Factors f(fbase + tid * ff, nr, m);
    factor(hb + tid * nr * m, f, nr, m, nv, !RT);
    bias_column(f, m, 0, a.norm);
  }
  __syncthreads();
  if (m > 1) {  // 1b: the other bias columns
    for (int w = tid; w < nsc * (m - 1); w += THREADS)
      bias_column(Factors(fbase + (w / (m - 1)) * ff, nr, m), m,
                  1 + w % (m - 1), a.norm);
    __syncthreads();
  }

  // 2: THREADS REs at a time, (symbol, subcarrier) with subcarriers fastest
  const int wx = 2 * m, wn = m, wl = 2 * nb * m;  // floats an RE writes
  float* stage_x = fbase + SCT * ff;              // [THREADS][wx], then
  float* stage_n = stage_x + THREADS * wx;        // [THREADS][wn],
  float* stage_l = stage_n + THREADS * wn;        // [THREADS][wl]
  for (int c0 = 0; c0 < a.n_sym * SCT; c0 += THREADS) {
    const int i = c0 + tid, sym = i / SCT, scl = i % SCT;
    if constexpr (!RT) {
      if (c0 > 0) load_y(c0);
    }
    if (sym < a.n_sym && scl < nsc) {
      const Factors f(fbase + scl * ff, nr, m);
      const size_t re = (row0 + sym) * a.n_sc + sc0 + scl;
      CVec<NT> z;
      if constexpr (RT) {
        z.p = reinterpret_cast<float2*>(fbase + SCT * ff) + tid * m;
        apply<NT>(a.y + re * nr, hb + scl * nr * m, f, z, nr, m, lv, nb,
                  a.scale, a.x_hat + re * m, a.nv_eff + re * m,
                  a.llr + re * wl);
      } else if constexpr (STAGE) {
        apply<NT>(y_r, f.hs, f, z, nr, m, lv, nb, a.scale,
                  reinterpret_cast<float2*>(stage_x + tid * wx),
                  stage_n + tid * wn, stage_l + tid * wl);
      } else {
        float2 xo[NT];
        float no[NT], lo[NT * 2 * NB];
        apply<NT>(y_r, f.hs, f, z, nr, m, lv, nb, a.scale, xo, no, lo);
        store_row<2 * NT>(reinterpret_cast<float*>(a.x_hat) + re * wx,
                          reinterpret_cast<const float*>(xo));
        store_row<NT>(a.nv_eff + re * wn, no);
        store_row<NT * 2 * NB>(a.llr + re * wl, lo);
      }
    }
    if constexpr (STAGE) {
      __syncthreads();  // the chunk's outputs are staged
      const int s0 = c0 / SCT, rows = min(a.n_sym, s0 + THREADS / SCT) - s0;
      const size_t g0 = (row0 + s0) * a.n_sc + sc0;  // first RE of the chunk
      store_rows(reinterpret_cast<float*>(a.x_hat) + g0 * wx, a.n_sc * wx,
                 stage_x, SCT * wx, rows, nsc * wx);
      store_rows(a.nv_eff + g0 * wn, a.n_sc * wn, stage_n, SCT * wn, rows,
                 nsc * wn);
      store_rows(a.llr + g0 * wl, a.n_sc * wl, stage_l, SCT * wl, rows,
                 nsc * wl);
      __syncthreads();  // the stage is free again
    }
  }
}

// ---- SIC ------------------------------------------------------------------

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

// SIC stage K and, recursively, the stages after it
template <int NR, int NT, int NB, int K>
__device__ __forceinline__ void sic_stage(float (&yr)[NR], float (&yi)[NR],
                                          const float (&hr)[NR][NT],
                                          const float (&hi)[NR][NT],
                                          float nv, const Levels<NB>& lv,
                                          float norm, float scale,
                                          float2* x_hat, float* nv_eff,
                                          float* llr) {
  float zr[NT - K][2], zi[NT - K][2];
  mmse_solve<NR, NT, K, 2>(yr, yi, hr, hi, nv, zr, zi);
  float ux, uy;
  unbias_demap(zr[0][0], zi[0][0], zr[0][1], lv, NB, norm, scale, x_hat + K,
               nv_eff + K, llr + K * 2 * NB, ux, uy);
  if constexpr (K + 1 < NT) {
    const float hx = hard_axis(ux, lv, 1 << NB, scale);
    const float hy = hard_axis(uy, lv, 1 << NB, scale);
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

// one thread per RE, every stage in registers
template <int NR, int NT, int NB>
__global__ void sic_demap_kernel(DemapArgs a) {
  const int n_re = a.batch * a.n_sym * a.n_sc;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_re) return;
  const float nv = *a.nv;
  Levels<NB> lv;
#pragma unroll
  for (int j = 0; j < (1 << NB); ++j) lv.v[j] = a.levels[j];
  float yr[NR], yi[NR], hr[NR][NT], hi[NR][NT];
  load_re<NR, NT>(a.y, a.h, i, a.n_sym, a.n_sc, yr, yi, hr, hi);
  sic_stage<NR, NT, NB, 0>(yr, yi, hr, hi, nv, lv, a.norm, a.scale,
                           a.x_hat + (size_t)i * NT,
                           a.nv_eff + (size_t)i * NT,
                           a.llr + (size_t)i * NT * 2 * NB);
}

// floats of one SIC RE's state: the residual [nr], the stage's system
// A [m][m] and its two right-hand sides [m][2] (solved in place), complex
__host__ __device__ __forceinline__ int sic_floats(int nr, int m) {
  return 2 * (nr + m * m + 2 * m);
}

// any shape: one thread per RE, runtime loops over mmse_solve's
// operations (NRHS = 2) on the RE's state (in shared memory, or in the
// workspace where a block's would not fit)
__global__ void __launch_bounds__(SIC_THREADS)
sic_demap_kernel_any(DemapArgs a) {
  extern __shared__ float4 smem4[];
  const int n_re = a.batch * a.n_sym * a.n_sc;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_re) return;
  const int nr = a.n_rx, nt = a.n_tx, nb = a.nb;
  const float nv = *a.nv;
  const Levels<0> lv{a.levels};
  const int sc = i % a.n_sc, b = i / (a.n_sym * a.n_sc);
  const float2* h = a.h + ((size_t)b * a.n_sc + sc) * nr * nt;
  const int per = sic_floats(nr, nt);
  float2* yres = reinterpret_cast<float2*>(
      a.ws != nullptr ? a.ws + (size_t)i * per
                      : reinterpret_cast<float*>(smem4) + threadIdx.x * per);
  float2* A = yres + nr;
  for (int r = 0; r < nr; ++r) yres[r] = a.y[(size_t)i * nr + r];
  for (int k = 0; k < nt; ++k) {
    const int m = nt - k;
    float2* B = A + m * m;  // [m][2]
    for (int t = 0; t < m; ++t) {
      for (int u = 0; u < m; ++u) {
        float sr = 0.f, si = 0.f;
        for (int r = 0; r < nr; ++r) {
          const float2 ht = h[r * nt + k + t], hu = h[r * nt + k + u];
          const cf p = cmul(ht.x, -ht.y, hu.x, hu.y);
          sr = sr + p.r;
          si = si + p.i;
        }
        A[t * m + u] = make_float2(t == u ? sr + nv : sr + 0.f, si + 0.f);
        if (u == 0) B[t * 2 + 1] = make_float2(sr, si);
      }
      float sr = 0.f, si = 0.f;
      for (int r = 0; r < nr; ++r) {
        const float2 ht = h[r * nt + k + t], yv = yres[r];
        const cf p = cmul(ht.x, -ht.y, yv.x, yv.y);
        sr = sr + p.r;
        si = si + p.i;
      }
      B[t * 2] = make_float2(sr, si);
    }
    for (int kd = 0; kd < m; ++kd) {
      const float2 d = A[kd * m + kd];
      const float den = d.x * d.x + d.y * d.y;
      const float ivr = d.x / den, ivi = -d.y / den;
      for (int r = kd + 1; r < m; ++r) {
        const float2 x = A[r * m + kd];
        const cf f = cmul(x.x, x.y, ivr, ivi);
        for (int u = kd; u < m; ++u) {
          const float2 w = A[kd * m + u];
          const cf p = cmul(f.r, f.i, w.x, w.y);
          const float2 o = A[r * m + u];
          A[r * m + u] = make_float2(o.x - p.r, o.y - p.i);
        }
        for (int j = 0; j < 2; ++j) {
          const float2 w = B[kd * 2 + j];
          const cf p = cmul(f.r, f.i, w.x, w.y);
          const float2 o = B[r * 2 + j];
          B[r * 2 + j] = make_float2(o.x - p.r, o.y - p.i);
        }
      }
    }
    for (int kd = m - 1; kd >= 0; --kd) {
      const float2 d = A[kd * m + kd];
      const float den = d.x * d.x + d.y * d.y;
      const float ivr = d.x / den, ivi = -d.y / den;
      for (int j = 0; j < 2; ++j) {
        const float2 s0 = B[kd * 2 + j];
        float sr = s0.x, si = s0.y;
        for (int u = kd + 1; u < m; ++u) {
          const float2 w = A[kd * m + u], z = B[u * 2 + j];
          const cf p = cmul(w.x, w.y, z.x, z.y);
          sr = sr - p.r;
          si = si - p.i;
        }
        const cf z = cmul(sr, si, ivr, ivi);
        B[kd * 2 + j] = make_float2(z.r, z.i);
      }
    }
    float ux, uy;
    const size_t o = (size_t)i * nt + k;
    unbias_demap(B[0].x, B[0].y, B[1].x, lv, nb, a.norm, a.scale,
                 a.x_hat + o, a.nv_eff + o, a.llr + o * 2 * nb, ux, uy);
    if (k + 1 < nt) {
      const float hx = hard_axis(ux, lv, 1 << nb, a.scale);
      const float hy = hard_axis(uy, lv, 1 << nb, a.scale);
      for (int r = 0; r < nr; ++r) {
        const float2 hk = h[r * nt + k];
        const cf c = cmul(hk.x, hk.y, hx, hy);
        yres[r] = make_float2(yres[r].x - c.r, yres[r].y - c.i);
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------

bool registered(int n_rx, int n_tx) {
  return (n_rx == 1 && n_tx == 1) || (n_rx == 2 && n_tx == 2) ||
         (n_rx == 4 && n_tx == 4) || (n_rx == 8 && n_tx == 4);
}

long long joint_blocks(const DemapArgs& a) {
  return (long long)a.batch * ((a.n_sc + SCT - 1) / SCT);
}

// shared memory of a registered joint instance: SCT subcarriers' factors
// and, where staged, THREADS REs' outputs
template <int NR, int NT, int NB>
int joint_smem() {
  return 4 * (SCT * factor_floats(NR, NT) +
              (staged<NT, NB>() ? THREADS * NT * (3 + 2 * NB) : 0));
}

// a runtime-sized route's state a block: the joint route's SCT
// subcarriers' factors and THREADS per-RE vectors, or SIC's per-RE state
long long route_bytes(bool sic, int n_rx, int n_tx) {
  return 4LL * (sic ? (long long)SIC_THREADS * sic_floats(n_rx, n_tx)
                    : (long long)SCT * factor_floats(n_rx, n_tx) +
                          THREADS * 2 * n_tx);
}

// dynamic shared memory of a launch: a registered joint instance's
// factors (and staged outputs), a runtime-sized route's state where it
// fits; raises the kernel's limit once per device where that is over 48 KB
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int limit,
                       std::atomic<unsigned long long>& done) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return hopper::allow_dynamic_smem(kernel, limit, done,
                                    hopper::current_device());
}

template <int NR, int NT, int NB>
int launch_joint(const DemapArgs& a, cudaStream_t s) {
  auto kernel = detect_demap_kernel<NR, NT, NB>;
  int smem = 0, limit = 0;
  if constexpr (NT == 0) {
    smem = a.ws == nullptr ? (int)route_bytes(false, a.n_rx, a.n_tx) : 0;
    limit = kSharedRoute;
  } else {
    smem = limit = joint_smem<NR, NT, NB>();
  }
  static std::atomic<unsigned long long> smem_set{0};  // per device
  const cudaError_t err = allow_smem(kernel, smem, limit, smem_set);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)joint_blocks(a), THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int NR, int NT, int NB>
int launch_sic(const DemapArgs& a, cudaStream_t s) {
  const long long n_re = (long long)a.batch * a.n_sym * a.n_sc;
  const unsigned blocks = (unsigned)((n_re + SIC_THREADS - 1) / SIC_THREADS);
  if constexpr (NT == 0) {
    const int smem =
        a.ws == nullptr ? (int)route_bytes(true, a.n_rx, a.n_tx) : 0;
    static std::atomic<unsigned long long> smem_set{0};  // per device
    const cudaError_t err =
        allow_smem(sic_demap_kernel_any, smem, kSharedRoute, smem_set);
    if (err != cudaSuccess) return (int)err;
    sic_demap_kernel_any<<<blocks, SIC_THREADS, smem, s>>>(a);
  } else {
    sic_demap_kernel<NR, NT, NB><<<blocks, SIC_THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool SIC, int NR, int NT>
int launch_nb(const DemapArgs& a, cudaStream_t s) {
  switch (a.nb) {
    case 1: return SIC ? launch_sic<NR, NT, 1>(a, s) : launch_joint<NR, NT, 1>(a, s);
    case 2: return SIC ? launch_sic<NR, NT, 2>(a, s) : launch_joint<NR, NT, 2>(a, s);
    case 3: return SIC ? launch_sic<NR, NT, 3>(a, s) : launch_joint<NR, NT, 3>(a, s);
    default: return SIC ? launch_sic<NR, NT, 4>(a, s) : launch_joint<NR, NT, 4>(a, s);
  }
}

long long workspace_floats(bool sic, int batch, int n_sym, int n_sc,
                           int n_rx, int n_tx) {
  if (registered(n_rx, n_tx) || route_bytes(sic, n_rx, n_tx) <= kSharedRoute)
    return 0;
  if (sic)
    return (long long)batch * n_sym * n_sc * sic_floats(n_rx, n_tx);
  return (long long)batch * ((n_sc + SCT - 1) / SCT) *
         (SCT * factor_floats(n_rx, n_tx) + THREADS * 2 * n_tx);
}

template <bool SIC>
int dispatch(const void* y, const void* h, const float* nv,
             const float* levels, float norm, float scale, void* x_hat,
             float* nv_eff, float* llr, float* ws, int batch, int n_sym,
             int n_sc, int n_rx, int n_tx, int nb, void* stream) {
  if (batch <= 0 || n_sym <= 0 || n_sc <= 0 || n_rx <= 0 || n_tx <= 0 ||
      nb < 1 || nb > 4)
    return (int)cudaErrorInvalidValue;
  const long long n_re = (long long)batch * n_sym * n_sc;
  if (n_re * n_tx * 2 * nb > 0x7fffffffLL ||
      (workspace_floats(SIC, batch, n_sym, n_sc, n_rx, n_tx) > 0 &&
       ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const DemapArgs a{static_cast<const float2*>(y),
                    static_cast<const float2*>(h),
                    nv,
                    levels,
                    norm,
                    scale,
                    static_cast<float2*>(x_hat),
                    nv_eff,
                    llr,
                    ws,
                    batch,
                    n_sym,
                    n_sc,
                    n_rx,
                    n_tx,
                    nb};
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rx == 1 && n_tx == 1) return launch_nb<SIC, 1, 1>(a, s);
  if (n_rx == 2 && n_tx == 2) return launch_nb<SIC, 2, 2>(a, s);
  if (n_rx == 4 && n_tx == 4) return launch_nb<SIC, 4, 4>(a, s);
  if (n_rx == 8 && n_tx == 4) return launch_nb<SIC, 8, 4>(a, s);
  return SIC ? launch_sic<0, 0, 0>(a, s) : launch_joint<0, 0, 0>(a, s);
}

}  // namespace

// Floats of the workspace a launch needs (0 for the registered antenna
// shapes, and for other shapes whose state fits a block's shared memory);
// sic selects sic_demap_launch's.
extern "C" long long detect_demap_workspace(int sic, int batch, int n_sym,
                                            int n_sc, int n_rx, int n_tx) {
  return workspace_floats(sic != 0, batch, n_sym, n_sc, n_rx, n_tx);
}

// y (B, n_sym, n_sc, n_rx) complex64; h (B, n_sc, n_rx, n_tx) complex64;
// nv a device float; levels (2^nb,) float in the modem's order; outputs
// x_hat (B, n_sym, n_sc, n_tx) complex64, nv_eff (B, n_sym, n_sc, n_tx)
// float, llr (B, n_sym, n_sc, n_tx, 2*nb) float, per original stream; ws
// the workspace (detect_demap_workspace floats, or null where that is 0).
// Any n_rx, n_tx >= 1, nb in 1..4.  Each returns the launch's cudaError_t.
extern "C" int detect_demap_launch(const void* y, const void* h,
                                   const float* nv, const float* levels,
                                   float norm, float scale, void* x_hat,
                                   float* nv_eff, float* llr, float* ws,
                                   int batch, int n_sym, int n_sc, int n_rx,
                                   int n_tx, int nb, void* stream) {
  return dispatch<false>(y, h, nv, levels, norm, scale, x_hat, nv_eff, llr,
                         ws, batch, n_sym, n_sc, n_rx, n_tx, nb, stream);
}

extern "C" int sic_demap_launch(const void* y, const void* h, const float* nv,
                                const float* levels, float norm, float scale,
                                void* x_hat, float* nv_eff, float* llr,
                                float* ws, int batch, int n_sym, int n_sc,
                                int n_rx, int n_tx, int nb, void* stream) {
  return dispatch<true>(y, h, nv, levels, norm, scale, x_hat, nv_eff, llr,
                        ws, batch, n_sym, n_sc, n_rx, n_tx, nb, stream);
}
