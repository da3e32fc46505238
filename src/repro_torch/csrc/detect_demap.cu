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
// costs up to a few thousand fp32 flops (SIC at 4x4 16-QAM ~2.3 kflop as
// the reference counts it, ~15 flop/byte, under the card's 20 flop/byte
// balance of 67 TFLOP/s over 3.35 TB/s); on the small SISO and 2x2 grids
// the bytes dominate.  fp32 outside the tensor cores either way: the
// per-RE systems are small.
//
// Both kernels factor once per subcarrier and apply per symbol, as the TPU
// kernel broadcasts H over the symbols of its tile.  Everything but the
// right-hand side H^H y depends on (b, sc) and nv alone, so a block owns
// one batch row's tile of SCT subcarriers x all n_sym symbols
// (subcarriers fastest, so y loads and output stores coalesce).  SCT is a
// template value, the caller's choice (kernels/rx_fused.py
// pick_subcarrier_tile: a tuned winner, else 16): 16 on every route, 8
// and 32 also on the routes the main paths launch (tiled_route).  Every
// RE's chain is the same operations in the same order at any SCT, so the
// outputs are too.  The joint kernel:
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
//       stored f, back-substitutes, unbiases and demaps.
// SIC's stage k is that joint problem on H[:, k:] with the residual as
// its right-hand side, and only stream k's column of it is kept:
//   1a. the block copies its H tile to shared memory (H is read once per
//       (b, sc)), asynchronously, with y's loads in flight beside it;
//   1b. one thread per (subcarrier, entry) forms the Gram of all n_tx
//       streams: stage k's suffix Gram is its block [k:, k:], the same
//       sums;
//   1c. a warp per stage k, a lane per subcarrier, eliminates the
//       stage's system (nv on its diagonal) and solves its bias column 0
//       (mu, ne and the noise scale of stream k) in registers (in place
//       for a runtime-sized stage of more than kRegStage streams); the
//       stages depend on H alone, so they are factored side by side;
//   2.  one thread per RE runs the stage chain on its residual:
//       H[:, k:]^H y_res, forward elimination with stage k's multipliers,
//       back substitution down to row 0, unbias and demap stream k, its
//       hard decision and the cancellation.
// The joint kernel stages an RE's LLR row wider than one 16-byte store in
// shared memory and writes each symbol's run of subcarriers with 16-byte
// stores; else, and in SIC, each thread keeps its RE's rows in registers
// and stores each whole (neighbouring threads, neighbouring rows).  Every
// value is the per-RE chain's: the same operations on the same operands
// in the same order (a column's elimination reads only A and itself), so
// the factors are those each RE would recompute.  SIC keeps its shared
// state with subcarriers fastest (element e of subcarrier sc at
// [e][SCT]), so a warp's SCT subcarriers read SCT neighbouring words.
//
// Shapes: <N_RX, N_TX, NB> instances for the registered antenna shapes
// (1x1, 2x2, 4x4, 8x4) x 1..4 bits per axis keep every loop unrolled and
// the per-RE vectors in registers, with the factors in shared memory.  SIC
// with one stream has no cancellation and runs the joint kernel.  Any
// other (n_rx, n_tx) runs the <0, 0, 0> instance of the same kernel with
// runtime loop bounds, its factors and per-RE vectors in shared memory
// (in a workspace the wrapper allocates, sized by detect_demap_workspace,
// where a block's would not fit), and its outputs stored directly; its
// 2^nb levels sit in dynamic shared memory after that state, so it also
// runs every modem of more than 4 bits per axis (1024-QAM and up, to
// kMaxNb), at any antenna shape.  SIC's
// hard decision is _hard_axis's: levels in the modem's order, a strict <
// so the first level wins a tie, v = comp * scale and a true division
// best / scale.  A decision at a level boundary changes every later
// stage's residual, so the operation order is the reference core's
// throughout and the library is built with -fmad=false: each product and
// sum rounds where the plain PyTorch twin's does.  noise_var is read
// through a device pointer (no host read on the hot path), and x_hat,
// nv_eff and the LLRs are written in the port's final layouts.
//
// Lanes: a multi-cell step folds L cells' batches into the batch axis, L
// contiguous blocks of B / L rows, each cell with its own noise variance.
// nv points at n_nv floats, n_nv = 1 or L dividing B, and batch row b
// reads nv[b / (B / n_nv)].  One value is loaded at once, with no index
// arithmetic in front of the load (lane_noise), as before lanes existed.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;  // threads a block
// subcarriers a block (SCT, a template value of both kernels): 16 on every
// route; 8 and 32 also on the routes the main paths launch (tiled_route)
constexpr int kTiles[] = {8, 16, 32};
// bits per axis of the compiled <N_RX, N_TX, NB> instances
constexpr int kMaxCompiledNb = 4;
// bits per axis the runtime-sized <0, 0, 0> instance takes: its 2^nb
// levels (64 KB at 14) fit shared memory beside kSharedRoute's state
constexpr int kMaxNb = 14;
// the runtime-sized routes keep a block's state in shared memory up to
// this many bytes, else in the wrapper's workspace
constexpr int kSharedRoute = 160 * 1024;
// SIC's runtime-sized route factors a stage of up to this many streams in
// registers (the largest whose factors fit them without spilling), a
// larger one in place
constexpr int kRegStage = 6;

struct cf {
  float r, i;
};

__device__ __forceinline__ cf cmul(float ar, float ai, float br, float bi) {
  return {ar * br - ai * bi, ar * bi + ai * br};
}

struct DemapArgs {
  const float2* y;      // (B, n_sym, n_sc, n_rx)
  const float2* h;      // (B, n_sc, n_rx, n_tx)
  const float* nv;      // n_nv device floats, one per lane
  const float* levels;  // (2^nb,) in the modem's order
  float norm, scale;
  float2* x_hat;        // (B, n_sym, n_sc, n_tx)
  float* nv_eff;        // (B, n_sym, n_sc, n_tx)
  float* llr;           // (B, n_sym, n_sc, n_tx, 2 nb)
  float* ws;            // runtime-sized routes' workspace, else null
  int batch, n_sym, n_sc, n_rx, n_tx, nb;
  int lane_rows;        // batch rows per noise value (batch: one value)
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
// unrolling), else in memory at p, element k at p[k * s]
template <int N>
struct CVec {
  float2 v[N];
  __device__ __forceinline__ float2& operator[](int k) { return v[k]; }
};
template <>
struct CVec<0> {
  float2* p;
  int s;
  __device__ __forceinline__ float2& operator[](int k) const {
    return p[k * s];
  }
};

// A channel matrix read in place: element (r, t) at p[(r * ld + t) * s]
struct HMat {
  const float2* p;
  int ld, s;
  __device__ __forceinline__ float2 operator()(int r, int t) const {
    return p[(r * ld + t) * s];
  }
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

// ---- factor per subcarrier, apply per RE ---------------------------------

// One subcarrier's factors of an m-stream system: H copy [nr][m], A [m][m]
// (f below the diagonal, eliminated rows above), G [m][gc] (the first gc
// bias columns, solved in place), the pivots' reciprocals [m] (complex),
// then mu, ne, nvs [gc] each.  Element j of each array lies at [j * s]:
// the joint kernel keeps a subcarrier's factors together (s = 1), SIC a
// stage's factors of the block's SCT subcarriers interleaved (s = SCT,
// subcarrier scl at offset scl).
struct Factors {
  float2 *hs, *a, *g, *iv;
  float* mu;
  int m, gc, s;
  __device__ __forceinline__ Factors(float* base, int nr, int m_, int gc_,
                                     int s_ = 1, int scl = 0)
      : m(m_), gc(gc_), s(s_) {
    float2* p = reinterpret_cast<float2*>(base);
    hs = p + scl;
    a = hs + nr * m * s;
    g = a + m * m * s;
    iv = g + m * gc * s;
    mu = reinterpret_cast<float*>(p + (nr * m + m * m + m * gc + m) * s) +
         scl;
  }
  __device__ __forceinline__ float2& H(int r, int t) const {
    return hs[(r * m + t) * s];
  }
  __device__ __forceinline__ float2& A(int r, int c) const {
    return a[(r * m + c) * s];
  }
  __device__ __forceinline__ float2& G(int r, int c) const {
    return g[(r * gc + c) * s];
  }
  __device__ __forceinline__ float2& IV(int k) const { return iv[k * s]; }
  __device__ __forceinline__ float& MU(int j) const { return mu[j * s]; }
};

// floats of one subcarrier's joint factors (Factors with gc = m, s = 1),
// rounded to 16 bytes
__host__ __device__ __forceinline__ int factor_floats(int nr, int m) {
  return (2 * nr * m + 4 * m * m + 2 * m + 3 * m + 3) & ~3;
}

// floats a subcarrier of SIC's stage factors for m streams (Factors with
// nr = 0, gc = 1): A [m][m], G [m], the reciprocals [m], mu, ne, nvs
__host__ __device__ __forceinline__ int sic_stage_floats(int m) {
  return 2 * m * m + 4 * m + 3;
}

// floats a subcarrier of SIC's tile: its H [nr][nt], its Gram [nt][nt]
// and the stages k = 0..nt-1 (m = nt - k streams each) in that order
__host__ __device__ __forceinline__ int sic_tile_floats(int nr, int nt) {
  int f = 2 * nr * nt + 2 * nt * nt;
  for (int m = 1; m <= nt; ++m) f += sic_stage_floats(m);
  return f;
}

// A SIC stage's factors of one subcarrier in registers (a compile-time M,
// every index known after unrolling), formed by one thread, then stored
template <int M>
struct RegFactors {
  static constexpr int m = M, gc = 1;
  float2 a[M][M], g[M], iv[M];
  float mu[3];
  __device__ __forceinline__ float2& A(int r, int c) { return a[r][c]; }
  __device__ __forceinline__ float2& G(int r, int) { return g[r]; }
  __device__ __forceinline__ float2& IV(int k) { return iv[k]; }
  __device__ __forceinline__ float& MU(int j) { return mu[j]; }
};

// Gram entry (t, u) of h's columns: sum_r conj(h[r][t]) h[r][u]
__device__ __forceinline__ float2 gram_entry(HMat h, int nr, int t, int u) {
  float sr = 0.f, si = 0.f;
#pragma unroll
  for (int r = 0; r < nr; ++r) {
    const float2 ht = h(r, t), hu = h(r, u);
    const cf p = cmul(ht.x, -ht.y, hu.x, hu.y);
    sr = sr + p.r;
    si = si + p.i;
  }
  return make_float2(sr, si);
}

// f's system from its Gram entries gram(t, u) with nv on the diagonal
// (and its first gc bias columns), eliminated in place
template <class F, class Gram>
__device__ __forceinline__ void factor(F& f, Gram gram, float nv) {
  const int m = f.m;
#pragma unroll
  for (int t = 0; t < m; ++t) {
#pragma unroll
    for (int u = 0; u < m; ++u) {
      const float2 g = gram(t, u);
      if (u < f.gc) f.G(t, u) = g;
      f.A(t, u) = make_float2(t == u ? g.x + nv : g.x + 0.f, g.y + 0.f);
    }
  }
#pragma unroll
  for (int kd = 0; kd < m; ++kd) {
    const float2 d = f.A(kd, kd);
    const float den = d.x * d.x + d.y * d.y;
    const float ivr = d.x / den, ivi = -d.y / den;
    f.IV(kd) = make_float2(ivr, ivi);
#pragma unroll
    for (int r = kd + 1; r < m; ++r) {
      const float2 x = f.A(r, kd);
      const cf fr = cmul(x.x, x.y, ivr, ivi);
#pragma unroll
      for (int u = kd; u < m; ++u) {
        const float2 w = f.A(kd, u);
        const cf p = cmul(fr.r, fr.i, w.x, w.y);
        const float2 o = f.A(r, u);
        f.A(r, u) = make_float2(o.x - p.r, o.y - p.i);
      }
      f.A(r, kd) = make_float2(fr.r, fr.i);  // the multiplier
    }
  }
}

// bias column u, solved in place down to row u -> mu_u, ne_u, nvs_u
template <class F>
__device__ __forceinline__ void bias_column(F& f, int u, float norm) {
  const int m = f.m;
#pragma unroll
  for (int kd = 0; kd < m; ++kd) {
    const float2 bk = f.G(kd, u);
#pragma unroll
    for (int r = kd + 1; r < m; ++r) {
      const float2 fr = f.A(r, kd);
      const cf p = cmul(fr.x, fr.y, bk.x, bk.y);
      const float2 o = f.G(r, u);
      f.G(r, u) = make_float2(o.x - p.r, o.y - p.i);
    }
  }
#pragma unroll
  for (int kd = m - 1; kd >= u; --kd) {
    const float2 s0 = f.G(kd, u);
    float sr = s0.x, si = s0.y;
#pragma unroll
    for (int v = kd + 1; v < m; ++v) {
      const float2 w = f.A(kd, v), z = f.G(v, u);
      const cf p = cmul(w.x, w.y, z.x, z.y);
      sr = sr - p.r;
      si = si - p.i;
    }
    const float2 iv = f.IV(kd);
    const cf z = cmul(sr, si, iv.x, iv.y);
    f.G(kd, u) = make_float2(z.r, z.i);
  }
  float mu, ne, nvs;
  bias_terms(f.G(u, u).x, norm, mu, ne, nvs);
  f.MU(u) = mu;
  f.MU(f.gc + u) = ne;
  f.MU(2 * f.gc + u) = nvs;
}

// A SIC stage of m streams of one subcarrier (Gram entries gram(t, u)):
// factored and bias column 0 solved in registers where m <= M (a
// compile-time size, every index known after unrolling), then stored to
// f; a larger stage, which only the runtime-sized route (RT) has, in
// place at f
template <int M, bool RT, class Gram>
__device__ __forceinline__ void factor_stage(int m, Factors f, Gram gram,
                                             float nv, float norm) {
  if constexpr (M > 0) {
    if (m < M) {
      factor_stage<M - 1, RT>(m, f, gram, nv, norm);
      return;
    }
    if (!RT || m == M) {
      RegFactors<M> rf;
      factor(rf, gram, nv);
      bias_column(rf, 0, norm);
#pragma unroll
      for (int t = 0; t < M; ++t) {
#pragma unroll
        for (int u = 0; u < M; ++u) f.A(t, u) = rf.a[t][u];
        f.IV(t) = rf.iv[t];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) f.MU(j) = rf.mu[j];
      return;
    }
  }
  if constexpr (RT) {
    factor(f, gram, nv);
    bias_column(f, 0, norm);
  }
}

// one RE: z = H^H y over h's m columns, forward-eliminated with the stored
// multipliers, back-substituted with the eliminated rows and reciprocals
template <int NT, class YV>
__device__ __forceinline__ void solve(HMat h, const YV& y, Factors f,
                                      CVec<NT>& z, int nr) {
  const int m = f.m;
#pragma unroll
  for (int t = 0; t < m; ++t) {
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int r = 0; r < nr; ++r) {
      const float2 ht = h(r, t), yv = y[r];
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
      const float2 fr = f.A(r, kd);
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
      const float2 w = f.A(kd, v), zv = z[v];
      const cf p = cmul(w.x, w.y, zv.x, zv.y);
      sr = sr - p.r;
      si = si - p.i;
    }
    const float2 iv = f.IV(kd);
    const cf zz = cmul(sr, si, iv.x, iv.y);
    z[kd] = make_float2(zz.r, zz.i);
  }
}

// Unbias stream t's solution zt with its stored bias terms and write its
// estimate, effective noise variance and 2*nb LLRs; returns the estimate
template <class LV>
__device__ __forceinline__ float2 unbias_demap(Factors f, int t, float2 zt,
                                               const LV& lv, int nb,
                                               float scale, float2* xo,
                                               float* no, float* lo) {
  const float mu = f.MU(t);
  const float ux = zt.x / mu, uy = zt.y / mu;
  *xo = make_float2(ux, uy);
  *no = f.MU(f.gc + t);
  demap(ux, uy, lv, nb, scale, f.MU(2 * f.gc + t), lo);
  return make_float2(ux, uy);
}

// the joint receiver's RE: solve, then unbias and demap every stream;
// outputs at xo [m], no [m], lo [m][2 nb]
template <int NT, class YV, class LV>
__device__ __forceinline__ void apply(HMat h, const YV& y, Factors f,
                                      CVec<NT>& z, int nr, const LV& lv,
                                      int nb, float scale, float2* xo,
                                      float* no, float* lo) {
  solve(h, y, f, z, nr);
#pragma unroll
  for (int t = 0; t < f.m; ++t)
    unbias_demap(f, t, z[t], lv, nb, scale, xo + t, no + t,
                 lo + t * 2 * nb);
}

// SIC's RE: the nt stages on the residual y (its received samples on
// entry), with the tile's H (hs: element (r, t) of subcarrier scl at
// hs[(r * nt + t) * SCT + scl]) and stage factors (st: stage k's after
// stage k - 1's, sic_stage_floats(nt - k) x SCT floats each); stream k's
// outputs at xo [k], no [k], lo [k][2 nb]
template <int SCT, int NT, class YV, class LV>
__device__ __forceinline__ void sic_apply(YV& y, const float2* hs, float* st,
                                          int scl, CVec<NT>& z, int nr,
                                          int nt, const LV& lv, int nb,
                                          float scale, float2* xo, float* no,
                                          float* lo) {
#pragma unroll
  for (int k = 0; k < nt; ++k) {
    const int m = nt - k;
    const Factors f(st, 0, m, 1, SCT, scl);
    solve(HMat{hs + k * SCT + scl, nt, SCT}, y, f, z, nr);
    const float2 u = unbias_demap(f, 0, z[0], lv, nb, scale, xo + k, no + k,
                                  lo + k * 2 * nb);
    if (k + 1 < nt) {
      const float hx = hard_axis(u.x, lv, 1 << nb, scale);
      const float hy = hard_axis(u.y, lv, 1 << nb, scale);
#pragma unroll
      for (int r = 0; r < nr; ++r) {
        const float2 hk = hs[(r * nt + k) * SCT + scl];
        const cf c = cmul(hk.x, hk.y, hx, hy);
        const float2 o = y[r];
        y[r] = make_float2(o.x - c.r, o.y - c.i);
      }
    }
    st += SCT * sic_stage_floats(m);
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

// The joint kernel stages an RE's LLR row wider than one 16-byte store in
// shared memory, so that each symbol's run of subcarriers leaves in
// 16-byte stores; SIC keeps an RE's rows in registers and stores each
// whole at the end of its chain (the staging pass cost more than it saved
// at the served batches)
template <int NT, int NB>
__host__ __device__ constexpr bool staged() {
  return NT > 0 && NT * 2 * NB > 4;
}

// floats of a runtime-sized route's state a block: sct subcarriers'
// factors (SIC: its tile) and THREADS REs' vectors (the solution z [nt]
// and, for SIC, the residual [nr], complex)
__host__ __device__ __forceinline__ long long route_floats(bool sic, int nr,
                                                           int nt, int sct) {
  return sic ? (long long)sct * sic_tile_floats(nr, nt) +
                   THREADS * 2 * (nr + nt)
             : (long long)sct * factor_floats(nr, nt) + THREADS * 2 * nt;
}

// The noise variance of batch row b: nv[0] is loaded before any index
// arithmetic, a lane's value only when there are several
__device__ __forceinline__ float lane_noise(const DemapArgs& a, int b) {
  float nv = a.nv[0];
  if (a.lane_rows != a.batch) nv = a.nv[b / a.lane_rows];
  return nv;
}

// A block's tile: batch row b, subcarriers [sc0, sc0 + nsc) of a tile of
// sct, every symbol; its (b, sym) rows start at row0
struct Tile {
  int b, sc0, nsc;
  size_t row0;
  __device__ __forceinline__ Tile(const DemapArgs& a, int sct) {
    const int tiles = (a.n_sc + sct - 1) / sct;
    b = blockIdx.x / tiles;
    sc0 = (blockIdx.x % tiles) * sct;
    nsc = min(sct, a.n_sc - sc0);
    row0 = (size_t)b * a.n_sym;
  }
};

// the 2^nb levels: a compile-time NB's in registers, else in the dynamic
// shared memory after the route's state (read after the block's next
// barrier)
template <int NB>
__device__ __forceinline__ Levels<NB> load_levels(const DemapArgs& a,
                                                  bool sic, int sct) {
  Levels<NB> lv;
  if constexpr (NB == 0) {
    extern __shared__ float4 smem4[];
    float* lv_s = reinterpret_cast<float*>(smem4) +
                  (a.ws ? 0 : route_floats(sic, a.n_rx, a.n_tx, sct));
    for (int j = threadIdx.x; j < (1 << a.nb); j += THREADS)
      lv_s[j] = a.levels[j];
    lv.p = lv_s;
  } else {
#pragma unroll
    for (int j = 0; j < (1 << NB); ++j) lv.v[j] = a.levels[j];
  }
  return lv;
}

// a registered shape's y of this thread's RE of the chunk at c0, into
// registers
template <int SCT, int NR>
__device__ __forceinline__ void load_y(const DemapArgs& a, const Tile& t,
                                       int c0, float2 (&y)[NR]) {
  const int i = c0 + threadIdx.x, sym = i / SCT, scl = i % SCT;
  if (sym < a.n_sym && scl < t.nsc) {
    const float2* yre = a.y + ((t.row0 + sym) * a.n_sc + t.sc0 + scl) * NR;
#pragma unroll
    for (int r = 0; r < NR; ++r) y[r] = yre[r];
  }
}

// an RE's register rows to its x_hat, nv_eff and LLR rows
template <int NT, int NB>
__device__ __forceinline__ void store_re(const DemapArgs& a, size_t re,
                                         const float2* xo, const float* no,
                                         const float* lo) {
  store_row<2 * NT>(reinterpret_cast<float*>(a.x_hat) + re * 2 * NT,
                    reinterpret_cast<const float*>(xo));
  store_row<NT>(a.nv_eff + re * NT, no);
  store_row<NT * 2 * NB>(a.llr + re * NT * 2 * NB, lo);
}

// A block of either kernel: batch row b, subcarriers [sc0, sc0 + SCT),
// every symbol.  <N_RX, N_TX, NB> > 0: a registered shape, factors (and
// for the joint kernel where staged(), the outputs) in shared memory, y
// and the per-RE vectors in registers; <0, 0, 0>: runtime sizes, factors
// and per-RE vectors in shared memory or the workspace, outputs stored
// directly.
template <int NR, int NT, int NB, int SCT>
__global__ void __launch_bounds__(THREADS) detect_demap_kernel(DemapArgs a) {
  constexpr bool RT = NT == 0;
  constexpr bool STAGE = staged<NT, NB>();
  extern __shared__ float4 smem4[];
  const int nr = RT ? a.n_rx : NR;
  const int m = RT ? a.n_tx : NT;
  const int nb = RT ? a.nb : NB;
  const int tid = threadIdx.x;
  const Tile tl(a, SCT);
  const int ff = factor_floats(nr, m);
  float* fbase = reinterpret_cast<float*>(smem4);
  if (RT && a.ws != nullptr)
    fbase = a.ws + (size_t)blockIdx.x * route_floats(false, nr, m, SCT);
  // the first chunk's y loads are in flight while the factors are formed
  float2 y_r[RT ? 1 : NR];
  if constexpr (!RT) load_y<SCT>(a, tl, 0, y_r);
  const float nv = lane_noise(a, tl.b);
  const Levels<NB> lv = load_levels<NB>(a, false, SCT);
  const float2* hb = a.h + ((size_t)tl.b * a.n_sc + tl.sc0) * nr * m;

  if (tid < tl.nsc) {  // 1a, and bias column 0 by the same thread
    const Factors f(fbase + tid * ff, nr, m, m);
    const HMat h{hb + tid * nr * m, m, 1};
    factor(f, [&](int t, int u) { return gram_entry(h, nr, t, u); }, nv);
    if constexpr (!RT) {
#pragma unroll
      for (int r = 0; r < nr; ++r)
#pragma unroll
        for (int t = 0; t < m; ++t) f.H(r, t) = h(r, t);
    }
    bias_column(f, 0, a.norm);
  }
  __syncthreads();
  if (m > 1) {  // 1b: the other bias columns
    for (int w = tid; w < tl.nsc * (m - 1); w += THREADS) {
      const Factors f(fbase + (w / (m - 1)) * ff, nr, m, m);
      bias_column(f, 1 + w % (m - 1), a.norm);
    }
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
      if (c0 > 0) load_y<SCT>(a, tl, c0, y_r);
    }
    if (sym < a.n_sym && scl < tl.nsc) {
      const size_t re = (tl.row0 + sym) * a.n_sc + tl.sc0 + scl;
      const Factors f(fbase + scl * ff, nr, m, m);
      if constexpr (RT) {
        CVec<0> z{reinterpret_cast<float2*>(fbase + SCT * ff) + tid * m, 1};
        apply(HMat{hb + scl * nr * m, m, 1}, a.y + re * nr, f, z, nr, lv, nb,
              a.scale, a.x_hat + re * m, a.nv_eff + re * wn,
              a.llr + re * wl);
      } else if constexpr (STAGE) {
        CVec<NT> z;
        apply(HMat{f.hs, m, 1}, y_r, f, z, nr, lv, nb, a.scale,
              reinterpret_cast<float2*>(stage_x + tid * wx),
              stage_n + tid * wn, stage_l + tid * wl);
      } else {
        CVec<NT> z;
        float2 xo[NT];
        float no[NT], lo[NT * 2 * NB];
        apply(HMat{f.hs, m, 1}, y_r, f, z, nr, lv, nb, a.scale, xo, no, lo);
        store_re<NT, NB>(a, re, xo, no, lo);
      }
    }
    if constexpr (STAGE) {
      __syncthreads();  // the chunk's outputs are staged
      const int s0 = c0 / SCT, rows = min(a.n_sym, s0 + THREADS / SCT) - s0;
      const size_t g0 = (tl.row0 + s0) * a.n_sc + tl.sc0;  // its first RE
      store_rows(reinterpret_cast<float*>(a.x_hat) + g0 * wx, a.n_sc * wx,
                 stage_x, SCT * wx, rows, tl.nsc * wx);
      store_rows(a.nv_eff + g0 * wn, a.n_sc * wn, stage_n, SCT * wn, rows,
                 tl.nsc * wn);
      store_rows(a.llr + g0 * wl, a.n_sc * wl, stage_l, SCT * wl, rows,
                 tl.nsc * wl);
      __syncthreads();  // the stage is free again
    }
  }
}

template <int NR, int NT, int NB, int SCT>
__global__ void __launch_bounds__(THREADS) sic_demap_kernel(DemapArgs a) {
  constexpr bool RT = NT == 0;
  extern __shared__ float4 smem4[];
  const int nr = RT ? a.n_rx : NR;
  const int m = RT ? a.n_tx : NT;
  const int nb = RT ? a.nb : NB;
  const int tid = threadIdx.x;
  const Tile tl(a, SCT);
  float* fbase = reinterpret_cast<float*>(smem4);
  if (RT && a.ws != nullptr)
    fbase = a.ws + (size_t)blockIdx.x * route_floats(true, nr, m, SCT);
  // the first chunk's y loads are in flight while the factors are formed
  float2 y_r[RT ? 1 : NR];
  if constexpr (!RT) load_y<SCT>(a, tl, 0, y_r);
  const float nv = lane_noise(a, tl.b);
  const Levels<NB> lv = load_levels<NB>(a, true, SCT);
  const float2* hb = a.h + ((size_t)tl.b * a.n_sc + tl.sc0) * nr * m;
  // the tile: H and its Gram, element e of subcarrier scl at
  // [e * SCT + scl] (H's e = r * m + t, the Gram's e = t * m + u), then
  // the stages' factors; the runtime-sized route's per-RE vectors after
  // the tile, the residual and z of thread tid at [element][THREADS]
  float2* hs = reinterpret_cast<float2*>(fbase);
  float2* gs = hs + SCT * nr * m;
  float* st = reinterpret_cast<float*>(gs + SCT * m * m);
  float2* vre =
      reinterpret_cast<float2*>(fbase + SCT * sic_tile_floats(nr, m)) + tid;

  // 1a: H into shared memory (and the runtime-sized route's first y into
  // its residual), asynchronously where the state is there
  const bool async = a.ws == nullptr;
  auto copy_in = [&](float2* dst, const float2* src) {
    if (async)
      hopper::cp_async8(hopper::smem_u32(dst), src, 8);
    else
      *dst = *src;
  };
  if constexpr (RT) {
    const int sym = tid / SCT, scl = tid % SCT;
    if (sym < a.n_sym && scl < tl.nsc)
      for (int r = 0; r < nr; ++r)
        copy_in(vre + r * THREADS,
                a.y + ((tl.row0 + sym) * a.n_sc + tl.sc0 + scl) * nr + r);
  }
  const int ne = nr * m;
  for (int i = tid; i < tl.nsc * ne; i += THREADS)
    copy_in(hs + (i % ne) * SCT + i / ne, hb + i);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  // 1b: the Gram of all m streams, an entry a thread; stage k's suffix
  // Gram is its block [k:, k:] (the same sums)
  for (int w = tid; w < tl.nsc * m * m; w += THREADS) {
    const int scl = w % tl.nsc, e = w / tl.nsc;
    gs[e * SCT + scl] = gram_entry(HMat{hs + scl, m, SCT}, nr, e / m, e % m);
  }
  __syncthreads();
  // 1c: a warp per stage k, a lane per subcarrier: the stage's system
  // eliminated, its bias column 0 solved
  for (int w = tid; w < 32 * m; w += THREADS) {
    const int scl = w % 32, k = w / 32;
    if (scl < tl.nsc) {
      float* sk = st;
      for (int j = 0; j < k; ++j) sk += SCT * sic_stage_floats(m - j);
      const float2* gk = gs + (k * m + k) * SCT + scl;
      factor_stage<RT ? kRegStage : NT, RT>(
          m - k, Factors(sk, 0, m - k, 1, SCT, scl),
          [&](int t, int u) { return gk[(t * m + u) * SCT]; }, nv, a.norm);
    }
  }
  __syncthreads();

  // 2: THREADS REs at a time, (symbol, subcarrier) with subcarriers
  // fastest, each running its stage chain; an RE's rows stay in registers
  // and are stored whole (SIC is never staged)
  for (int c0 = 0; c0 < a.n_sym * SCT; c0 += THREADS) {
    const int i = c0 + tid, sym = i / SCT, scl = i % SCT;
    if constexpr (!RT) {
      if (c0 > 0) load_y<SCT>(a, tl, c0, y_r);
    }
    if (sym < a.n_sym && scl < tl.nsc) {
      const size_t re = (tl.row0 + sym) * a.n_sc + tl.sc0 + scl;
      if constexpr (RT) {
        const CVec<0> yres{vre, THREADS};
        CVec<0> z{vre + nr * THREADS, THREADS};
        if (c0 > 0)
          for (int r = 0; r < nr; ++r) yres[r] = a.y[re * nr + r];
        sic_apply<SCT>(yres, hs, st, scl, z, nr, m, lv, nb, a.scale,
                  a.x_hat + re * m, a.nv_eff + re * m,
                  a.llr + re * m * 2 * nb);
      } else {
        CVec<NT> z;
        float2 xo[NT];
        float no[NT], lo[NT * 2 * NB];
        sic_apply<SCT>(y_r, hs, st, scl, z, nr, m, lv, nb, a.scale, xo, no,
                       lo);
        store_re<NT, NB>(a, re, xo, no, lo);
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------

bool registered(int n_rx, int n_tx) {
  return (n_rx == 1 && n_tx == 1) || (n_rx == 2 && n_tx == 2) ||
         (n_rx == 4 && n_tx == 4) || (n_rx == 8 && n_tx == 4);
}

// The routes that also have SCT = 8 and 32 instances (16 is on every
// route): those the main paths launch, the SISO and 2x2 ladders' QPSK and
// 16-QAM, 4x8 64-QAM, the MU grid's SIC and every runtime-sized route
// (<0, 0, 0>, e.g. SIC at 8x6).  kernels/rx_fused.py's TILED_ROUTES is
// the same list.
constexpr bool tiled_route(bool sic, int nr, int nt, int nb) {
  if (nt == 0) return true;
  if (sic) return nr == 4 && nt == 4 && nb == 2;
  return ((nr == 1 && nt == 1) || (nr == 2 && nt == 2)) ? nb <= 2
                                                       : nr == 8 && nb == 3;
}

// shared memory of a registered instance: SCT subcarriers' factors (SIC:
// its tile) and, where the joint kernel stages, THREADS REs' outputs
template <bool SIC, int NR, int NT, int NB, int SCT>
int instance_smem() {
  if constexpr (SIC) return 4 * SCT * sic_tile_floats(NR, NT);
  return 4 * (SCT * factor_floats(NR, NT) +
              (staged<NT, NB>() ? THREADS * NT * (3 + 2 * NB) : 0));
}

// dynamic shared memory of a launch: a registered instance's factors (and
// staged outputs), a runtime-sized route's state where it fits; raises the
// kernel's limit once per device where that is over 48 KB
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int limit,
                       std::atomic<unsigned long long>& done) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return hopper::allow_dynamic_smem(kernel, limit, done,
                                    hopper::current_device());
}

template <bool SIC, int NR, int NT, int NB, int SCT>
int launch(const DemapArgs& a, cudaStream_t s) {
  static_assert(SCT <= 32 && THREADS % SCT == 0,
                "a warp's lane per subcarrier (SIC's stage factoring), "
                "whole rows of subcarriers a chunk");
  if constexpr (SCT != 16 && !tiled_route(SIC, NR, NT, NB)) {
    return (int)cudaErrorInvalidValue;  // no such instance
  } else {
    auto kernel = detect_demap_kernel<NR, NT, NB, SCT>;
    if constexpr (SIC) kernel = sic_demap_kernel<NR, NT, NB, SCT>;
    int smem = 0, limit = 0;
    if constexpr (NT == 0) {
      smem = 4 * ((a.ws == nullptr
                       ? (int)route_floats(SIC, a.n_rx, a.n_tx, SCT)
                       : 0) +
                  (1 << a.nb));
      limit = kSharedRoute + 4 * (1 << kMaxNb);
    } else {
      smem = limit = instance_smem<SIC, NR, NT, NB, SCT>();
    }
    static std::atomic<unsigned long long> smem_set{0};  // per device
    const cudaError_t err = allow_smem(kernel, smem, limit, smem_set);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)a.batch * ((a.n_sc + SCT - 1) / SCT);
    kernel<<<(unsigned)blocks, THREADS, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
}

template <bool SIC, int NR, int NT, int SCT>
int launch_nb(const DemapArgs& a, cudaStream_t s) {
  static_assert(kMaxCompiledNb == 4, "one case per compiled width");
  switch (a.nb) {
    case 1: return launch<SIC, NR, NT, 1, SCT>(a, s);
    case 2: return launch<SIC, NR, NT, 2, SCT>(a, s);
    case 3: return launch<SIC, NR, NT, 3, SCT>(a, s);
    default: return launch<SIC, NR, NT, 4, SCT>(a, s);
  }
}

bool is_tile(int sct) {
  for (int t : kTiles)
    if (t == sct) return true;
  return false;
}

long long workspace_floats(bool sic, int batch, int n_sym, int n_sc,
                           int n_rx, int n_tx, int nb, int sct) {
  sic = sic && n_tx > 1;  // one stream runs the joint kernel (dispatch)
  const long long floats = route_floats(sic, n_rx, n_tx, sct);
  if ((registered(n_rx, n_tx) && nb <= kMaxCompiledNb) ||
      4 * floats <= kSharedRoute)
    return 0;
  return (long long)batch * ((n_sc + sct - 1) / sct) * floats;
}

// the route of a launch at subcarrier tile SCT
template <bool SIC, int SCT>
int route(const DemapArgs& a, cudaStream_t s) {
  if (a.nb > kMaxCompiledNb) return launch<SIC, 0, 0, 0, SCT>(a, s);
  if constexpr (!SIC) {
    if (a.n_rx == 1 && a.n_tx == 1) return launch_nb<SIC, 1, 1, SCT>(a, s);
  }
  if (a.n_rx == 2 && a.n_tx == 2) return launch_nb<SIC, 2, 2, SCT>(a, s);
  if (a.n_rx == 4 && a.n_tx == 4) return launch_nb<SIC, 4, 4, SCT>(a, s);
  if (a.n_rx == 8 && a.n_tx == 4) return launch_nb<SIC, 8, 4, SCT>(a, s);
  return launch<SIC, 0, 0, 0, SCT>(a, s);
}

template <bool SIC>
int dispatch(const void* y, const void* h, const float* nv, int n_nv,
             const float* levels, float norm, float scale, void* x_hat,
             float* nv_eff, float* llr, float* ws, int batch, int n_sym,
             int n_sc, int n_rx, int n_tx, int nb, int sct, void* stream) {
  if (batch <= 0 || n_sym <= 0 || n_sc <= 0 || n_rx <= 0 || n_tx <= 0 ||
      nb < 1 || nb > kMaxNb || n_nv < 1 || batch % n_nv != 0 ||
      !is_tile(sct))
    return (int)cudaErrorInvalidValue;
  // one stream leaves nothing to cancel: SIC's only stage is the joint
  // problem, the same operations on the same operands, and its kernel
  // does it in fewer phases
  if constexpr (SIC) {
    if (n_tx == 1)
      return dispatch<false>(y, h, nv, n_nv, levels, norm, scale, x_hat,
                             nv_eff, llr, ws, batch, n_sym, n_sc, n_rx, n_tx,
                             nb, sct, stream);
  }
  const long long n_re = (long long)batch * n_sym * n_sc;
  if (n_re * n_tx * 2 * nb > 0x7fffffffLL ||
      (workspace_floats(SIC, batch, n_sym, n_sc, n_rx, n_tx, nb, sct) > 0 &&
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
                    nb,
                    batch / n_nv};
  cudaStream_t s = (cudaStream_t)stream;
  if (sct == 8) return route<SIC, 8>(a, s);
  if (sct == 32) return route<SIC, 32>(a, s);
  return route<SIC, 16>(a, s);
}

}  // namespace

// Floats of the workspace a launch needs (0 for the registered antenna
// shapes' compiled instances, and for any launch whose runtime-sized state
// fits a block's shared memory); sic selects sic_demap_launch's, sct the
// subcarrier tile.
extern "C" long long detect_demap_workspace(int sic, int batch, int n_sym,
                                            int n_sc, int n_rx, int n_tx,
                                            int nb, int sct) {
  return is_tile(sct) ? workspace_floats(sic != 0, batch, n_sym, n_sc, n_rx,
                                         n_tx, nb, sct)
                      : 0;
}

// y (B, n_sym, n_sc, n_rx) complex64; h (B, n_sc, n_rx, n_tx) complex64;
// nv n_nv device floats (1, or one per lane of B / n_nv rows); levels
// (2^nb,) float in the modem's order; outputs
// x_hat (B, n_sym, n_sc, n_tx) complex64, nv_eff (B, n_sym, n_sc, n_tx)
// float, llr (B, n_sym, n_sc, n_tx, 2*nb) float, per original stream; ws
// the workspace (detect_demap_workspace floats, or null where that is 0).
// Any n_rx, n_tx >= 1, nb in 1..kMaxNb (1..4 compiled for the registered
// shapes, wider modems at runtime sizes).  sct, the subcarriers a block,
// is the caller's (kernels/rx_fused.py pick_subcarrier_tile): 16 on any
// route, 8 or 32 on a tiled_route.  Each returns cudaErrorInvalidValue for
// a tile with no instance, else the launch's cudaError_t.
extern "C" int detect_demap_launch(const void* y, const void* h,
                                   const float* nv, int n_nv,
                                   const float* levels, float norm,
                                   float scale, void* x_hat, float* nv_eff,
                                   float* llr, float* ws, int batch,
                                   int n_sym, int n_sc, int n_rx, int n_tx,
                                   int nb, int sct, void* stream) {
  return dispatch<false>(y, h, nv, n_nv, levels, norm, scale, x_hat, nv_eff,
                         llr, ws, batch, n_sym, n_sc, n_rx, n_tx, nb, sct,
                         stream);
}

extern "C" int sic_demap_launch(const void* y, const void* h, const float* nv,
                                int n_nv, const float* levels, float norm,
                                float scale, void* x_hat, float* nv_eff,
                                float* llr, float* ws, int batch, int n_sym,
                                int n_sc, int n_rx, int n_tx, int nb, int sct,
                                void* stream) {
  return dispatch<true>(y, h, nv, n_nv, levels, norm, scale, x_hat, nv_eff,
                        llr, ws, batch, n_sym, n_sc, n_rx, n_tx, nb, sct,
                        stream);
}
