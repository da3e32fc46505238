// Batched layered normalized min-sum LDPC decoder on Hopper (sm_90a).
//
// Replaces: repro/kernels/ldpc.py::_ldpc_kernel over _decode_core
// (ldpc_decode_pallas, fp32): per layer of the QC code, t = rolled
// posterior - previous check message, min / second min excluding self (the
// first argmin takes the second min), sign product, alpha damping and the
// write-back through the inverse circulant roll; per-codeword syndrome
// early exit and iteration count.
//
// What bounds it: operations and latency, not bytes.  A codeword reads
// n_b*z LLRs once and writes its posterior once (~6 KB for r12), but runs
// up to max_iters sweeps of ~10 dependent ops per edge and lifted row over
// state that never leaves the SM.
//
// Design: one warp per codeword; lane r owns lifted row r (z == 32, the
// warp width, which the wrapper enforces).  The posterior v (n_b*z floats)
// and the check messages (edges*z floats) live in shared memory: 10.6 KB a
// codeword for r12 (8.3 KB for r34), so CW_PER_BLOCK = 4 codewords share a
// 128-thread block under the 48 KB dynamic shared-memory default.  A circulant roll is the index (r + s) % z.  Within a
// layer each block column appears once, so lane r reads and writes only
// its own positions; a __syncwarp() between layers is the only ordering
// needed.  Early exit is per codeword (a per-lane syndrome over every
// layer, then __any_sync), which stops exactly where the reference freezes
// a converged lane, so posterior and iteration count match it.  Products
// and sums use __fmul_rn / __fadd_rn / __fsub_rn (and the library is built
// with -fmad=false): no contraction, each rounding where the reference's
// alpha*par*sg*mag and t + upd round, so hard bits and iteration counts
// match the plain twin exactly.  Internally v = log P(0)/P(1): the
// boundary negates, as _to_lanes / _from_lanes do.
//
// ldpc_minsum_q_kernel, below, replaces the int8 datapath of the same
// Pallas kernel (ldpc_decode_pallas(precision="int8"|"fp8") over
// _decode_core_q / _layered_iteration_q): channel LLRs quantized onto the
// int8 grid with a true float32 division and round-half-to-even
// (__fdiv_rn + rintf, clipped at +-127), int8-saturated check messages,
// the damping (mag * round(alpha*256)) >> 8 applied to the magnitude
// before the sign, a posterior saturating at +-2047, the syndrome on the
// integer state, and the dequantized posterior v * step.  Same bound and
// the same design as the fp32 kernel: one warp per codeword, CSR schedule,
// state in shared memory (int32 lanes, 4 bytes a value as in fp32; int16
// posterior plus int8 messages would halve it), per-codeword early exit.
// Integer arithmetic is exact, so posteriors and iteration counts equal
// the plain twin's bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int Z = 32;
constexpr int MAX_DEG = 16;
constexpr int CW_PER_BLOCK = 4;  // warps, hence codewords, per block
constexpr size_t SMEM_LIMIT = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ bool syndrome_ok(const T* v, int lane,
                                            const int* layer_off,
                                            const int* edge_col,
                                            const int* edge_shift,
                                            int n_layers) {
  int bad = 0;
  for (int l = 0; l < n_layers; ++l) {
    int p = 0;
    for (int e = layer_off[l]; e < layer_off[l + 1]; ++e) {
      const int pos = edge_col[e] * Z + (lane + edge_shift[e]) % Z;
      p ^= v[pos] < T(0) ? 1 : 0;
    }
    bad |= p;
  }
  return !__any_sync(FULL, bad);
}

__global__ void ldpc_minsum_kernel(const float* __restrict__ llr,
                                   float* __restrict__ post,
                                   int* __restrict__ iters_out,
                                   const int* __restrict__ layer_off,
                                   const int* __restrict__ edge_col,
                                   const int* __restrict__ edge_shift,
                                   int n_cw, int n_b, int n_layers,
                                   int n_edges, int max_iters, float alpha) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cw = blockIdx.x * CW_PER_BLOCK + warp;
  if (cw >= n_cw) return;  // whole warps retire together; no block barrier
  float* v = smem + (size_t)warp * (n_b + n_edges) * Z;
  float* c2v = v + n_b * Z;

  const float* in = llr + (size_t)cw * n_b * Z;
  for (int c = 0; c < n_b; ++c) v[c * Z + lane] = -in[c * Z + lane];
  for (int e = 0; e < n_edges; ++e) c2v[e * Z + lane] = 0.f;
  __syncwarp();

  int it = 0;
  bool done =
      syndrome_ok(v, lane, layer_off, edge_col, edge_shift, n_layers);
  while (!done && it < max_iters) {
    for (int l = 0; l < n_layers; ++l) {
      const int e0 = layer_off[l];
      const int deg = layer_off[l + 1] - e0;
      float t[MAX_DEG];
      int pos[MAX_DEG];
      float m1 = __int_as_float(0x7f800000), m2 = m1;  // +inf
      int amin = 0;
      int neg = 0;
#pragma unroll
      for (int k = 0; k < MAX_DEG; ++k) {
        if (k < deg) {
          pos[k] = edge_col[e0 + k] * Z + (lane + edge_shift[e0 + k]) % Z;
          t[k] = __fsub_rn(v[pos[k]], c2v[(e0 + k) * Z + lane]);
          const float a = fabsf(t[k]);
          if (a < m1) {
            m2 = m1;
            m1 = a;
            amin = k;
          } else if (a < m2) {
            m2 = a;
          }
          neg ^= t[k] < 0.f ? 1 : 0;
        }
      }
      const float par = neg ? -1.f : 1.f;
      const float ap = __fmul_rn(alpha, par);
#pragma unroll
      for (int k = 0; k < MAX_DEG; ++k) {
        if (k < deg) {
          const float sg = t[k] < 0.f ? -1.f : 1.f;
          const float mag = k == amin ? m2 : m1;
          const float upd = __fmul_rn(__fmul_rn(ap, sg), mag);
          v[pos[k]] = __fadd_rn(t[k], upd);
          c2v[(e0 + k) * Z + lane] = upd;
        }
      }
      __syncwarp();
    }
    ++it;
    done = syndrome_ok(v, lane, layer_off, edge_col, edge_shift, n_layers);
  }

  float* out = post + (size_t)cw * n_b * Z;
  for (int c = 0; c < n_b; ++c) out[c * Z + lane] = -v[c * Z + lane];
  if (lane == 0) iters_out[cw] = it;
}

constexpr int SAT_V = 2047;    // 12-bit posterior
constexpr int INT_INF = 32767;  // second-min sentinel, as the reference's

__global__ void ldpc_minsum_q_kernel(const float* __restrict__ llr,
                                     float* __restrict__ post,
                                     int* __restrict__ iters_out,
                                     const int* __restrict__ layer_off,
                                     const int* __restrict__ edge_col,
                                     const int* __restrict__ edge_shift,
                                     int n_cw, int n_b, int n_layers,
                                     int n_edges, int max_iters,
                                     int alpha_q8, float step) {
  extern __shared__ int smem_i[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cw = blockIdx.x * CW_PER_BLOCK + warp;
  if (cw >= n_cw) return;
  int* v = smem_i + (size_t)warp * (n_b + n_edges) * Z;
  int* c2v = v + n_b * Z;

  const float* in = llr + (size_t)cw * n_b * Z;
  for (int c = 0; c < n_b; ++c) {
    const float q = rintf(__fdiv_rn(-in[c * Z + lane], step));
    v[c * Z + lane] = (int)fminf(fmaxf(q, -127.f), 127.f);
  }
  for (int e = 0; e < n_edges; ++e) c2v[e * Z + lane] = 0;
  __syncwarp();

  int it = 0;
  bool done =
      syndrome_ok(v, lane, layer_off, edge_col, edge_shift, n_layers);
  while (!done && it < max_iters) {
    for (int l = 0; l < n_layers; ++l) {
      const int e0 = layer_off[l];
      const int deg = layer_off[l + 1] - e0;
      int t[MAX_DEG];
      int pos[MAX_DEG];
      int m1 = INT_INF, m2 = INT_INF;
      int amin = 0;
      int neg = 0;
#pragma unroll
      for (int k = 0; k < MAX_DEG; ++k) {
        if (k < deg) {
          pos[k] = edge_col[e0 + k] * Z + (lane + edge_shift[e0 + k]) % Z;
          t[k] = v[pos[k]] - c2v[(e0 + k) * Z + lane];
          const int a = abs(t[k]);
          if (a < m1) {
            m2 = m1;
            m1 = a;
            amin = k;
          } else if (a < m2) {
            m2 = a;
          }
          neg ^= t[k] < 0 ? 1 : 0;
        }
      }
      // the damped magnitudes, once per layer: (mag * alpha_q8) >> 8 of a
      // magnitude >= 0, saturated at 127 (sat8 of +-x is +-min(x, 127))
      const int d1 = min((m1 * alpha_q8) >> 8, 127);
      const int d2 = min((m2 * alpha_q8) >> 8, 127);
#pragma unroll
      for (int k = 0; k < MAX_DEG; ++k) {
        if (k < deg) {
          const int mag = k == amin ? d2 : d1;
          const int upd = (neg ^ (t[k] < 0 ? 1 : 0)) ? -mag : mag;
          v[pos[k]] = min(max(t[k] + upd, -SAT_V), SAT_V);
          c2v[(e0 + k) * Z + lane] = upd;
        }
      }
      __syncwarp();
    }
    ++it;
    done = syndrome_ok(v, lane, layer_off, edge_col, edge_shift, n_layers);
  }

  float* out = post + (size_t)cw * n_b * Z;
  for (int c = 0; c < n_b; ++c)
    out[c * Z + lane] = -__fmul_rn((float)v[c * Z + lane], step);
  if (lane == 0) iters_out[cw] = it;
}

}  // namespace

// llr, post (n_cw, n_b * 32) float in the log P(1)/P(0) convention;
// iters (n_cw,) int; the schedule is CSR over layers: layer_off
// (n_layers + 1), edge_col / edge_shift (n_edges).  Returns the launch's
// cudaError_t (cudaErrorInvalidValue when a row is wider than MAX_DEG or a
// block's state exceeds 48 KB).
extern "C" int ldpc_minsum_launch(const float* llr, float* post, int* iters,
                                  const int* layer_off, const int* edge_col,
                                  const int* edge_shift, int n_cw, int n_b,
                                  int n_layers, int n_edges, int max_deg,
                                  int max_iters, float alpha, void* stream) {
  const size_t smem =
      sizeof(float) * (size_t)CW_PER_BLOCK * (n_b + n_edges) * Z;
  if (max_deg > MAX_DEG || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (n_cw == 0) return 0;
  const int blocks = (n_cw + CW_PER_BLOCK - 1) / CW_PER_BLOCK;
  ldpc_minsum_kernel<<<blocks, CW_PER_BLOCK * 32, smem,
                       (cudaStream_t)stream>>>(
      llr, post, iters, layer_off, edge_col, edge_shift, n_cw, n_b,
      n_layers, n_edges, max_iters, alpha);
  return (int)cudaGetLastError();
}

// The int8 datapath, same arguments and layouts as ldpc_minsum_launch;
// alpha_q8 = round(alpha * 256), step = the LLR units of one int8 code.
extern "C" int ldpc_minsum_q_launch(const float* llr, float* post,
                                    int* iters, const int* layer_off,
                                    const int* edge_col,
                                    const int* edge_shift, int n_cw,
                                    int n_b, int n_layers, int n_edges,
                                    int max_deg, int max_iters, int alpha_q8,
                                    float step, void* stream) {
  const size_t smem =
      sizeof(int) * (size_t)CW_PER_BLOCK * (n_b + n_edges) * Z;
  if (max_deg > MAX_DEG || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (n_cw == 0) return 0;
  const int blocks = (n_cw + CW_PER_BLOCK - 1) / CW_PER_BLOCK;
  ldpc_minsum_q_kernel<<<blocks, CW_PER_BLOCK * 32, smem,
                         (cudaStream_t)stream>>>(
      llr, post, iters, layer_off, edge_col, edge_shift, n_cw, n_b,
      n_layers, n_edges, max_iters, alpha_q8, step);
  return (int)cudaGetLastError();
}
