// Batched layered normalized min-sum LDPC decoder on Hopper (sm_90a).
//
// Replaces: repro/kernels/ldpc.py::_ldpc_kernel over _decode_core
// (ldpc_decode_pallas, fp32): per layer of the QC code, t = rolled
// posterior - previous check message, min / second min excluding self (the
// first argmin takes the second min), sign product, alpha damping and the
// write-back through the inverse circulant roll; per-codeword syndrome
// early exit and iteration count.
//
// What bounds it: latency, not bytes or operations.  A codeword reads
// n_b*z LLRs once and writes its posterior once (~6 KB for r12), but runs
// up to max_iters sweeps of n_layers dependent layer updates over state
// that never leaves the SM; a launch lasts as long as its slowest
// codeword.
//
// Design: one block per codeword, spread over the edges of a layer: warp
// e owns edge slot e of every layer, lane r owns lifted row r (lanes past
// z idle, still at every barrier).  A layer is two barriers: each thread
// forms its edge's t = v[pos] - c2v into shared memory; then each thread
// reads its row's deg t values, takes min1, min2, the first argmin and
// the sign parity in schedule order (the serial chain of the reference's
// sequential scan, so ties break the same way), and writes its edge's
// update.  Within a layer each block column appears once, so every
// (edge, row) owns a distinct position.  After each sweep the syndrome
// meets in __syncthreads_or; a converged codeword stops exactly where the
// reference freezes it, so posterior and iteration count match.
// ldpc_minsum_kernel takes codes of at most 16 layers of at most 16 edges
// whose z rows of S lanes (S the widest layer, to a power of two) fit one
// block of 1024 threads (every registered code; z <= 128 at S = 8) and
// lays a row's edges in one warp, so a layer is one barrier and its min /
// argmin / parity meet by shuffles (below).  ldpc_minsum_kernel_any takes
// any other code, as above (warp e owns slot e, lane r row r): warps loop
// over slots when a layer is wider than 32, lanes over rows when z > 32,
// and the check messages and rolled positions (computed once per block)
// live in shared memory beside the posterior, dynamic above 48 KB up to
// the device's opt-in limit; its syndrome runs one thread per (layer, row)
// check.  Products and sums use __fmul_rn / __fadd_rn / __fsub_rn (and the
// library is built with -fmad=false): no contraction, each rounding where
// the reference's alpha*par*sg*mag and t + upd round.
// Internally v = log P(0)/P(1): the boundary negates, as _to_lanes /
// _from_lanes do.
//
// ldpc_minsum_q_kernel, below, replaces the int8 datapath of the same
// Pallas kernel (ldpc_decode_pallas(precision="int8"|"fp8") over
// _decode_core_q / _layered_iteration_q): channel LLRs quantized onto the
// int8 grid with a true float32 division and round-half-to-even
// (__fdiv_rn + rintf, clipped at +-127), int8-saturated check messages,
// the damping (mag * round(alpha*256)) >> 8 applied to the magnitude
// before the sign, a posterior saturating at +-2047, the syndrome on the
// integer state, and the dequantized posterior v * step.  Its design is
// the earlier one-warp-per-codeword layout: lane r owns lifted row r, so
// z <= 32 (lanes past z idle: no loads or stores, a clean syndrome, still
// at every __syncwarp / __any_sync); 4 codewords a block, state (int32,
// 4 bytes a value) in shared memory, per-codeword early exit.  Integer
// arithmetic is exact, so posteriors and iteration counts equal the plain
// twin's bit for bit.
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_DEG_Q = 16;    // int8 kernel: a layer's edges per lane
constexpr int CW_PER_BLOCK = 4;  // int8 kernel: warps, hence codewords
constexpr unsigned FULL = 0xffffffffu;

// row r's position in a circulant of shift s, (r + s) % z, for r, s in
// [0, z) (the wrapper reduces the shifts): no integer division
__device__ __forceinline__ int roll(int r, int s, int z) {
  const int p = r + s;
  return p >= z ? p - z : p;
}

// ---- fp32: a block per codeword --------------------------------------------

// every (layer, row) check holds on v; a block-wide vote
__device__ __forceinline__ bool block_syndrome_ok(const float* v,
                                                  const int* pos,
                                                  const int* loff,
                                                  int n_layers, int z) {
  int bad = 0;
  for (int i = threadIdx.x; i < n_layers * z; i += blockDim.x) {
    const int l = i / z, r = i - l * z;
    int p = 0;
    for (int e = loff[l]; e < loff[l + 1]; ++e)
      p ^= v[pos[e * z + r]] < 0.f ? 1 : 0;
    bad |= p;
  }
  return !__syncthreads_or(bad);
}

__global__ void __launch_bounds__(1024)
ldpc_minsum_kernel_any(const float* __restrict__ llr,
                       float* __restrict__ post,
                       int* __restrict__ iters_out,
                       const int* __restrict__ layer_off,
                       const int* __restrict__ edge_col,
                       const int* __restrict__ edge_shift, int n_b, int z,
                       int n_layers, int n_edges, int max_deg,
                       int max_iters, float alpha) {
  extern __shared__ float smem[];
  float* v = smem;                      // n_b * z
  float* c2v = v + n_b * z;             // n_edges * z
  float* ts = c2v + n_edges * z;        // max_deg * z: one layer's t
  int* pos = reinterpret_cast<int*>(ts + max_deg * z);  // n_edges * z
  int* loff = pos + n_edges * z;        // n_layers + 1

  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const size_t cw = blockIdx.x;

  const float* in = llr + cw * n_b * z;
  for (int i = tid; i < n_b * z; i += nt) v[i] = -in[i];
  for (int i = tid; i < n_edges * z; i += nt) {
    const int e = i / z, r = i - e * z;
    c2v[i] = 0.f;
    pos[i] = edge_col[e] * z + roll(r, edge_shift[e], z);
  }
  for (int i = tid; i <= n_layers; i += nt) loff[i] = layer_off[i];
  __syncthreads();

  int it = 0;
  bool done = block_syndrome_ok(v, pos, loff, n_layers, z);
  while (!done && it < max_iters) {
    for (int l = 0; l < n_layers; ++l) {
      const int e0 = loff[l], deg = loff[l + 1] - e0;
      for (int e = warp; e < deg; e += nwarps)
        for (int r = lane; r < z; r += 32) {
          const int i = (e0 + e) * z + r;
          ts[e * z + r] = __fsub_rn(v[pos[i]], c2v[i]);
        }
      __syncthreads();
      for (int e = warp; e < deg; e += nwarps)
        for (int r = lane; r < z; r += 32) {
          float m1 = __int_as_float(0x7f800000), m2 = m1;  // +inf
          int amin = 0, neg = 0;
          for (int k = 0; k < deg; ++k) {
            const float tk = ts[k * z + r];
            const float a = fabsf(tk);
            if (a < m1) {
              m2 = m1;
              m1 = a;
              amin = k;
            } else if (a < m2) {
              m2 = a;
            }
            neg ^= tk < 0.f ? 1 : 0;
          }
          const float t = ts[e * z + r];
          const float ap = __fmul_rn(alpha, neg ? -1.f : 1.f);
          const float sg = t < 0.f ? -1.f : 1.f;
          const float upd = __fmul_rn(__fmul_rn(ap, sg), e == amin ? m2 : m1);
          const int i = (e0 + e) * z + r;
          v[pos[i]] = __fadd_rn(t, upd);
          c2v[i] = upd;
        }
      __syncthreads();
    }
    ++it;
    done = block_syndrome_ok(v, pos, loff, n_layers, z);
  }

  float* out = post + cw * n_b * z;
  for (int i = tid; i < n_b * z; i += nt) out[i] = -v[i];
  if (tid == 0) iters_out[cw] = it;
}

// The same decode for codes of at most REG_LAYERS layers of at most
// REG_DEG edges and z * S <= 1024 (every registered code), with a row's
// edges in one warp: a row owns a segment of S lanes (S the next power of
// two >= the widest layer), lane e of it edge slot e, so 32 / S rows a
// warp.  Each thread keeps, for every layer, its edge's rolled position
// and check message in registers; only the posterior (n_b*z floats, 3 KB
// for r12) lives in shared memory.  A layer is one barrier: t = v[pos] -
// c2v, then (min1, first argmin, min2) and the sign parity meet across the
// segment by log2(S) xor-shuffle merges (a tie goes to the lower slot, so
// the result is the sequential scan's), the update is written, barrier.
// The syndrome is each thread's sign bits of its edges, one bit a layer,
// XORed across the segment by shuffles.
constexpr int REG_LAYERS = 16;
constexpr int REG_DEG = 16;

__device__ __forceinline__ void merge_min(float& m1, int& i1, float& m2,
                                          float o1, int oi, float o2) {
  if (o1 < m1 || (o1 == m1 && oi < i1)) {
    m2 = fminf(m1, o2);
    m1 = o1;
    i1 = oi;
  } else {
    m2 = fminf(m2, o1);
  }
}

template <int SEG>
__global__ void __launch_bounds__(1024)
ldpc_minsum_kernel(const float* __restrict__ llr, float* __restrict__ post,
                   int* __restrict__ iters_out,
                   const int* __restrict__ layer_off,
                   const int* __restrict__ edge_col,
                   const int* __restrict__ edge_shift, int n_b, int z,
                   int n_layers, int max_iters, float alpha) {
  extern __shared__ float smem[];
  float* v = smem;  // n_b * z
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int e = lane & (SEG - 1);                      // edge slot
  const int r = (tid >> 5) * (32 / SEG) + lane / SEG;  // lifted row
  const bool row = r < z;
  const size_t cw = blockIdx.x;

  // the schedule, each step's loads issued together: layer offsets, then
  // this thread's edge of every layer
  int off[REG_LAYERS + 1], deg[REG_LAYERS], pos[REG_LAYERS];
  float c2v[REG_LAYERS];
#pragma unroll
  for (int l = 0; l <= REG_LAYERS; ++l)
    off[l] = l <= n_layers ? __ldg(layer_off + l) : 0;
#pragma unroll
  for (int l = 0; l < REG_LAYERS; ++l) {
    deg[l] = l < n_layers ? off[l + 1] - off[l] : 0;
    const bool mine = row && e < deg[l];
    const int col = mine ? __ldg(edge_col + off[l] + e) : 0;
    const int shift = mine ? __ldg(edge_shift + off[l] + e) : 0;
    pos[l] = col * z + roll(r < z ? r : 0, shift, z);
    c2v[l] = 0.f;
  }
  const float* in = llr + cw * n_b * z;
  for (int i = tid; i < n_b * z; i += nt) v[i] = -in[i];
  __syncthreads();

  int it = 0;
  bool done = false;
  for (;;) {
    // every (layer, row) check: bit l of a lane's mask is the sign of its
    // edge of layer l; a row's checks are the XOR over its segment
    int mask = 0;
#pragma unroll
    for (int l = 0; l < REG_LAYERS; ++l)
      if (l < n_layers && row && e < deg[l])
        mask |= (v[pos[l]] < 0.f ? 1 : 0) << l;
#pragma unroll
    for (int o = 1; o < SEG; o <<= 1)
      mask ^= __shfl_xor_sync(0xffffffffu, mask, o);
    done = !__syncthreads_or(mask);
    if (done || it >= max_iters) break;
#pragma unroll
    for (int l = 0; l < REG_LAYERS; ++l) {
      if (l >= n_layers) break;
      const bool live = row && e < deg[l];
      const float t = live ? __fsub_rn(v[pos[l]], c2v[l]) : 0.f;
      float m1 = live ? fabsf(t) : __int_as_float(0x7f800000);  // +inf
      float m2 = __int_as_float(0x7f800000);
      int i1 = e, neg = live && t < 0.f ? 1 : 0;
#pragma unroll
      for (int o = 1; o < SEG; o <<= 1) {
        const float o1 = __shfl_xor_sync(0xffffffffu, m1, o);
        const int oi = __shfl_xor_sync(0xffffffffu, i1, o);
        const float o2 = __shfl_xor_sync(0xffffffffu, m2, o);
        neg ^= __shfl_xor_sync(0xffffffffu, neg, o);
        merge_min(m1, i1, m2, o1, oi, o2);
      }
      if (live) {
        const float ap = __fmul_rn(alpha, neg ? -1.f : 1.f);
        const float sg = t < 0.f ? -1.f : 1.f;
        const float upd = __fmul_rn(__fmul_rn(ap, sg), e == i1 ? m2 : m1);
        v[pos[l]] = __fadd_rn(t, upd);
        c2v[l] = upd;
      }
      __syncthreads();
    }
    ++it;
  }

  float* out = post + cw * n_b * z;
  for (int i = tid; i < n_b * z; i += nt) out[i] = -v[i];
  if (tid == 0) iters_out[cw] = it;
}

// ---- int8: a warp per codeword ---------------------------------------------

constexpr int SAT_V = 2047;     // 12-bit posterior
constexpr int INT_INF = 32767;  // second-min sentinel, as the reference's

__device__ __forceinline__ bool warp_syndrome_ok(const int* v, int lane,
                                                 int z, const int* layer_off,
                                                 const int* edge_col,
                                                 const int* edge_shift,
                                                 int n_layers) {
  int bad = 0;
  if (lane < z) {
    for (int l = 0; l < n_layers; ++l) {
      int p = 0;
      for (int e = layer_off[l]; e < layer_off[l + 1]; ++e) {
        const int pos = edge_col[e] * z + roll(lane, edge_shift[e], z);
        p ^= v[pos] < 0 ? 1 : 0;
      }
      bad |= p;
    }
  }
  return !__any_sync(FULL, bad);
}

__global__ void ldpc_minsum_q_kernel(const float* __restrict__ llr,
                                     float* __restrict__ post,
                                     int* __restrict__ iters_out,
                                     const int* __restrict__ layer_off,
                                     const int* __restrict__ edge_col,
                                     const int* __restrict__ edge_shift,
                                     int n_cw, int n_b, int z, int n_layers,
                                     int n_edges, int max_iters,
                                     int alpha_q8, float step) {
  extern __shared__ int smem_i[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cw = blockIdx.x * CW_PER_BLOCK + warp;
  if (cw >= n_cw) return;  // whole warps retire together; no block barrier
  const bool live = lane < z;
  int* v = smem_i + (size_t)warp * (n_b + n_edges) * z;
  int* c2v = v + n_b * z;

  const float* in = llr + (size_t)cw * n_b * z;
  if (live) {
    for (int c = 0; c < n_b; ++c) {
      const float q = rintf(__fdiv_rn(-in[c * z + lane], step));
      v[c * z + lane] = (int)fminf(fmaxf(q, -127.f), 127.f);
    }
    for (int e = 0; e < n_edges; ++e) c2v[e * z + lane] = 0;
  }
  __syncwarp();

  int it = 0;
  bool done = warp_syndrome_ok(v, lane, z, layer_off, edge_col, edge_shift,
                               n_layers);
  while (!done && it < max_iters) {
    for (int l = 0; l < n_layers; ++l) {
      if (live) {
        const int e0 = layer_off[l];
        const int deg = layer_off[l + 1] - e0;
        int t[MAX_DEG_Q];
        int pos[MAX_DEG_Q];
        int m1 = INT_INF, m2 = INT_INF;
        int amin = 0;
        int neg = 0;
#pragma unroll
        for (int k = 0; k < MAX_DEG_Q; ++k) {
          if (k < deg) {
            pos[k] = edge_col[e0 + k] * z + roll(lane, edge_shift[e0 + k], z);
            t[k] = v[pos[k]] - c2v[(e0 + k) * z + lane];
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
        // the damped magnitudes, once per layer: (mag * alpha_q8) >> 8 of
        // a magnitude >= 0, saturated at 127 (sat8 of +-x is
        // +-min(x, 127))
        const int d1 = min((m1 * alpha_q8) >> 8, 127);
        const int d2 = min((m2 * alpha_q8) >> 8, 127);
#pragma unroll
        for (int k = 0; k < MAX_DEG_Q; ++k) {
          if (k < deg) {
            const int mag = k == amin ? d2 : d1;
            const int upd = (neg ^ (t[k] < 0 ? 1 : 0)) ? -mag : mag;
            v[pos[k]] = min(max(t[k] + upd, -SAT_V), SAT_V);
            c2v[(e0 + k) * z + lane] = upd;
          }
        }
      }
      __syncwarp();
    }
    ++it;
    done = warp_syndrome_ok(v, lane, z, layer_off, edge_col, edge_shift,
                            n_layers);
  }

  if (live) {
    float* out = post + (size_t)cw * n_b * z;
    for (int c = 0; c < n_b; ++c)
      out[c * z + lane] = -__fmul_rn((float)v[c * z + lane], step);
    if (lane == 0) iters_out[cw] = it;
  }
}

// the device's opt-in shared memory per block; raise `kernel`'s dynamic
// limit to it (once per device) when `bytes` exceeds the 48 KB default
template <typename Kernel>
cudaError_t fit_smem(Kernel kernel, size_t bytes,
                     std::atomic<unsigned long long>& done) {
  const int dev = hopper::current_device();
  int optin = 48 * 1024;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return hopper::allow_dynamic_smem(kernel, optin, done, dev);
}

}  // namespace

// llr, post (n_cw, n_b * z) float in the log P(1)/P(0) convention; iters
// (n_cw,) int; the schedule is CSR over layers: layer_off (n_layers + 1),
// edge_col / edge_shift (n_edges, shifts in [0, z)); max_deg is the
// widest layer.  Returns
// the launch's cudaError_t (cudaErrorInvalidValue when a codeword's state
// exceeds the device's shared memory per block).
extern "C" int ldpc_minsum_launch(const float* llr, float* post, int* iters,
                                  const int* layer_off, const int* edge_col,
                                  const int* edge_shift, int n_cw, int n_b,
                                  int z, int n_layers, int n_edges,
                                  int max_deg, int max_iters, float alpha,
                                  void* stream) {
  if (z <= 0 || n_b <= 0 || n_layers <= 0 || max_deg <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // lanes a row: the widest layer, to a power of two (at least 4)
  const int seg = max_deg <= 4 ? 4 : max_deg <= 8 ? 8 : 16;
  if (n_layers <= REG_LAYERS && max_deg <= REG_DEG && z * seg <= 1024) {
    const int threads = 32 * ((z * seg + 31) / 32);
    const size_t smem = sizeof(float) * (size_t)n_b * z;
    auto kernel = seg == 4    ? ldpc_minsum_kernel<4>
                  : seg == 8  ? ldpc_minsum_kernel<8>
                              : ldpc_minsum_kernel<16>;
    static std::atomic<unsigned long long> smem_set[3];  // per device
    const cudaError_t fit =
        fit_smem(kernel, smem, smem_set[seg == 4 ? 0 : seg == 8 ? 1 : 2]);
    if (fit != cudaSuccess) return (int)fit;
    if (n_cw == 0) return 0;
    kernel<<<n_cw, threads, smem, s>>>(llr, post, iters, layer_off,
                                       edge_col, edge_shift, n_b, z,
                                       n_layers, max_iters, alpha);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      sizeof(float) * ((size_t)z * (n_b + 2 * n_edges + max_deg)
                       + n_layers + 1);
  static std::atomic<unsigned long long> smem_set{0};  // per device
  const cudaError_t fit = fit_smem(ldpc_minsum_kernel_any, smem, smem_set);
  if (fit != cudaSuccess) return (int)fit;
  if (n_cw == 0) return 0;
  const int threads = 32 * (max_deg < 32 ? max_deg : 32);
  ldpc_minsum_kernel_any<<<n_cw, threads, smem, s>>>(
      llr, post, iters, layer_off, edge_col, edge_shift, n_b, z, n_layers,
      n_edges, max_deg, max_iters, alpha);
  return (int)cudaGetLastError();
}

// The int8 datapath, the same layouts as ldpc_minsum_launch, z <= 32 and
// layers of at most 16 edges; alpha_q8 = round(alpha * 256), step = the
// LLR units of one int8 code.
extern "C" int ldpc_minsum_q_launch(const float* llr, float* post,
                                    int* iters, const int* layer_off,
                                    const int* edge_col,
                                    const int* edge_shift, int n_cw,
                                    int n_b, int z, int n_layers,
                                    int n_edges, int max_deg, int max_iters,
                                    int alpha_q8, float step, void* stream) {
  if (z <= 0 || z > 32 || max_deg > MAX_DEG_Q)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(int) * (size_t)CW_PER_BLOCK * (n_b + n_edges) * z;
  static std::atomic<unsigned long long> smem_set{0};  // per device
  const cudaError_t fit = fit_smem(ldpc_minsum_q_kernel, smem, smem_set);
  if (fit != cudaSuccess) return (int)fit;
  if (n_cw == 0) return 0;
  const int blocks = (n_cw + CW_PER_BLOCK - 1) / CW_PER_BLOCK;
  ldpc_minsum_q_kernel<<<blocks, CW_PER_BLOCK * 32, smem,
                         (cudaStream_t)stream>>>(
      llr, post, iters, layer_off, edge_col, edge_shift, n_cw, n_b, z,
      n_layers, n_edges, max_iters, alpha_q8, step);
  return (int)cudaGetLastError();
}
