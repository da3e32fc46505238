// Batched layered normalized min-sum LDPC decoder on Hopper (sm_90a): the
// fp32 datapath and the saturating int8 one.
//
// Replaces: repro/kernels/ldpc.py::_ldpc_kernel (ldpc_decode_pallas) over
// _decode_core (fp32) and over _decode_core_q / _layered_iteration_q
// (precision="int8"|"fp8"): per layer of the QC code, t = rolled posterior
// - previous check message, min / second min excluding self (the first
// argmin takes the second min), sign product, damping and the write-back
// through the inverse circulant roll; per-codeword syndrome early exit and
// iteration count.
//
// What bounds it: latency, not bytes or operations.  A codeword reads
// n_b*z LLRs once and writes its posterior once (~6 KB for r12), but runs
// up to max_iters sweeps of n_layers dependent layer updates over state
// that never leaves the SM; a launch lasts as long as its slowest
// codeword.
//
// The two datapaths share every kernel below through a policy (Fp32 /
// Int8): only the entry, the check message, the posterior update and the
// exit differ.
//   fp32: v = -llr; upd = alpha * (sign product) * mag and t + upd with
//     __fmul_rn / __fadd_rn / __fsub_rn (and the library is built with
//     -fmad=false): no contraction, each rounding where the reference's
//     alpha*par*sg*mag and t + upd round; posterior -v.
//   int8: channel LLRs quantized onto the int8 grid with a true float32
//     division and round-half-to-even (__fdiv_rn + rintf, clipped at
//     +-127), the damping (mag * round(alpha*256)) >> 8 applied to the
//     magnitude before the sign and saturated at 127 (int8 messages), a
//     posterior saturating at +-2047, the syndrome on the integer state,
//     and the dequantized posterior -(v * step) (__fmul_rn).  Integer
//     arithmetic is exact, so posteriors and iteration counts equal the
//     plain twin's bit for bit.
// Internally v = log P(0)/P(1): the boundary negates, as _to_lanes /
// _from_lanes do.
//
// Design: one block per codeword.  ldpc_minsum_kernel<SEG> (fp32) and
// ldpc_minsum_q_kernel<SEG> (int8) take codes of at most 16 layers of at
// most 16 edges whose z rows of S lanes (S >= the widest layer, a power of
// two; the caller's choice, kernels/ldpc.py pick_segment, whose heuristic
// takes the widest layer to a power of two, at least 4) fit one block of
// 1024 threads (every registered code; z <= 128 at S = 8): a row owns a
// segment of S lanes of one warp, lane e of it edge slot e (lanes past the
// layer's edges idle), so 32 / S rows a warp.  Each thread keeps, for every layer, its
// edge's rolled position and check message in registers; only the
// posterior (n_b*z values, 3 KB for r12, int32 for int8) lives in shared
// memory.  A layer is one barrier: t = v[pos] - c2v, then (min1, first
// argmin, min2) and the sign parity meet across the segment by log2(S)
// xor-shuffle merges (a tie goes to the lower slot, so the result is the
// sequential scan's), the update is written, barrier.  Within a layer each
// block column appears once, so every (edge, row) owns a distinct
// position.  The syndrome is each thread's sign bits of its edges, one bit
// a layer, XORed across the segment by shuffles and met in
// __syncthreads_or; a converged codeword stops exactly where the reference
// freezes it, so posterior and iteration count match.
//
// ldpc_minsum_kernel_any / ldpc_minsum_q_kernel_any take every other code
// (any z, any layer width, any number of layers): a thread owns lifted row
// r (rows looped past 1024), and per layer scans its row's edges in
// schedule order twice (min1 / min2 / first argmin / parity, then the
// updates), so no t and no rolled position is stored: within a layer no
// two (edge, row) pairs share a position, so a thread reads and writes
// only its own.  One barrier a layer.  The posterior stays in shared
// memory (48 KB at z = 512 for r12) and the check messages go to a global
// workspace the wrapper allocates, (n_cw, n_edges, z) values: a thread
// reads only its own messages, consecutive threads consecutive rows, and
// for 216 r12 codewords at z = 512 the workspace (26 MB) stays in the
// 50 MB L2.  A posterior past the device's shared memory (z > ~2400 for
// r12) goes to the workspace too.
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int REG_LAYERS = 16;  // the fast kernels' codes: layers ...
constexpr int REG_DEG = 16;     // ... and edges a layer
constexpr int SAT_V = 2047;     // int8: 12-bit posterior
constexpr int INT_INF = 32767;  // int8: second-min sentinel, as the twin's
constexpr unsigned FULL = 0xffffffffu;

// row r's position in a circulant of shift s, (r + s) % z, for r, s in
// [0, z) (the wrapper reduces the shifts): no integer division
__device__ __forceinline__ int roll(int r, int s, int z) {
  const int p = r + s;
  return p >= z ? p - z : p;
}

struct Fp32 {
  using V = float;
  float alpha;
  __device__ __forceinline__ V enter(float llr) const { return -llr; }
  __device__ __forceinline__ float leave(V v) const { return -v; }
  __device__ __forceinline__ static V inf() {
    return __int_as_float(0x7f800000);
  }
  __device__ __forceinline__ static V sub(V a, V b) { return __fsub_rn(a, b); }
  __device__ __forceinline__ static V mag(V t) { return fabsf(t); }
  // the check message of an edge with variable-to-check value t, given
  // the row's sign parity neg (all edges) and the magnitude m excluding t
  __device__ __forceinline__ V message(V t, int neg, V m) const {
    const float ap = __fmul_rn(alpha, neg ? -1.f : 1.f);
    const float sg = t < 0.f ? -1.f : 1.f;
    return __fmul_rn(__fmul_rn(ap, sg), m);
  }
  __device__ __forceinline__ static V post(V t, V upd) {
    return __fadd_rn(t, upd);
  }
};

struct Int8 {
  using V = int;
  int alpha_q8;
  float step;
  __device__ __forceinline__ V enter(float llr) const {
    const float q = rintf(__fdiv_rn(-llr, step));
    return (int)fminf(fmaxf(q, -127.f), 127.f);
  }
  __device__ __forceinline__ float leave(V v) const {
    return -__fmul_rn((float)v, step);
  }
  __device__ __forceinline__ static V inf() { return INT_INF; }
  __device__ __forceinline__ static V sub(V a, V b) { return a - b; }
  __device__ __forceinline__ static V mag(V t) { return abs(t); }
  // sat8(par * sg * ((mag * alpha_q8) >> 8)) of a magnitude >= 0: the
  // sign after the damping, saturated at 127
  __device__ __forceinline__ V message(V t, int neg, V m) const {
    const int d = min((m * alpha_q8) >> 8, 127);
    return (neg ^ (t < 0 ? 1 : 0)) ? -d : d;
  }
  __device__ __forceinline__ static V post(V t, V upd) {
    return min(max(t + upd, -SAT_V), SAT_V);
  }
};

template <typename V>
__device__ __forceinline__ void merge_min(V& m1, int& i1, V& m2, V o1,
                                          int oi, V o2) {
  if (o1 < m1 || (o1 == m1 && oi < i1)) {
    m2 = min(m1, o2);
    m1 = o1;
    i1 = oi;
  } else {
    m2 = min(m2, o1);
  }
}

// ---- a row's edges in one warp segment -------------------------------------

template <int SEG, typename P>
__device__ __forceinline__ void decode_segments(
    const P& p, const float* __restrict__ llr, float* __restrict__ post,
    int* __restrict__ iters_out, const int* __restrict__ layer_off,
    const int* __restrict__ edge_col, const int* __restrict__ edge_shift,
    int n_b, int z, int n_layers, int max_iters) {
  using V = typename P::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* v = reinterpret_cast<V*>(smem_raw);  // n_b * z
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int e = lane & (SEG - 1);                      // edge slot
  const int r = (tid >> 5) * (32 / SEG) + lane / SEG;  // lifted row
  const bool row = r < z;
  const size_t cw = blockIdx.x;

  // the schedule, each step's loads issued together: layer offsets, then
  // this thread's edge of every layer
  int off[REG_LAYERS + 1], deg[REG_LAYERS], pos[REG_LAYERS];
  V c2v[REG_LAYERS];
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
    c2v[l] = V(0);
  }
  const float* in = llr + cw * n_b * z;
  for (int i = tid; i < n_b * z; i += nt) v[i] = p.enter(in[i]);
  __syncthreads();

  int it = 0;
  for (;;) {
    // every (layer, row) check: bit l of a lane's mask is the sign of its
    // edge of layer l; a row's checks are the XOR over its segment
    int mask = 0;
#pragma unroll
    for (int l = 0; l < REG_LAYERS; ++l)
      if (l < n_layers && row && e < deg[l])
        mask |= (v[pos[l]] < V(0) ? 1 : 0) << l;
#pragma unroll
    for (int o = 1; o < SEG; o <<= 1) mask ^= __shfl_xor_sync(FULL, mask, o);
    const bool done = !__syncthreads_or(mask);
    if (done || it >= max_iters) break;
#pragma unroll
    for (int l = 0; l < REG_LAYERS; ++l) {
      if (l >= n_layers) break;
      const bool live = row && e < deg[l];
      const V t = live ? P::sub(v[pos[l]], c2v[l]) : V(0);
      V m1 = live ? P::mag(t) : P::inf();
      V m2 = P::inf();
      int i1 = e, neg = live && t < V(0) ? 1 : 0;
#pragma unroll
      for (int o = 1; o < SEG; o <<= 1) {
        const V o1 = __shfl_xor_sync(FULL, m1, o);
        const int oi = __shfl_xor_sync(FULL, i1, o);
        const V o2 = __shfl_xor_sync(FULL, m2, o);
        neg ^= __shfl_xor_sync(FULL, neg, o);
        merge_min(m1, i1, m2, o1, oi, o2);
      }
      if (live) {
        const V upd = p.message(t, neg, e == i1 ? m2 : m1);
        v[pos[l]] = P::post(t, upd);
        c2v[l] = upd;
      }
      __syncthreads();
    }
    ++it;
  }

  float* out = post + cw * n_b * z;
  for (int i = tid; i < n_b * z; i += nt) out[i] = p.leave(v[i]);
  if (tid == 0) iters_out[cw] = it;
}

template <int SEG>
__global__ void __launch_bounds__(1024)
ldpc_minsum_kernel(Fp32 p, const float* __restrict__ llr,
                   float* __restrict__ post, int* __restrict__ iters,
                   const int* __restrict__ layer_off,
                   const int* __restrict__ edge_col,
                   const int* __restrict__ edge_shift, int n_b, int z,
                   int n_layers, int max_iters) {
  decode_segments<SEG>(p, llr, post, iters, layer_off, edge_col, edge_shift,
                       n_b, z, n_layers, max_iters);
}

template <int SEG>
__global__ void __launch_bounds__(1024)
ldpc_minsum_q_kernel(Int8 p, const float* __restrict__ llr,
                     float* __restrict__ post, int* __restrict__ iters,
                     const int* __restrict__ layer_off,
                     const int* __restrict__ edge_col,
                     const int* __restrict__ edge_shift, int n_b, int z,
                     int n_layers, int max_iters) {
  decode_segments<SEG>(p, llr, post, iters, layer_off, edge_col, edge_shift,
                       n_b, z, n_layers, max_iters);
}

// ---- any code: a thread per lifted row -------------------------------------

// ws: this launch's workspace, per codeword the check messages
// (n_edges * z values) and, with v_in_ws, the posterior before them
template <typename P>
__device__ __forceinline__ void decode_rows(
    const P& p, const float* __restrict__ llr, float* __restrict__ post,
    int* __restrict__ iters_out, const int* __restrict__ layer_off,
    const int* __restrict__ edge_col, const int* __restrict__ edge_shift,
    typename P::V* __restrict__ ws, int n_b, int z, int n_layers,
    int n_edges, int v_in_ws, int max_iters) {
  using V = typename P::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* loff = reinterpret_cast<int*>(smem_raw);  // n_layers + 1
  int* col = loff + n_layers + 1;                // n_edges
  int* shift = col + n_edges;                    // n_edges
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t cw = blockIdx.x;
  V* mine = ws + cw * (size_t)(n_edges + (v_in_ws ? n_b : 0)) * z;
  V* v = v_in_ws ? mine : reinterpret_cast<V*>(shift + n_edges);
  V* c2v = v_in_ws ? mine + (size_t)n_b * z : mine;  // n_edges * z

  for (int i = tid; i <= n_layers; i += nt) loff[i] = layer_off[i];
  for (int i = tid; i < n_edges; i += nt) {
    col[i] = edge_col[i] * z;
    shift[i] = edge_shift[i];
  }
  const float* in = llr + cw * n_b * z;
  for (int i = tid; i < n_b * z; i += nt) v[i] = p.enter(in[i]);
  for (int i = tid; i < n_edges * z; i += nt) c2v[i] = V(0);
  __syncthreads();

  // every (layer, row) check holds on v; a block-wide vote
  auto syndrome_ok = [&]() {
    int bad = 0;
    for (int r = tid; r < z; r += nt)
      for (int l = 0; l < n_layers; ++l) {
        int par = 0;
        for (int e = loff[l]; e < loff[l + 1]; ++e)
          par ^= v[col[e] + roll(r, shift[e], z)] < V(0) ? 1 : 0;
        bad |= par;
      }
    return !__syncthreads_or(bad);
  };

  int it = 0;
  bool done = syndrome_ok();
  while (!done && it < max_iters) {
    for (int l = 0; l < n_layers; ++l) {
      const int e0 = loff[l], e1 = loff[l + 1];
      for (int r = tid; r < z; r += nt) {
        V m1 = P::inf(), m2 = P::inf();
        int amin = e0, neg = 0;
        for (int e = e0; e < e1; ++e) {
          const V t = P::sub(v[col[e] + roll(r, shift[e], z)],
                             c2v[(size_t)e * z + r]);
          const V a = P::mag(t);
          if (a < m1) {
            m2 = m1;
            m1 = a;
            amin = e;
          } else if (a < m2) {
            m2 = a;
          }
          neg ^= t < V(0) ? 1 : 0;
        }
        for (int e = e0; e < e1; ++e) {
          const int at = col[e] + roll(r, shift[e], z);
          const size_t ci = (size_t)e * z + r;
          const V t = P::sub(v[at], c2v[ci]);
          const V upd = p.message(t, neg, e == amin ? m2 : m1);
          v[at] = P::post(t, upd);
          c2v[ci] = upd;
        }
      }
      __syncthreads();
    }
    ++it;
    done = syndrome_ok();
  }

  float* out = post + cw * n_b * z;
  for (int i = tid; i < n_b * z; i += nt) out[i] = p.leave(v[i]);
  if (tid == 0) iters_out[cw] = it;
}

__global__ void __launch_bounds__(1024)
ldpc_minsum_kernel_any(Fp32 p, const float* __restrict__ llr,
                       float* __restrict__ post, int* __restrict__ iters,
                       const int* __restrict__ layer_off,
                       const int* __restrict__ edge_col,
                       const int* __restrict__ edge_shift,
                       float* __restrict__ ws, int n_b, int z, int n_layers,
                       int n_edges, int v_in_ws, int max_iters) {
  decode_rows(p, llr, post, iters, layer_off, edge_col, edge_shift, ws, n_b,
              z, n_layers, n_edges, v_in_ws, max_iters);
}

__global__ void __launch_bounds__(1024)
ldpc_minsum_q_kernel_any(Int8 p, const float* __restrict__ llr,
                         float* __restrict__ post, int* __restrict__ iters,
                         const int* __restrict__ layer_off,
                         const int* __restrict__ edge_col,
                         const int* __restrict__ edge_shift,
                         int* __restrict__ ws, int n_b, int z, int n_layers,
                         int n_edges, int v_in_ws, int max_iters) {
  decode_rows(p, llr, post, iters, layer_off, edge_col, edge_shift, ws, n_b,
              z, n_layers, n_edges, v_in_ws, max_iters);
}

// ---- launch ----------------------------------------------------------------

// the device's opt-in shared memory per block (227 KB on an H100)
int smem_optin() {
  int optin = 48 * 1024;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         hopper::current_device());
  return optin;
}

// raise `kernel`'s dynamic shared-memory limit to the device's opt-in
// (once per device) when `bytes` exceeds the 48 KB default; refuse bytes
// past the opt-in
template <typename Kernel>
cudaError_t fit_smem(Kernel kernel, size_t bytes,
                     std::atomic<unsigned long long>& done) {
  const int optin = smem_optin();
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return hopper::allow_dynamic_smem(kernel, optin, done,
                                    hopper::current_device());
}

// each datapath's kernels, picked by the policy's type
template <int SEG>
auto segment_kernel(Fp32) { return ldpc_minsum_kernel<SEG>; }
template <int SEG>
auto segment_kernel(Int8) { return ldpc_minsum_q_kernel<SEG>; }
inline auto rows_kernel(Fp32) { return ldpc_minsum_kernel_any; }
inline auto rows_kernel(Int8) { return ldpc_minsum_q_kernel_any; }

template <typename P>
int launch(const P& p, const float* llr, float* post, int* iters,
           const int* layer_off, const int* edge_col, const int* edge_shift,
           void* ws, int n_cw, int n_b, int z, int n_layers, int n_edges,
           int max_deg, int max_iters, int seg, cudaStream_t s) {
  using V = typename P::V;
  if (z <= 0 || n_b <= 0 || n_layers <= 0 || max_deg <= 0 || n_cw < 0)
    return (int)cudaErrorInvalidValue;
  // seg, the caller's: lanes a row of the segment kernels (4, 8 or 16, at
  // least the widest layer, z rows of it in one block), or 0 for the row
  // kernels
  if (seg != 0 &&
      ((seg != 4 && seg != 8 && seg != REG_DEG) || seg < max_deg ||
       n_layers > REG_LAYERS || z * seg > 1024))
    return (int)cudaErrorInvalidValue;
  if (seg != 0) {
    const int threads = 32 * ((z * seg + 31) / 32);
    const size_t smem = sizeof(V) * (size_t)n_b * z;
    auto kernel = seg == 4   ? segment_kernel<4>(p)
                  : seg == 8 ? segment_kernel<8>(p)
                             : segment_kernel<16>(p);
    static std::atomic<unsigned long long> smem_set[3];  // per device
    const cudaError_t fit =
        fit_smem(kernel, smem, smem_set[seg == 4 ? 0 : seg == 8 ? 1 : 2]);
    if (fit != cudaSuccess) return (int)fit;
    if (n_cw == 0) return 0;
    kernel<<<n_cw, threads, smem, s>>>(p, llr, post, iters, layer_off,
                                       edge_col, edge_shift, n_b, z,
                                       n_layers, max_iters);
    return (int)cudaGetLastError();
  }
  if (ws == nullptr && n_cw > 0) return (int)cudaErrorInvalidValue;
  // the schedule, and the posterior while it fits
  const size_t sched = sizeof(int) * (size_t)(n_layers + 1 + 2 * n_edges);
  const size_t v_bytes = sizeof(V) * (size_t)n_b * z;
  const int v_in_ws = sched + v_bytes > (size_t)smem_optin();
  const size_t smem = sched + (v_in_ws ? 0 : v_bytes);
  static std::atomic<unsigned long long> smem_set{0};  // per device
  auto kernel = rows_kernel(p);
  const cudaError_t fit = fit_smem(kernel, smem, smem_set);
  if (fit != cudaSuccess) return (int)fit;
  if (n_cw == 0) return 0;
  const int threads = z < 1024 ? 32 * ((z + 31) / 32) : 1024;
  kernel<<<n_cw, threads, smem, s>>>(p, llr, post, iters, layer_off,
                                     edge_col, edge_shift,
                                     static_cast<V*>(ws), n_b, z, n_layers,
                                     n_edges, v_in_ws, max_iters);
  return (int)cudaGetLastError();
}

}  // namespace

// llr, post (n_cw, n_b * z) float in the log P(1)/P(0) convention; iters
// (n_cw,) int; the schedule is CSR over layers: layer_off (n_layers + 1),
// edge_col / edge_shift (n_edges, shifts in [0, z)); max_deg is the
// widest layer.  ws: room for n_cw * (n_edges + n_b) * z 4-byte values,
// the row kernels' workspace (unused by the segment kernels).  seg, the
// caller's (kernels/ldpc.py pick_segment): the segment kernels' lanes a
// row, 4, 8 or 16 (at least max_deg, with z * seg <= 1024 and at most 16
// layers), or 0 for the row kernels.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a seg with no instance at this code, when the
// shared memory asked for exceeds the device's, or ws is missing).
extern "C" int ldpc_minsum_launch(const float* llr, float* post, int* iters,
                                  const int* layer_off, const int* edge_col,
                                  const int* edge_shift, void* ws, int n_cw,
                                  int n_b, int z, int n_layers, int n_edges,
                                  int max_deg, int max_iters, float alpha,
                                  int seg, void* stream) {
  return launch(Fp32{alpha}, llr, post, iters, layer_off, edge_col,
                edge_shift, ws, n_cw, n_b, z, n_layers, n_edges, max_deg,
                max_iters, seg, (cudaStream_t)stream);
}

// The int8 datapath, the same layouts; alpha_q8 = round(alpha * 256),
// step = the LLR units of one int8 code.
extern "C" int ldpc_minsum_q_launch(const float* llr, float* post,
                                    int* iters, const int* layer_off,
                                    const int* edge_col,
                                    const int* edge_shift, void* ws,
                                    int n_cw, int n_b, int z, int n_layers,
                                    int n_edges, int max_deg, int max_iters,
                                    int alpha_q8, float step, int seg,
                                    void* stream) {
  return launch(Int8{alpha_q8, step}, llr, post, iters, layer_off, edge_col,
                edge_shift, ws, n_cw, n_b, z, n_layers, n_edges, max_deg,
                max_iters, seg, (cudaStream_t)stream);
}
