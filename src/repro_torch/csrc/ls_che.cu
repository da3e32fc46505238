// Fused LS channel estimate on Hopper (sm_90a).
//
// Replaces: repro/kernels/rx_fused.py::_ls_che_kernel (ls_che_pallas): DMRS
// comb extract -> pilot-symbol average -> split-complex GEMM against the
// static interpolation operator (per-pilot conjugate divide + clamped
// linear frequency interpolation folded in by make_ls_interp_operator).
//
// What bounds it: latency.  Per slot row it reads n_tx * n_p comb REs of
// each pilot symbol, the whole (n_tx, n_p, n_sc) complex64 operator (131 KB
// on every registered grid) once, and writes n_sc * n_tx channel taps; the
// GEMM is a few MFLOP, and the bytes are 0.05 us of HBM time at the served
// batch, far under one launch.
//
// Design: the grid splits the output columns.  A block owns a slab of
// SC = 16 subcarriers of one tx and up to RB = 64 rows (batch x rx) --
// the reference also holds up to 64 rows in a block, so the operator is
// read once per row group -- which gives 16 blocks for the SISO batch of
// 8 and 32 for 2x2 where one block per row gave 8 and 16.  Per chunk of
// PC = 64 pilots, the block stages the operator's (PC x SC) slab in shared
// memory with cp.async copies and, meanwhile, gathers the comb of
// each of its rows there: subcarrier t*stride + p*stride*n_tx of each
// pilot symbol, read by index arithmetic straight from the interleaved
// complex64 grid (the reference's stack/transpose/concat staging does not
// exist) and averaged over the pilot symbols (sum, then times 1/n_psym).
// Each output (row, subcarrier) is a complex dot product over the pilots,
// unrolled by 4 into four independent partial sums, so shared-memory
// loads overlap instead of waiting on one accumulator; a thread has up to
// four outputs; or (TPO = 2, for a block of at most 16 rows) two adjacent
// threads split an output's pilots and meet by a shuffle, so the chain
// halves.  The caller picks TPO (kernels/rx_fused.py
// pick_threads_per_output: a tuned winner, else 2 where a block has at
// most 128 outputs, the SISO batch of 8: 8 rows x 16 subcarriers, so no
// thread idles).
// Accumulation is plain fp32 on the CUDA cores (no tensor cores, so no
// TF32), and H is written directly in its (B, n_sc, n_rx, n_tx)
// complex64 layout.
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async8;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_u32;

constexpr int SC = 16;   // subcarriers of a block's output slab
constexpr int PC = 64;   // pilots staged at a time
constexpr int RB = 64;   // rows (batch x rx) a block holds
constexpr int NT = 256;
constexpr int OPT = RB * SC / NT;  // outputs a thread, at most

__device__ __forceinline__ void cmac(float2& acc, float2 c, float2 o) {
  acc.x += c.x * o.x - c.y * o.y;
  acc.y += c.x * o.y + c.y * o.x;
}

// WIDE: a slot of more than 32 symbols, whose mask takes 64-bit words
template <int TPO, bool WIDE>
__global__ void __launch_bounds__(NT)
ls_che_kernel(const float2* __restrict__ y, const float2* __restrict__ op,
              unsigned long long mask0,
              const unsigned long long* __restrict__ mask_rest, int words,
              float2* __restrict__ h, int n_rows, int n_sym, int n_sc,
              int n_rx, int n_tx, int n_p, int stride, float inv_psym) {
  __shared__ __align__(16) float2 op_s[PC][SC];
  __shared__ float2 comb_s[RB][PC + 1];  // + 1: rows start on other banks
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * SC;
  const int t = blockIdx.y;
  const int row0 = blockIdx.z * RB;
  const int rows = min(RB, n_rows - row0);
  const int spacing = stride * n_tx;

  float2 acc[OPT][4];
#pragma unroll
  for (int j = 0; j < OPT; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[j][u] = make_float2(0.f, 0.f);

  for (int p0 = 0; p0 < n_p; p0 += PC) {
    const int pc = min(PC, n_p - p0);
    // the operator's slab: pc rows of SC complex, one 8-byte copy each
    // (any n_sc), zero past n_sc
    for (int i = tid; i < pc * SC; i += NT) {
      const int p = i / SC, c = i % SC, s = s0 + c;
      const bool in = s < n_sc;
      cp_async8(smem_u32(&op_s[p][c]),
                in ? op + ((size_t)t * n_p + p0 + p) * n_sc + s : op,
                in ? 8 : 0);
    }
    cp_async_commit();
    // the comb of each row at these pilots, averaged over the pilot symbols
    for (int i = tid; i < rows * pc; i += NT) {
      const int rr = i / pc, p = i % pc;
      const int row = row0 + rr, b = row / n_rx, r = row % n_rx;
      const int sc = t * stride + (p0 + p) * spacing;
      float sr = 0.f, si = 0.f;
      if constexpr (WIDE) {
        for (int w = 0; w < words; ++w) {
          unsigned long long mask = w == 0 ? mask0 : mask_rest[w - 1];
          for (; mask != 0ull; mask &= mask - 1ull) {
            const int sym = 64 * w + __ffsll((long long)mask) - 1;
            const float2 v =
                y[((size_t)(b * n_sym + sym) * n_sc + sc) * n_rx + r];
            sr += v.x;
            si += v.y;
          }
        }
      } else {
        for (unsigned mask = (unsigned)mask0; mask != 0u; mask &= mask - 1u) {
          const int sym = __ffs(mask) - 1;
          const float2 v =
              y[((size_t)(b * n_sym + sym) * n_sc + sc) * n_rx + r];
          sr += v.x;
          si += v.y;
        }
      }
      comb_s[rr][p] = make_float2(sr * inv_psym, si * inv_psym);
    }
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int j = 0; j < OPT / TPO; ++j) {
      const int o = tid / TPO + j * (NT / TPO);
      const int rr = o / SC, c = o % SC;
      if (rr >= rows) continue;
      const float2* cr = comb_s[rr];
      int p = tid % TPO;
      for (; p + 3 * TPO < pc; p += 4 * TPO) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          cmac(acc[j][u], cr[p + u * TPO], op_s[p + u * TPO][c]);
      }
      for (; p < pc; p += TPO) cmac(acc[j][0], cr[p], op_s[p][c]);
    }
    __syncthreads();  // the next chunk overwrites both slabs
  }

#pragma unroll
  for (int j = 0; j < OPT / TPO; ++j) {
    float2 v = make_float2(
        (acc[j][0].x + acc[j][1].x) + (acc[j][2].x + acc[j][3].x),
        (acc[j][0].y + acc[j][1].y) + (acc[j][2].y + acc[j][3].y));
    if (TPO == 2) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, 1);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, 1);
    }
    const int o = tid / TPO + j * (NT / TPO);
    const int rr = o / SC, s = s0 + o % SC;
    if (tid % TPO != 0 || rr >= rows || s >= n_sc) continue;
    const int row = row0 + rr, b = row / n_rx, r = row % n_rx;
    h[(((size_t)b * n_sc + s) * n_rx + r) * n_tx + t] = v;
  }
}

}  // namespace

// y (batch, n_sym, n_sc, n_rx) complex64; op (n_tx, n_p, n_sc) complex64;
// the pilot symbols as a mask of ceil(n_sym / 64) 64-bit words, bit k of
// word w for symbol 64 w + k (summed in ascending order): word 0 by value,
// so a slot of up to 64 symbols reads no mask from memory (up to 32, the
// kernel scans one 32-bit word), the others in mask_rest on the device;
// n_psym the number of bits set; h (batch, n_sc, n_rx, n_tx) complex64;
// tpo the threads an output, the caller's (kernels/rx_fused.py
// pick_threads_per_output): 1, or 2 where a block's outputs are at most
// those of 16 rows.  Returns cudaErrorInvalidValue for a tpo with no
// instance at this shape, else the launch's cudaError_t.
extern "C" int ls_che_launch(const void* y, const void* op, void* h,
                             int batch, int n_sym, int n_sc, int n_rx,
                             int n_tx, int stride,
                             unsigned long long mask0,
                             const unsigned long long* mask_rest,
                             int n_psym, int tpo, void* stream) {
  const int n_p = n_sc / (stride * n_tx);
  const int n_rows = batch * n_rx;
  const int words = (n_sym + 63) / 64;
  if (n_p <= 0 || n_rows <= 0 || n_psym <= 0 || n_sym <= 0 ||
      (words > 1 && mask_rest == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_sc + SC - 1) / SC, n_tx, (n_rows + RB - 1) / RB);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  // two threads an output cover OPT / 2 x NT / 2 outputs a block
  if (tpo != 1 && (tpo != 2 || (n_rows < RB ? n_rows : RB) * SC >
                                   (OPT / 2) * (NT / 2)))
    return (int)cudaErrorInvalidValue;
  auto kernel = n_sym > 32 ? (tpo == 2 ? ls_che_kernel<2, true>
                                       : ls_che_kernel<1, true>)
                           : (tpo == 2 ? ls_che_kernel<2, false>
                                       : ls_che_kernel<1, false>);
  kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(op), mask0,
      mask_rest, words, static_cast<float2*>(h), n_rows, n_sym, n_sc, n_rx,
      n_tx, n_p, stride, 1.0f / (float)n_psym);
  return (int)cudaGetLastError();
}
