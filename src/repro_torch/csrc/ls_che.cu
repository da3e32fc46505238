// Fused LS channel estimate on Hopper (sm_90a).
//
// Replaces: repro/kernels/rx_fused.py::_ls_che_kernel (ls_che_pallas): DMRS
// comb extract -> pilot-symbol average -> split-complex GEMM against the
// static interpolation operator (per-pilot conjugate divide + clamped
// linear frequency interpolation folded in by make_ls_interp_operator).
//
// What bounds it: bytes.  Per slot row it reads n_tx * n_p comb REs of
// each pilot symbol, the whole (n_tx, n_p, n_sc) complex64 operator (131 KB
// on every registered grid) and writes n_sc * n_tx channel taps; the GEMM
// is a few MFLOP.  At the served batch the launch itself dominates.
//
// Design: one block per (batch, rx) row.  The comb is gathered by index
// arithmetic straight from the interleaved complex64 grid (subcarrier
// t*stride + p*stride*n_tx of each pilot symbol), so the reference's
// stack/transpose/concat staging does not exist; the pilot-symbol average
// lands in shared memory.  Each thread then produces one output subcarrier
// for every tx, looping over the pilots against the operator, which stays
// dense and is read through L2 (neighbouring threads read neighbouring
// operator columns, so the loads coalesce).  Accumulation is plain fp32
// (no tensor cores, so no TF32), and H is written directly in its
// (B, n_sc, n_rx, n_tx) complex64 layout.
#include <cuda_runtime.h>

namespace {

__global__ void ls_che_kernel(const float2* __restrict__ y,
                              const float2* __restrict__ op,
                              float2* __restrict__ h, int n_sym, int n_sc,
                              int n_rx, int n_tx, int n_p, int stride,
                              unsigned psym_mask, float inv_psym) {
  extern __shared__ float2 comb[];  // (n_tx, n_p) pilot-symbol averages
  const int row = blockIdx.x;       // b * n_rx + r
  const int b = row / n_rx;
  const int r = row % n_rx;
  const int spacing = stride * n_tx;

  for (int i = threadIdx.x; i < n_tx * n_p; i += blockDim.x) {
    const int t = i / n_p;
    const int p = i % n_p;
    const int sc = t * stride + p * spacing;
    float sr = 0.f, si = 0.f;
    for (int sym = 0; sym < n_sym; ++sym) {
      if ((psym_mask >> sym) & 1u) {
        const float2 v = y[((size_t)(b * n_sym + sym) * n_sc + sc) * n_rx + r];
        sr += v.x;
        si += v.y;
      }
    }
    comb[i] = make_float2(sr * inv_psym, si * inv_psym);
  }
  __syncthreads();

  for (int s = threadIdx.x; s < n_sc; s += blockDim.x) {
    for (int t = 0; t < n_tx; ++t) {
      const float2* opt = op + (size_t)t * n_p * n_sc + s;
      const float2* ct = comb + t * n_p;
      float ar = 0.f, ai = 0.f;
      for (int p = 0; p < n_p; ++p) {
        const float2 c = ct[p];
        const float2 o = opt[(size_t)p * n_sc];
        ar += c.x * o.x - c.y * o.y;
        ai += c.x * o.y + c.y * o.x;
      }
      h[(((size_t)b * n_sc + s) * n_rx + r) * n_tx + t] = make_float2(ar, ai);
    }
  }
}

}  // namespace

// y (batch, n_sym, n_sc, n_rx) complex64; op (n_tx, n_p, n_sc) complex64;
// h (batch, n_sc, n_rx, n_tx) complex64.  psym_mask has bit k set for each
// pilot symbol k (< 32).  Returns the launch's cudaError_t.
extern "C" int ls_che_launch(const void* y, const void* op, void* h,
                             int batch, int n_sym, int n_sc, int n_rx,
                             int n_tx, int stride, unsigned psym_mask,
                             int n_psym, void* stream) {
  const int n_p = n_sc / (stride * n_tx);
  const int threads = n_sc < 1024 ? ((n_sc + 31) / 32) * 32 : 1024;
  const size_t smem = sizeof(float2) * (size_t)n_tx * n_p;
  ls_che_kernel<<<batch * n_rx, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(op),
      static_cast<float2*>(h), n_sym, n_sc, n_rx, n_tx, n_p, stride,
      psym_mask, 1.0f / (float)n_psym);
  return (int)cudaGetLastError();
}
