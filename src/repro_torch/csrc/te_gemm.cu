// TE GEMM with a fused epilogue on Hopper (sm_90a): out = epi(X @ W + b).
//
// Replaces: repro/kernels/te_gemm.py::te_gemm (_te_gemm_kernel), the
// paper's RedMulE tensor engine: (M, K) @ (K, N) with an fp32 accumulator,
// + bias, then none / relu / silu / row-softmax, stored in X's dtype.
//
// What bounds it: on the neural receivers' shapes, bytes.  DeepRx's block
// conv (M = 28,672 im2col rows, K = 288, N = 32) is 0.53 GFLOP against
// ~37 MB of fp32 operands: about 11 us of HBM time, and 8 us of FMA time
// at the card's 67 TFLOP/s fp32, so fp32 on the CUDA cores could reach
// the bound only with perfect overlap.  CE-ViT's GEMMs (M = 512, K and
// N <= 192) are a few microseconds of work and so bound by latency.
//
// Design: wgmma fed by an asynchronous ring, persistent blocks.  A block
// is one warpgroup; it owns a BN-column slab of W (BN in 8..64) and walks
// 64-row tiles of X (blockIdx.x, then every gridDim.x-th tile), so one
// tile's epilogue overlaps the next tile's loads.  The slab is loaded
// once per block (per K chunk when BN x K does not fit its 160 KB), from
// (K, N) row-major into K-major 128-byte-swizzled atoms, as wgmma wants
// it.  X streams through a 4-stage ring of 64 x 128-byte stages, three in
// flight while one is multiplied, each refill issued behind the stage's
// wgmmas (the issuing thread would otherwise hold its warpgroup at them):
// one TMA copy per stage where the row pitch is a multiple of 16 bytes
// (the map zero-fills past M and K),
// 4-byte cp.async copies otherwise (DeepRx's conv_in, K = 54), plain
// loads for bf16 rows of odd length.  The column slab and the grid's
// blocks an SM are the caller's (kernels/te_gemm.py pick_block_shape: a
// tuned winner, else its heuristic: a slab as wide as N needs, halved
// while the grid would have under 64 tiles (so CE-ViT's M = 512 GEMMs
// still run on 64-96 blocks) or while the slab's whole K would not fit
// (Fig. 10's 512^3 FC GEMM: 32 columns, not 64 in four K chunks each
// loaded anew for every tile); as many blocks an SM as its shared memory
// holds, up to 4); this source only refuses a choice it has no instance
// for.
//
// fp32 is 3xTF32: x = x_hi + x_lo with x_hi the top 19 bits of x (a
// tf32) and x_lo = x - x_hi (exact), likewise W; the product is
// x_hi w_hi + x_hi w_lo + x_lo w_hi on m64nBNk8 tf32 wgmmas with fp32
// accumulators (the dropped x_lo w_lo and the truncation of the lo parts
// are near 2^-21 relative).  W is split once as it lands (a hi and a lo
// slab); X is split in registers: each thread loads its A fragments of a
// stage from shared memory, splits them and feeds both halves to the
// wgmmas as register operands, so the split never goes back to shared
// memory.  bf16 runs m64nBNk16 wgmmas on the ring and the slab as they
// are, fp32 accumulators.  On the card (clock64 stamps, PERF.md), a
// DeepRx fp32 stage is set by its twelve tf32 wgmmas, which at N = 32 run
// far below the tensor cores' rate, and each block's first W load waits
// on L2 lines that every block reads at once.
//
// Epilogue on the accumulator fragments: + bias (fp32), relu or silu, and
// the row softmax.  A row of N <= 64 lies in one column slab and is
// normalised there (a row's values of a thread meet in its quad of lanes
// by two shuffles).  A wider row is two passes: each column tile writes
// its fp32 logits and a (max, sum of exp(z - max)) pair per row, then
// row_softmax_kernel rescales the pairs to the row's max and normalises,
// one warp a row, at any N.  The quantized GEMM (te_gemm_quant.cu) runs
// the same second pass on its logits, with no pairs.  FMA contraction is
// allowed here (the product is not claimed bit-exact against cuBLAS).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;                 // rows per tile: one wgmma's M
constexpr int NT = 128;                // one warpgroup
constexpr int STAGES = 4;              // depth of the X ring
constexpr int AHEAD = STAGES - 1;      // stages in flight while one computes
constexpr int STAGE_BYTES = BM * 128;  // 64 rows x one 128-byte row of K
constexpr int W_BUDGET = 160 * 1024;   // bytes of resident W (both slabs)
constexpr int MAX_PER_SM = 4;          // persistent blocks an SM, at most
constexpr int SPLIT_BN = 64;           // widest slab; a wider softmax row
                                       // takes two passes

// kPartial: the first pass of a row softmax wider than one column slab
enum Epilogue { kNone = 0, kRelu = 1, kSilu = 2, kSoftmax = 3, kPartial = 4 };

template <typename T>
struct Op;
template <>
struct Op<float> {
  using Raw = uint32_t;
  static constexpr int SLABS = 2;  // W hi and lo
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Op<__nv_bfloat16> {
  using Raw = uint16_t;
  static constexpr int SLABS = 1;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <typename T, int BN>
struct Tile {
  static constexpr int EL = sizeof(T);
  static constexpr int KA = 128 / EL;    // K a stage and a W atom
  static constexpr int ATOM = BN * 128;  // bytes of one W atom of one slab
  static constexpr int KC = W_BUDGET / (Op<T>::SLABS * ATOM) * KA;  // K held
  static constexpr int SMEM_MAX =
      1024 + STAGES * STAGE_BYTES + Op<T>::SLABS * (KC / KA) * ATOM;
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint64_t b, int s) {
  wgmma_tf32_rs(d, a, b, s);
}
__device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                    uint64_t b, int s) {
  wgmma_tf32_rs(d, a, b, s);
}
__device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                    uint64_t b, int s) {
  wgmma_tf32_rs(d, a, b, s);
}
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                    uint64_t b, int s) {
  wgmma_tf32_rs(d, a, b, s);
}

__device__ __forceinline__ uint32_t tf32_hi(uint32_t bits) {
  return bits & 0xffffe000u;
}
__device__ __forceinline__ uint32_t tf32_lo(uint32_t bits) {
  return __float_as_uint(__uint_as_float(bits) -
                         __uint_as_float(tf32_hi(bits)));
}

// W columns [n0, n0 + BN), rows [kc0, kend) into the resident K-major
// slab: per KA of K an atom of BN swizzled 128-byte rows, one per column,
// zero past kend (to the end of its atom) and past N.  fp32 is split as
// it lands: the hi slab keeps each value's top 19 bits, the lo slab
// (lo_off bytes on) the rest.  A thread takes 16 bytes of K of one column
// at a time, consecutive threads consecutive columns (so each k's loads
// coalesce), and issues the loads of U such chunks before it stores any.
template <typename T, int BN>
__device__ __forceinline__ void load_w(uint32_t slab, uint32_t lo_off,
                                       const T* __restrict__ w, int n0,
                                       int kc0, int kend, int n, int tid) {
  using L = Tile<T, BN>;
  using Raw = typename Op<T>::Raw;
  constexpr int VE = 16 / L::EL;  // values a 16-byte chunk
  constexpr int U = 4;
  const Raw* wr = reinterpret_cast<const Raw*>(w);
  const int items = (kend - kc0 + L::KA - 1) / L::KA * (L::KA / VE) * BN;
  for (int i0 = tid; i0 < items; i0 += U * NT) {
    Raw v[U][VE];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT;
      const int gc = n0 + i % BN, gk = kc0 + (i / BN) * VE;
#pragma unroll
      for (int e = 0; e < VE; ++e)
        v[u][e] = (i < items && gc < n && gk + e < kend)
                      ? wr[(size_t)(gk + e) * n + gc] : Raw(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT;
      if (i >= items) break;
      const int kl = (i / BN) * VE;
      const uint32_t dst =
          slab + kl / L::KA * L::ATOM + sw128(i % BN, kl % L::KA / VE);
      if constexpr (L::EL == 4) {
        st_shared_v4(dst, tf32_hi(v[u][0]), tf32_hi(v[u][1]),
                     tf32_hi(v[u][2]), tf32_hi(v[u][3]));
        st_shared_v4(dst + lo_off, tf32_lo(v[u][0]), tf32_lo(v[u][1]),
                     tf32_lo(v[u][2]), tf32_lo(v[u][3]));
      } else {
        st_shared_v4(dst, v[u][0] | (uint32_t)v[u][1] << 16,
                     v[u][2] | (uint32_t)v[u][3] << 16,
                     v[u][4] | (uint32_t)v[u][5] << 16,
                     v[u][6] | (uint32_t)v[u][7] << 16);
      }
    }
  }
}

// X rows [m0, m0 + 64), bytes [kb0, kb0 + 128) of each row into a ring
// stage where TMA cannot go (rows not 16-byte aligned): 4-byte cp.async
// copies, consecutive threads along a row, zero-filled past it and past M
__device__ __forceinline__ void load_x_words(uint32_t stage,
                                             const uint8_t* __restrict__ x,
                                             int m0, int kb0, int m,
                                             int row_bytes, int tid) {
  for (int i = tid; i < BM * 32; i += NT) {
    const int r = i >> 5, wd = i & 31, b = kb0 + 4 * wd;
    const bool in = m0 + r < m && b < row_bytes;
    cp_async4(stage + sw128(r, wd >> 2) + 4 * (wd & 3),
              in ? x + (size_t)(m0 + r) * row_bytes + b : x, in ? 4 : 0);
  }
}

// bf16 rows of odd length (2-byte aligned only): plain loads
__device__ __forceinline__ void load_x_halves(uint32_t stage,
                                              const uint16_t* __restrict__ x,
                                              int m0, int k0, int m, int k,
                                              int tid) {
  for (int i = tid; i < BM * 64; i += NT) {
    const int r = i >> 6, e = i & 63, gk = k0 + e;
    const uint16_t v =
        m0 + r < m && gk < k ? x[(size_t)(m0 + r) * k + gk] : (uint16_t)0;
    st_shared_u16(stage + sw128(r, e >> 3) + 2 * (e & 7), v);
  }
}

// a pair of adjacent outputs (columns col, col + 1 of one row) at `at`
template <typename O>
__device__ __forceinline__ void store_pair(O* out, size_t at, float v0,
                                           float v1, bool both, bool vec) {
  if (both && vec) {
    if constexpr (sizeof(O) == 4) {
      *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(out + at) =
          __floats2bfloat162_rn(v0, v1);
    }
    return;
  }
  if constexpr (sizeof(O) == 4) {
    out[at] = v0;
    if (both) out[at + 1] = v1;
  } else {
    out[at] = __float2bfloat16(v0);
    if (both) out[at + 1] = __float2bfloat16(v1);
  }
}

// xmode: 0 TMA, 1 4-byte cp.async, 2 plain 2-byte loads
template <typename T, int BN>
__global__ void __launch_bounds__(NT)
te_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, void* __restrict__ out,
               float2* __restrict__ stats, int m, int n, int k,
               int epilogue, const __grid_constant__ CUtensorMap tmap_x,
               int xmode) {
  using L = Tile<T, BN>;
  constexpr int NACC = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float col_b[BN];
  __shared__ __align__(8) uint64_t full[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t slab = ring + STAGES * STAGE_BYTES;
  const int kpad = (k + L::KA - 1) / L::KA * L::KA;
  const uint32_t lo_off = (kpad < L::KC ? kpad : L::KC) / L::KA * L::ATOM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row_tiles = (m + BM - 1) / BM;
  const int col_tiles = (n + BN - 1) / BN;
  const int tiles = row_tiles * col_tiles;
  const int slices = kpad / L::KA;
  const int chunks = (k + L::KC - 1) / L::KC;
  const int mine = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = mine * slices;  // X stages this block consumes

  if (xmode == 0 && tid == 0) {
    tma_prefetch_map(&tmap_x);
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    fence_mbar_init();
  }
  __syncthreads();
  auto load = [&](int q) {
    const int tile = blockIdx.x + (q / slices) * gridDim.x;
    const int m0 = (tile % row_tiles) * BM, s = q % slices;
    const uint32_t stage = ring + (q % STAGES) * STAGE_BYTES;
    if (xmode == 0) {
      if (tid == 0) {
        const uint32_t bar = smem_u32(&full[q % STAGES]);
        mbar_expect_tx(bar, STAGE_BYTES);
        tma_load_2d(stage, &tmap_x, bar, s * L::KA, m0);
      }
    } else if (xmode == 1) {
      load_x_words(stage, reinterpret_cast<const uint8_t*>(x), m0, s * 128,
                   m, k * L::EL, tid);
    } else {
      load_x_halves(stage, reinterpret_cast<const uint16_t*>(x), m0,
                    s * L::KA, m, k, tid);
    }
  };
  // one cp.async group per stage, empty ones included, so waiting for all
  // but the newest AHEAD - 1 groups means stage q has landed
  for (int q = 0; q < AHEAD; ++q) {
    if (q < total) load(q);
    if (xmode == 1) cp_async_commit();
  }

  int resident = -1;  // which (column slab, K chunk) of W is in shared memory
  int q = 0;
  const int rloc = 16 * warp + g;
  for (int it = 0; it < mine; ++it) {
    const int tile = blockIdx.x + it * gridDim.x;
    const int rt = tile % row_tiles, ct = tile / row_tiles;
    // no zeroing: a tile's first wgmma overwrites (scale_d = 0)
    float acc[NACC];

    for (int s = 0; s < slices; ++s, ++q) {
      const int k0 = s * L::KA;
      if (k0 % L::KC == 0 && ct * chunks + k0 / L::KC != resident) {
        __syncthreads();  // every wgmma on the old slab has completed
        // the slab's bias, read alongside its W
        const int gc = ct * BN + tid;
        const float cb = tid < BN && bias != nullptr && gc < n ? bias[gc]
                                                                : 0.f;
        load_w<T, BN>(slab, lo_off, w, ct * BN, k0, min(k0 + L::KC, k), n,
                      tid);
        if (tid < BN) col_b[tid] = cb;
        fence_async_shared();  // the slab's plain stores, to wgmma
        resident = ct * chunks + k0 / L::KC;
      }
      if (xmode == 0) {
        mbar_wait(smem_u32(&full[q % STAGES]), (q / STAGES) & 1);
      } else {
        if (xmode == 1) cp_async_wait<AHEAD - 1>();
        fence_async_shared();
      }
      __syncthreads();  // stage q is in; stage q - 1 is read by everyone

      const uint32_t a0 = ring + (q % STAGES) * STAGE_BYTES;
      const uint32_t b0 = slab + (k0 % L::KC) / L::KA * L::ATOM;
      if constexpr (L::EL == 4) {
        // A fragments of the stage's four k-steps of 8, split in registers
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const uint32_t v = ld_shared_u32(
                a0 + sw128(rloc + 8 * (f & 1), 2 * j + (f >> 1)) + 4 * t4);
            hi[j][f] = tf32_hi(v);
            lo[j][f] = tf32_lo(v);
          }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint64_t bh = desc_sw128(b0 + 32 * j, 1024);
          const uint64_t bl = desc_sw128(b0 + lo_off + 32 * j, 1024);
          mma(acc, hi[j], bh, s > 0 || j > 0);
          mma(acc, hi[j], bl, 1);
          mma(acc, lo[j], bh, 1);
        }
      } else {
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_bf16(acc, desc_sw128(a0 + 32 * j, 1024),
                     desc_sw128(b0 + 32 * j, 1024), s > 0 || j > 0);
      }
      wgmma_commit();
      // into stage q - 1's slot, behind the wgmmas: the issuing thread
      // would otherwise hold its warpgroup at them
      if (q + AHEAD < total) load(q + AHEAD);
      if (xmode == 1) cp_async_commit();
      wgmma_wait<0>();  // the A registers and the stage are free again
    }
    fence_regs(acc);

    // bias, activation; past N a softmax value is -inf (left out)
    float z[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
      float v = acc[i] + col_b[c];
      if (epilogue == kRelu) {
        v = fmaxf(v, 0.f);
      } else if (epilogue == kSilu) {
        v = v * (1.f / (1.f + expf(-v)));
      } else if (epilogue >= kSoftmax && ct * BN + c >= n) {
        v = -CUDART_INF_F;
      }
      z[i] = v;
    }

    if (epilogue >= kSoftmax) {  // a row's values meet in a quad of lanes
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // row h's values of this thread: z[4 jj + 2 h + e]
        float mx = -CUDART_INF_F, sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) mx = fmaxf(mx, z[4 * jj + 2 * h + e]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * h + e;
            const float ev = expf(z[i] - mx);  // exp(-inf) = 0 past N
            sum += ev;
            if (epilogue == kSoftmax) z[i] = ev;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int row = rt * BM + rloc + 8 * h;
        if (epilogue == kSoftmax) {
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) z[4 * jj + 2 * h + e] /= sum;
        } else if (t4 == 0 && row < m) {
          stats[(size_t)row * col_tiles + ct] = make_float2(mx, sum);
        }
      }
    }

    const bool vec = (n & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rt * BM + rloc + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int col = ct * BN + 8 * jj + 2 * t4;
        if (col >= n) continue;
        const size_t at = (size_t)row * n + col;
        const float v0 = z[4 * jj + 2 * h], v1 = z[4 * jj + 2 * h + 1];
        if (sizeof(T) == 4 || epilogue == kPartial) {
          store_pair(static_cast<float*>(out), at, v0, v1, col + 1 < n, vec);
        } else {
          store_pair(static_cast<__nv_bfloat16*>(out), at, v0, v1,
                     col + 1 < n, vec);
        }
      }
    }
  }
}

__device__ __forceinline__ void merge(float& mx, float& sum, float m2,
                                      float s2) {
  if (m2 == -CUDART_INF_F) return;  // nothing to add (and no inf - inf)
  const float mn = fmaxf(mx, m2);
  sum = sum * expf(mx - mn) + s2 * expf(m2 - mn);
  mx = mn;
}

// The second pass of a row softmax wider than one column tile, one warp
// a row: the row's max M and sum S from the per-(row, tile) pairs
// (m_t, s_t) as max m_t and sum s_t exp(m_t - M), or, with no pairs (the
// quantized GEMM's logits), by one online pass over the row; then
// out = exp(z - M) / S in the output's type.  The butterfly merges are
// commutative, so every lane ends with the same M and S.  z may be out.
__global__ void __launch_bounds__(256)
row_softmax_kernel(const float* z, const float2* __restrict__ stats,
                   int tiles, void* out, int m, int n, int out_bf16) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const float* zr = z + (size_t)row * n;
  float mx = -CUDART_INF_F, sum = 0.f;
  if (stats != nullptr) {
    for (int t = lane; t < tiles; t += 32) {
      const float2 p = stats[(size_t)row * tiles + t];
      merge(mx, sum, p.x, p.y);
    }
  } else {
    for (int c = lane; c < n; c += 32) merge(mx, sum, zr[c], 1.f);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, mx, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, sum, o);
    merge(mx, sum, m2, s2);
  }
  for (int c = lane; c < n; c += 32) {
    const float p = expf(zr[c] - mx) / sum;
    if (out_bf16) {
      static_cast<__nv_bfloat16*>(out)[(size_t)row * n + c] =
          __float2bfloat16(p);
    } else {
      static_cast<float*>(out)[(size_t)row * n + c] = p;
    }
  }
}

int row_softmax(const float* z, const float2* stats, int tiles, void* out,
                int m, int n, int out_bf16, cudaStream_t stream) {
  row_softmax_kernel<<<(m + 7) / 8, 256, 0, stream>>>(z, stats, tiles, out,
                                                      m, n, out_bf16);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int launch(const T* x, const T* w, const float* bias, void* out,
           float2* stats, int m, int n, int k, int epilogue, int per_sm,
           cudaStream_t stream) {
  using L = Tile<T, BN>;
  auto kernel = te_gemm_kernel<T, BN>;
  const int dev = current_device();
  static std::atomic<unsigned long long> smem_set{0};  // per device
  const cudaError_t attr =
      allow_dynamic_smem(kernel, L::SMEM_MAX, smem_set, dev);
  if (attr != cudaSuccess) return (int)attr;
  const int kpad = (k + L::KA - 1) / L::KA * L::KA;
  const int smem = 1024 + STAGES * STAGE_BYTES +
                   Op<T>::SLABS * (kpad < L::KC ? kpad : L::KC) / L::KA *
                       L::ATOM;
  const long long tiles =
      (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long cap = (long long)per_sm * sm_count(dev);
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  const int row_bytes = k * L::EL;
  const int xmode = row_bytes % 16 == 0 && (base & 15) == 0 ? 0
                    : row_bytes % 4 == 0 && (base & 3) == 0 ? 1 : 2;
  CUtensorMap tmap_x = {};
  if (xmode == 0 && !tma_map_2d(&tmap_x, x, Op<T>::kTma, L::EL, m, k, BM,
                                L::KA))
    return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)(tiles < cap ? tiles : cap), NT, smem, stream>>>(
      x, w, bias, out, stats, m, n, k, epilogue, tmap_x, xmode);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, const T* w, const float* bias, void* out,
             float* logits, float2* stats, int m, int n, int k,
             int epilogue, int bn, int per_sm, cudaStream_t s) {
  const bool split = epilogue == kSoftmax && n > bn;
  // a split row: fp32 logits (in place for an fp32 output) and pairs
  void* dst = split ? (logits != nullptr ? (void*)logits : out) : out;
  const int epi = split ? kPartial : epilogue;
  const int err =
      bn == 8    ? launch<T, 8>(x, w, bias, dst, stats, m, n, k, epi, per_sm, s)
      : bn == 16 ? launch<T, 16>(x, w, bias, dst, stats, m, n, k, epi, per_sm,
                                 s)
      : bn == 32 ? launch<T, 32>(x, w, bias, dst, stats, m, n, k, epi, per_sm,
                                 s)
                 : launch<T, 64>(x, w, bias, dst, stats, m, n, k, epi, per_sm,
                                 s);
  if (err != 0 || !split) return err;
  return row_softmax(static_cast<const float*>(dst), stats,
                     (n + bn - 1) / bn, out, m, n, sizeof(T) == 2, s);
}

}  // namespace

// x (m, k), w (k, n), out (m, n), row-major and of one dtype: dtype 0 =
// float32, 1 = bfloat16; bias (n,) fp32 or null.  epilogue: 0 none,
// 1 relu, 2 silu, 3 row-softmax.  The launch shape is the caller's
// (te_gemm.pick_block_shape): bn, the column slab a block holds (8, 16, 32
// or 64), and per_sm, the persistent grid's blocks an SM (1..4, times the
// SM count).  A softmax row wider than bn takes two passes and needs
// stats, room for m * ceil(n / 8) float2, and, for a bf16 output, logits,
// an (m, n) fp32 buffer (an fp32 output is normalised in place).  Returns
// cudaErrorInvalidValue for a slab or grid cap with no instance, else the
// first failing launch's cudaError_t.
extern "C" int te_gemm_launch(const void* x, const void* w, const void* bias,
                              void* out, void* logits, void* stats, int m,
                              int n, int k, int epilogue, int dtype, int bn,
                              int per_sm, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || epilogue < 0 || epilogue > kSoftmax)
    return (int)cudaErrorInvalidValue;
  if ((bn != 8 && bn != 16 && bn != 32 && bn != SPLIT_BN) || per_sm < 1 ||
      per_sm > MAX_PER_SM)
    return (int)cudaErrorInvalidValue;
  if (epilogue == kSoftmax && n > bn &&
      (stats == nullptr || (dtype == 1 && logits == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* b = static_cast<const float*>(bias);
  float* lg = static_cast<float*>(logits);
  float2* st = static_cast<float2*>(stats);
  if (dtype == 0)
    return dispatch(static_cast<const float*>(x),
                    static_cast<const float*>(w), b, out, lg, st, m, n, k,
                    epilogue, bn, per_sm, s);
  if (dtype == 1)
    return dispatch(static_cast<const __nv_bfloat16*>(x),
                    static_cast<const __nv_bfloat16*>(w), b, out, lg, st, m,
                    n, k, epilogue, bn, per_sm, s);
  return (int)cudaErrorInvalidValue;
}

// The row softmax's second pass alone, with no pairs, over fp32 logits z
// (m, n) (the quantized GEMM's, bias included) into out (m, n), fp32
// (out_bf16 = 0; may be z itself) or bf16.  Returns the launch's
// cudaError_t.
extern "C" int te_gemm_row_softmax_launch(const void* z, void* out, int m,
                                          int n, int out_bf16,
                                          void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  return row_softmax(static_cast<const float*>(z), nullptr, 0, out, m, n,
                     out_bf16, (cudaStream_t)stream);
}
