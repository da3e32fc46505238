// Quantized TE GEMM with a dequant epilogue on Hopper (sm_90a):
// out = epi((Xq @ Wq) * xs * ws + b).
//
// Replaces: repro/kernels/te_gemm.py::te_gemm_quant
// (_te_gemm_quant_kernel): (M, K) int8 or e4m3 codes times (K, N) codes
// of the same type, per-row activation scales xs (M, 1) and per-column
// weight scales ws (1, N) in fp32, an int32 accumulator for int8 and an
// fp32 one for e4m3, then acc * xs * ws, + bias, then none / relu / silu /
// row-softmax, stored as fp32 or bf16.
//
// What bounds it: bytes at the shapes it serves.  At 256^3 it moves
// 0.39 MB (0.12 us of HBM time) against 34 MOP (0.02 us at the card's
// 1,979 TOP/s int8 / fp8 tensor-core peak); at DeepRx's block conv
// (M = 28,672, K = 288, N = 32) 11.9 MB (3.6 us) against 0.53 GOP.
//
// Design: wgmma fed by asynchronous copies.  A block of one or two
// warpgroups owns a BN-column slab of the output (BN the caller's:
// kernels/te_gemm.py pick_block_shape, a tuned winner or its heuristic,
// the whole row for the softmax, else 32 or 64 columns for more blocks at
// small M) and walks 64-row tiles
// (persistent: about two blocks per SM take the tiles in turn, so one
// tile's epilogue overlaps the next tile's loads).  X, K-major already,
// streams through a ring of five 64 x 128-code stages, three loading while
// one is multiplied and the wgmmas of the one before finish: one thread's
// TMA copy per stage, issued behind the stage's wgmmas (the whole warpgroup
// waits for that thread at a wgmma), where K % 16 == 0 (the tensor map
// zero-fills past K and M; completion on an mbarrier), plain byte loads
// with zero fill otherwise.  W, (K, N) row-major, is N-major: each block
// transposes its W slab once, 4 x 4 bytes at a time, into a
// 128-byte-swizzled K-major tile in shared memory (BN rows of K, up to 128
// KB; a longer K is held chunk by chunk), with the slab's column scales and
// bias beside it.
// int8: m64nNk32 .s32.s8.s8 wgmmas on the codes as they are (8-bit
// operands must both be K-major), exact in int32 over the whole K.
// e4m3 (design (b)): the codes become bf16 on the way into shared
// memory (W in the transposing load, each X stage in one pass from the
// ring into one of two bf16 tiles), then m64nNk16 bf16 wgmmas with fp32
// accumulators.  Every e4m3 value is exact in bf16 and every product of
// two exact in fp32, so only the fp32 sums round, as in the twin's fp32
// product.  Design (a), e4m3 wgmmas with each 128-code stage added into
// fp32 registers, missed the twin's rtol 1e-4 on the card (max abs error
// 1.7e-3 at DeepRx's conv, 12% of the outputs): the tensor core keeps
// too few bits of its fp8 sums.
// The epilogue works on the accumulator fragments and rounds where the
// plain twin does: float(acc) * xs, then * ws, then + b, each a separate
// IEEE operation (the source is built with -fmad=false), so for int8
// with epilogue none or relu the result equals the twin's bit for bit.
// The row-softmax needs the row in one block (N <= 256): a row's columns
// lie in one quad of lanes of each warpgroup, so it reduces by two
// shuffles, and across the two warpgroups of a 256-column slab through
// shared memory.  A wider row runs this kernel with epilogue none into
// fp32 logits, then te_gemm.cu's second softmax pass (the caller's job).  The output type is a runtime flag at the single store.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;               // rows per tile: one wgmma's M
constexpr int BK = 128;              // K codes per stage: one swizzled row
constexpr int STAGES = 5;            // depth of the X ring
constexpr int AHEAD = STAGES - 2;    // stages loading while one computes
                                     // and the one before may still be read
constexpr int X_STAGE = BM * BK;     // bytes per X stage
constexpr int W_BUDGET = 128 * 1024;  // bytes of W held at once
constexpr int BLOCKS_PER_SM = 2;

enum Epilogue { kNone = 0, kRelu = 1, kSilu = 2, kSoftmax = 3 };

// kInt8: the wgmma operands are the 1-byte codes; otherwise bf16 (EL = 2
// bytes), converted from e4m3 on the way into shared memory
template <int BN, bool kInt8>
struct Tile {
  static constexpr int NWG = BN > 128 ? 2 : 1;       // warpgroups
  static constexpr int WN = BN / NWG;                // columns each
  static constexpr int SUBN = WN < 64 ? WN : 64;     // columns a wgmma
  static constexpr int NSUB = WN / SUBN;
  static constexpr int NT = 128 * NWG;
  static constexpr int EL = kInt8 ? 1 : 2;           // bytes per operand
  static constexpr int KA = 128 / EL;                // K per 128-byte row
  static constexpr int STEPS = BK * EL / 32;         // 32-byte K steps a stage
  static constexpr int A_TILE = kInt8 ? 0 : BM * BK * EL;  // bf16 X stage
  static constexpr int A_TILES = kInt8 ? 0 : 2 * A_TILE;   // double-buffered
  static constexpr int KC = W_BUDGET / (BN * EL) / BK * BK;  // K of W held
  static constexpr int SMEM_MAX =
      1024 + STAGES * X_STAGE + A_TILES + BN * KC * EL;
  static_assert(BN <= NT, "a thread per column reads the slab's scales");
};

template <bool kInt8>
struct Acc {
  using T = float;
};
template <>
struct Acc<true> {
  using T = int;
};

template <int N>
__device__ __forceinline__ void mma(int (&d)[N], uint64_t a, uint64_t b,
                                    int scale_d) {
  wgmma_s8(d, a, b, scale_d);
}
template <int N>
__device__ __forceinline__ void mma(float (&d)[N], uint64_t a, uint64_t b,
                                    int scale_d) {
  wgmma_bf16(d, a, b, scale_d);
}

// two e4m3 codes (the low byte first) as two bf16 (the low half first);
// exact: e4m3 -> f16 -> f32 -> bf16 loses nothing
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t codes) {
  const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(codes), __NV_E4M3)));
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// X rows [m0, m0 + 64), codes [k0, k0 + 128) into a swizzled ring stage
// by plain loads (rows not 16-byte aligned for TMA), zero past K and M
__device__ __forceinline__ void load_x(uint32_t stage,
                                       const uint8_t* __restrict__ xq,
                                       int m0, int k0, int m, int k,
                                       int tid, int nt) {
  for (int i = tid; i < BM * (BK / 16); i += nt) {
    const int r = i >> 3, c = i & 7;
    const int gr = m0 + r, gk = k0 + 16 * c;
    const int valid = gr < m ? min(max(k - gk, 0), 16) : 0;
    const uint8_t* src = xq + (size_t)gr * k + gk;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < valid) v[b >> 2] |= (uint32_t)src[b] << (8 * (b & 3));
    st_shared_v4(stage + sw128(r, c), v[0], v[1], v[2], v[3]);
  }
}

// W columns [n0, n0 + BN), codes [kc0, kend) transposed into the K-major
// slab (bf16 for e4m3): atoms of BN swizzled 128-byte rows, zero past
// kend up to the end of its stage.  A thread takes 4 k x 4 columns at a
// time: four 32-bit loads (one per k, 4 columns each) when N % 4 == 0,
// byte loads otherwise, a 4 x 4 byte transpose, then one store per
// column (4 k codes, or 4 bf16).  Each thread issues all its loads
// (up to U blocks) before it stores any.
template <int BN, bool kInt8>
__device__ __forceinline__ void load_w(uint32_t slab,
                                       const uint8_t* __restrict__ wq,
                                       int n0, int kc0, int kend, int n,
                                       int vec_w, int tid, int nt) {
  using T = Tile<BN, kInt8>;
  constexpr int U = 8;
  constexpr int NQ = BN / 4;  // column quads
  const int items = (kend - kc0 + BK - 1) / BK * (BK / 4) * NQ;
  for (int i0 = tid; i0 < items; i0 += U * nt) {
    uint32_t w[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nt;
      const int gc = n0 + 4 * (i % NQ), gk = kc0 + 4 * (i / NQ);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        w[u][t] = 0u;
        if (i >= items || gk + t >= kend || gc >= n) continue;
        const uint8_t* row = wq + (size_t)(gk + t) * n + gc;
        if (vec_w) {
          w[u][t] = *reinterpret_cast<const uint32_t*>(row);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gc + j < n) w[u][t] |= (uint32_t)row[j] << (8 * j);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nt;
      if (i >= items) break;
      const int nl = 4 * (i % NQ), kk = 4 * (i / NQ);
      // column nl + j gets byte j of each k's word
      const uint32_t lo01 = __byte_perm(w[u][0], w[u][1], 0x5140);
      const uint32_t hi01 = __byte_perm(w[u][0], w[u][1], 0x7362);
      const uint32_t lo23 = __byte_perm(w[u][2], w[u][3], 0x5140);
      const uint32_t hi23 = __byte_perm(w[u][2], w[u][3], 0x7362);
      const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410),
                               __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410),
                               __byte_perm(hi01, hi23, 0x7632)};
      const int atom = kk / T::KA, b = (kk % T::KA) * T::EL;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t dst =
            slab + atom * BN * 128 + sw128(nl + j, b >> 4) + (b & 15);
        if constexpr (kInt8) {
          st_shared_u32(dst, col[j]);
        } else {
          st_shared_v2(dst, e4m3x2_to_bf16x2(col[j] & 0xffffu),
                       e4m3x2_to_bf16x2(col[j] >> 16));
        }
      }
    }
  }
}

// e4m3: an X ring stage (64 rows x 128 codes) into the bf16 tile, two
// K-major atoms of 64 rows x 64 values
__device__ __forceinline__ void widen_x(uint32_t stage, uint32_t tile,
                                        int tid, int nt) {
  for (int i = tid; i < BM * 8; i += nt) {
    const int r = i >> 3, c = i & 7;  // codes 16 c .. 16 c + 15 of row r
    const uint4 v = ld_shared_v4(stage + sw128(r, c));
    const uint32_t atom = tile + (c >> 2) * (BM * 128);
    st_shared_v4(atom + sw128(r, 2 * (c & 3)),
                 e4m3x2_to_bf16x2(v.x & 0xffffu), e4m3x2_to_bf16x2(v.x >> 16),
                 e4m3x2_to_bf16x2(v.y & 0xffffu), e4m3x2_to_bf16x2(v.y >> 16));
    st_shared_v4(atom + sw128(r, 2 * (c & 3) + 1),
                 e4m3x2_to_bf16x2(v.z & 0xffffu), e4m3x2_to_bf16x2(v.z >> 16),
                 e4m3x2_to_bf16x2(v.w & 0xffffu), e4m3x2_to_bf16x2(v.w >> 16));
  }
}

template <int BN, bool kInt8>
__global__ void __launch_bounds__(Tile<BN, kInt8>::NT)
te_gemm_quant_kernel(const uint8_t* __restrict__ xq,
                     const uint8_t* __restrict__ wq,
                     const float* __restrict__ xs,
                     const float* __restrict__ ws,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int m, int n, int k, int epilogue, int out_bf16,
                     const __grid_constant__ CUtensorMap tmap_x, int tma,
                     int vec_w) {
  using T = Tile<BN, kInt8>;
  using AccT = typename Acc<kInt8>::T;
  constexpr int NACC = T::SUBN / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float rowred[2][T::NWG][BM];  // softmax: row max, row sum
  __shared__ float col_ws[BN], col_b[BN];   // the resident columns' ws, bias
  __shared__ __align__(8) uint64_t full[STAGES];  // TMA: a stage landed
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t atile = ring + STAGES * X_STAGE;  // e4m3: stages as bf16
  const uint32_t slab = atile + T::A_TILES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int row_tiles = (m + BM - 1) / BM;
  const int tiles = row_tiles * ((n + BN - 1) / BN);
  const int slices = (k + BK - 1) / BK;
  const int chunks = (k + T::KC - 1) / T::KC;
  const int mine = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = mine * slices;  // X stages this block consumes

  if (tma && tid == 0) {
    tma_prefetch_map(&tmap_x);
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    fence_mbar_init();
  }
  __syncthreads();
  auto load = [&](int q) {
    const int tile = blockIdx.x + (q / slices) * gridDim.x;
    const int m0 = (tile % row_tiles) * BM, k0 = (q % slices) * BK;
    const uint32_t stage = ring + (q % STAGES) * X_STAGE;
    if (!tma) {
      load_x(stage, xq, m0, k0, m, k, tid, T::NT);
    } else if (tid == 0) {
      const uint32_t bar = smem_u32(&full[q % STAGES]);
      mbar_expect_tx(bar, X_STAGE);
      tma_load_2d(stage, &tmap_x, bar, k0, m0);
    }
  };
  for (int q = 0; q < AHEAD && q < total; ++q) load(q);

  int resident = -1;  // which (column slab, K chunk) of W is in shared memory
  int q = 0;
  const int rloc = 16 * warp + (lane >> 2);
  for (int it = 0; it < mine; ++it) {
    const int tile = blockIdx.x + it * gridDim.x;
    const int rt = tile % row_tiles, ct = tile / row_tiles;
    float sx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rt * BM + rloc + 8 * h;
      sx[h] = row < m ? xs[row] : 0.f;
    }
    // no zeroing: the tile's first wgmma overwrites (scale_d = 0), so no
    // other instruction writes the accumulators inside the wgmma pipeline
    AccT acc[T::NSUB][NACC];

    for (int s = 0; s < slices; ++s, ++q) {
      const int k0 = s * BK;
      if (k0 % T::KC == 0 && ct * chunks + k0 / T::KC != resident) {
        wgmma_wait<0>();
        __syncthreads();  // every wgmma on the old slab has completed
        // the slab's column scales and bias, read alongside its codes
        const int gc = ct * BN + tid;
        const bool has_col = tid < BN && gc < n;
        const float cw = has_col ? ws[gc] : 0.f;
        const float cb = has_col && bias != nullptr ? bias[gc] : 0.f;
        load_w<BN, kInt8>(slab, wq, ct * BN, k0, min(k0 + T::KC, k), n,
                          vec_w, tid, T::NT);
        if (tid < BN) {
          col_ws[tid] = cw;
          col_b[tid] = cb;
        }
        resident = ct * chunks + k0 / T::KC;
      }
      if (tma) mbar_wait(smem_u32(&full[q % STAGES]), (q / STAGES) & 1);
      fence_async_shared();  // the plain stores (W slab, ragged X) to wgmma
      __syncthreads();

      uint32_t a0 = ring + (q % STAGES) * X_STAGE;
      if constexpr (!kInt8) {
        a0 = atile + (q & 1) * T::A_TILE;  // stage q - 2's wgmmas read it
        widen_x(ring + (q % STAGES) * X_STAGE, a0, tid, T::NT);
        fence_async_shared();
        __syncthreads();
      }
      const uint32_t b0 =
          slab + (k0 % T::KC) / T::KA * (BN * 128) + wg * T::WN * 128;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < T::STEPS; ++j) {
        // 32 bytes of K a step; four steps to a 128-byte row, then the
        // next atom
        const uint32_t koff = 32 * (j & 3);
        const uint64_t da =
            desc_sw128(a0 + (j >> 2) * (BM * 128) + koff, 1024);
#pragma unroll
        for (int sb = 0; sb < T::NSUB; ++sb)
          mma(acc[sb], da,
              desc_sw128(b0 + (j >> 2) * (BN * 128) + sb * T::SUBN * 128 +
                             koff,
                         1024),
              s > 0 || j > 0);
      }
      wgmma_commit();
      // issued behind the wgmmas, into the slot of stage q - 2, whose
      // wgmmas have completed
      if (q + AHEAD < total) load(q + AHEAD);
      wgmma_wait<1>();  // stage q's wgmmas run on while stage q + 1 starts
    }
    wgmma_wait<0>();
#pragma unroll
    for (int sb = 0; sb < T::NSUB; ++sb) fence_regs(acc[sb]);

    // dequant + bias + activation in the twin's order
    const int cloc = wg * T::WN + 2 * (lane & 3);  // + sb SUBN + 8 j + e
    const int col0 = ct * BN + cloc;
    float z[T::NSUB][NACC];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int sb = 0; sb < T::NSUB; ++sb)
#pragma unroll
        for (int j = 0; j < T::SUBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const int c = cloc + sb * T::SUBN + 8 * j + e;
            const int col = ct * BN + c;
            float v = (float)acc[sb][i] * sx[h];
            v = v * col_ws[c];  // 0 past N
            if (bias != nullptr && col < n) v = v + col_b[c];
            if (epilogue == kRelu) {
              v = fmaxf(v, 0.f);
            } else if (epilogue == kSilu) {
              v = v * (1.f / (1.f + expf(-v)));
            } else if (epilogue == kSoftmax && col >= n) {
              v = -CUDART_INF_F;  // past the row: not part of the softmax
            }
            z[sb][i] = v;
          }
    }

    if (epilogue == kSoftmax) {  // the block holds each row (N <= BN)
      float mx[2], sum[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = -CUDART_INF_F;
#pragma unroll
        for (int sb = 0; sb < T::NSUB; ++sb)
#pragma unroll
          for (int j = 0; j < T::SUBN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              mx[h] = fmaxf(mx[h], z[sb][4 * j + 2 * h + e]);
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        if constexpr (T::NWG > 1) {
          if ((lane & 3) == 0) rowred[0][wg][rloc + 8 * h] = mx[h];
        }
      }
      if constexpr (T::NWG > 1) {
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int g = 0; g < T::NWG; ++g)
            mx[h] = fmaxf(mx[h], rowred[0][g][rloc + 8 * h]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] = 0.f;
#pragma unroll
        for (int sb = 0; sb < T::NSUB; ++sb)
#pragma unroll
          for (int j = 0; j < T::SUBN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              z[sb][i] = expf(z[sb][i] - mx[h]);  // exp(-inf) = 0 past N
              sum[h] += z[sb][i];
            }
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        if constexpr (T::NWG > 1) {
          if ((lane & 3) == 0) rowred[1][wg][rloc + 8 * h] = sum[h];
        }
      }
      if constexpr (T::NWG > 1) {
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] = 0.f;
#pragma unroll
          for (int g = 0; g < T::NWG; ++g)
            sum[h] += rowred[1][g][rloc + 8 * h];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int sb = 0; sb < T::NSUB; ++sb)
#pragma unroll
          for (int j = 0; j < T::SUBN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) z[sb][4 * j + 2 * h + e] /= sum[h];
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rt * BM + rloc + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int sb = 0; sb < T::NSUB; ++sb)
#pragma unroll
        for (int j = 0; j < T::SUBN / 8; ++j) {
          const int col = col0 + sb * T::SUBN + 8 * j;
          const float v0 = z[sb][4 * j + 2 * h], v1 = z[sb][4 * j + 2 * h + 1];
          const size_t at = (size_t)row * n + col;
          if (col + 1 < n && (n & 1) == 0) {  // an aligned pair
            if (out_bf16) {
              *reinterpret_cast<__nv_bfloat162*>(
                  static_cast<__nv_bfloat16*>(out) + at) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
                  make_float2(v0, v1);
            }
          } else {
            for (int e = 0; e < 2 && col + e < n; ++e) {
              const float v = e ? v1 : v0;
              if (out_bf16) {
                static_cast<__nv_bfloat16*>(out)[at + e] = __float2bfloat16(v);
              } else {
                static_cast<float*>(out)[at + e] = v;
              }
            }
          }
        }
    }
  }
}

template <int BN, bool kInt8>
int launch(const void* xq, const void* wq, const float* xs, const float* ws,
           const float* bias, void* out, int m, int n, int k, int epilogue,
           int out_bf16, cudaStream_t stream) {
  using T = Tile<BN, kInt8>;
  auto kernel = te_gemm_quant_kernel<BN, kInt8>;
  const int dev = current_device();
  static std::atomic<unsigned long long> smem_set{0};  // per device
  const cudaError_t attr =
      allow_dynamic_smem(kernel, T::SMEM_MAX, smem_set, dev);
  if (attr != cudaSuccess) return (int)attr;
  const int kpad = (k + BK - 1) / BK * BK;
  const int smem = 1024 + STAGES * X_STAGE + T::A_TILES +
                   BN * T::EL * (kpad < T::KC ? kpad : T::KC);
  const long long tiles = (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const long long cap = (long long)BLOCKS_PER_SM * sm_count(dev);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // TMA needs 16-byte rows; the map zero-fills the ragged M and K edges
  CUtensorMap tmap_x = {};
  const int tma = k % 16 == 0 && (reinterpret_cast<uintptr_t>(xq) & 15) == 0;
  if (tma && !tma_map_2d(&tmap_x, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, m,
                         k, BM, BK))
    return (int)cudaErrorInvalidValue;
  const int vec_w = n % 4 == 0 && (reinterpret_cast<uintptr_t>(wq) & 3) == 0;
  kernel<<<(unsigned)(tiles < cap ? tiles : cap), T::NT, smem, stream>>>(
      static_cast<const uint8_t*>(xq), static_cast<const uint8_t*>(wq), xs,
      ws, bias, out, m, n, k, epilogue, out_bf16, tmap_x, tma, vec_w);
  return (int)cudaGetLastError();
}

template <bool kInt8>
int dispatch(const void* xq, const void* wq, const float* xs,
             const float* ws, const float* bias, void* out, int m, int n,
             int k, int epilogue, int out_bf16, int bn, cudaStream_t s) {
  // the softmax takes the whole row in one block
  if (epilogue == kSoftmax && n > bn) return (int)cudaErrorInvalidValue;
  if (bn == 32)
    return launch<32, kInt8>(xq, wq, xs, ws, bias, out, m, n, k, epilogue,
                             out_bf16, s);
  if (bn == 64)
    return launch<64, kInt8>(xq, wq, xs, ws, bias, out, m, n, k, epilogue,
                             out_bf16, s);
  if (bn == 128)
    return launch<128, kInt8>(xq, wq, xs, ws, bias, out, m, n, k, epilogue,
                              out_bf16, s);
  if (bn == 256)
    return launch<256, kInt8>(xq, wq, xs, ws, bias, out, m, n, k, epilogue,
                              out_bf16, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xq (m, k) and wq (k, n) codes, row-major, of one type: qtype 0 = int8,
// 1 = e4m3 (float8_e4m3fn); xs (m,) and ws (n,) fp32 scales; bias (n,)
// fp32 or null; out (m, n) fp32 (out_bf16 = 0) or bf16 (1).  epilogue:
// 0 none, 1 relu, 2 silu, 3 row-softmax (n <= bn).  bn, the column slab a
// block holds, is the caller's (kernels/te_gemm.py pick_block_shape): 32,
// 64, 128 or 256.  Returns cudaErrorInvalidValue for a slab with no
// instance (or narrower than a softmax row), else the launch's
// cudaError_t.
extern "C" int te_gemm_quant_launch(const void* xq, const void* wq,
                                    const void* xs, const void* ws,
                                    const void* bias, void* out, int m,
                                    int n, int k, int epilogue, int qtype,
                                    int out_bf16, int bn, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || epilogue < 0 || epilogue > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* sx = static_cast<const float*>(xs);
  const float* sw = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  if (qtype == 0)
    return dispatch<true>(xq, wq, sx, sw, b, out, m, n, k, epilogue,
                          out_bf16, bn, s);
  if (qtype == 1)
    return dispatch<false>(xq, wq, sx, sw, b, out, m, n, k, epilogue,
                           out_bf16, bn, s);
  return (int)cudaErrorInvalidValue;
}
