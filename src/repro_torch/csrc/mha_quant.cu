// Flash multi-head attention over quantized q, k, v on Hopper (sm_90a), on
// the tensor cores.
//
// Replaces: repro/kernels/mha.py::mha_quant (_mha_quant_kernel): q, k, v
// (BH, S, D) as int8 or e4m3 codes with one fp32 scale per (batch*head)
// row each (qs, ks, vs).  The scores come out in real units as
// (q . k) * (qs * ks * D^-0.5); the causal mask (q_pos >= k_pos on
// absolute positions, -1e30 fill) and the online softmax run in fp32 over
// key tiles; P @ V accumulates the raw v codes in fp32 and the result is
// scaled by vs / l once at the end, stored as fp32 or bf16.
//
// What bounds it: at (4, 256, 64) causal it moves 0.26 MB of codes plus
// the fp32 output (0.6 MB, 0.2 us of HBM time) against ~17 MFLOP of
// useful work (0.01 us at the 1,979 TOP/s 8-bit tensor-core peak):
// bytes, and in practice latency: how many SMs a call keeps busy and how
// long each waits on its loads.
//
// Design: mha.cu's.  One warpgroup (128 threads) owns 64 query rows
// (wgmma M = 64), an output slab of DV <= 128 columns of D (a grid axis
// when D > 128: every slab block computes the scores over the whole D)
// and a run of 64-key tiles.  S (64 x 64) and the O accumulator (64 x DV)
// live in registers.  Per key tile:
//   - the Q and K codes of each 128-code column of D come through a
//     3-stage ring as one item (TMA, 3-D maps so a box never crosses a
//     head, zero past Sq, Sk and D, 128-byte swizzle), then the tile's V
//     slab as one more item; each item's refill is issued behind its
//     wgmmas;
//   - S = Q K^T: int8 on m64n64k32 s8 wgmmas over the codes as they landed
//     (both operands K-major along D, the only layout 8-bit wgmma takes),
//     the int32 score converted once and multiplied by qs * ks * D^-0.5;
//     e4m3 codes are widened to bf16 in shared memory (exact) for bf16
//     wgmmas with fp32 accumulators, since e4m3 sums in fp8 wgmmas miss
//     rtol 1e-4 (te_gemm_quant.cu);
//   - the online softmax on the S fragments (a row's values meet in a quad
//     of lanes; the s32 and f32 accumulators share one fragment layout):
//     mask (keys past Sk left out, causal -1e30 fill), running max,
//     p = exp(s - m), corr = exp(m_old - m), O *= corr;
//   - O += P V: P from the S registers split as hi + lo bf16 (P rounded to
//     bf16 alone would miss rtol 1e-4), V's codes widened to bf16 (exact
//     for int8 and e4m3) and transposed by the threads into a K-major V^T
//     tile while the tile's last Q K^T wgmmas run.
// Small grids: when BH x ceil(Sq / 64) x slabs is well under the SM count,
// a thread-block cluster of up to 8 blocks splits the key tiles and merges
// its partial (m, l, O) through distributed shared memory, as mha.cu.
// With the causal mask, key tiles wholly after the query tile are skipped
// (their p is exactly 0).  Rows past Sq and columns past D are masked:
// any BH, Sq, Sk and D.  The wrapper zero-pads the codes' D only to a
// multiple of 16 (TMA's 16-byte row pitch); a k-step of 32 codes past D
// reads TMA's zero fill.  The output keeps the true D.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int BM = 64;                  // query rows: one wgmma M
constexpr int BKV = 64;                 // keys per tile
constexpr int NT = 128;                 // one warpgroup
constexpr int STAGES = 3;               // depth of the Q/K and V ring
constexpr int AHEAD = STAGES - 1;
constexpr int ATOM = 64 * 128;          // bytes of one 64-row, 128-byte column
constexpr int CODES = 128;              // codes of D a ring item holds
constexpr int STAGE_BYTES = 2 * ATOM;   // a Q column and a K column
constexpr int MAX_CLUSTER = 8;
constexpr float kMaskFill = -1e30f;

template <bool FP8, int DV>
struct Cfg {
  static constexpr int NC = DV > 64 ? DV / 64 : 1;  // PV wgmmas across DV
  static constexpr int CW = DV > 64 ? 64 : DV;      // and their width
  static constexpr int VT = DV * 128;  // V^T: DV rows of 64 keys in bf16
  static constexpr int WIDE = FP8 ? 4 * ATOM : 0;  // widened Q, K columns
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + VT + WIDE;
  static constexpr int PITCH = DV + 4;  // floats a row of a merge partial
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// one code (the low byte of c) as fp32: exact for int8 and for e4m3
template <bool FP8>
__device__ __forceinline__ float decode(uint32_t c) {
  if constexpr (FP8) {
    return __half2float(
        __half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)(c & 0xffu),
                                       __NV_E4M3)));
  } else {
    return (float)(int8_t)(c & 0xffu);
  }
}

// two e4m3 codes (the low byte first) as two bf16 (the low half first);
// exact: e4m3 -> f16 -> f32 -> bf16 loses nothing
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t codes) {
  const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(codes), __NV_E4M3)));
  return pack_bf16(f.x, f.y);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <bool FP8, int DV, typename T>
__global__ void __launch_bounds__(NT)
mha_quant_kernel(const __grid_constant__ CUtensorMap tmap_q,
                 const __grid_constant__ CUtensorMap tmap_k,
                 const __grid_constant__ CUtensorMap tmap_v,
                 const float* __restrict__ qs, const float* __restrict__ ks,
                 const float* __restrict__ vs, T* __restrict__ out, int sq,
                 int sk, int dp, int d, int slabs, int causal, float scale) {
  using C = Cfg<FP8, DV>;
  constexpr int NS = BKV / 2;  // S fragments a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ float row_m[BM], row_l[BM], row_inv[BM];
  __shared__ float row_f[BM][MAX_CLUSTER];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int unit = blockIdx.x / cs;
  const int qtiles = (sq + BM - 1) / BM;
  const int slab = unit % slabs;
  const int qt = (unit / slabs) % qtiles;
  const int bh = unit / (slabs * qtiles);
  const int q0 = qt * BM, dv0 = slab * DV;

  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t vt = ring + STAGES * STAGE_BYTES;
  const uint32_t wide = vt + C::VT;  // e4m3: Q's, then K's bf16 columns

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int rloc = 16 * warp + (lane >> 2);  // this thread's rows: +0, +8

  // this block's key tiles: its share of those the query tile sees
  const int kv_end = causal ? min(sk, q0 + BM) : sk;
  const int ntiles = (kv_end + BKV - 1) / BKV;
  const int t_begin = rank * ntiles / cs, t_end = (rank + 1) * ntiles / cs;
  const int nchunks = (dp + CODES - 1) / CODES;
  const int per_tile = nchunks + 1;  // Q/K columns, then the V slab
  const int total = (t_end - t_begin) * per_tile;
  const float sc = qs[bh] * ks[bh] * scale;  // the scores' real units

  if (tid == 0) {
    tma_prefetch_map(&tmap_q);
    tma_prefetch_map(&tmap_k);
    tma_prefetch_map(&tmap_v);
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    fence_mbar_init();
  }
  __syncthreads();
  auto issue = [&](int qi) {  // one thread: item qi into its ring slot
    const int t = t_begin + qi / per_tile, j = qi % per_tile;
    const uint32_t slot = ring + (qi % STAGES) * STAGE_BYTES;
    const uint32_t bar = smem_u32(&full[qi % STAGES]);
    if (j < nchunks) {
      mbar_expect_tx(bar, 2 * ATOM);
      tma_load_3d(slot, &tmap_q, bar, j * CODES, q0, bh);
      tma_load_3d(slot + ATOM, &tmap_k, bar, j * CODES, t * BKV, bh);
    } else {
      mbar_expect_tx(bar, ATOM);
      tma_load_3d(slot, &tmap_v, bar, dv0, t * BKV, bh);
    }
  };
  if (tid == 0)
    for (int qi = 0; qi < AHEAD && qi < total; ++qi) issue(qi);

  float o[C::NC][C::CW / 2];
#pragma unroll
  for (int c = 0; c < C::NC; ++c)
#pragma unroll
    for (int i = 0; i < C::CW / 2; ++i) o[c][i] = 0.f;
  float m[2] = {kMaskFill, kMaskFill}, lsum[2] = {0.f, 0.f};
  float s[NS];

  // e4m3: the landed Q and K columns' first n16 16-byte chunks of every
  // row, widened to bf16 (two 128-byte bf16 columns each)
  auto widen_qk = [&](uint32_t slot, int n16) {
    for (int i = tid; i < 2 * BM * n16; i += NT) {
      const int op = i / (BM * n16), r = (i / n16) % BM, c = i % n16;
      const uint4 w = ld_shared_v4(slot + op * ATOM + sw128(r, c));
      const uint32_t x[4] = {w.x, w.y, w.z, w.w};
      uint32_t b[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        b[2 * e] = e4m3x2_to_bf16x2(x[e] & 0xffffu);
        b[2 * e + 1] = e4m3x2_to_bf16x2(x[e] >> 16);
      }
      const uint32_t dst = wide + op * 2 * ATOM + (c / 4) * ATOM;
      st_shared_v4(dst + sw128(r, 2 * (c % 4)), b[0], b[1], b[2], b[3]);
      st_shared_v4(dst + sw128(r, 2 * (c % 4) + 1), b[4], b[5], b[6], b[7]);
    }
  };
  // V item vq, once landed, widened to bf16 and transposed into the
  // K-major V^T tile: two keys' 16 columns a thread, each column's pair of
  // keys one 32-bit word of V^T
  auto stage_v = [&](int vq) {
    const uint32_t slot = ring + (vq % STAGES) * STAGE_BYTES;
    mbar_wait(smem_u32(&full[vq % STAGES]), (vq / STAGES) & 1);
    for (int i = tid; i < (BKV / 2) * (DV / 16); i += NT) {
      const int k0 = 2 * (i % (BKV / 2)), dd = 16 * (i / (BKV / 2));
      const uint4 a = ld_shared_v4(slot + sw128(k0, dd / 16));
      const uint4 b = ld_shared_v4(slot + sw128(k0 + 1, dd / 16));
      const uint32_t av[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int sh = 8 * (e % 4);
        st_shared_u32(vt + sw128(dd + e, k0 / 8) + 2 * (k0 % 8),
                      pack_bf16(decode<FP8>(av[e / 4] >> sh),
                                decode<FP8>(bv[e / 4] >> sh)));
      }
    }
    fence_async_shared();  // V^T, to wgmma
  };

  for (int t = t_begin; t < t_end; ++t) {
    const int qk = (t - t_begin) * per_tile;  // the tile's first item
    // ---- S = Q K^T, a 128-code column of D at a time ----------------------
    int si[NS];  // int8: the exact integer scores
    for (int j = 0; j < nchunks; ++j) {
      const int qi = qk + j;
      const uint32_t slot = ring + (qi % STAGES) * STAGE_BYTES;
      const int n32 = (min(CODES, dp - j * CODES) + 31) / 32;  // k-steps
      mbar_wait(smem_u32(&full[qi % STAGES]), (qi / STAGES) & 1);
      __syncthreads();  // item qi is in; item qi - 1 is done everywhere
      if constexpr (FP8) {
        widen_qk(slot, 2 * n32);
        fence_async_shared();  // the widened columns, to wgmma
        __syncthreads();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {  // bf16 k-steps of 16 codes
          if (kk >= 2 * n32) break;
          const uint32_t off = (kk / 4) * ATOM + 32 * (kk % 4);
          wgmma_bf16(s, desc_sw128(wide + off, 1024),
                     desc_sw128(wide + 2 * ATOM + off, 1024),
                     j > 0 || kk > 0);
        }
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk >= n32) break;
          wgmma_s8(si, desc_sw128(slot + 32 * kk, 1024),
                   desc_sw128(slot + ATOM + 32 * kk, 1024), j > 0 || kk > 0);
        }
      }
      wgmma_commit();
      // the refill, behind the wgmmas: the issuing thread would otherwise
      // hold its warpgroup at them
      if (tid == 0 && qi + AHEAD < total) issue(qi + AHEAD);
      // while the tile's last wgmmas run, its V^T
      if (j == nchunks - 1) stage_v(qk + nchunks);
      wgmma_wait<0>();
    }
    if constexpr (FP8) {
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = s[i] * sc;
    } else {
      fence_regs(si);
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = (float)si[i] * sc;
    }

    // ---- online softmax on the tile's scores -----------------------------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = q0 + rloc + 8 * h;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * h + e;
          const int kpos = t * BKV + 8 * jj + 2 * t4 + e;
          float x = s[i];
          if (kpos >= sk) {
            x = -CUDART_INF_F;  // past the keys: not in the softmax
          } else if (causal && qpos < kpos) {
            x = kMaskFill;
          }
          s[i] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx);
      const float corr = __expf(m[h] - mn);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * h + e;
          s[i] = __expf(s[i] - mn);
          ps += s[i];
        }
      lsum[h] = lsum[h] * corr + ps;  // this thread's part of the row
      m[h] = mn;
#pragma unroll
      for (int c = 0; c < C::NC; ++c)
#pragma unroll
        for (int jj = 0; jj < C::CW / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) o[c][4 * jj + 2 * h + e] *= corr;
    }

    // ---- O += P V --------------------------------------------------------
    __syncthreads();  // V^T is written by every thread
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float x0 = s[8 * kk + 2 * f], x1 = s[8 * kk + 2 * f + 1];
        ph[f] = pack_bf16(x0, x1);
        const __nv_bfloat162 hv =
            *reinterpret_cast<const __nv_bfloat162*>(&ph[f]);
        pl[f] = pack_bf16(x0 - __bfloat162float(hv.x),
                          x1 - __bfloat162float(hv.y));
      }
#pragma unroll
      for (int c = 0; c < C::NC; ++c) {
        const uint64_t vd = desc_sw128(vt + 32 * kk + c * 64 * 128, 1024);
        wgmma_bf16_rs(o[c], ph, vd, 1);
        wgmma_bf16_rs(o[c], pl, vd, 1);
      }
    }
    wgmma_commit();
    const int vq = qk + nchunks;
    if (tid == 0 && vq + AHEAD < total) issue(vq + AHEAD);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::NC; ++c) fence_regs(o[c]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {  // a row's sum meets in its quad
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
  const float vsc = vs[bh];
  T* ob = out + ((size_t)bh * sq + q0) * d + dv0;
  if (cs == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (q0 + rloc + 8 * h >= sq) continue;
      const float post = vsc / fmaxf(lsum[h], 1e-30f);
      T* orow = ob + (size_t)(rloc + 8 * h) * d;
#pragma unroll
      for (int c = 0; c < C::NC; ++c)
#pragma unroll
        for (int jj = 0; jj < C::CW / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c * 64 + 8 * jj + 2 * t4 + e;
            if (dv0 + col < d)
              store_out(orow + col, o[c][4 * jj + 2 * h + e] * post);
          }
    }
    return;
  }

  // ---- the cluster's partials merged through distributed shared memory --
  // every load into the ring has landed and every wgmma has completed, so
  // the ring holds this block's partial O
  float* part =
      reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rloc + 8 * h;
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
#pragma unroll
      for (int jj = 0; jj < C::CW / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[r * C::PITCH + c * 64 + 8 * jj + 2 * t4 + e] =
              o[c][4 * jj + 2 * h + e];
    if (t4 == 0) {
      row_m[r] = m[h];
      row_l[r] = lsum[h];
    }
  }
  cluster.sync();
  const int rows = BM / cs, r0 = rank * rows;
  if (tid < rows) {  // each row's common max, its blocks' factors, vs / l
    float mr[MAX_CLUSTER], mx = -CUDART_INF_F;
#pragma unroll
    for (int b = 0; b < MAX_CLUSTER; ++b) {
      mr[b] = b < cs ? cluster.map_shared_rank(row_m, b)[r0 + tid]
                     : -CUDART_INF_F;
      mx = fmaxf(mx, mr[b]);
    }
    float l = 0.f;
#pragma unroll
    for (int b = 0; b < MAX_CLUSTER; ++b) {
      if (b >= cs) break;
      const float f = __expf(mr[b] - mx);
      row_f[tid][b] = f;
      l += cluster.map_shared_rank(row_l, b)[r0 + tid] * f;
    }
    row_inv[tid] = vsc / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  // 4 columns a thread at a time, every block's loads of a round issued
  // before any is used (a remote load costs hundreds of cycles)
  constexpr int U = 8;
  const int per = rows * (DV / 4);
  const bool vec = d % 4 == 0;  // output rows 16-byte (fp32) / 8-byte aligned
  for (int i0 = 0; i0 < per; i0 += U * NT) {
    float4 acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int b = 0; b < MAX_CLUSTER; ++b) {
      if (b >= cs) break;
      // this block's own partial through its local window
      const float* pb = b == rank ? part : cluster.map_shared_rank(part, b);
      float4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NT + tid;
        x[u] = i < per ? *reinterpret_cast<const float4*>(
                             pb + (r0 + i / (DV / 4)) * C::PITCH +
                             4 * (i % (DV / 4)))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NT + tid;
        const float f = i < per ? row_f[i / (DV / 4)][b] : 0.f;
        acc[u].x += x[u].x * f;
        acc[u].y += x[u].y * f;
        acc[u].z += x[u].z * f;
        acc[u].w += x[u].w * f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT + tid;
      if (i >= per) continue;
      const int rr = i / (DV / 4), col = 4 * (i % (DV / 4));
      if (q0 + r0 + rr >= sq) continue;
      const float inv = row_inv[rr];
      const float v4[4] = {acc[u].x * inv, acc[u].y * inv, acc[u].z * inv,
                           acc[u].w * inv};
      T* orow = ob + (size_t)(r0 + rr) * d + col;
      if (vec && dv0 + col + 3 < d) {
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(orow) =
              make_float4(v4[0], v4[1], v4[2], v4[3]);
        } else {
          *reinterpret_cast<uint2*>(orow) =
              make_uint2(pack_bf16(v4[0], v4[1]), pack_bf16(v4[2], v4[3]));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (dv0 + col + e < d) store_out(orow + e, v4[e]);
      }
    }
  }
  cluster.sync();  // no block leaves while another may read its partials
}

template <bool FP8, int DV, typename T>
int launch(const void* q, const void* k, const void* v, const float* qs,
           const float* ks, const float* vs, void* out, int bh, int sq,
           int sk, int dp, int d, int causal, float scale,
           cudaStream_t stream) {
  using C = Cfg<FP8, DV>;
  auto kernel = mha_quant_kernel<FP8, DV, T>;
  const int dev = current_device();
  static std::atomic<unsigned long long> smem_set{0};  // per device
  const cudaError_t attr = allow_dynamic_smem(kernel, C::SMEM, smem_set, dev);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mq = {}, mk = {}, mv = {};
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!tma_map_3d(&mq, q, u8, 1, bh, sq, dp, BM, CODES) ||
      !tma_map_3d(&mk, k, u8, 1, bh, sk, dp, BKV, CODES) ||
      !tma_map_3d(&mv, v, u8, 1, bh, sk, dp, BKV, CODES))
    return (int)cudaErrorInvalidValue;
  const long long qtiles = (sq + BM - 1) / BM, slabs = (d + DV - 1) / DV;
  const long long units = (long long)bh * qtiles * slabs;
  const long long kv_max = causal ? (sk < qtiles * BM ? sk : qtiles * BM)
                                  : sk;
  const long long tiles = (kv_max + BKV - 1) / BKV;
  // a cluster splits the keys while the grid is under one wave
  int cs = 1;
  while (cs < MAX_CLUSTER && 2 * cs <= tiles &&
         units * 2 * cs <= sm_count(dev))
    cs *= 2;
  if (units * cs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(units * cs));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, mq, mk, mv, qs, ks, vs, static_cast<T*>(out), sq, sk, dp,
      d, (int)slabs, causal, scale);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool FP8, typename T>
int dispatch(const void* q, const void* k, const void* v, const float* qs,
             const float* ks, const float* vs, void* out, int bh, int sq,
             int sk, int dp, int d, int causal, float scale, cudaStream_t s) {
  if (d <= 32)
    return launch<FP8, 32, T>(q, k, v, qs, ks, vs, out, bh, sq, sk, dp, d,
                              causal, scale, s);
  if (d <= 64)
    return launch<FP8, 64, T>(q, k, v, qs, ks, vs, out, bh, sq, sk, dp, d,
                              causal, scale, s);
  return launch<FP8, 128, T>(q, k, v, qs, ks, vs, out, bh, sq, sk, dp, d,
                             causal, scale, s);
}

}  // namespace

// q (bh, sq, dp), k and v (bh, sk, dp): contiguous codes of one type,
// qtype 0 = int8, 1 = e4m3, zero-padded along D to dp, a multiple of 16,
// 16-byte aligned; qs, ks, vs (bh,) fp32 scales; out (bh, sq, d) fp32
// (out_bf16 = 0) or bf16 (1), d <= dp the true head dimension; scale is
// d^-0.5 as the caller rounds it.  Returns the launch's cudaError_t.
extern "C" int mha_quant_launch(const void* q, const void* k, const void* v,
                                const void* qs, const void* ks,
                                const void* vs, void* out, int bh, int sq,
                                int sk, int dp, int d, int causal,
                                float scale, int qtype, int out_bf16,
                                void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > dp || dp % 16 != 0 ||
      qtype < 0 || qtype > 1)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  if ((bits & 15) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = static_cast<const float*>(qs);
  const float* b = static_cast<const float*>(ks);
  const float* c = static_cast<const float*>(vs);
  if (qtype == 1)
    return out_bf16 ? dispatch<true, __nv_bfloat16>(q, k, v, a, b, c, out, bh,
                                                    sq, sk, dp, d, causal,
                                                    scale, s)
                    : dispatch<true, float>(q, k, v, a, b, c, out, bh, sq, sk,
                                            dp, d, causal, scale, s);
  return out_bf16 ? dispatch<false, __nv_bfloat16>(q, k, v, a, b, c, out, bh,
                                                   sq, sk, dp, d, causal,
                                                   scale, s)
                  : dispatch<false, float>(q, k, v, a, b, c, out, bh, sq, sk,
                                           dp, d, causal, scale, s);
}
