// Flash multi-head attention on Hopper (sm_90a), on the tensor cores.
//
// Replaces: repro/kernels/mha.py::mha (_mha_kernel), the paper's MHA block:
// q, k, v (BH, S, D), scores q * D^-0.5 @ k^T with an optional causal mask
// (q_pos >= k_pos on absolute positions, -1e30 fill), online softmax in
// fp32 over key tiles, out = acc / max(l, 1e-30), in q's dtype.
//
// What bounds it: on the shapes served and tested it is small work with
// little data (CE-ViT's (32, 64, 64, 16) moves 0.5 MB and does 8.4 MFLOP;
// Fig. 10's (4, 128, 128, 128) causal 0.5 MB and 18 MFLOP), so latency:
// how many SMs a call can keep busy and how long each waits on its loads.
//
// Design: one warpgroup (128 threads) owns 64 query rows (wgmma M = 64),
// an output slab of DV <= 128 columns of D (a grid axis when D > 128:
// every slab block computes the scores over the whole D) and a run of
// 64-key tiles.  S (64 x 64) and the O accumulator (64 x DV) live in
// registers.  Per key tile:
//   - K streams through a 3-stage ring as chunks of up to 4 128-byte
//     columns of D (TMA, 3-D maps so a box never crosses a head, zero past
//     Sk and D, 128-byte swizzle), then the tile's V slab as one more item;
//     each item's refill of the ring is issued behind its wgmmas;
//   - S = Q K^T: Q's A fragments come from device memory (L1 / L2; any D,
//     no shared memory), a whole chunk's loaded while its K lands; K is
//     the B operand as it landed (K-major);
//   - the online softmax on the S fragments (a row's values meet in a quad
//     of lanes): scale, mask (keys past Sk left out, causal -1e30 fill),
//     running max, p = exp(s - m), corr = exp(m_old - m), O *= corr;
//   - O += P V: P from the S registers, V transposed by the threads into a
//     K-major tile (the only layout TF32 wgmma takes) while the tile's
//     last Q K^T wgmmas run.
// The wgmma count is the tensor cores' share; thread work that needs none
// (the split of K's next column, the transpose) overlaps it.
// fp32 is 3xTF32, as te_gemm.cu: x = hi + lo (hi the top 19 bits), the
// product hi.hi + hi.lo + lo.hi on tf32 wgmmas (m64nNk8) with fp32
// accumulators.  Q and P are split in registers; each landed K chunk is
// split in place (hi, with a lo tile beside it), and V^T is written as hi
// and lo tiles.
// P's accumulator layout (columns 2 (lane % 4) + {0, 1} of each 8) is not
// TF32's A layout (columns lane % 4 + {0, 4}), so each group of 8 keys is
// permuted: A column c holds key 2c (c < 4) or 2 (c - 4) + 1, and V^T's
// K positions follow the same permutation.  bf16 runs bf16 wgmmas
// (m64nNk16) with fp32 accumulators: Q.K^T on the codes as they are, and
// P V with P split as hi + lo bf16 (P rounded to bf16 alone would miss a
// one-bf16-step gate where outputs cancel).
// Small grids: when BH x ceil(Sq / 64) x slabs is well under the SM count,
// a thread-block cluster of up to 8 blocks splits the key tiles (its size
// the caller's: kernels/mha.py pick_cluster, a tuned winner or the
// heuristic that doubles it while the grid stays within one wave); each
// block keeps its partial (m, l, O) and the cluster merges them through
// distributed shared memory in one exchange, rescaled to the common max,
// each block finishing 64 / cluster rows.  With the causal mask, key tiles
// wholly after the query tile are skipped, which changes nothing (each of
// their p is exactly 0 and their corr exactly 1 in the reference).  Rows
// past Sq and columns past D are masked: any BH, Sq, Sk and D work; the
// wrapper zero-pads D to a 16-byte row pitch (TMA's), with the true D's
// scale.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int BM = 64;                         // query rows: one wgmma M
constexpr int BKV = 64;                        // keys per tile
constexpr int NT = 128;                        // one warpgroup
constexpr int STAGES = 3;                      // depth of the K / V ring
constexpr int AHEAD = STAGES - 1;
constexpr int MAX_ATOMS = 4;                   // 128-byte columns a K item
constexpr int ATOM = BKV * 128;                // bytes of one 64-row column
constexpr int STAGE_BYTES = MAX_ATOMS * ATOM;  // 32 KB
constexpr int MAX_CLUSTER = 8;
constexpr float kMaskFill = -1e30f;

template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr int EPA = 32;  // elements a 128-byte column holds
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Op<__nv_bfloat16> {
  static constexpr int EPA = 64;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <typename T, int DV>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int NC = DV > 64 ? DV / 64 : 1;  // PV wgmmas across DV
  static constexpr int CW = DV > 64 ? 64 : DV;      // and their width
  // 128-byte columns of a V item, and of V^T (K-major: keys along a row)
  static constexpr int NVA = DV * (int)sizeof(T) > 128
                                 ? DV * (int)sizeof(T) / 128 : 1;
  static constexpr int VT = BKV * (int)sizeof(T) / 128 * DV * 128;
  static constexpr int SMEM =
      1024 + STAGES * STAGE_BYTES + (F32 ? STAGE_BYTES + 2 * VT : VT);
  static constexpr int PITCH = DV + 4;  // floats a row of a merge partial
};

__device__ __forceinline__ uint32_t tf32_hi(uint32_t bits) {
  return bits & 0xffffe000u;
}
__device__ __forceinline__ uint32_t tf32_lo(uint32_t bits) {
  return __float_as_uint(__uint_as_float(bits) -
                         __uint_as_float(tf32_hi(bits)));
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int DV>
__global__ void __launch_bounds__(NT)
mha_kernel(const T* __restrict__ q, T* __restrict__ out,
           const __grid_constant__ CUtensorMap tmap_k,
           const __grid_constant__ CUtensorMap tmap_v, int sq, int sk, int d,
           int slabs, int causal, float scale) {
  using C = Cfg<T, DV>;
  constexpr int EPA = Op<T>::EPA;
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
  const uint32_t klo = ring + STAGES * STAGE_BYTES;  // fp32: K's lo parts
  const uint32_t vt = C::F32 ? klo + STAGE_BYTES : klo;
  const uint32_t vt_lo = vt + C::VT;                 // fp32: V^T's lo parts

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rloc = 16 * warp + g;  // this thread's rows: rloc, rloc + 8

  // this block's key tiles: its share of those the query tile sees
  const int kv_end = causal ? min(sk, q0 + BM) : sk;
  const int ntiles = (kv_end + BKV - 1) / BKV;
  const int t_begin = rank * ntiles / cs, t_end = (rank + 1) * ntiles / cs;
  const int nchunks = (d + MAX_ATOMS * EPA - 1) / (MAX_ATOMS * EPA);
  const int per_tile = nchunks + 1;  // K chunks, then the V slab
  const int total = (t_end - t_begin) * per_tile;

  if (tid == 0) {
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
      const int c0 = j * MAX_ATOMS * EPA;
      const int na = min(MAX_ATOMS, (d - c0 + EPA - 1) / EPA);
      mbar_expect_tx(bar, na * ATOM);
      for (int a = 0; a < na; ++a)
        tma_load_3d(slot + a * ATOM, &tmap_k, bar, c0 + a * EPA, t * BKV,
                    bh);
    } else {
      mbar_expect_tx(bar, C::NVA * ATOM);
      for (int a = 0; a < C::NVA; ++a)
        tma_load_3d(slot + a * ATOM, &tmap_v, bar, dv0 + a * EPA, t * BKV,
                    bh);
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
  const bool live[2] = {q0 + rloc < sq, q0 + rloc + 8 < sq};
  const T* qrow = q + ((size_t)bh * sq + q0 + rloc) * d;
  // this thread's A fragments of a K chunk's Q columns, raw, all issued
  // at once: for column a (at c0 + a * EPA), fp32 values (columns
  // + 8 kk + lane % 4 (+ 4)) or bf16 pairs (columns + 16 kk + 2 (lane % 4)
  // (+ 8)), rows rloc (+ 8 for odd f); zero past D and Sq
  uint32_t qraw[MAX_ATOMS][4][4];
  auto load_q = [&](int c0) {
#pragma unroll
    for (int a = 0; a < MAX_ATOMS; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const size_t row = (f & 1) * 8 * (size_t)d;
          const int cb = c0 + a * EPA;
          if constexpr (C::F32) {
            const int col = cb + 8 * kk + t4 + 4 * (f >> 1);
            qraw[a][kk][f] = live[f & 1] && col < d
                                 ? __float_as_uint(__ldg(qrow + row + col))
                                 : 0u;
          } else {
            const int col = cb + 16 * kk + 2 * t4 + 8 * (f >> 1);
            qraw[a][kk][f] = live[f & 1] && col < d
                                 ? __ldg(reinterpret_cast<const uint32_t*>(
                                       qrow + row + col))
                                 : 0u;
          }
        }
  };

  // fp32: atom a of a landed K chunk split in place into hi, lo beside it
  auto split_k = [&](uint32_t slot, int a) {
    for (int i = tid; i < ATOM / 16; i += NT) {
      const uint32_t at = a * ATOM + 16 * i;
      const uint4 w = ld_shared_v4(slot + at);
      st_shared_v4(slot + at, tf32_hi(w.x), tf32_hi(w.y), tf32_hi(w.z),
                   tf32_hi(w.w));
      st_shared_v4(klo + at, tf32_lo(w.x), tf32_lo(w.y), tf32_lo(w.z),
                   tf32_lo(w.w));
    }
  };
  // V item vq, once landed, transposed into the K-major V^T tile(s)
  auto stage_v = [&](int vq) {
    const uint32_t slot = ring + (vq % STAGES) * STAGE_BYTES;
    mbar_wait(smem_u32(&full[vq % STAGES]), (vq / STAGES) & 1);
    if constexpr (C::F32) {
      // one 16-byte chunk (4 columns of one key) a thread at a time; key w
      // of each group of 8 goes to A column w / 2 + 4 (w & 1)
      for (int i = tid; i < BKV * DV / 4; i += NT) {
        const int key = i % BKV, dd = 4 * (i / BKV);
        const uint4 w =
            ld_shared_v4(slot + (dd / 32) * ATOM + sw128(key, (dd % 32) / 4));
        const int col = (key & 24) + (key & 7) / 2 + 4 * (key & 1);
        const uint32_t base = (key / 32) * (DV * 128) + 4 * (col & 3);
        const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t off = base + sw128(dd + e, col >> 2);
          st_shared_u32(vt + off, tf32_hi(x[e]));
          st_shared_u32(vt_lo + off, tf32_lo(x[e]));
        }
      }
    } else {
      // two keys' 8 columns a thread: each column's pair of keys is one
      // 32-bit word of V^T
      for (int i = tid; i < (BKV / 2) * (DV / 8); i += NT) {
        const int k0 = 2 * (i % (BKV / 2)), dd = 8 * (i / (BKV / 2));
        const uint32_t src = slot + (dd / 64) * ATOM;
        const uint4 a = ld_shared_v4(src + sw128(k0, (dd % 64) / 8));
        const uint4 b = ld_shared_v4(src + sw128(k0 + 1, (dd % 64) / 8));
        const uint32_t av[4] = {a.x, a.y, a.z, a.w};
        const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          st_shared_u32(vt + sw128(dd + e, k0 / 8) + 2 * (k0 % 8),
                        __byte_perm(av[e / 2], bv[e / 2],
                                    e & 1 ? 0x7632 : 0x5410));
      }
    }
    fence_async_shared();  // V^T, to wgmma
  };

  for (int t = t_begin; t < t_end; ++t) {
    const int qk = (t - t_begin) * per_tile;  // the tile's first item
    // ---- S = Q K^T, chunk by chunk of D ----------------------------------
    for (int j = 0; j < nchunks; ++j) {
      const int qi = qk + j;
      const uint32_t slot = ring + (qi % STAGES) * STAGE_BYTES;
      const int c0 = j * MAX_ATOMS * EPA;
      const int na = min(MAX_ATOMS, (d - c0 + EPA - 1) / EPA);
      load_q(c0);  // the chunk's Q, while its K lands
      mbar_wait(smem_u32(&full[qi % STAGES]), (qi / STAGES) & 1);
      __syncthreads();  // item qi is in; item qi - 1 is done everywhere
      if constexpr (C::F32) {
        split_k(slot, 0);
        fence_async_shared();  // the hi and lo parts, to wgmma
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < MAX_ATOMS; ++a) {  // a 128-byte column: 4 k-steps
        if (a >= na) break;
        if constexpr (C::F32) {
          uint32_t hi[4][4], lo[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              hi[kk][f] = tf32_hi(qraw[a][kk][f]);
              lo[kk][f] = tf32_lo(qraw[a][kk][f]);
            }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t off = a * ATOM + 32 * kk;
            const uint64_t kh = desc_sw128(slot + off, 1024);
            const uint64_t kl = desc_sw128(klo + off, 1024);
            wgmma_tf32_rs(s, hi[kk], kh, j > 0 || a > 0 || kk > 0);
            wgmma_tf32_rs(s, hi[kk], kl, 1);
            wgmma_tf32_rs(s, lo[kk], kh, 1);
          }
        } else {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16_rs(s, qraw[a][kk],
                          desc_sw128(slot + a * ATOM + 32 * kk, 1024),
                          j > 0 || a > 0 || kk > 0);
        }
        wgmma_commit();
        // the refill, behind the first wgmmas: the issuing thread would
        // otherwise hold its warpgroup at them
        if (a == 0 && tid == 0 && qi + AHEAD < total) issue(qi + AHEAD);
        // work that needs no tensor core, while the wgmmas run: the next
        // column's split, and after the tile's last K column its V^T
        if constexpr (C::F32) {
          if (a + 1 < na) {
            split_k(slot, a + 1);
            fence_async_shared();
          }
        }
        if (j == nchunks - 1 && a == na - 1) stage_v(qk + nchunks);
        wgmma_wait<0>();  // the A registers are free again
        if (C::F32 && a + 1 < na) __syncthreads();  // the split is in
      }
    }
    fence_regs(s);

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
          float x = s[i] * scale;
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
    if constexpr (C::F32) {
#pragma unroll
      for (int kk = 0; kk < BKV / 8; ++kk) {
        const float p[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1],
                            s[4 * kk + 3]};
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          ph[f] = tf32_hi(__float_as_uint(p[f]));
          pl[f] = tf32_lo(__float_as_uint(p[f]));
        }
        const uint32_t off = (kk / 4) * (DV * 128) + 32 * (kk % 4);
#pragma unroll
        for (int c = 0; c < C::NC; ++c) {
          const uint64_t vh = desc_sw128(vt + off + c * 64 * 128, 1024);
          const uint64_t vl = desc_sw128(vt_lo + off + c * 64 * 128, 1024);
          wgmma_tf32_rs(o[c], ph, vh, 1);
          wgmma_tf32_rs(o[c], ph, vl, 1);
          wgmma_tf32_rs(o[c], pl, vh, 1);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float x0 = s[8 * kk + 2 * f], x1 = s[8 * kk + 2 * f + 1];
          ph[f] = pack_bf16(x0, x1);
          const __nv_bfloat162 h =
              *reinterpret_cast<const __nv_bfloat162*>(&ph[f]);
          pl[f] = pack_bf16(x0 - __bfloat162float(h.x),
                            x1 - __bfloat162float(h.y));
        }
#pragma unroll
        for (int c = 0; c < C::NC; ++c) {
          const uint64_t vd = desc_sw128(vt + 32 * kk + c * 64 * 128, 1024);
          wgmma_bf16_rs(o[c], ph, vd, 1);
          wgmma_bf16_rs(o[c], pl, vd, 1);
        }
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
  T* ob = out + ((size_t)bh * sq + q0) * d + dv0;
  if (cs == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live[h]) continue;
      const float inv = 1.f / fmaxf(lsum[h], 1e-30f);
      T* orow = ob + (size_t)(rloc + 8 * h) * d;
#pragma unroll
      for (int c = 0; c < C::NC; ++c)
#pragma unroll
        for (int jj = 0; jj < C::CW / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c * 64 + 8 * jj + 2 * t4 + e;
            if (dv0 + col < d)
              orow[col] = from_f32<T>(o[c][4 * jj + 2 * h + e] * inv);
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
  if (tid < rows) {  // each row's common max, its blocks' factors, 1 / l
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
    row_inv[tid] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  // 4 columns a thread at a time, every block's loads of a round issued
  // before any is used (a remote load costs hundreds of cycles)
  constexpr int U = 8;
  const int per = rows * (DV / 4);
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
      if (dv0 + col + 3 < d) {  // d's rows are 16-byte aligned: vector
        if constexpr (C::F32) {
          *reinterpret_cast<float4*>(orow) =
              make_float4(v4[0], v4[1], v4[2], v4[3]);
        } else {
          *reinterpret_cast<uint2*>(orow) =
              make_uint2(pack_bf16(v4[0], v4[1]), pack_bf16(v4[2], v4[3]));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (dv0 + col + e < d) orow[e] = from_f32<T>(v4[e]);
      }
    }
  }
  cluster.sync();  // no block leaves while another may read its partials
}

template <typename T, int DV>
int launch(const T* q, const T* k, const T* v, T* out, int bh, int sq,
           int sk, int d, int causal, float scale, int cs,
           cudaStream_t stream) {
  using C = Cfg<T, DV>;
  auto kernel = mha_kernel<T, DV>;
  const int dev = current_device();
  static std::atomic<unsigned long long> smem_set{0};  // per device
  const cudaError_t attr = allow_dynamic_smem(kernel, C::SMEM, smem_set, dev);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mk = {}, mv = {};
  if (!tma_map_3d(&mk, k, Op<T>::kTma, sizeof(T), bh, sk, d, BKV,
                  Op<T>::EPA) ||
      !tma_map_3d(&mv, v, Op<T>::kTma, sizeof(T), bh, sk, d, BKV,
                  Op<T>::EPA))
    return (int)cudaErrorInvalidValue;
  const long long qtiles = (sq + BM - 1) / BM, slabs = (d + DV - 1) / DV;
  const long long units = (long long)bh * qtiles * slabs;
  const long long kv_max = causal ? (sk < qtiles * BM ? sk : qtiles * BM)
                                  : sk;
  const long long tiles = (kv_max + BKV - 1) / BKV;
  // the caller's cluster splits the keys: 1, 2, 4 or 8 blocks, at most
  // one a key tile
  if ((cs != 1 && cs != 2 && cs != 4 && cs != MAX_CLUSTER) || cs > tiles ||
      units * cs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, q, out, mk, mv, sq,
                                             sk, d, (int)slabs, causal,
                                             scale);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int sk, int d, int causal, float scale, int cs,
             cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (d <= 16)
    return launch<T, 16>(qt, kt, vt, ot, bh, sq, sk, d, causal, scale,
                         cs, s);
  if (d <= 32)
    return launch<T, 32>(qt, kt, vt, ot, bh, sq, sk, d, causal, scale,
                         cs, s);
  if (d <= 64)
    return launch<T, 64>(qt, kt, vt, ot, bh, sq, sk, d, causal, scale,
                         cs, s);
  return launch<T, 128>(qt, kt, vt, ot, bh, sq, sk, d, causal, scale,
                        cs, s);
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), out (bh, sq, d), contiguous, of one
// dtype (0 = float32, 1 = bfloat16), 16-byte aligned with a row pitch of
// a multiple of 16 bytes (d % 4 == 0 for fp32, d % 8 == 0 for bf16; pad
// with zeros); scale is the true head dimension's ^-0.5 as the caller
// rounds it; cs the key-split cluster, the caller's (kernels/mha.py
// pick_cluster): 1, 2, 4 or 8, at most the key tiles.  Returns
// cudaErrorInvalidValue for a cluster with no instance, else the launch's
// cudaError_t.
extern "C" int mha_launch(const void* q, const void* k, const void* v,
                          void* out, int bh, int sq, int sk, int d,
                          int causal, float scale, int dtype, int cs,
                          void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int el = dtype == 0 ? 4 : 2;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out);
  if ((bits & 15) != 0 || (d * el) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, bh, sq, sk, d, causal, scale, cs, s);
  return dispatch<__nv_bfloat16>(q, k, v, out, bh, sq, sk, d, causal, scale,
                                 cs, s);
}
