// Fused depthwise-separable conv block on Hopper (sm_90a): depthwise 3x3
// -> pointwise 1x1 (a GEMM over channels) -> LayerNorm over F -> gamma /
// beta -> ReLU, with the depthwise plane and the pointwise accumulator
// never in device memory.
//
// Replaces: repro/kernels/dwconv_block.py::dwconv_block (_dwconv_kernel),
// the paper's depthwise-separable block (Sec. V-C, Fig. 9): x pre-padded
// (B, H+2, W+2, C), dw (3, 3, C), pw (C, F), gamma and beta (F,), out
// (B, H, W, F) in x's dtype; LayerNorm as the reference's, mean over F,
// var = mean((acc - mu)^2), (acc - mu) * rsqrt(var + eps).
//
// What bounds it: operations.  The paper's block (H = 32, W = 16,
// C = F = 512, batch 1) is 268 MFLOP of pointwise GEMM and 4.7 MFLOP of
// depthwise stencil (4.1 us at 67 TFLOP/s fp32) against 3.2 MB of
// operands and output (0.9 us of HBM time).
//
// Design: a block is one warpgroup and owns a tile of 64 output pixels
// (TH x TW, TW = W to a power of two in 8..32, TH = 64 / TW) and a slab of
// BN output channels (64, or 128 above F = 512).  The pointwise product
// runs on m64n64k8 tf32 wgmmas as 3xTF32 (x = hi + lo, hi the top 19
// bits: hi*hi + hi*lo + lo*hi, as te_gemm.cu), for bf16 x too, because
// the depthwise plane is fp32 in the reference.  C is walked in chunks of
// 32 channels through a two-stage ring: one mbarrier a stage, three TMA
// copies a chunk, issued two chunks ahead (zero past every edge):
//   - pw's (32 x BN) box, split hi / lo as it lands into K-major
//     128-byte-swizzled B tiles (two stages: a chunk's split runs while
//     the chunk before is multiplied);
//   - x's (TH + 2) x (TW + 2) halo of the chunk (a 4-D box; fp32 lands
//     128-byte swizzled) and dw's 9 x 32 taps;
//   - A, the depthwise plane, never goes to shared memory: each thread
//     computes its own m64n8k8 fragments from the halo (fp32, the taps a
//     column at a time) and splits them hi / lo in registers, while the
//     chunk before is multiplied.  The K and M orders are permuted so
//     that a thread's fragments are 8 adjacent channels of 2 vertically
//     adjacent pixels (k-step j, column c of the fragment is channel
//     8 (c % 4) + 2 j + c / 4; accumulator row 16 w + g + 8 h is tile
//     pixel (2 r + h, x) with r, x = (8 w + g) / TW, (8 w + g) % TW): a
//     thread reads 4 x 3 halo positions for its 18 taps in 16-byte loads,
//     a quarter warp two neighbouring positions (disjoint banks), and the
//     B tiles hold the same K permutation.
// Stamps with clock64 (PERF.md) set the design: an earlier one spent a
// third of its time issuing 16-byte cp.async copies of the halo.
// The slabs of one pixel tile form a cluster of up to 8 blocks (F <= 512
// at BN = 64, F <= 1024 at BN = 128); the LayerNorm meets through
// distributed shared memory in the reference's two passes: the slabs'
// partial sums give mu, then their partial sums of (acc - mu)^2 give var;
// then gamma / beta, ReLU and one store.  A wider F takes two passes: each
// block writes its fp32 pre-norm values (into the output itself for fp32,
// into a workspace for bf16) and per-(pixel, slab) partial sums, and
// dwconv_block_kernel_norm, a block per pixel, takes mu from the partial
// sums, var from the row, and normalises (the two-pass pattern of
// te_gemm.cu's row_softmax_kernel).  Any H, W, B: pixels past the image
// are computed and not stored.  TMA wants 16-byte row pitches, so the
// wrapper pads C to a multiple of 16 bytes of x and F to a multiple of 4
// with zeros.  The paper's block is 64 blocks (8 tiles x 8 slabs of 64),
// half a wave: wgmma's M is 64 pixels, and slabs of 32 would need
// clusters of 16, past the portable 8.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int NT = 128;          // one warpgroup
constexpr int TILE = 64;         // pixels a block: one wgmma's M
constexpr int KC = 32;           // channels a chunk: one 128-byte B row
constexpr int MAX_CLUSTER = 8;   // slabs of one tile that meet in DSMEM
constexpr int MAX_HALO = 4 * 34; // halo positions of the widest tile, 2 x 32
constexpr int HALO_BYTES = MAX_HALO * 128;  // one stage of the fp32 halo
constexpr int DW_BYTES = 9 * KC * 4;        // one stage of dw's taps

template <int BN>
struct Smem {
  static constexpr int B_TILE = BN * 128;          // hi or lo, one chunk
  static constexpr int B_STAGE = 2 * B_TILE;       // hi and lo
  static constexpr int RAW = KC * BN * 4;           // one TMA stage of pw
  static constexpr int RAW_OFF = 2 * B_STAGE;
  static constexpr int HALO_OFF = RAW_OFF + 2 * RAW;
  static constexpr int DW_OFF = HALO_OFF + 2 * HALO_BYTES;
  static constexpr int BYTES = 1024 + DW_OFF + 2 * DW_BYTES;
};

__device__ __forceinline__ uint32_t tf32_hi(uint32_t bits) {
  return bits & 0xffffe000u;
}
__device__ __forceinline__ uint32_t tf32_lo(uint32_t bits) {
  return __float_as_uint(__uint_as_float(bits) -
                         __uint_as_float(tf32_hi(bits)));
}

// The halo as TMA lands it: position p (the box's rows, x fastest) holds
// the chunk's 32 channels.  fp32: 128 bytes a position, swizzled by TMA
// (16-byte chunk c at c ^ (p % 8)); bf16: 64 bytes a position, as is.  A
// quarter warp's loads read two neighbouring positions, which fall on
// disjoint banks either way.
template <typename T>
struct Halo;
template <>
struct Halo<float> {
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  // the 8 channels 8 t .. 8 t + 7 of position p
  __device__ __forceinline__ static void load8(uint32_t base, int p, int t,
                                               float (&v)[8]) {
    const uint32_t row = base + p * 128;
    const uint4 a = ld_shared_v4(row + (((2 * t) ^ (p & 7)) << 4));
    const uint4 b = ld_shared_v4(row + (((2 * t + 1) ^ (p & 7)) << 4));
    v[0] = __uint_as_float(a.x);
    v[1] = __uint_as_float(a.y);
    v[2] = __uint_as_float(a.z);
    v[3] = __uint_as_float(a.w);
    v[4] = __uint_as_float(b.x);
    v[5] = __uint_as_float(b.y);
    v[6] = __uint_as_float(b.z);
    v[7] = __uint_as_float(b.w);
  }
};
template <>
struct Halo<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kTma =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_NONE;
  __device__ __forceinline__ static void load8(uint32_t base, int p, int t,
                                               float (&v)[8]) {
    const uint4 a = ld_shared_v4(base + p * 64 + 16 * t);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T>
__device__ __forceinline__ void store_pair(T* out, size_t at, float v0,
                                           float v1, bool both, bool vec) {
  if constexpr (sizeof(T) == 4) {
    if (both && vec) {
      *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
    } else {
      out[at] = v0;
      if (both) out[at + 1] = v1;
    }
  } else {
    if (both && vec) {
      *reinterpret_cast<__nv_bfloat162*>(out + at) =
          __floats2bfloat162_rn(v0, v1);
    } else {
      out[at] = __float2bfloat16(v0);
      if (both) out[at + 1] = __float2bfloat16(v1);
    }
  }
}

// PARTIAL: F wider than a cluster holds; write the pre-norm values to z
// (fp32, (B*H*W, F)) and the per-(pixel, slab) sums to stats
template <typename T, int BN, bool PARTIAL>
__global__ void __launch_bounds__(NT)
dwconv_block_kernel_tile(const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ out,
                         float* __restrict__ z, float* __restrict__ stats,
                         const __grid_constant__ CUtensorMap tmap_x,
                         const __grid_constant__ CUtensorMap tmap_dw,
                         const __grid_constant__ CUtensorMap tmap_pw, int h,
                         int w, int c, int f, int tw, int slabs, float eps) {
  using L = Smem<BN>;
  using H = Halo<T>;
  constexpr int NS = BN / 64;  // m64n64 wgmmas a k-step
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[2];
  __shared__ float part[2][TILE];
  __shared__ float gb[2][BN];  // the slab's gamma and beta
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int slab = blockIdx.x % slabs;
  const int tile = blockIdx.x / slabs;
  const int b = blockIdx.y;
  const int th = TILE / tw;
  const int tiles_x = (w + tw - 1) / tw;
  const int ty0 = (tile / tiles_x) * th, tx0 = (tile % tiles_x) * tw;
  const int f0 = slab * BN;
  const int nq = (c + KC - 1) / KC;
  // one chunk's bytes: pw's box, the halo, dw's taps
  const int halo = (th + 2) * (tw + 2) * KC * (int)sizeof(T);
  const int chunk_bytes = L::RAW + halo + DW_BYTES;

  if (tid == 0) {
    tma_prefetch_map(&tmap_x);
    tma_prefetch_map(&tmap_dw);
    tma_prefetch_map(&tmap_pw);
    mbar_init(smem_u32(&full[0]), 1);
    mbar_init(smem_u32(&full[1]), 1);
    fence_mbar_init();
  }
  for (int i = tid; i < BN; i += NT) {
    gb[0][i] = f0 + i < f ? gamma[f0 + i] : 0.f;
    gb[1][i] = f0 + i < f ? beta[f0 + i] : 0.f;
  }
  __syncthreads();

  // chunk q's three boxes into stage q % 2, one barrier
  auto load = [&](int q) {
    const int st = q & 1;
    const uint32_t bar = smem_u32(&full[st]);
    mbar_expect_tx(bar, chunk_bytes);
    tma_load_2d(base + L::RAW_OFF + st * L::RAW, &tmap_pw, bar, f0, q * KC);
    tma_load_4d(base + L::HALO_OFF + st * HALO_BYTES, &tmap_x, bar, q * KC,
                tx0, ty0, b);
    tma_load_2d(base + L::DW_OFF + st * DW_BYTES, &tmap_dw, bar, q * KC, 0);
  };
  if (tid == 0) {
    load(0);
    if (nq > 1) load(1);
  }

  // this thread's two pixels: (2 rp, x) and (2 rp + 1, x) of the tile
  const int rp = (8 * warp + g) / tw, px = (8 * warp + g) - rp * tw;
  float acc[NS][32];

  for (int q = 0; q < nq; ++q) {
    const int st = q & 1;
    mbar_wait(smem_u32(&full[st]), (q >> 1) & 1);

    // pw's box, (32 channels x BN columns) row-major, into the K-major
    // swizzled hi / lo tiles of stage st: row n, chunk cc holds channels
    // cc, cc + 8, cc + 16, cc + 24 (the K permutation above).  The wgmmas
    // of chunk q - 2 read this stage; they were waited for in chunk q - 1.
    const uint32_t raw = base + L::RAW_OFF + st * L::RAW;
    const uint32_t b_hi = base + st * L::B_STAGE, b_lo = b_hi + L::B_TILE;
#pragma unroll
    for (int i0 = 0; i0 < BN * 8; i0 += NT) {
      const int i = i0 + tid, n = i % BN, cc = i / BN;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = ld_shared_u32(raw + 4 * ((cc + 8 * e) * BN + n));
      const uint32_t at = sw128(n, cc);
      st_shared_v4(b_hi + at, tf32_hi(v[0]), tf32_hi(v[1]), tf32_hi(v[2]),
                   tf32_hi(v[3]));
      st_shared_v4(b_lo + at, tf32_lo(v[0]), tf32_lo(v[1]), tf32_lo(v[2]),
                   tf32_lo(v[3]));
    }
    fence_async_shared();

    // the depthwise 3x3 of this thread's pixels and channels 8 t4 ..
    // 8 t4 + 7, fp32: a column of four halo positions a tap column
    const uint32_t hs = base + L::HALO_OFF + st * HALO_BYTES;
    const uint32_t ds = base + L::DW_OFF + st * DW_BYTES;
    float y[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) y[i][k] = 0.f;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float xv[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        H::load8(hs, (2 * rp + r) * (tw + 2) + px + dx, t4, xv[r]);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint32_t wa = ds + (dy * 3 + dx) * (KC * 4) + 32 * t4;
        const uint4 w0 = ld_shared_v4(wa), w1 = ld_shared_v4(wa + 16);
        const float wv[8] = {
            __uint_as_float(w0.x), __uint_as_float(w0.y),
            __uint_as_float(w0.z), __uint_as_float(w0.w),
            __uint_as_float(w1.x), __uint_as_float(w1.y),
            __uint_as_float(w1.z), __uint_as_float(w1.w)};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int k = 0; k < 8; ++k)
            y[i][k] = fmaf(xv[dy + i][k], wv[k], y[i][k]);
      }
    }
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a[4] = {y[0][2 * j], y[1][2 * j], y[0][2 * j + 1],
                          y[1][2 * j + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[j][e] = tf32_hi(__float_as_uint(a[e]));
        lo[j][e] = tf32_lo(__float_as_uint(a[e]));
      }
    }
    wgmma_wait<0>();  // chunk q - 1's products: its B stage is free
    __syncthreads();  // the B tiles are written; stage st's boxes are read
    if (tid == 0 && q + 2 < nq) load(q + 2);

    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const uint64_t bh = desc_sw128(b_hi + s * 8192 + 32 * j, 1024);
        const uint64_t bl = desc_sw128(b_lo + s * 8192 + 32 * j, 1024);
        wgmma_tf32_rs(acc[s], hi[j], bh, q > 0 || j > 0);
        wgmma_tf32_rs(acc[s], hi[j], bl, 1);
        wgmma_tf32_rs(acc[s], lo[j], bh, 1);
      }
    wgmma_commit();  // waited for behind the next chunk's split and taps
  }
  wgmma_wait<0>();
#pragma unroll
  for (int s = 0; s < NS; ++s) fence_regs(acc[s]);

  // accumulator d[4 jj + 2 i + e] of sub-tile s: tile pixel (2 rp + i,
  // px), column f0 + 64 s + 8 jj + 2 t4 + e
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (f0 + 64 * s + 8 * jj + 2 * t4 + e < f) {
          sum[0] += acc[s][4 * jj + e];
          sum[1] += acc[s][4 * jj + 2 + e];
        }
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
  }
  const int hw = h * w;
  int pix[2];  // global pixel index, -1 past the image
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gy = ty0 + 2 * rp + i, gx = tx0 + px;
    pix[i] = gy < h && gx < w ? gy * w + gx : -1;
  }
  const bool vec = (f & 1) == 0;

  if constexpr (PARTIAL) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (pix[i] < 0) continue;
      const size_t row = (size_t)b * hw + pix[i];
      if (t4 == 0) stats[row * slabs + slab] = sum[i];
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = f0 + 64 * s + 8 * jj + 2 * t4;
          if (col < f)
            store_pair(z, row * f + col, acc[s][4 * jj + 2 * i],
                       acc[s][4 * jj + 2 * i + 1], col + 1 < f, vec);
        }
    }
    return;
  } else {
    // a pixel's partials, indexed by accumulator row 16 warp + g + 8 i;
    // each rank's read in one round (the remote loads overlap)
    cg::cluster_group cl = cg::this_cluster();
    const unsigned ranks = cl.num_blocks();
    const int r0 = 16 * warp + g;
    auto gather = [&](const float* mine, float (&tot)[2]) {
      float v[MAX_CLUSTER][2];
#pragma unroll
      for (unsigned r = 0; r < MAX_CLUSTER; ++r) {
        const float* p = r < ranks ? cl.map_shared_rank(mine, r) : mine;
        v[r][0] = r < ranks ? p[r0] : 0.f;
        v[r][1] = r < ranks ? p[r0 + 8] : 0.f;
      }
      tot[0] = tot[1] = 0.f;
#pragma unroll
      for (unsigned r = 0; r < MAX_CLUSTER; ++r) {
        tot[0] += v[r][0];
        tot[1] += v[r][1];
      }
    };
    if (t4 == 0) {
      part[0][r0] = sum[0];
      part[0][r0 + 8] = sum[1];
    }
    cl.sync();
    float mu[2], sq[2] = {0.f, 0.f}, inv[2];
    gather(&part[0][0], mu);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mu[i] /= (float)f;
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (f0 + 64 * s + 8 * jj + 2 * t4 + e < f) {
              const float d = acc[s][4 * jj + 2 * i + e] - mu[i];
              sq[i] += d * d;
            }
      sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 1);
      sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 2);
    }
    if (t4 == 0) {
      part[1][r0] = sq[0];
      part[1][r0 + 8] = sq[1];
    }
    cl.sync();
    gather(&part[1][0], inv);
    cluster_arrive();  // this block has read every partial it needs
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      inv[i] = rsqrtf(inv[i] / (float)f + eps);
      if (pix[i] < 0) continue;
      const size_t row = (size_t)b * hw + pix[i];
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int cl0 = 64 * s + 8 * jj + 2 * t4;  // column in the slab
          if (f0 + cl0 >= f) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float zn = (acc[s][4 * jj + 2 * i + e] - mu[i]) * inv[i] *
                                 gb[0][cl0 + e] + gb[1][cl0 + e];
            v[e] = fmaxf(zn, 0.f);
          }
          store_pair(out, row * f + f0 + cl0, v[0], v[1], f0 + cl0 + 1 < f,
                     vec);
        }
    }
    // no block leaves while another may read its partials
    cluster_wait();
  }
}

// The second pass of an F wider than a cluster holds, a block per pixel
// row: mu from the slabs' partial sums, var = mean((z - mu)^2) over the
// row, then gamma / beta and ReLU into out (which may be z itself).
template <typename T>
__global__ void __launch_bounds__(256)
dwconv_block_kernel_norm(const float* z, const float* __restrict__ stats,
                         int slabs, const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* out, int f,
                         float eps) {
  __shared__ float red[8];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* zr = z + row * f;
  auto block_sum = [&](float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    __syncthreads();  // red is free (an earlier sum has been read)
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i];
    return t;
  };
  float s = 0.f;
  for (int i = tid; i < slabs; i += 256) s += stats[row * slabs + i];
  const float mu = block_sum(s) / (float)f;
  float sq = 0.f;
  for (int col = tid; col < f; col += 256) {
    const float d = zr[col] - mu;
    sq += d * d;
  }
  const float inv = rsqrtf(block_sum(sq) / (float)f + eps);
  T* orow = out + row * f;
  for (int col = tid; col < f; col += 256) {
    const float v =
        fmaxf((zr[col] - mu) * inv * __ldg(gamma + col) + __ldg(beta + col),
              0.f);
    if constexpr (sizeof(T) == 4) {
      orow[col] = v;
    } else {
      orow[col] = __float2bfloat16(v);
    }
  }
}

// x's halo boxes: (C, W + 2, H + 2, B) read 32 channels x (tw + 2) x
// (th + 2) at a time, zero past every edge
template <typename T>
bool halo_map(CUtensorMap* map, const T* x, int b, int h, int w, int c,
              int tw) {
  const TmaEncode encode = tma_encoder();
  if (encode == nullptr) return false;
  const uint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w + 2,
                              (cuuint64_t)h + 2, (cuuint64_t)b};
  const cuuint64_t strides[3] = {c * e, (w + 2) * c * e,
                                 (h + 2) * (uint64_t)(w + 2) * c * e};
  const cuuint32_t box[4] = {KC, (cuuint32_t)tw + 2,
                             (cuuint32_t)(TILE / tw) + 2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, Halo<T>::kTma, 4, const_cast<T*>(x), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, Halo<T>::kSwizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BN, bool PARTIAL>
int launch_tiles(const T* x, const float* dw, const float* pw, int ldp,
                 const float* gamma, const float* beta, T* out, float* z,
                 float* stats, int b, int h, int w, int c, int f, int tw,
                 int slabs, float eps, cudaStream_t stream) {
  using L = Smem<BN>;
  auto kernel = dwconv_block_kernel_tile<T, BN, PARTIAL>;
  const int dev = current_device();
  static std::atomic<unsigned long long> smem_set{0};  // per device
  const cudaError_t attr =
      allow_dynamic_smem(kernel, L::BYTES, smem_set, dev);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tmap_x = {}, tmap_dw = {}, tmap_pw = {};
  if (!halo_map(&tmap_x, x, b, h, w, c, tw) ||
      !tma_map_2d(&tmap_dw, dw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 9, c, 9,
                  KC, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tma_map_2d(&tmap_pw, pw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, c, ldp,
                  KC, BN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const int th = TILE / tw;
  const long long tiles =
      (long long)((h + th - 1) / th) * ((w + tw - 1) / tw);
  if (b > 65535 || tiles * slabs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * slabs), b);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = PARTIAL ? 1 : slabs;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, gamma, beta, out, z, stats, tmap_x,
                         tmap_dw, tmap_pw, h, w, c, f, tw, slabs, eps);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int dispatch(const void* xv, const float* dw, const float* pw, int ldp,
             const float* gamma, const float* beta, void* outv, float* z,
             float* stats, int b, int h, int w, int c, int f, float eps,
             cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  int tw = 8;  // the image width to a power of two, 8..32
  while (tw < w && tw < TILE / 2) tw *= 2;
  if (f <= 64 * MAX_CLUSTER)
    return launch_tiles<T, 64, false>(x, dw, pw, ldp, gamma, beta, out,
                                      nullptr, nullptr, b, h, w, c, f, tw,
                                      (f + 63) / 64, eps, s);
  if (f <= 128 * MAX_CLUSTER)
    return launch_tiles<T, 128, false>(x, dw, pw, ldp, gamma, beta, out,
                                       nullptr, nullptr, b, h, w, c, f, tw,
                                       (f + 127) / 128, eps, s);
  // two passes: fp32 pre-norm values in the output (fp32) or in z
  const int slabs = (f + 127) / 128;
  float* pre = sizeof(T) == 4 ? reinterpret_cast<float*>(out) : z;
  if (pre == nullptr || stats == nullptr) return (int)cudaErrorInvalidValue;
  const int err = launch_tiles<T, 128, true>(x, dw, pw, ldp, gamma, beta,
                                             out, pre, stats, b, h, w, c, f,
                                             tw, slabs, eps, s);
  if (err != 0) return err;
  dwconv_block_kernel_norm<T><<<b * h * w, 256, 0, s>>>(
      pre, stats, slabs, gamma, beta, out, f, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x (b, h+2, w+2, c) pre-padded, contiguous, 16-byte aligned, c a
// multiple of 16 bytes of x (dtype 0 = float32, 1 = bfloat16); dw (3, 3, c)
// fp32; pw (c, ldp) fp32, ldp >= f a multiple of 4, columns past f zero;
// gamma and beta (f,) fp32; out (b, h, w, f) in x's dtype.  Above
// f = 1024 the two-pass route needs stats, room for b*h*w*ceil(f / 128)
// floats, and, for bf16, z, a (b*h*w, f) fp32 buffer.  Returns the first
// failing launch's cudaError_t.
extern "C" int dwconv_block_launch(const void* x, const void* dw,
                                   const void* pw, int ldp,
                                   const void* gamma, const void* beta,
                                   void* out, void* z, void* stats, int b,
                                   int h, int w, int c, int f, float eps,
                                   int dtype, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || f <= 0 || ldp < f ||
      ldp % 4 != 0 || c % (dtype == 0 ? 4 : 8) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* d = static_cast<const float*>(dw);
  const float* p = static_cast<const float*>(pw);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* zz = static_cast<float*>(z);
  float* st = static_cast<float*>(stats);
  if (dtype == 0)
    return dispatch<float>(x, d, p, ldp, g, be, out, zz, st, b, h, w, c, f,
                           eps, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, d, p, ldp, g, be, out, zz, st, b, h, w,
                                   c, f, eps, s);
  return (int)cudaErrorInvalidValue;
}
