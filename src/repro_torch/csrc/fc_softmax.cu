// Fused FC + row softmax on Hopper (sm_90a): out = softmax(X @ W + b).
//
// Replaces: repro/kernels/fc_softmax.py::fc_softmax (_fc_softmax_kernel),
// the paper's FC block (Sec. V-C, Fig. 9): (M, K) @ (K, N) accumulated in
// fp32, + b, then a softmax over the whole output row (z - max, exp,
// p / sum) before the tile leaves the chip, stored in X's dtype.
//
// What bounds it: operations.  The paper's 512 x 512 x 512 block is 268
// MFLOP (4.0 us at the card's 67 TFLOP/s fp32 outside the tensor cores)
// against 3.1 MB of fp32 operands and output (0.9 us of HBM time).
//
// Design: the row softmax needs the whole row, so each row is split over
// the blocks of a thread-block cluster: a block owns BN = 64 columns, a
// cluster of ceil(N / 64) <= 8 blocks owns the row, and the blocks meet
// through distributed shared memory in one exchange: each block
// publishes its slab's row max m_b and sum of exp(z - m_b), and after one
// cluster.sync reads every block's pair at once (cluster.map_shared_rank)
// for the row's max M and sum S = sum_b s_b exp(m_b - M); each block
// stores exp(z - M) / S once, between the two halves of the last cluster
// barrier.  N above 512 is refused here; the wrapper sends such a row
// to te_gemm.cu's two-pass softmax.
//
// fp32 keeps IEEE products on the FMA units (the reference accumulates in
// full fp32; TF32 would not hold rtol 1e-4).  A cluster owns 32 rows, so
// the paper's 512^3 block runs 16 clusters of 8 = 128 blocks.  A block
// is 4 groups of 64 threads; K streams in stages of 32 through a ring of
// 3 cp.async stages (16-byte copies where K and N are multiples of 4,
// 4-byte ones otherwise, zero-filled past M, N and K), and each group
// sums its quarter of every stage into a 4 x 8 register micro-tile (one
// 16-byte shared load of X per row feeds 4 k, two of W feed 8 columns:
// 32 FMAs per 3 loads).  The four partial tiles meet in shared memory.
// Every block reads its cluster's X rows from L2 itself.
//
// bf16 runs on the tensor cores: one warpgroup per block, 64 rows, and
// m64n64k16 wgmmas with fp32 accumulators.  X is K-major; W, (K, N)
// row-major, is read as stored through the descriptor's transpose bit.
// Both stream through a 5-stage ring of 128-byte-swizzled tiles, three
// loading while one is multiplied and the wgmmas of the one before
// finish: two TMA copies per stage, issued by one thread behind the
// stage's wgmmas and completed on an mbarrier, where both row pitches
// are multiples of 16 bytes
// (K % 8 == 0 and N % 8 == 0); cp.async 16-byte copies or plain loads
// per operand otherwise.  The softmax runs on the accumulator fragments,
// a row's 16 values a thread meeting within a quad of lanes.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int BN = 64;          // columns per block
constexpr int MAX_CLUSTER = 8;  // blocks per cluster: N <= 512

// Row r's max and softmax denominator over every block of the cluster,
// after a cluster.sync: each block's (pmax[r], psum[r]) is its slab's max
// and sum of exp(z - max).  The remote loads are issued together.
__device__ __forceinline__ void cluster_row_stats(cg::cluster_group& cluster,
                                                  float* pmax, float* psum,
                                                  int r, float& mx,
                                                  float& sum) {
  const unsigned nb = cluster.num_blocks();
  float m[MAX_CLUSTER], s[MAX_CLUSTER];
#pragma unroll
  for (unsigned q = 0; q < MAX_CLUSTER; ++q) {
    m[q] = -CUDART_INF_F;
    s[q] = 0.f;
    if (q < nb) {
      m[q] = cluster.map_shared_rank(pmax, q)[r];
      s[q] = cluster.map_shared_rank(psum, q)[r];
    }
  }
  mx = -CUDART_INF_F;
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q) mx = fmaxf(mx, m[q]);
  sum = 0.f;
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    if (q < (int)nb) sum += s[q] * expf(m[q] - mx);
}

// ---------------------------------------------------------------------------
// fp32: SIMT FMA
// ---------------------------------------------------------------------------

constexpr int F_BM = 32;              // rows per cluster
constexpr int F_BK = 32;              // K per stage
constexpr int F_GROUPS = 4;           // each sums a quarter of every stage
constexpr int F_NT = 64 * F_GROUPS;
constexpr int F_STAGES = 3;
constexpr int F_XP = F_BK + 4;        // X row pitch in floats (no conflicts)
constexpr int F_XS = F_BM * F_XP;     // floats per X stage
constexpr int F_STAGE = F_XS + F_BK * BN;
constexpr int F_SMEM = F_STAGES * F_STAGE * 4;  // bytes of the ring
static_assert(F_STAGES * F_STAGE >= F_GROUPS * F_BM * BN,
              "the partial tiles reuse the ring");
static_assert(F_BM * F_BK / 4 == F_NT && F_BK * BN / 4 == 2 * F_NT,
              "one X and two W 16-byte chunks a thread per stage");

__device__ __forceinline__ void f32_load(float* stage,
                                         const float* __restrict__ x,
                                         const float* __restrict__ w,
                                         int m0, int n0, int k0, int m,
                                         int n, int k, int vec, int tid) {
  float* xs = stage;
  float* ws = stage + F_XS;
  if (vec) {  // one 16-byte X chunk and two W chunks a thread
    {
      const int r = tid >> 3, c = 4 * (tid & 7);
      const int gr = m0 + r, gk = k0 + c;
      const bool ok = gr < m && gk < k;
      cp_async16(smem_u32(xs + r * F_XP + c),
                 ok ? x + (size_t)gr * k + gk : x, ok ? 16 : 0);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = (tid >> 4) + 16 * u, c = 4 * (tid & 15);
      const int gk = k0 + r, gc = n0 + c;
      const bool ok = gk < k && gc < n;
      cp_async16(smem_u32(ws + r * BN + c),
                 ok ? w + (size_t)gk * n + gc : w, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < F_BM * F_BK; i += F_NT) {
      const int r = i / F_BK, c = i % F_BK;
      const int gr = m0 + r, gk = k0 + c;
      const bool ok = gr < m && gk < k;
      cp_async4(smem_u32(xs + r * F_XP + c),
                ok ? x + (size_t)gr * k + gk : x, ok ? 4 : 0);
    }
    for (int i = tid; i < F_BK * BN; i += F_NT) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gc = n0 + c;
      const bool ok = gk < k && gc < n;
      cp_async4(smem_u32(ws + r * BN + c),
                ok ? w + (size_t)gk * n + gc : w, ok ? 4 : 0);
    }
  }
}

__global__ void __launch_bounds__(F_NT)
fc_softmax_kernel_fp32(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int m, int n, int k,
                       int vec) {
  extern __shared__ __align__(16) float ring[];  // F_STAGES stages
  __shared__ float pmax[F_BM], psum[F_BM];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int n0 = cluster.block_rank() * BN;
  const int m0 = (blockIdx.x / cluster.num_blocks()) * F_BM;

  // compute layout: group g sums k in [8 g, 8 g + 8) of each stage;
  // thread (ty, tx) of the group owns rows ty + 8 i and columns
  // 4 tx + {0..3}, 32 + 4 tx + {0..3}
  const int g = tid / 64, lt = tid % 64, ty = lt / 8, tx = lt % 8;
  // epilogue layout: thread (r, c) owns row r, columns 4 c + {0..3} and
  // 32 + 4 c + {0..3}; the row's 8 threads are 8 consecutive lanes
  const int r = tid / 8, c = tid % 8;
  auto ecol = [&](int j) { return (j < 4 ? 0 : 32) + 4 * c + (j & 3); };
  float bv[8];  // its columns' bias (-inf past N), read now
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + ecol(j);
    bv[j] = col < n ? (bias != nullptr ? bias[col] : 0.f) : -CUDART_INF_F;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int slices = (k + F_BK - 1) / F_BK;
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < slices)
      f32_load(ring + s * F_STAGE, x, w, m0, n0, s * F_BK, m, n, k, vec, tid);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();
    if (s + F_STAGES - 1 < slices)
      f32_load(ring + (s + F_STAGES - 1) % F_STAGES * F_STAGE, x, w, m0, n0,
               (s + F_STAGES - 1) * F_BK, m, n, k, vec, tid);
    cp_async_commit();
    const float* xs = ring + s % F_STAGES * F_STAGE;
    const float* ws = xs + F_XS;
#pragma unroll
    for (int kq = 0; kq < 2; ++kq) {
      const int kk = 8 * g + 4 * kq;
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + (ty + 8 * i) * F_XP + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(ws + (kk + t) * BN + 4 * tx);
        const float4 b1 =
            *reinterpret_cast<const float4*>(ws + (kk + t) * BN + 32 + 4 * tx);
        const float wv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = t == 0 ? a[i].x : t == 1 ? a[i].y
                         : t == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += av * wv[j];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the four groups' partial tiles meet in shared memory (the ring)
  float* part = ring;  // [group][row][col]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* p = part + (g * F_BM + ty + 8 * i) * BN + 4 * tx;
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(p + 32) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();

  float z[8];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < F_GROUPS; ++q)
      v += part[(q * F_BM + r) * BN + ecol(j)];
    z[j] = v + bv[j];  // -inf past N
    mx = fmaxf(mx, z[j]);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += expf(z[j] - mx);  // exp(-inf) = 0 past N
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (c == 0) {
    pmax[r] = mx;
    psum[r] = sum;
  }
  cluster.sync();
  cluster_row_stats(cluster, pmax, psum, r, mx, sum);
  cluster_arrive();  // this block has read every partial it needs

  const int row = m0 + r;
  if (row < m) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + ecol(j);
      if (col < n) out[(size_t)row * n + col] = expf(z[j] - mx) / sum;
    }
  }
  cluster_wait();  // no block leaves while another may read its partials
}

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

constexpr int B_BM = 64;                  // rows per cluster: one wgmma's M
constexpr int B_BK = 64;                  // K per stage: 128-byte rows
constexpr int B_STAGES = 5;
constexpr int B_AHEAD = B_STAGES - 2;     // stages loading while one computes
                                          // and the one before may be read
constexpr int B_TILE = 64 * 128;          // bytes of one operand tile
constexpr int B_SMEM = 1024 + B_STAGES * 2 * B_TILE;

// 8 bf16 from global into the 16-byte chunk at dst: an async copy when
// the row is 16-byte aligned, else plain loads; zero past `valid`
__device__ __forceinline__ void bf16_chunk(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           const __nv_bfloat16* base,
                                           int valid, bool vec) {
  if (vec) {
    cp_async16(dst, valid > 0 ? src : base, 2 * valid);
  } else {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(src);
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < valid) v[e >> 1] |= (uint32_t)p[e] << (16 * (e & 1));
    st_shared_v4(dst, v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void bf16_load(uint32_t a_tile, uint32_t b_tile,
                                          const __nv_bfloat16* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ w,
                                          int m0, int n0, int k0, int m,
                                          int n, int k, bool vec_x,
                                          bool vec_w, int tid) {
  for (int i = tid; i < 64 * 8; i += 128) {
    const int r = i >> 3, c = i & 7;
    // X rows m0 + r, K columns k0 + 8 c: K-major
    const int gr = m0 + r, gk = k0 + 8 * c;
    bf16_chunk(a_tile + sw128(r, c), x + (size_t)gr * k + gk, x,
               gr < m ? min(max(k - gk, 0), 8) : 0, vec_x);
    // W row k0 + r, columns n0 + 8 c: N-major
    const int wk = k0 + r, gc = n0 + 8 * c;
    bf16_chunk(b_tile + sw128(r, c), w + (size_t)wk * n + gc, w,
               wk < k ? min(max(n - gc, 0), 8) : 0, vec_w);
  }
}

__global__ void __launch_bounds__(128)
fc_softmax_kernel_bf16(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int m, int n, int k,
                       const __grid_constant__ CUtensorMap tmap_x,
                       const __grid_constant__ CUtensorMap tmap_w, int tma,
                       int vec_x, int vec_w) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float pmax[B_BM], psum[B_BM];
  __shared__ __align__(8) uint64_t full[B_STAGES];  // TMA: a stage landed
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = cluster.block_rank() * BN;
  const int m0 = (blockIdx.x / cluster.num_blocks()) * B_BM;

  // acc[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h, column
  // 8 j + 2 (lane % 4) + e of the block's 64
  const int rloc = 16 * warp + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  float bv[16];  // the thread's columns' bias (-inf past N), read now
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = col0 + 8 * (i >> 1) + (i & 1);
    bv[i] = col < n ? (bias != nullptr ? bias[col] : 0.f) : -CUDART_INF_F;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  const int slices = (k + B_BK - 1) / B_BK;
  auto tile = [&](int s) { return ring + (s % B_STAGES) * 2 * B_TILE; };
  if (tma && tid == 0) {
    tma_prefetch_map(&tmap_x);
    tma_prefetch_map(&tmap_w);
    for (int s = 0; s < B_STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    fence_mbar_init();
  }
  __syncthreads();
  auto load = [&](int s) {  // stage s, or nothing past K
    if (s < slices && !tma) {
      bf16_load(tile(s), tile(s) + B_TILE, x, w, m0, n0, s * B_BK, m, n, k,
                vec_x, vec_w, tid);
    } else if (s < slices && tid == 0) {
      const uint32_t bar = smem_u32(&full[s % B_STAGES]);
      mbar_expect_tx(bar, 2 * B_TILE);
      tma_load_2d(tile(s), &tmap_x, bar, s * B_BK, m0);
      tma_load_2d(tile(s) + B_TILE, &tmap_w, bar, n0, s * B_BK);
    }
    cp_async_commit();
  };
  for (int s = 0; s < B_AHEAD; ++s) load(s);
  for (int s = 0; s < slices; ++s) {
    if (tma) {
      mbar_wait(smem_u32(&full[s % B_STAGES]), (s / B_STAGES) & 1);
    } else {
      cp_async_wait<B_AHEAD - 1>();
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t a0 = tile(s), b0 = tile(s) + B_TILE;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < B_BK / 16; ++j)
      wgmma_bf16_nmajor_b(acc, desc_sw128(a0 + 32 * j, 1024),
                          desc_sw128(b0 + 16 * 128 * j, 1024), 1);
    wgmma_commit();
    // issued behind the wgmmas, into stage s - 2's slot: its wgmmas are done
    load(s + B_AHEAD);
    wgmma_wait<1>();  // stage s's wgmmas run on while stage s + 1 starts
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();

  float mx[2], sum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = acc[4 * j + 2 * h + e];
        v = v + bv[2 * j + e];  // -inf past N
        mx[h] = fmaxf(mx[h], v);
      }
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    sum[h] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i)  // exp(-inf) = 0 past N
      sum[h] += expf(acc[4 * (i >> 1) + 2 * h + (i & 1)] - mx[h]);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    if ((lane & 3) == 0) {
      pmax[rloc + 8 * h] = mx[h];
      psum[rloc + 8 * h] = sum[h];
    }
  }
  cluster.sync();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    cluster_row_stats(cluster, pmax, psum, rloc + 8 * h, mx[h], sum[h]);
  cluster_arrive();  // this block has read every partial it needs

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + rloc + 8 * h;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + 8 * j;
      const float v0 = expf(acc[4 * j + 2 * h] - mx[h]) / sum[h];
      const float v1 = expf(acc[4 * j + 2 * h + 1] - mx[h]) / sum[h];
      const size_t at = (size_t)row * n + col;
      if (col + 1 < n && (n & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < n) out[at] = __float2bfloat16(v0);
        if (col + 1 < n) out[at + 1] = __float2bfloat16(v1);
      }
    }
  }
  cluster_wait();  // no block leaves while another may read its partials
}

// one cluster of `cluster` blocks per `rows_per` rows
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int cluster, int rows_per,
                   int m, int threads, int smem, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((m + rows_per - 1) / rows_per));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x (m, k), w (k, n), out (m, n), row-major and of one dtype: dtype 0 =
// float32, 1 = bfloat16; bias (n,) fp32 or null; n <= 512.  Returns the
// launch's cudaError_t.
extern "C" int fc_softmax_launch(const void* x, const void* w,
                                 const void* bias, void* out, int m, int n,
                                 int k, int dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n > BN * MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* b = static_cast<const float*>(bias);
  const int cluster = (n + BN - 1) / BN;
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int dev = current_device();
  if (dtype == 0) {
    static std::atomic<unsigned long long> smem_set{0};  // per device
    const cudaError_t attr =
        allow_dynamic_smem(fc_softmax_kernel_fp32, F_SMEM, smem_set, dev);
    if (attr != cudaSuccess) return (int)attr;
    const int vec = k % 4 == 0 && n % 4 == 0 && aligned(x) && aligned(w);
    return launch_cluster(fc_softmax_kernel_fp32, cluster, F_BM, m, F_NT,
                          F_SMEM, s, static_cast<const float*>(x),
                          static_cast<const float*>(w), b,
                          static_cast<float*>(out), m, n, k, vec);
  }
  if (dtype == 1) {
    static std::atomic<unsigned long long> smem_set{0};  // per device
    const cudaError_t attr =
        allow_dynamic_smem(fc_softmax_kernel_bf16, B_SMEM, smem_set, dev);
    if (attr != cudaSuccess) return (int)attr;
    // 16-byte rows: TMA for both operands, or per operand cp.async
    const int vec_x = k % 8 == 0 && aligned(x);
    const int vec_w = n % 8 == 0 && aligned(w);
    CUtensorMap tmap_x = {}, tmap_w = {};
    const int tma = vec_x && vec_w;
    if (tma && !(tma_map_2d(&tmap_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            m, k, B_BM, B_BK) &&
                 tma_map_2d(&tmap_w, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            k, n, B_BK, BN)))
      return (int)cudaErrorInvalidValue;
    return launch_cluster(fc_softmax_kernel_bf16, cluster, B_BM, m, 128,
                          B_SMEM, s, static_cast<const __nv_bfloat16*>(x),
                          static_cast<const __nv_bfloat16*>(w), b,
                          static_cast<__nv_bfloat16*>(out), m, n, k, tmap_x,
                          tmap_w, tma, vec_x, vec_w);
  }
  return (int)cudaErrorInvalidValue;
}
