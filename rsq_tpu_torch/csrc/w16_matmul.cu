// Dense bf16 matmul against one layer of stacked (L, K, N) weights.
//
// Replaces: rsq_tpu/kernels/matmul_w4.py w16_matmul_stacked (:822), Pallas
//   body _w16_kernel_pref (:802).
// Computes: y = x @ w_all[layer] for bf16 x (M, K) and bf16 weights read in
//   place at the layer's offset (no copy), products exact in f32, sums in
//   f32, one rounding to the output type (bf16 or f32).
// Bound on this card: at decode (M = 8) the weight bytes -- 2*K*N per call,
//   436 MB for one Llama-3-8B layer's seven products, 0.13 ms at 3.35 TB/s.
//   At prefill (M = 128..4096) the bf16 tensor-core operations, 2*M*K*N.
// Design: two kernels, one launch per call, no workspace and no float
//   atomics, so every run gives the same bits.
//   - M <= 16, w16_stream, a weight stream.  The operands are swapped: 16
//     weight columns are the m side of mma.sync.m16n8k16 (bf16 in, f32
//     sums) and the <= 16 activation rows its n side, so no tensor-core
//     work goes to padding rows.  The (K, N) weights stay in their layout
//     and pass once through a 4-stage cp.async ring of 64-row x 128-column
//     tiles (smem_ring.cuh), whose 16-byte chunks are XOR-swizzled by the
//     row's low 3 bits; ldmatrix.trans reads them as the transposed A
//     operand without bank conflicts.  x rides in the same ring.  Where the
//     column tiles cannot fill the 132 SMs (about one block an SM), K is
//     split over a cluster of up to 8 blocks: each leaves its f32 partial
//     tile in its idle ring, and after a cluster barrier every block sums a
//     slice of the tile over all of them in rank order through distributed
//     shared memory.
//     (wgmma needs 64 rows of A in shared memory: at M <= 16 that is the
//     weights as MN-major A with x^T as B, one 64 x 8 x 16 product per
//     16-k step per 64 columns, against the same bytes through mma.sync;
//     the stream is bound by bytes either way, and mma.sync keeps the
//     fragments in registers with no descriptor or warpgroup barrier.)
//   - M > 16, w16_tma: wgmma on tiles brought by the Tensor Memory
//     Accelerator.  128 x 128 output tiles, rastered in groups of 8 row
//     tiles (row tile fastest) for reuse in the L2, 64-deep K steps, a
//     5-stage ring of mbarrier pairs: one producer thread issues the TMA
//     loads (x through a 2-D tensor map made per call, the weights through
//     one 3-D map over (L, K, N) per stacked weight, the layer a
//     coordinate), and two consumer warpgroups each run wgmma.m64n128k16
//     on 64 rows of the tile, one k step's group left in flight.  x tiles
//     are K-major and the weights MN-major (the wgmma transpose bit for
//     B), both with the 128-byte swizzle that the tensor maps write and the
//     matrix descriptors read.  TMA zero-fills the ragged M, N and K edges;
//     the epilogue guards its stores.  Where the tiles leave SMs idle (k|v
//     at M = 1024 is 64 tiles), K is split over a cluster as above: the
//     consumers leave the f32 tile in the idle ring.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "hopper_tma.cuh"
#include "smem_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;
using namespace smem_ring;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// M <= 16: the weight stream
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;        // 4 warps, 32 columns each
constexpr int NT = 128;             // weight columns per block
constexpr int KS = 64;              // k rows per pipeline stage
constexpr int ST = 4;               // pipeline stages
constexpr int WROW = NT * 2;        // bytes per staged weight row
constexpr int XP = KS * 2 + 16;     // x row pitch in bytes (conflict-free)
constexpr int MAXSPLIT = 8;         // a portable cluster

// Byte offset of 16-byte chunk c of row r in a weight tile
__device__ __forceinline__ int wswz(int r, int c) {
  return r * WROW + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const uint8_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s) : "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MT tiles of 8 activation rows.  grid (ceil(N/NT), ceil(M/8MT), nsplit)
// in clusters of (1, 1, nsplit); block z sums k in [z*kchunk,
// min(K, (z+1)*kchunk)), kchunk a multiple of KS.
template <int MT, typename TOut>
__global__ void __launch_bounds__(THREADS)
w16_stream(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ w, TOut* __restrict__ y, int M,
           int K, int N, int kchunk) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ws = smem;                               // ST x KS x WROW
  uint8_t* xs = smem + ST * KS * WROW;              // ST x 8MT x XP
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * NT, m0 = blockIdx.y * 8 * MT;
  const int nsplit = gridDim.z;
  const int k0 = blockIdx.z * kchunk, k1 = min(K, k0 + kchunk);
  const int nst = (k1 - k0 + KS - 1) / KS;

  // stage st into ring slot `slot`; N % 8 == 0 and K % 8 == 0, so every
  // 16-byte chunk lies wholly inside or wholly outside (zero-filled)
  auto load = [&](int st, int slot) {
    uint8_t* wd = ws + slot * KS * WROW;
    for (int c = tid; c < KS * (NT / 8); c += THREADS) {
      const int r = c / (NT / 8), ch = c % (NT / 8);
      const int k = k0 + st * KS + r, n = n0 + 8 * ch;
      const bool ok = k < k1 && n < N;
      cp_async(wd + wswz(r, ch), ok ? w + (size_t)k * N + n : w, ok ? 16 : 0,
               16);
    }
    uint8_t* xd = xs + slot * 8 * MT * XP;
    for (int c = tid; c < 8 * MT * (KS / 8); c += THREADS) {
      const int r = c / (KS / 8), kk = 8 * (c % (KS / 8));
      const int m = m0 + r, k = k0 + st * KS + kk;
      const bool ok = m < M && k < k1;
      cp_async(xd + r * XP + kk * 2, ok ? x + (size_t)m * K + k : x,
               ok ? 16 : 0, 16);
    }
  };

  // acc[i][u]: columns 32wp + 16u + g (+8) by rows 8i + 2t, +1
  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][u][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nst) load(s, s);
    cp_commit();
  }
  // ldmatrix.trans: lane's 8x8 matrix j = lane/8 is k rows 8*(j/2).. and
  // columns 8*(j%2).. of the warp's 16-column tile
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lch = 4 * wp + ((lane >> 3) & 1);
  for (int it = 0; it < nst; ++it) {
    cp_wait<ST - 2>();
    __syncthreads();
    if (it + ST - 1 < nst) load(it + ST - 1, (it + ST - 1) % ST);
    cp_commit();
    const uint8_t* W = ws + (it % ST) * KS * WROW;
    const uint8_t* X = xs + (it % ST) * 8 * MT * XP;
#pragma unroll
    for (int s = 0; s < KS / 16; ++s) {
      uint32_t a[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        ldsm_x4_trans(a[u], W + wswz(16 * s + lrow, lch + 2 * u));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint8_t* xr = X + (8 * i + g) * XP + (16 * s + 2 * t) * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
#pragma unroll
        for (int u = 0; u < 2; ++u) mma(acc[i][u], a[u], b0, b1);
      }
    }
  }
  cp_wait<0>();

  if (nsplit == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = m0 + 8 * i + 2 * t + (c & 1);
          const int n = n0 + 32 * wp + 16 * u + g + (c >> 1) * 8;
          if (m < M && n < N) store(y + (size_t)m * N + n, acc[i][u][c]);
        }
    return;
  }
  // K split: the partial tile (8MT rows x NT) in the idle ring, then block
  // r of the cluster sums quads r, r + nsplit, ... over all blocks in rank
  // order
  __syncthreads();                                  // ring reads done
  float* red = reinterpret_cast<float*>(ws);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(8 * i + 2 * t + (c & 1)) * NT + 32 * wp + 16 * u + g +
            (c >> 1) * 8] = acc[i][u][c];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  constexpr int Q = 8 * MT * NT / 4;
  for (int qd = rank * THREADS + tid; qd < Q; qd += nsplit * THREADS) {
    float4 v = cluster.map_shared_rank(reinterpret_cast<float4*>(red), 0)[qd];
    for (int r = 1; r < nsplit; ++r) {
      const float4 o =
          cluster.map_shared_rank(reinterpret_cast<float4*>(red), r)[qd];
      v.x = __fadd_rn(v.x, o.x); v.y = __fadd_rn(v.y, o.y);
      v.z = __fadd_rn(v.z, o.z); v.w = __fadd_rn(v.w, o.w);
    }
    const int m = m0 + qd / (NT / 4), n = n0 + 4 * (qd % (NT / 4));
    if (m < M && n < N) {                           // N % 8 == 0
      TOut* o = y + (size_t)m * N + n;
      store2(o, v.x, v.y);
      store2(o + 2, v.z, v.w);
    }
  }
  cluster.sync();                    // no block leaves while read from
}

template <int MT, typename TOut>
int launch_stream(const void* x, const void* w, void* y, int M, int K, int N,
                  int kchunk, int nsplit, cudaStream_t s) {
  const int smem = ST * (KS * WROW + 8 * MT * XP);
  static bool ready = false;
  cudaError_t e = allow_smem(w16_stream<MT, TOut>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + NT - 1) / NT, (M + 8 * MT - 1) / (8 * MT), nsplit);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = nsplit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, w16_stream<MT, TOut>,
                         static_cast<const __nv_bfloat16*>(x),
                         static_cast<const __nv_bfloat16*>(w),
                         static_cast<TOut*>(y), M, K, N, kchunk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// M > 16: TMA and wgmma
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 64;   // output tile, K step
constexpr int PST = 5;                       // pipeline stages
constexpr int PTHREADS = 384;                // producer + 2 consumer groups
constexpr int A_BYTES = BM * BK * 2;         // x tile: 128 rows of 128 bytes
constexpr int B_BOX = BK * 64 * 2;           // weight box: 64 rows x 64 cols
constexpr int STAGE = A_BYTES + 2 * B_BOX;
constexpr int PSMEM = PST * STAGE + 1024;    // + room to align to 1024
constexpr int GROUP_M = 8;                   // row tiles of a raster group

// Sum the f32 partial tiles (BM x BN, row-major) that the cluster's
// nsplit blocks left in shared memory, in rank order; block `rank` takes
// quads rank, rank + nsplit, ... and stores them to y.
template <typename TOut>
__device__ __forceinline__ void reduce_tiles(float* red, TOut* __restrict__ y,
                                             int M, int N, int m0, int n0,
                                             int nsplit) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  constexpr int Q = BM * BN / 4;
  for (int qd = rank * PTHREADS + (int)threadIdx.x; qd < Q;
       qd += nsplit * PTHREADS) {
    float4 v = cluster.map_shared_rank(reinterpret_cast<float4*>(red), 0)[qd];
    for (int r = 1; r < nsplit; ++r) {
      const float4 o =
          cluster.map_shared_rank(reinterpret_cast<float4*>(red), r)[qd];
      v.x = __fadd_rn(v.x, o.x); v.y = __fadd_rn(v.y, o.y);
      v.z = __fadd_rn(v.z, o.z); v.w = __fadd_rn(v.w, o.w);
    }
    const int m = m0 + qd / (BN / 4), n = n0 + 4 * (qd % (BN / 4));
    if (m < M && n < N) {                           // N % 8 == 0
      TOut* o = y + (size_t)m * N + n;
      store2(o, v.x, v.y);
      store2(o + 2, v.z, v.w);
    }
  }
}

// grid (ceil(M/BM) * ceil(N/BN), nsplit) in clusters of (1, nsplit): the
// output tiles rastered in groups of GROUP_M row tiles with the row tile
// fastest, so the blocks in flight share a few weight column tiles through
// the L2 (column-fastest order streams all the weights once per wave: 117
// MB at up|gate); block y of a cluster sums k steps [y*kst, (y+1)*kst).
// xmap: x (M, K) in boxes of 64 k x 128 rows; wmap: the stacked weights
// (L, K, N) in boxes of 64 columns x 64 k x 1 layer; both 128-byte
// swizzled.
template <typename TOut>
__global__ void __launch_bounds__(PTHREADS, 1)
w16_tma(const __grid_constant__ CUtensorMap xmap,
        const __grid_constant__ CUtensorMap wmap, TOut* __restrict__ y,
        int M, int K, int N, int layer, int kst) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[PST], empty[PST];
  // the swizzle repeats every 1024 bytes: tiles start on that boundary
  uint8_t* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int tm = (M + BM - 1) / BM, tn = (N + BN - 1) / BN;
  const int group = blockIdx.x / (GROUP_M * tn);
  const int first = group * GROUP_M, rows = min(GROUP_M, tm - first);
  const int in_group = blockIdx.x % (GROUP_M * tn);
  const int m0 = (first + in_group % rows) * BM, n0 = (in_group / rows) * BN;
  const int nsplit = gridDim.y;
  const int k0 = blockIdx.y * kst;
  const int nk = min((K + BK - 1) / BK - k0, kst);  // >= 1: the planner's

  if (threadIdx.x == 0) {
    for (int s = 0; s < PST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                      // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  if (wg == 0) {
    // producer: one thread keeps PST stages of loads in flight
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % PST;
        mbar_wait(&empty[s], ((kt / PST) & 1) ^ 1);
        uint8_t* a = smem + s * STAGE;
        uint8_t* b = a + A_BYTES;
        const int k = (k0 + kt) * BK;
        mbar_expect_tx(&full[s], STAGE);            // boxes count whole
        tma_2d(a, &xmap, &full[s], k, m0);
        tma_3d(b, &wmap, &full[s], n0, k, layer);
        tma_3d(b + B_BOX, &wmap, &full[s], n0 + 64, k, layer);
      }
    }
    if (nsplit == 1) return;
  } else {
    // consumer c: rows 64c..64c+63 of the tile
    const int c = wg - 1;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % PST;
      mbar_wait(&full[s], (kt / PST) & 1);
      const uint8_t* a = smem + s * STAGE + c * (A_BYTES / 2);
      const uint8_t* b = smem + s * STAGE + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // A: 8-row groups 1024 bytes apart, k16 steps 32 bytes along the
        // swizzled row.  B: 8-row k groups 1024 bytes apart, the second 64
        // columns one box (B_BOX) on, k16 steps 16 rows (2048 bytes) on.
        wgmma_128(d, sw128_desc(a + 32 * kk, 16, 1024),
                  sw128_desc(b + 2048 * kk, B_BOX, 1024));
      wgmma_commit();
      // one group stays in flight: the previous stage's products are done,
      // so its slot goes back to the producer
      wgmma_wait<1>();
      if (kt > 0 && (tid & 31) == 0) mbar_arrive(&empty[(kt - 1) % PST]);
    }
    wgmma_wait<0>();
  }

  // d[4j + 2h + e]: row 64c + 16*warp + g + 8h, column 8j + 2t + e
  const int c = wg - 1, warp = (tid >> 5), g = (tid & 31) >> 2, t = tid & 3;
  if (nsplit == 1) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * c + 16 * warp + g + 8 * h;
        const int n = n0 + 8 * j + 2 * t;
        if (m < M && n < N)                         // N % 8 == 0
          store2(y + (size_t)m * N + n, d[4 * j + 2 * h],
                 d[4 * j + 2 * h + 1]);
      }
    return;
  }
  // K split: the consumers' partial tile into the idle ring once both
  // groups are done reading it, then the cluster sums the tiles
  float* red = reinterpret_cast<float*>(smem);
  if (wg > 0) {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * c + 16 * warp + g + 8 * h, col = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(red + row * BN + col) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
  }
  cg::this_cluster().sync();
  reduce_tiles(red, y, M, N, m0, n0, nsplit);
  cg::this_cluster().sync();         // no block leaves while read from
}

// A 128-byte swizzled bf16 tensor map
int encode_bf16(CUtensorMap* map, int rank, const void* base,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  return hopper::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, base,
                        dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename TOut>
int launch_tma(const void* x, const void* wmap_bytes, void* y, int M, int K,
               int N, int layer, int kst, int nsplit, cudaStream_t s) {
  CUtensorMap xmap, wmap;
  memcpy(&wmap, wmap_bytes, sizeof wmap);     // the caller's copy may be
                                              // less aligned than the type
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {BK, BM};
  int rc = encode_bf16(&xmap, 2, x, dims, strides, box);
  if (rc != 0) return rc;
  static bool ready = false;
  cudaError_t e = allow_smem(w16_tma<TOut>, PSMEM, ready);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((M + BM - 1) / BM) * ((N + BN - 1) / BN), nsplit, 1);
  cfg.blockDim = dim3(PTHREADS);
  cfg.dynamicSmemBytes = PSMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = nsplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, w16_tma<TOut>, xmap, wmap,
                         static_cast<TOut*>(y), M, K, N, layer, kst);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The tensor map of stacked weights w_all (L, K, N) bf16 for the M > 16
// kernel, written to `map` (sizeof(CUtensorMap) = 128 bytes of host
// memory).  Needs N % 8 == 0 and a 16-byte aligned w_all.
extern "C" int w16_weight_map(void* map, const void* w_all, int L, int K,
                              int N) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2,
                                 (cuuint64_t)K * (cuuint64_t)N * 2};
  const cuuint32_t box[3] = {64, BK, 1};
  CUtensorMap m;
  const int rc = encode_bf16(&m, 3, w_all, dims, strides, box);
  if (rc == 0) memcpy(map, &m, sizeof m);
  return rc;
}

// y (M, N) = x (M, K) @ w_all[layer], bf16 or f32 (out_f32), K split into
// nsplit <= 8 slices of kchunk rows (a multiple of 64; nsplit * kchunk
// covers K with no empty slice).  M <= 16: w_layer is the layer's (K, N)
// weights.  M > 16: wmap is w16_weight_map's map of w_all; w_layer is
// unused.  Needs K % 8 == 0, N % 8 == 0 and 16-byte aligned x and weights
// (the wrapper checks).
extern "C" int w16_matmul_stacked_launch(const void* x, const void* w_layer,
                                         const void* wmap, void* y, int M,
                                         int K, int N, int layer, int kchunk,
                                         int nsplit, int out_f32,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsplit < 1 || nsplit > MAXSPLIT || kchunk % KS != 0)
    return (int)cudaErrorInvalidValue;
  if (M > 16) {
    const int kst = kchunk / BK;
    return out_f32 ? launch_tma<float>(x, wmap, y, M, K, N, layer, kst,
                                       nsplit, s)
                   : launch_tma<__nv_bfloat16>(x, wmap, y, M, K, N, layer,
                                               kst, nsplit, s);
  }
  if (M <= 8)
    return out_f32 ? launch_stream<1, float>(x, w_layer, y, M, K, N, kchunk,
                                             nsplit, s)
                   : launch_stream<1, __nv_bfloat16>(x, w_layer, y, M, K, N,
                                                     kchunk, nsplit, s);
  return out_f32 ? launch_stream<2, float>(x, w_layer, y, M, K, N, kchunk,
                                           nsplit, s)
                 : launch_stream<2, __nv_bfloat16>(x, w_layer, y, M, K, N,
                                                   kchunk, nsplit, s);
}
