// Weight-only INT4 matmul (bf16 activations) against one layer of stacked
// packed INT4 weights, with two epilogues.
//
// Replaces: rsq_tpu/kernels/matmul_w4.py
//   - w4_matmul_paired_stacked (:665), Pallas body _w4_kernel_pref (:626):
//     the per-column paired scale;
//   - w4_affine_matmul_stacked (:747), body _w4_affine_kernel_pref (:712):
//     the per-tensor scale with the +0.5 rank-1 term (E8P re-encoded);
//   - w4_matmul (:143), body _w4_matmul_kernel (:122): the int4 lm_head,
//     through an L = 1 view, its per-column scale and output unpaired;
//   - on L = 1 views of unstacked weights, w4_matmul_paired (:190, the
//     paired scale) and w4_affine_matmul (:269, body _w4_affine_kernel
//     :246, the affine epilogue).
// Computes: acc[m, p, j] = sum_k x[m, k] * q_p(w[k, j]) for bf16 x (M, K)
//   and the layer's packed bytes w (K, Nh), read in place: byte (k, j)
//   holds q_0 in its low nibble and q_1 in its high nibble, two's-complement
//   int4.  bf16 x int4 products are exact in f32; sums are f32.  Output
//   (M, 2 * Nh) bf16, column oc of plane p and packed column j either
//   plane-paired, oc = p * Nh + j (the (M, 2, Nh) layout), or adjacent,
//   oc = 2 * j + p (the natural columns of the adjacent packing):
//     scale2: out = bf16(acc * scale[oc]) (paired (2, Nh) or natural (N,)
//             scales, indexed as the output);
//     affine: out = bf16((acc + 0.5 * xsum[m]) * sh), sh read from device
//             memory (a pointer to sh_all[layer]: no host scalar, no sync),
//             xsum the f32 row sums of x: the caller's beyond M = 16, taken
//             here at decode (M <= 16), each block summing its K slice.
// Bound on this card: at decode (M = 8) the weight bytes, K*Nh per call --
//   109 MB per Llama-3-8B layer, 0.033 ms at 3.35 TB/s.  At prefill
//   (M = 128..4096) the bf16 tensor-core operations, 2*M*K*2Nh.
// Design: two kernels, one launch per call, no workspace and no float
//   atomics, so every run gives the same bits.  Nibbles become bf16 exactly
//   in registers: q + 8 = nib ^ 8, and the bf16 bits 0x4300 | (q + 8) are
//   the value 136 + q, so one bf16x2 subtraction of 136 gives q, two values
//   at a time.  No +8 bias is carried into the products (the TPU kernel's
//   biased dot is a workaround for its compiler's int8 unpack).  Both
//   kernels swap the operands: weight columns are the m side of the
//   tensor-core products (an m16 tile is 8 packed columns of a 16-byte
//   chunk, low plane on rows 0-7, high plane on 8-15), converted straight
//   from an ldmatrix.trans of the packed bytes into mma.sync's A fragment
//   layout, which wgmma also takes from registers.
//   - M <= 16, w4_stream, a weight stream in the manner of w16_stream: 4
//     x KH warps a block (KH per 32 packed columns, each on its part of a
//     stage's k steps) and a 4-stage ring of 128 k x 128 packed-column
//     tiles, four times the k depth of a bf16 stage of the same width,
//     brought by the Tensor Memory Accelerator (a 3-D map over (L, K, Nh)
//     uint8, the layer a coordinate, 128-byte swizzled) where it can
//     address them and else by byte loads; x rides in the ring by cp.async.
//     The <= 16 activation rows are the n side of mma.sync.m16n8k16.  K is
//     split over a cluster of up to 8 blocks (enough to fill one wave, at
//     least two where the column tiles are fewer than the SMs) that sum
//     their f32 partial tiles (and row sums) in rank order through
//     distributed shared memory.  A block streams about 15-16 GB/s on the
//     H100, so short calls do not reach the bytes' bound (PERF.md sec. 6).
//   - M > 16, w4_tma: TMA brings 64 k x BT x rows (2-D map) and 64 k x 128
//     packed columns (the 3-D map), both 128-byte swizzled, into an
//     mbarrier ring.  Each warp of the two consumer warpgroups converts its
//     16-byte chunk of each packed row into two A fragments in registers
//     and the group runs wgmma.m64nBTk16 with x (K-major in shared memory)
//     as B: 128 packed columns (256 outputs) by BT rows a block, BT = 128
//     (thread 0 keeping the ring full between its own products) or 64 (a
//     producer warp) as matmul_w4.w4_tma_rows picks by the waves of tiles.
//     The weights never pass through shared memory as bf16.  (A bf16 B
//     tile converted in shared memory for wgmma's B operand, as w16_tma
//     reads its weights, was 6-25% slower; 128-row tiles cut M = 1024-4096
//     from 1.6x torch.matmul to 1.2-1.4x: PERF.md section 6.)  Where the
//     tiles leave SMs idle, K is split over a cluster as above.  Shapes the
//     maps cannot address (Nh % 16 != 0, an unaligned base) go to w4_stream
//     by a rule on the shape, fixed before the launch
//     (matmul_w4.w4_uses_tma).

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

constexpr int kScale2 = 0, kAffine = 1;
// The affine format's offset: E8P re-encodes to v = (q + 0.5) * sh.
constexpr float kZero = 0.5f;
constexpr int MAXSPLIT = 8;          // a portable cluster

// Output column (and scale index) of plane p, packed column j
__device__ __forceinline__ int out_col(int p, int j, int Nh, int adj) {
  return adj ? 2 * j + p : p * Nh + j;
}

// Epilogue of one sum: xs the row's sum of x (affine), oc its column.
template <int EPI>
__device__ __forceinline__ float finish(float acc, float xs, int oc,
                                        const float* __restrict__ scale) {
  if (EPI == kScale2) return __fmul_rn(acc, scale[oc]);
  return __fmul_rn(__fadd_rn(acc, __fmul_rn(kZero, xs)), scale[0]);
}

// bf16 pair (136 + a, 136 + b) -> (a, b), exactly
__device__ __forceinline__ uint32_t sub136(uint32_t v) {
  const __nv_bfloat162 k136 = __halves2bfloat162(
      __ushort_as_bfloat16(0x4308), __ushort_as_bfloat16(0x4308));
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), k136);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// An ldmatrix.trans register -- bytes (k, c), (k, c+1), (k+1, c), (k+1, c+1)
// -> bf16 pairs over (k, k+1): lo[e], hi[e] of packed column c + e's low
// and high planes.
__device__ __forceinline__ void planes(uint32_t r, uint32_t (&lo)[2],
                                       uint32_t (&hi)[2]) {
  const uint32_t bl = (r & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t bh = ((r >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  lo[0] = sub136(__byte_perm(bl, 0x43434343u, 0x4240));
  lo[1] = sub136(__byte_perm(bl, 0x43434343u, 0x4341));
  hi[0] = sub136(__byte_perm(bh, 0x43434343u, 0x4240));
  hi[1] = sub136(__byte_perm(bh, 0x43434343u, 0x4341));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const uint8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)) : "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// M <= 16: the weight stream
// ---------------------------------------------------------------------------

constexpr int KH = 2;               // warps sharing a column group's k steps
constexpr int THREADS = 128 * KH;   // 4 column groups x KH
constexpr int NTH = 128;            // packed columns per block (256 outputs)
constexpr int KS = 128;             // k rows per pipeline stage
constexpr int ST = 4;               // pipeline stages
constexpr int XP = KS * 2 + 16;     // x row pitch in bytes (conflict-free)

// Byte offset of 16-byte chunk c of row r in a weight tile of NTH-byte rows
__device__ __forceinline__ int wswz(int r, int c) {
  return r * NTH + ((c ^ (r & 7)) << 4);
}

// MT tiles of 8 activation rows.  grid (ceil(Nh/NTH), ceil(M/8MT), nsplit)
// in clusters of (1, 1, nsplit); block z sums k in [z*kchunk,
// min(K, (z+1)*kchunk)), kchunk a multiple of 64.  Warp w takes packed
// columns 32(w % 4).. of every stage's k16 steps j with j * KH / 8 == w /
// 4, so KH warps share each column group and their parts are added in a
// fixed order at the end.  WIDE (Nh % 16 == 0 and a 16-byte aligned
// stacked base): the weight tiles come by TMA through wmap, the (L, K, Nh)
// bytes in boxes of 128 columns x 128 k x 1 layer, 128-byte swizzled --
// rows past the slice are read but meet zeros of x; else bytes one at a
// time from w, the layer's (outside the matrix: zeros, q = 0).  xsum null
// (affine): the row sums are taken here.
template <int MT, int EPI, bool WIDE>
__global__ void __launch_bounds__(THREADS)
w4_stream(const __grid_constant__ CUtensorMap wmap,
          const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scale, const float* __restrict__ xsum,
          __nv_bfloat16* __restrict__ y, int M, int K, int Nh, int layer,
          int kchunk, int adj) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];
  // TMA's swizzle repeats every 1024 bytes: the ring starts on a boundary
  uint8_t* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* ws = smem;                               // ST x KS x NTH
  uint8_t* xs = smem + ST * KS * NTH;               // ST x 8MT x XP
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int cw = wp & 3, kh = wp >> 2;              // column group, k part
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * NTH, m0 = blockIdx.y * 8 * MT;
  const int nsplit = gridDim.z;
  const int k0 = blockIdx.z * kchunk, k1 = min(K, k0 + kchunk);
  const int nst = (k1 - k0 + KS - 1) / KS;
  const bool own_sums = EPI == kAffine && xsum == nullptr;

  if (WIDE && tid == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage st into ring slot `slot`; K % 8 == 0, so every x chunk lies
  // wholly inside or wholly outside (zero-filled)
  auto load = [&](int st, int slot) {
    uint8_t* wd = ws + slot * KS * NTH;
    if (WIDE && tid == 0) {
      mbar_expect_tx(&full[slot], KS * NTH);        // the box counts whole
      tma_3d(wd, &wmap, &full[slot], n0, k0 + st * KS, layer);
    }
    for (int c = tid; !WIDE && c < KS * (NTH / 16); c += THREADS) {
      const int r = c / (NTH / 16), ch = c % (NTH / 16);
      const int k = k0 + st * KS + r, n = n0 + 16 * ch;
      uint32_t v[4] = {0, 0, 0, 0};
      if (k < k1) {
        const uint8_t* src = w + (size_t)k * Nh + n;
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (n + b < Nh)
            v[b / 4] |= (uint32_t)__ldg(src + b) << (8 * (b % 4));
      }
      *reinterpret_cast<uint4*>(wd + wswz(r, ch)) =
          make_uint4(v[0], v[1], v[2], v[3]);
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

  // acc[i][u]: m16 tile u = 2ch + e is packed column 16(2cw + ch) + 2g + e,
  // low plane (c 0, 1) and high plane (c 2, 3), by rows 8i + 2t, +1
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][u][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nst) load(s, s);
    cp_commit();
  }
  // ldmatrix.trans: lane's 8x8 matrix j = lane/8 is k rows 8*(j%2).. and
  // the 16 packed columns of chunk 2cw + j/2
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lch = 2 * cw + (lane >> 4);
  for (int it = 0; it < nst; ++it) {
    cp_wait<ST - 2>();
    __syncthreads();
    if (it + ST - 1 < nst) load(it + ST - 1, (it + ST - 1) % ST);
    cp_commit();
    if (WIDE) mbar_wait(&full[it % ST], (it / ST) & 1);
    const uint8_t* W = ws + (it % ST) * KS * NTH;
    const uint8_t* X = xs + (it % ST) * 8 * MT * XP;
#pragma unroll
    for (int ss = 0; ss < KS / 16 / KH; ++ss) {
      const int s = (KS / 16 / KH) * kh + ss;       // this part's k16 steps
      uint32_t r[4];
      ldsm_x4_trans(r, W + wswz(16 * s + lrow, lch));
      uint32_t a[4][4];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        uint32_t l0[2], h0[2], l1[2], h1[2];
        planes(r[2 * ch], l0, h0);                  // k 2t, 2t+1
        planes(r[2 * ch + 1], l1, h1);              // k 2t+8, 2t+9
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          a[2 * ch + e][0] = l0[e];
          a[2 * ch + e][1] = h0[e];
          a[2 * ch + e][2] = l1[e];
          a[2 * ch + e][3] = h1[e];
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint8_t* xr = X + (8 * i + g) * XP + (16 * s + 2 * t) * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
#pragma unroll
        for (int u = 0; u < 4; ++u) mma(acc[i][u], a[u], b0, b1);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                                  // the ring is idle

  // the KH k parts' tiles (8MT rows x 2 planes x NTH columns each) and this
  // slice's row sums in the idle ring (and x's, past it); each row's sum in
  // a fixed order: lane-strided 16-byte runs, then a butterfly
  constexpr int TILE = 8 * MT * 2 * NTH;
  float* red = reinterpret_cast<float*>(ws);
  float* rsum = red + KH * TILE;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = 8 * i + 2 * t + (c & 1);
        const int col = 16 * (2 * cw + (u >> 1)) + 2 * g + (u & 1);
        red[kh * TILE + (row * 2 + (c >> 1)) * NTH + col] = acc[i][u][c];
      }
  if (own_sums) {
    for (int r = wp; r < 8 * MT; r += THREADS / 32) {
      float sum = 0.0f;
      if (m0 + r < M)
        for (int k = k0 + 8 * lane; k < k1; k += 256) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(
              x + (size_t)(m0 + r) * K + k));
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f = __bfloat1622float2(h[q]);
            sum = __fadd_rn(__fadd_rn(sum, f.x), f.y);
          }
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      if (lane == 0) rsum[r] = sum;
    }
  }
  __syncthreads();
  for (int i = tid; i < TILE; i += THREADS) {        // the k parts in order
    float v = red[i];
#pragma unroll
    for (int h = 1; h < KH; ++h) v = __fadd_rn(v, red[h * TILE + i]);
    red[i] = v;
  }

  // the cluster's slices summed in rank order (a lone block: its own);
  // block r of the cluster finishes quads r, r + nsplit, ...
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  for (int qd = rank * THREADS + tid; qd < TILE / 4; qd += nsplit * THREADS) {
    const int row = qd / (NTH / 2), p = (qd / (NTH / 4)) % 2;
    const int m = m0 + row, j0 = n0 + 4 * (qd % (NTH / 4));
    if (m >= M) continue;
    float4 v = cluster.map_shared_rank(reinterpret_cast<float4*>(red), 0)[qd];
    float xv = 0.0f;
    if (EPI == kAffine)
      xv = own_sums ? cluster.map_shared_rank(rsum, 0)[row] : xsum[m];
#pragma unroll
    for (int r = 1; r < MAXSPLIT; ++r)
      if (r < nsplit) {
        const float4 o =
            cluster.map_shared_rank(reinterpret_cast<float4*>(red), r)[qd];
        v.x = __fadd_rn(v.x, o.x); v.y = __fadd_rn(v.y, o.y);
        v.z = __fadd_rn(v.z, o.z); v.w = __fadd_rn(v.w, o.w);
        if (own_sums)
          xv = __fadd_rn(xv, cluster.map_shared_rank(rsum, r)[row]);
      }
    const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j0 + e < Nh) {
        const int oc = out_col(p, j0 + e, Nh, adj);
        y[(size_t)m * 2 * Nh + oc] =
            __float2bfloat16_rn(finish<EPI>(vals[e], xv, oc, scale));
      }
  }
  cluster.sync();                    // no block leaves while read from
}

template <int MT, int EPI, bool WIDE>
int launch_stream(const void* wmap_bytes, const void* x, const void* w,
                  const float* scale, const float* xsum, void* y, int M,
                  int K, int Nh, int layer, int kchunk, int nsplit, int adj,
                  cudaStream_t s) {
  CUtensorMap wmap;
  memset(&wmap, 0, sizeof wmap);
  if (WIDE) memcpy(&wmap, wmap_bytes, sizeof wmap);
  const int smem = ST * (KS * NTH + 8 * MT * XP) + 1024;   // + alignment
  static bool ready = false;
  cudaError_t e = allow_smem(w4_stream<MT, EPI, WIDE>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Nh + NTH - 1) / NTH, (M + 8 * MT - 1) / (8 * MT),
                     nsplit);
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
  e = cudaLaunchKernelEx(&cfg, w4_stream<MT, EPI, WIDE>, wmap,
                         static_cast<const __nv_bfloat16*>(x),
                         static_cast<const uint8_t*>(w), scale, xsum,
                         static_cast<__nv_bfloat16*>(y), M, K, Nh, layer,
                         kchunk, adj);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// M > 16: TMA and wgmma
// ---------------------------------------------------------------------------

// BT rows (64 or 128, matmul_w4.w4_tma_rows) x 128 packed columns a block.
// Two consumer warpgroups; the ring's producer is warp 8 at 64 rows and
// thread 0 itself at 128, where that measured 1.21-1.37x torch.matmul
// against 1.83-1.94x with the producer warp (and the other way round at
// 64 rows: PERF.md section 6).
constexpr int BNH = 128, BK = 64;
constexpr int WB_BYTES = BK * BNH;           // packed tile: 64 k x 128 bytes
constexpr int GROUP_M = 8;                   // row tiles of a raster group
template <int BT> struct Tma {
  static constexpr bool INLINE = BT == 128;           // thread 0 produces
  static constexpr int THREADS = INLINE ? 256 : 288;
  static constexpr int PST = BT == 128 ? 6 : 8;       // pipeline stages
  static constexpr int X_BYTES = BT * BK * 2;         // x tile: BT rows
  static constexpr int STAGE = X_BYTES + WB_BYTES;    // a multiple of 1024
  static constexpr int SMEM = PST * STAGE + 1024;     // + alignment
};

// d += A . B over one k16 step, A (64 x 16) from registers -- each warp's
// 16 rows in mma.sync's A fragment layout -- and B (16 x 64) K-major,
// 128-byte swizzled in shared memory (descriptor b)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the same with B (16 x 128)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// grid (ceil(M/BT) * ceil(Nh/BNH), nsplit) in clusters of (1, nsplit),
// rastered as w16_tma's (row tiles fastest in groups of GROUP_M); block y
// of a cluster sums k steps [y*kst, (y+1)*kst).  xmap: x (M, K) in boxes
// of 64 k x BT rows; wmap: the packed (L, K, Nh) bytes in boxes of 128
// columns x 64 k x 1 layer; both 128-byte swizzled.  xsum: the (M,) row
// sums (affine).  The operands are swapped: consumer c's warp w converts
// packed columns 16(4c + w)..+15 (chunk 4c + w of each 128-byte row) into
// two A fragments -- columns 2g and 2g + 1 of the chunk, low plane on rows
// g, high on g + 8 -- and x is B, so d0 and d1 are (64 columns) x (BT
// rows of x).
template <int EPI, int BT>
__global__ void __launch_bounds__(Tma<BT>::THREADS, 1)
w4_tma(const __grid_constant__ CUtensorMap xmap,
       const __grid_constant__ CUtensorMap wmap,
       const float* __restrict__ scale, const float* __restrict__ xsum,
       __nv_bfloat16* __restrict__ y, int M, int K, int Nh, int layer,
       int kst, int adj) {
  constexpr int PST = Tma<BT>::PST, X_BYTES = Tma<BT>::X_BYTES;
  constexpr int STAGE = Tma<BT>::STAGE, PTHREADS = Tma<BT>::THREADS;
  constexpr bool INLINE = Tma<BT>::INLINE;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[PST], empty[PST];
  // the swizzle repeats every 1024 bytes: tiles start on that boundary
  uint8_t* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int tm = (M + BT - 1) / BT, tn = (Nh + BNH - 1) / BNH;
  const int group = blockIdx.x / (GROUP_M * tn);
  const int first = group * GROUP_M, rows = min(GROUP_M, tm - first);
  const int in_group = blockIdx.x % (GROUP_M * tn);
  const int m0 = (first + in_group % rows) * BT, n0 = (in_group / rows) * BNH;
  const int nsplit = gridDim.y;
  const int k0 = blockIdx.y * kst;
  const int nk = min((K + BK - 1) / BK - k0, kst);  // >= 1: the planner's

  // stage kt's loads, once the consumers have released its slot
  auto fill = [&](int kt) {
    const int s = kt % PST;
    mbar_wait(&empty[s], ((kt / PST) & 1) ^ 1);
    uint8_t* a = smem + s * STAGE;
    const int k = (k0 + kt) * BK;
    mbar_expect_tx(&full[s], STAGE);                // boxes count whole
    tma_2d(a, &xmap, &full[s], k, m0);
    tma_3d(a + X_BYTES, &wmap, &full[s], n0, k, layer);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < PST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                      // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kt = 0; INLINE && kt < min(nk, PST); ++kt) fill(kt);
  }
  __syncthreads();
  if (wg == 2) {
    // producer warp: one thread keeps PST stages of loads in flight
    for (int kt = 0; tid == 0 && kt < nk; ++kt) fill(kt);
    if (nsplit == 1) return;
  }

  float d[2][BT / 2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) d[e][i] = 0.0f;
  // ldmatrix.trans of the warp's chunk, k rows 8j.. for matrix j = lane / 8
  // (rows 0-31, then 32-63)
  const int ch = 4 * wg + warp;
  const int lrow = (lane & 7) + 8 * (lane >> 3);
  for (int kt = 0; wg < 2 && kt < nk; ++kt) {
    const int s = kt % PST;
    mbar_wait(&full[s], (kt / PST) & 1);
    const uint8_t* X = smem + s * STAGE;
    const uint8_t* W = X + X_BYTES;
    uint32_t r[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ldsm_x4_trans(r[h], W + wswz(32 * h + lrow, ch));
    // A fragments of k16 step kk: columns 2g + e, k 2t, 2t+1 (low, high
    // plane) and 2t+8, 2t+9
    uint32_t af[4][2][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t l0[2], h0[2], l1[2], h1[2];
      planes(r[kk / 2][2 * (kk % 2)], l0, h0);
      planes(r[kk / 2][2 * (kk % 2) + 1], l1, h1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        af[kk][e][0] = l0[e];
        af[kk][e][1] = h0[e];
        af[kk][e][2] = l1[e];
        af[kk][e][3] = h1[e];
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        // B: 8-row groups 1024 bytes apart, k16 steps 32 bytes along the
        // swizzled row
        wgmma_rs(d[e], af[kk][e], sw128_desc(X + 32 * kk, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    // the products read af asynchronously: keep every register of it
    // unchanged until they are done
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          asm volatile("" : "+r"(af[kk][e][i]) :: "memory");
    if (lane == 0) mbar_arrive(&empty[s]);
    if (INLINE && threadIdx.x == 0 && kt + PST < nk) fill(kt + PST);
  }

  // d[e][4j + 2h + e2]: packed column n0 + 16 ch + 2g + e, plane h, row m0
  // + 8j + 2t + e2 of x
  if (nsplit == 1) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int m = m0 + 8 * j + 2 * t + e2;
            const int jj = n0 + 16 * ch + 2 * g + e;
            if (m < M && jj < Nh) {
              const int oc = out_col(h, jj, Nh, adj);
              const float xv = EPI == kAffine ? xsum[m] : 0.0f;
              y[(size_t)m * 2 * Nh + oc] = __float2bfloat16_rn(
                  finish<EPI>(d[e][4 * j + 2 * h + e2], xv, oc, scale));
            }
          }
    return;
  }
  // K split: the partial tile (BT rows x 2 planes x BNH columns, f32) into
  // the idle ring, then block r of the cluster sums quads r, r + nsplit,
  // ... over all blocks in rank order
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();                                  // the ring is idle
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
          if (wg < 2)
            red[((8 * j + 2 * t + e2) * 2 + h) * BNH + 16 * ch + 2 * g + e] =
                d[e][4 * j + 2 * h + e2];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  constexpr int Q = BT * 2 * BNH / 4;
  for (int qd = rank * PTHREADS + (int)threadIdx.x; qd < Q;
       qd += nsplit * PTHREADS) {
    const int row = qd / (BNH / 2), p = (qd / (BNH / 4)) % 2;
    const int m = m0 + row, j0 = n0 + 4 * (qd % (BNH / 4));
    if (m >= M) continue;
    float4 v = cluster.map_shared_rank(reinterpret_cast<float4*>(red), 0)[qd];
#pragma unroll
    for (int r = 1; r < MAXSPLIT; ++r)
      if (r < nsplit) {
        const float4 o =
            cluster.map_shared_rank(reinterpret_cast<float4*>(red), r)[qd];
        v.x = __fadd_rn(v.x, o.x); v.y = __fadd_rn(v.y, o.y);
        v.z = __fadd_rn(v.z, o.z); v.w = __fadd_rn(v.w, o.w);
      }
    const float xv = EPI == kAffine ? xsum[m] : 0.0f;
    const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j0 + e < Nh) {
        const int oc = out_col(p, j0 + e, Nh, adj);
        y[(size_t)m * 2 * Nh + oc] =
            __float2bfloat16_rn(finish<EPI>(vals[e], xv, oc, scale));
      }
  }
  cluster.sync();                    // no block leaves while read from
}

template <int EPI, int BT>
int launch_tma(const void* x, const void* wmap_bytes, const float* scale,
               const float* xsum, void* y, int M, int K, int Nh, int layer,
               int kst, int nsplit, int adj, cudaStream_t s) {
  CUtensorMap xmap, wmap;
  memcpy(&wmap, wmap_bytes, sizeof wmap);     // the caller's copy may be
                                              // less aligned than the type
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {BK, BT};
  const int rc = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims,
                        strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  static bool ready = false;
  cudaError_t e = allow_smem(w4_tma<EPI, BT>, Tma<BT>::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((M + BT - 1) / BT) * ((Nh + BNH - 1) / BNH), nsplit, 1);
  cfg.blockDim = dim3(Tma<BT>::THREADS);
  cfg.dynamicSmemBytes = Tma<BT>::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = nsplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, w4_tma<EPI, BT>, xmap, wmap, scale, xsum,
                         static_cast<__nv_bfloat16*>(y), M, K, Nh, layer,
                         kst, adj);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int EPI>
int launch(const void* x, const void* w_layer, const void* wmap,
           const void* smap, const float* scale, const float* xsum, void* y,
           int M, int K, int Nh, int layer, int kchunk, int nsplit, int adj,
           int rows, cudaStream_t s) {
  if (wmap != nullptr)
    return rows == 128
        ? launch_tma<EPI, 128>(x, wmap, scale, xsum, y, M, K, Nh, layer,
                               kchunk / BK, nsplit, adj, s)
        : launch_tma<EPI, 64>(x, wmap, scale, xsum, y, M, K, Nh, layer,
                              kchunk / BK, nsplit, adj, s);
  const bool wide = smap != nullptr;
  if (M <= 8)
    return wide ? launch_stream<1, EPI, true>(smap, x, w_layer, scale, xsum,
                                              y, M, K, Nh, layer, kchunk,
                                              nsplit, adj, s)
                : launch_stream<1, EPI, false>(smap, x, w_layer, scale, xsum,
                                               y, M, K, Nh, layer, kchunk,
                                               nsplit, adj, s);
  return wide ? launch_stream<2, EPI, true>(smap, x, w_layer, scale, xsum, y,
                                            M, K, Nh, layer, kchunk, nsplit,
                                            adj, s)
              : launch_stream<2, EPI, false>(smap, x, w_layer, scale, xsum, y,
                                             M, K, Nh, layer, kchunk, nsplit,
                                             adj, s);
}

}  // namespace

// A tensor map of stacked packed weights w_all (L, K, Nh) uint8 in boxes of
// 128 columns x `rows` k x 1 layer, 128-byte swizzled, written to `map`
// (sizeof(CUtensorMap) = 128 bytes of host memory): rows 64 for the M > 16
// kernel, 128 for the stream.  Needs Nh % 16 == 0 and a 16-byte aligned
// w_all.
extern "C" int w4_weight_map(void* map, const void* w_all, int L, int K,
                             int Nh, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)Nh, (cuuint64_t)K, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)Nh,
                                 (cuuint64_t)K * (cuuint64_t)Nh};
  const cuuint32_t box[3] = {BNH, (cuuint32_t)rows, 1};
  CUtensorMap m;
  const int rc = encode(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w_all, dims,
                        strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0) memcpy(map, &m, sizeof m);
  return rc;
}

// y (M, 2 * Nh) bf16 = epilogue(x (M, K) @ both planes of layer `layer`),
// columns paired (adj = 0) or adjacent (adj = 1).  affine = 0: scale is
// indexed as the output (paired (2, Nh) or natural (N,)), xsum unused.
// affine = 1: scale points to the layer's f32 sh, xsum to the (M,) f32 row
// sums, or null to have the stream kernel (M <= 16) take them.  K split
// into nsplit <= 8 slices of kchunk rows (a multiple of 64; nsplit * kchunk
// covers K with no empty slice).  wmap: w4_weight_map's 64-row map of the
// stacked weights, for the TMA kernel (M > 16 on addressable shapes); else
// the stream kernel, on smap, the 128-row map (addressable shapes), or, if
// null, on w_layer, the layer's (K, Nh) bytes.  rows: the TMA kernel's
// rows of x a block, 64 or 128.  Needs K % 8 == 0 and a
// 16-byte aligned x (the wrapper checks).
extern "C" int w4_matmul_launch(const void* x, const void* w_layer,
                                const void* wmap, const void* smap,
                                const void* scale, const void* xsum, void* y,
                                int M, int K, int Nh, int layer, int kchunk,
                                int nsplit, int affine, int adj, int rows,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsplit < 1 || nsplit > MAXSPLIT || kchunk % 64 != 0)
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* xs = static_cast<const float*>(xsum);
  if (affine)
    return launch<kAffine>(x, w_layer, wmap, smap, sc, xs, y, M, K, Nh,
                           layer, kchunk, nsplit, adj, rows, s);
  return launch<kScale2>(x, w_layer, wmap, smap, sc, xs, y, M, K, Nh, layer,
                         kchunk, nsplit, adj, rows, s);
}
