// W4A4 matmul against one layer of stacked plane-major INT4 weights.
//
// Replaces: rsq_tpu/kernels/matmul_w4.py w4a4_matmul_paired_stacked (:559),
//   Pallas body _w4a4_kernel_i8_pref (:523); and, on an L = 1 view of
//   unstacked weights, w4a4_matmul_paired (:458) with both of its bodies,
//   _w4a4_kernel_i8 (:369, decode) and _w4a4_kernel (:401, bf16, prefill):
//   all three sum the same integer products exactly.
// Computes: xq = clip(rint(x * (1/xs)), -8, 7) per row (xs = per-token
//   absmax*clip/7), acc = xq . W (exact int32),
//   out[m, p, j] = bf16(float(acc) * xs[m] * scale2[p, j]).
//   Weight byte (k, j) holds output j in its low nibble and output Nh + j in
//   its high nibble, both two's-complement int4 (plane-major layout).
// Bound on this card: at decode (M = 8) the weight bytes -- K*Nh per call,
//   about 109 MB per Llama-3-8B layer -- so the card's memory rate.  At
//   prefill (M = 512..4096) the integer operations (2*M*K*2Nh).
// Design: int8 tensor cores, mma.sync.m16n8k32 (s8 x s8 -> s32), exact, so
//   the output is bit-equal to the plain version whatever the sum order.
//   - The operands are swapped: 16 packed columns are the mma's m side and
//     up to 8 activation rows its n side.  The mma's row i and reduction
//     index kappa may stand for any column and k, so thread (g = lane/4,
//     t = lane%4) is given packed columns 4g..4g+3 of its warp's 32 and
//     k = 8t..8t+7 of each 32-k step.  It reads one 32-bit word of 4
//     columns from each of its 8 weight rows; a 4x4 byte transpose
//     (__byte_perm) gives one word of 4 consecutive k per column, which is
//     an A fragment register as it stands.  Masking it with 0xF0F0F0F0
//     (after a 4-bit shift for the low plane) leaves each nibble as a
//     signed byte worth 16*q: the two planes are two A tiles sharing one B
//     fragment, and the epilogue shifts the 16 back out.  The B fragment is
//     8 consecutive quantized k of one row: one 8-byte load.
//   - Weights are read once per block through a 4-stage cp.async ring of
//     64-row tiles of 128 packed columns (16-byte copies where Nh % 16 ==
//     0, else 4-byte ones), XOR-swizzled by row so the warp's word reads
//     fall on 32 distinct banks.  x's bf16 rides in the same ring; each
//     stage's x is quantized once, into one shared buffer, just before the
//     stage is multiplied.
//   - A block keeps 1, 2, 4 or 8 tiles of 8 activation rows (by M), so at
//     prefill each weight tile serves up to 64 rows.
//   - One launch per call, no workspace.  Small-N decode shapes split K
//     over up to 8 blocks that form one thread-block cluster: each leaves
//     its int32 partial in its shared memory, and after a cluster barrier
//     every block sums a slice of the tile from all of them through
//     distributed shared memory (exact: integers) and applies the
//     dual-scale epilogue.
//   - At decode (M <= 16, no caller-given scale) the per-token scale is
//     computed here: each block takes the absmax of its rows over its K
//     slice, the cluster exchanges them, and xs = absmax * f32(clip *
//     f32(1/7)) (1 where 0), as core/numerics.mul_div_const rounds it; a
//     NaN in a row makes its xs, and so its output, NaN.
//     Larger M takes xs from the caller (one pass over x there, instead of
//     one per column tile here).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "smem_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace smem_ring;

constexpr int THREADS = 128;        // 4 warps
constexpr int NT = 128;             // packed columns per block, 32 per warp
constexpr int KS = 64;              // k rows per pipeline stage
constexpr int ST = 4;               // pipeline stages
constexpr int XP = KS + 32;         // quantized x row pitch (conflict-free)
constexpr int MAXSPLIT = 8;         // a portable cluster

// Byte offset of (row, col) in a weight tile: thread t reads rows 8t..8t+7
__device__ __forceinline__ int wswz(int row, int col) {
  return swizzle<NT, 3>(row, col);
}

__device__ __forceinline__ void mma(int (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 4x4 byte transpose: w[r] holds row r's bytes of 4 columns; col[j] gets
// column j's bytes of the 4 rows.
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t* col) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

// 4 bf16 of x -> 4 int4 codes clip(rint(x * inv), -8, 7) as bytes.
__device__ __forceinline__ uint32_t quant4(uint2 r, float inv) {
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&r);
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float q = __fmul_rn(__bfloat162float(v[j]), inv);
    q = fminf(fmaxf(rintf(q), -8.0f), 7.0f);
    word |= ((uint32_t)(int32_t)q & 0xFFu) << (8 * j);
  }
  return word;
}

// out[m, p, n..n+3] = bf16(float(v >> 4) * xs * scale2[p, n..n+3]): undo the
// 16x nibble scale, then the reference's epilogue order.
__device__ __forceinline__ void epilogue4(const int32_t (&v)[4], float xs,
                                          const float* __restrict__ scale2,
                                          __nv_bfloat16* __restrict__ out,
                                          int m, int p, int n, int Nh) {
  const float* sc = scale2 + (size_t)p * Nh + n;
  __nv_bfloat16 o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = __float2bfloat16_rn(__fmul_rn(__fmul_rn((float)(v[j] >> 4), xs),
                                         sc[j]));
  *reinterpret_cast<uint2*>(out + ((size_t)m * 2 + p) * Nh + n) =
      *reinterpret_cast<const uint2*>(o);
}

// MT tiles of 8 activation rows per block, CH the weight copy size (16, 4).  grid (ceil(Nh/NT), ceil(M/8MT), nsplit) in clusters
// of (1, 1, nsplit); block z sums k in [z*kchunk, min(K, (z+1)*kchunk)),
// kchunk a multiple of KS.  xs null: the per-token scale is computed here
// (absmax times cmul); a split needs MT <= 2 (its partials fit the ring).
template <int MT, int CH>
__global__ void __launch_bounds__(THREADS)
w4a4_main(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xs,
          const uint8_t* __restrict__ wp, const float* __restrict__ scale2,
          __nv_bfloat16* __restrict__ out, int M, int K, int Nh, int kchunk,
          float cmul) {
  constexpr int ROWS = 8 * MT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ws = smem;                               // ST x KS x NT
  uint8_t* xraw = smem + ST * KS * NT;              // ST x ROWS x KS bf16
  uint8_t* xq = xraw + ST * ROWS * KS * 2;          // ROWS x XP codes
  __shared__ float s_amax[ROWS], s_xs[ROWS], s_inv[ROWS];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * NT, m0 = blockIdx.y * ROWS;
  const int nsplit = gridDim.z;
  const int k0 = blockIdx.z * kchunk, k1 = min(K, k0 + kchunk);
  const int nst = (k1 - k0 + KS - 1) / KS;

  // stage st into ring slot `slot`: the weight tile and x's raw bf16
  auto load = [&](int st, int slot) {
    uint8_t* d = ws + slot * KS * NT;
    for (int c = tid; c < KS * NT / CH; c += THREADS) {
      const int row = c / (NT / CH), col = (c % (NT / CH)) * CH;
      const int k = k0 + st * KS + row, n = n0 + col;
      const bool ok = k < k1 && n < Nh;
      cp_async(d + wswz(row, col), ok ? wp + (size_t)k * Nh + n : wp,
               ok ? CH : 0, CH);
    }
    uint8_t* xd = xraw + slot * ROWS * KS * 2;
    for (int c = tid; c < ROWS * (KS / 8); c += THREADS) {
      const int r = c / (KS / 8), kk = 8 * (c % (KS / 8));
      const int m = m0 + r, k = k0 + st * KS + kk;
      const bool ok = m < M && k < k1;                // K % 8 == 0
      cp_async(xd + (r * KS + kk) * 2, ok ? x + (size_t)m * K + k : x,
               ok ? 16 : 0, 16);
    }
  };

  // the first ST - 1 stages in flight while the scale is found
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nst) load(s, s);
    cp_commit();
  }
  if (xs == nullptr) {
    // absmax of each row over this block's K slice: THREADS / ROWS
    // neighbouring threads per row, loads issued 8 at a time
    constexpr int TPR = THREADS / ROWS;
    const int r = tid / TPR, m = m0 + r, nq = (k1 - k0) / 4;
    // |x| as bits: non-negative floats order as their bits do, and a NaN
    // orders above them all, so it reaches xs and the row's output is NaN
    // as in the plain version
    if (tid < ROWS) s_amax[tid] = 0.0f;
    unsigned a = 0u;
    if (m < M)
      for (int q0 = tid % TPR; q0 < nq; q0 += 8 * TPR) {
        uint2 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int q = q0 + j * TPR;
          v[j] = q < nq ? __ldg(reinterpret_cast<const uint2*>(
                              x + (size_t)m * K + k0 + 4 * q))
                        : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v[j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a = max(a, __float_as_uint(fabsf(__bfloat162float(b[i]))));
        }
      }
    __syncthreads();
    atomicMax(reinterpret_cast<int*>(&s_amax[r]), (int)a);
    if (nsplit > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      if (tid < ROWS) {
        unsigned mx = 0u;
        for (int rank = 0; rank < nsplit; ++rank)
          mx = max(mx, __float_as_uint(
                           *cluster.map_shared_rank(&s_amax[tid], rank)));
        s_xs[tid] = __uint_as_float(mx);
      }
    } else {
      __syncthreads();
      if (tid < ROWS) s_xs[tid] = s_amax[tid];
    }
    if (tid < ROWS)
      s_xs[tid] = s_xs[tid] == 0.0f ? 1.0f : __fmul_rn(s_xs[tid], cmul);
  } else if (tid < ROWS) {
    s_xs[tid] = m0 + tid < M ? xs[m0 + tid] : 1.0f;
  }
  if (tid < ROWS) s_inv[tid] = 1.0f / s_xs[tid];
  __syncthreads();
  int acc[MT][2][2][4];                             // [m tile][u][plane][c]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][u][p][j] = 0;

  const int wcol = 32 * w + 4 * g;                  // this thread's columns
  for (int it = 0; it < nst; ++it) {
    const int ahead = it + ST - 1;
    cp_wait<ST - 2>();
    __syncthreads();
    if (ahead < nst) load(ahead, ahead % ST);
    cp_commit();
    // quantize stage it's x, 4 values per thread and pass
    const uint8_t* xr = xraw + (it % ST) * ROWS * KS * 2;
    for (int e = tid; e < ROWS * (KS / 4); e += THREADS) {
      const int r = e / (KS / 4), kk = 4 * (e % (KS / 4));
      *reinterpret_cast<uint32_t*>(xq + r * XP + kk) = quant4(
          *reinterpret_cast<const uint2*>(xr + (r * KS + kk) * 2), s_inv[r]);
    }
    __syncthreads();
    const uint8_t* W = ws + (it % ST) * KS * NT;
    const uint8_t* X = xq;
#pragma unroll
    for (int s = 0; s < KS / 32; ++s) {
      uint32_t wr[8], lo[4], hi[4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        wr[r] = *reinterpret_cast<const uint32_t*>(
            W + wswz(32 * s + 8 * t + r, wcol));
      transpose4(wr, lo);                           // k 8t..8t+3, column c
      transpose4(wr + 4, hi);                       // k 8t+4..8t+7
      // a[u][plane]: rows g, g+8 = columns 2u, 2u+1
      uint32_t a[2][2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t v[4] = {lo[2 * u], lo[2 * u + 1], hi[2 * u],
                               hi[2 * u + 1]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[u][0][j] = (v[j] << 4) & 0xF0F0F0F0u;  // 16 * low nibble
          a[u][1][j] = v[j] & 0xF0F0F0F0u;         // 16 * high nibble
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            X + (8 * i + g) * XP + 32 * s + 8 * t);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int p = 0; p < 2; ++p)
            mma(acc[i][u][p], a[u][p][0], a[u][p][1], a[u][p][2], a[u][p][3],
                b.x, b.y);
      }
    }
  }
  cp_wait<0>();

  // acc[i][u][p]: c0, c1 = column 4g+2u, rows 2t, 2t+1; c2, c3 = column
  // 4g+2u+1.  Thread's four columns wcol..wcol+3 of tile row 8i + 2t + h:
  // {u0 c h, u0 c 2+h, u1 c h, u1 c 2+h}.
  if (nsplit == 1) {
    const int n = n0 + wcol;
    if (n >= Nh) return;                            // Nh % 4 == 0
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 8 * i + 2 * t + h;
        if (m0 + row >= M) continue;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int32_t v[4] = {acc[i][0][p][h], acc[i][0][p][2 + h],
                                acc[i][1][p][h], acc[i][1][p][2 + h]};
          epilogue4(v, s_xs[row], scale2, out, m0 + row, p, n, Nh);
        }
      }
    return;
  }
  // K split: partials (ROWS, 2, NT) int32 in the idle ring, then block r of
  // the cluster sums quads r, r + nsplit, ... over all blocks
  __syncthreads();
  int4* red = reinterpret_cast<int4*>(ws);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        red[((8 * i + 2 * t + h) * 2 + p) * (NT / 4) + wcol / 4] =
            make_int4(acc[i][0][p][h], acc[i][0][p][2 + h], acc[i][1][p][h],
                      acc[i][1][p][2 + h]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  constexpr int Q = ROWS * 2 * NT / 4;
  for (int qd = rank * THREADS + tid; qd < Q; qd += nsplit * THREADS) {
    int32_t v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int r = 0; r < MAXSPLIT; ++r) {
      if (r >= nsplit) break;
      const int4 o = cluster.map_shared_rank(red, r)[qd];
      v[0] += o.x; v[1] += o.y; v[2] += o.z; v[3] += o.w;
    }
    const int row = qd / (2 * NT / 4), p = (qd / (NT / 4)) % 2;
    const int n = n0 + 4 * (qd % (NT / 4));
    if (m0 + row < M && n < Nh)
      epilogue4(v, s_xs[row], scale2, out, m0 + row, p, n, Nh);
  }
  cluster.sync();                    // no block leaves while read from
}

template <int MT, int CH>
int launch(const void* x, const void* xs, const void* wp, const void* scale2,
           void* out, int M, int K, int Nh, int kchunk, int nsplit,
           float cmul, cudaStream_t s) {
  const int smem = ST * (KS * NT + 8 * MT * KS * 2) + 8 * MT * XP;
  static bool ready = false;
  cudaError_t e = allow_smem(w4a4_main<MT, CH>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Nh + NT - 1) / NT, (M + 8 * MT - 1) / (8 * MT), nsplit);
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
  e = cudaLaunchKernelEx(
      &cfg, w4a4_main<MT, CH>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(xs), static_cast<const uint8_t*>(wp),
      static_cast<const float*>(scale2), static_cast<__nv_bfloat16*>(out), M,
      K, Nh, kchunk, cmul);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int CH>
int launch_m(int mt, const void* x, const void* xs, const void* wp,
             const void* scale2, void* out, int M, int K, int Nh, int kchunk,
             int nsplit, float cmul, cudaStream_t s) {
  switch (mt) {
    case 1: return launch<1, CH>(x, xs, wp, scale2, out, M, K, Nh, kchunk,
                                 nsplit, cmul, s);
    case 2: return launch<2, CH>(x, xs, wp, scale2, out, M, K, Nh, kchunk,
                                 nsplit, cmul, s);
    case 4: return launch<4, CH>(x, xs, wp, scale2, out, M, K, Nh, kchunk, 1,
                                 cmul, s);
    case 8: return launch<8, CH>(x, xs, wp, scale2, out, M, K, Nh, kchunk, 1,
                                 cmul, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// mt: tiles of 8 activation rows per block (1, 2, 4 or 8); nsplit <= 8 K
// slices of kchunk rows (a multiple of 64), only with mt <= 2.  xs: the
// caller's (M,) per-token scales, or null to compute them here as absmax *
// cmul.  Needs K % 8 == 0, Nh % 4 == 0, x 16-byte aligned; wide16 = Nh % 16
// == 0 and wp 16-byte aligned (else 4-byte aligned).  The wrapper checks.
extern "C" int w4a4_matmul_paired_stacked_launch(
    const void* x, const void* xs, const void* wp_layer, const void* scale2,
    void* out, int M, int K, int Nh, int kchunk, int nsplit, int mt,
    int wide16, float cmul, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsplit < 1 || nsplit > MAXSPLIT || (nsplit > 1 && mt > 2))
    return (int)cudaErrorInvalidValue;
  return wide16 ? launch_m<16>(mt, x, xs, wp_layer, scale2, out, M, K, Nh,
                               kchunk, nsplit, cmul, s)
                : launch_m<4>(mt, x, xs, wp_layer, scale2, out, M, K, Nh,
                              kchunk, nsplit, cmul, s);
}
