// Dense bf16 matmul against one layer of stacked (L, K, N) weights.
//
// Replaces: rsq_tpu/kernels/matmul_w4.py w16_matmul_stacked (:822), Pallas
//   body _w16_kernel_pref (:802).
// Computes: y = x @ w_all[layer] for bf16 x (M, K) and bf16 weights read in
//   place at the layer's offset (no copy), products exact in f32, sums in
//   f32, one rounding to the output type (bf16 or f32).
// Bound on this card: at decode (M = 8) the weight bytes -- 2*K*N per call,
//   436 MB for one Llama-3-8B layer's seven products, 0.13 ms at 3.35 TB/s.
//   At prefill (M = 1024) the bf16 tensor-core operations, 2*M*K*N.
// Design: warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate) on tiles
//   staged through shared memory with 16-byte coalesced loads.  Two tile
//   shapes: M <= 16 takes 16-row blocks (rows past M are zeros) with a
//   64-deep K step and four warps side by side along N -- a weight stream;
//   larger M takes 64x128 blocks of four 32x64 warp tiles.  Where the
//   output tiles alone cannot fill the card's 132 SMs, K is split across
//   blocks: each slice writes f32 partial sums to a scratch and a second
//   kernel adds the slices in a fixed order, so every run gives the same
//   bits (no float atomics).  No TMA, no wgmma and no software pipelining
//   yet: loads and products of a tile do not overlap within a block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One (BM x BN) output tile over K range [k0, k1) of x (M, K) @ w (K, N).
// WM x WN warps; each warp owns a (BM/WM) x (BN/WN) sub-tile of
// (BM/WM/16) x (BN/WN/8) mma tiles.  Writes y (TOut) or, with a K split,
// the f32 partial of slice blockIdx.z.
template <int BM, int BN, int BK, int WM, int WN, typename TOut>
__global__ void __launch_bounds__(THREADS)
w16_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
        TOut* __restrict__ y, float* __restrict__ part, int M, int K, int N,
        int kchunk) {
  static_assert(WM * WN * 32 == THREADS, "four warps");
  constexpr int TM = BM / WM / 16, TN = BN / WN / 8;
  constexpr int AS = BK + 8, BS = BN + 8;   // padded rows: conflict-free frags
  __shared__ __align__(16) __nv_bfloat16 As[BM][AS];
  __shared__ __align__(16) __nv_bfloat16 Bs[BK][BS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k0 = blockIdx.z * kchunk, k1 = min(K, k0 + kchunk);

  float acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  for (int ks = k0; ks < k1; ks += BK) {
    // stage A (BM x BK) and B (BK x BN) in 8-value chunks; K % 8 == 0 and
    // N % 8 == 0, so a chunk is wholly inside or wholly outside the matrix
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = 8 * (i % (BK / 8));
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && ks + c < k1)
        v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + ks + c));
      *reinterpret_cast<uint4*>(&As[r][c]) = v;
    }
    for (int i = tid; i < BK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
      uint4 v = make_uint4(0, 0, 0, 0);
      if (ks + r < k1 && n0 + c < N)
        v = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(ks + r) * N + n0 + c));
      *reinterpret_cast<uint4*>(&Bs[r][c]) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = wm * (BM / WM) + 16 * i + gid, c = kk + 2 * tig;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][c]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][c + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c + 8]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = wn * (BN / WN) + 8 * j + gid, r = kk + 2 * tig;
        const uint16_t* bcol = reinterpret_cast<const uint16_t*>(&Bs[0][n]);
        const uint32_t b0 = bcol[r * BS] | ((uint32_t)bcol[(r + 1) * BS] << 16);
        const uint32_t b1 = bcol[(r + 8) * BS] | ((uint32_t)bcol[(r + 9) * BS] << 16);
#pragma unroll
        for (int i = 0; i < TM; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();
  }

  float* pz = part == nullptr ? nullptr : part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * (BM / WM) + 16 * i + gid + (r >= 2 ? 8 : 0);
        const int n = n0 + wn * (BN / WN) + 8 * j + 2 * tig + (r & 1);
        if (m < M && n < N) {
          if (pz != nullptr) pz[(size_t)m * N + n] = acc[i][j][r];
          else store(y + (size_t)m * N + n, acc[i][j][r]);
        }
      }
}

// y = sum over the K slices of the partials, in slice order
template <typename TOut>
__global__ void w16_reduce(const float* __restrict__ part, TOut* __restrict__ y,
                           size_t MN, int nsplit) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < nsplit; ++z) s = __fadd_rn(s, part[z * MN + i]);
    store(y + i, s);
  }
}

template <typename TOut>
int launch(const __nv_bfloat16* x, const __nv_bfloat16* w, TOut* y,
           float* part, int M, int K, int N, int kchunk, cudaStream_t s) {
  const int nsplit = (K + kchunk - 1) / kchunk;
  float* pz = nsplit > 1 ? part : nullptr;
  if (M <= 16) {
    dim3 grid((N + 127) / 128, 1, nsplit);
    w16_mma<16, 128, 64, 1, 4, TOut><<<grid, THREADS, 0, s>>>(x, w, y, pz, M, K, N, kchunk);
  } else {
    dim3 grid((N + 127) / 128, (M + 63) / 64, nsplit);
    w16_mma<64, 128, 32, 2, 2, TOut><<<grid, THREADS, 0, s>>>(x, w, y, pz, M, K, N, kchunk);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  const size_t MN = (size_t)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  w16_reduce<TOut><<<blocks, 256, 0, s>>>(part, y, MN, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// kchunk: K values per slice (a multiple of the K step, 64); part: f32
// scratch of (K / kchunk) * M * N values, unused when kchunk >= K.
extern "C" int w16_matmul_stacked_launch(const void* x, const void* w_layer,
                                         void* y, void* part, int M, int K,
                                         int N, int kchunk, int out_f32,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w_layer);
  float* pf = static_cast<float*>(part);
  if (out_f32)
    return launch(xb, wb, static_cast<float*>(y), pf, M, K, N, kchunk, s);
  return launch(xb, wb, static_cast<__nv_bfloat16*>(y), pf, M, K, N, kchunk, s);
}
