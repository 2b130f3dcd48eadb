// Weight-only INT4 matmul (bf16 activations) against one layer of stacked
// packed INT4 weights, with two epilogues.
//
// Replaces: rsq_tpu/kernels/matmul_w4.py
//   - w4_matmul_paired_stacked (:665), Pallas body _w4_kernel_pref (:626):
//     the per-column paired scale;
//   - w4_affine_matmul_stacked (:747), body _w4_affine_kernel_pref (:712):
//     the per-tensor scale with the +0.5 rank-1 term (E8P re-encoded);
//   - w4_matmul (:143), body _w4_matmul_kernel (:122): the int4 lm_head,
//     through an L = 1 view and the paired scale;
//   - on L = 1 views of unstacked weights, w4_matmul_paired (:190, the
//     paired scale) and w4_affine_matmul (:269, body _w4_affine_kernel
//     :246, the affine epilogue).
// Computes: acc[m, p, j] = sum_k x[m, k] * q_p(w[k, j]) for bf16 x (M, K)
//   and the layer's packed bytes w (K, Nh), read in place: byte (k, j)
//   holds q_0 in its low nibble and q_1 in its high nibble, two's-complement
//   int4.  bf16 x int4 products are exact in f32; sums are f32.  Output is
//   plane-paired (M, 2, Nh) bf16:
//     scale2: out = bf16(acc * scale2[p, j]);
//     affine: out = bf16((acc + 0.5 * xsum[m]) * sh), sh read from device
//             memory (a pointer to sh_all[layer]: no host scalar, no sync),
//             xsum the f32 row sums of x, computed by the caller.
// Bound on this card: at decode (M = 8) the weight bytes, K*Nh per call --
//   109 MB per Llama-3-8B layer, 0.033 ms at 3.35 TB/s.  At prefill
//   (M = 1024) the bf16 tensor-core operations, 2*M*K*2Nh.
// Design: the tiling of w16_matmul.cu -- warp-level mma.sync.m16n8k16 (bf16
//   in, f32 accumulate) on tiles staged through shared memory; 16-row blocks
//   with a 64-deep K step at M <= 16 (a weight stream), 64-row blocks with a
//   32-deep step above.  A block's B tile is BNH packed columns, staged as
//   BK x 2*BNH bf16: the low plane in the first BNH columns, the high plane
//   in the rest.  Nibbles become bf16 while they are staged: q + 8 =
//   nib ^ 8, and the bf16 bits 0x4300 | (q + 8) are the value 136 + q, so
//   one bf16x2 subtraction of 136 gives q exactly, two columns at a time.
//   No +8 bias is carried into the products (the TPU kernel's biased dot is
//   a workaround for its compiler's int8 unpack).  The next K step's x and
//   weight chunks are loaded into registers while the current step's
//   products run.  Where the output tiles alone cannot fill the 132 SMs, K
//   is split across blocks: each slice writes f32 partial sums to a scratch
//   and a second kernel adds the slices in a fixed order and applies the
//   epilogue, so every run gives the same bits (no float atomics).  No TMA
//   and no wgmma yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int kScale2 = 0, kAffine = 1;
// The affine format's offset: E8P re-encodes to v = (q + 0.5) * sh.
constexpr float kZero = 0.5f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Epilogue of one sum: m its row, pj = plane * Nh + packed column.
template <int EPI>
__device__ __forceinline__ float finish(float acc, int m, int pj,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ xsum) {
  if (EPI == kScale2) return __fmul_rn(acc, scale[pj]);
  return __fmul_rn(__fadd_rn(acc, __fmul_rn(kZero, xsum[m])), scale[0]);
}

// Four packed bytes (columns c..c+3 of one k) -> bf16 pairs of one plane:
// out[0] = (c, c+1), out[1] = (c+2, c+3).
__device__ __forceinline__ void nibbles_to_bf16(uint32_t nib, uint32_t (&out)[2]) {
  const uint32_t b = (nib & 0x0F0F0F0Fu) ^ 0x08080808u;          // q + 8
  const __nv_bfloat162 k136 = __halves2bfloat162(
      __ushort_as_bfloat16(0x4308), __ushort_as_bfloat16(0x4308));
  uint32_t p0 = __byte_perm(b, 0x43434343u, 0x4140);             // 136+q0, 136+q1
  uint32_t p1 = __byte_perm(b, 0x43434343u, 0x4342);             // 136+q2, 136+q3
  __nv_bfloat162 r0 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p0), k136);
  __nv_bfloat162 r1 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p1), k136);
  out[0] = *reinterpret_cast<uint32_t*>(&r0);
  out[1] = *reinterpret_cast<uint32_t*>(&r1);
}

// One (BM x 2*BNH) output tile over K range [k0, k1).  WM x WN warps; each
// warp owns a (BM/WM) x (BN/WN) sub-tile of (BM/WM/16) x (BN/WN/8) mma
// tiles.  Writes the finished output or, with a K split, the f32 partial
// of slice blockIdx.z.
template <int BM, int BNH, int BK, int WM, int WN, int EPI, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
w4_mma(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
       const float* __restrict__ scale, const float* __restrict__ xsum,
       __nv_bfloat16* __restrict__ y, float* __restrict__ part,
       int M, int K, int Nh, int kchunk) {
  constexpr int BN = 2 * BNH;
  static_assert(WM * WN * 32 == THREADS, "four warps");
  constexpr int TM = BM / WM / 16, TN = BN / WN / 8;
  constexpr int AS = BK + 8, BS = BN + 8;   // padded rows: conflict-free frags
  constexpr int A_CH = BM * BK / 8, B_CH = BK * BNH / 16;   // 16-byte chunks
  static_assert(A_CH % THREADS == 0 && B_CH % THREADS == 0, "whole chunks");
  constexpr int NA = A_CH / THREADS, NB = B_CH / THREADS;
  __shared__ __align__(16) __nv_bfloat16 As[BM][AS];
  __shared__ __align__(16) __nv_bfloat16 Bs[BK][BS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BNH, m0 = blockIdx.y * BM;
  const int k0 = blockIdx.z * kchunk, k1 = min(K, k0 + kchunk);

  float acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  // K % 8 == 0 and kchunk % 64 == 0: every x chunk lies wholly inside or
  // wholly outside the matrix (outside: zeros).  ALIGNED (Nh % 16 == 0 and
  // a 16-byte aligned layer) loads weight chunks whole too; otherwise byte
  // by byte, masking the ragged last columns (outside: zero bytes, q = 0).
  uint4 ra[NA], rb[NB];
  auto load = [&](int ks) {
#pragma unroll
    for (int t = 0; t < NA; ++t) {
      const int i = tid + t * THREADS;
      const int r = i / (BK / 8), c = 8 * (i % (BK / 8));
      ra[t] = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && ks + c < k1)
        ra[t] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + ks + c));
    }
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      const int i = tid + t * THREADS;
      const int r = i / (BNH / 16), c = 16 * (i % (BNH / 16));
      rb[t] = make_uint4(0, 0, 0, 0);
      if (ks + r >= k1) continue;
      const uint8_t* src = w + (size_t)(ks + r) * Nh + n0 + c;
      if (ALIGNED) {
        if (n0 + c < Nh) rb[t] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (n0 + c + b < Nh) v[b / 4] |= (uint32_t)__ldg(src + b) << (8 * (b % 4));
        rb[t] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  load(k0);
  for (int ks = k0; ks < k1; ks += BK) {
#pragma unroll
    for (int t = 0; t < NA; ++t) {
      const int i = tid + t * THREADS;
      const int r = i / (BK / 8), c = 8 * (i % (BK / 8));
      *reinterpret_cast<uint4*>(&As[r][c]) = ra[t];
    }
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      const int i = tid + t * THREADS;
      const int r = i / (BNH / 16), c = 16 * (i % (BNH / 16));
      const uint32_t words[4] = {rb[t].x, rb[t].y, rb[t].z, rb[t].w};
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t l2[2], h2[2];
        nibbles_to_bf16(words[q], l2);
        nibbles_to_bf16(words[q] >> 4, h2);
        lo[2 * q] = l2[0]; lo[2 * q + 1] = l2[1];
        hi[2 * q] = h2[0]; hi[2 * q + 1] = h2[1];
      }
      uint4* dl = reinterpret_cast<uint4*>(&Bs[r][c]);
      uint4* dh = reinterpret_cast<uint4*>(&Bs[r][BNH + c]);
      dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    __syncthreads();
    if (ks + BK < k1) load(ks + BK);   // in flight during the products

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

  float* pz = part == nullptr ? nullptr : part + (size_t)blockIdx.z * M * 2 * Nh;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * (BM / WM) + 16 * i + gid + (r >= 2 ? 8 : 0);
        const int n = wn * (BN / WN) + 8 * j + 2 * tig + (r & 1);   // < BN
        const int col = n0 + (n % BNH);
        if (m < M && col < Nh) {
          const int pj = (n / BNH) * Nh + col;
          const size_t o = (size_t)m * 2 * Nh + pj;
          if (pz != nullptr) pz[o] = acc[i][j][r];
          else y[o] = __float2bfloat16_rn(
              finish<EPI>(acc[i][j][r], m, pj, scale, xsum));
        }
      }
}

// y = epilogue(sum over the K slices of the partials, in slice order)
template <int EPI>
__global__ void w4_reduce(const float* __restrict__ part,
                          __nv_bfloat16* __restrict__ y,
                          const float* __restrict__ scale,
                          const float* __restrict__ xsum, int M,
                          int Nh, int nsplit) {
  const size_t MN = (size_t)M * 2 * Nh;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < nsplit; ++z) s = __fadd_rn(s, part[z * MN + i]);
    const int m = (int)(i / (2 * (size_t)Nh)), pj = (int)(i % (2 * (size_t)Nh));
    y[i] = __float2bfloat16_rn(finish<EPI>(s, m, pj, scale, xsum));
  }
}

template <int EPI, bool ALIGNED>
int launch(const __nv_bfloat16* x, const uint8_t* w, const float* scale,
           const float* xsum, __nv_bfloat16* y, float* part,
           int M, int K, int Nh, int kchunk, cudaStream_t s) {
  const int nsplit = (K + kchunk - 1) / kchunk;
  float* pz = nsplit > 1 ? part : nullptr;
  if (M <= 16) {
    dim3 grid((Nh + 127) / 128, 1, nsplit);
    w4_mma<16, 128, 64, 1, 4, EPI, ALIGNED><<<grid, THREADS, 0, s>>>(
        x, w, scale, xsum, y, pz, M, K, Nh, kchunk);
  } else {
    dim3 grid((Nh + 63) / 64, (M + 63) / 64, nsplit);
    w4_mma<64, 64, 32, 2, 2, EPI, ALIGNED><<<grid, THREADS, 0, s>>>(
        x, w, scale, xsum, y, pz, M, K, Nh, kchunk);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  const size_t MN = (size_t)M * 2 * Nh;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  w4_reduce<EPI><<<blocks, 256, 0, s>>>(part, y, scale, xsum, M, Nh, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, 16-byte aligned, K % 8 == 0; w_layer (K, Nh) packed
// bytes (aligned: Nh % 16 == 0 and w_layer 16-byte aligned); y (M, 2, Nh)
// bf16.  affine = 0: scale is scale2 (2, Nh) f32, xsum unused.
// affine = 1: scale points to the layer's f32 sh, xsum (M,) f32.
// kchunk: K values per slice (a multiple of 64); part: f32 scratch of
// (K / kchunk) * M * 2 * Nh values, unused when kchunk >= K.
extern "C" int w4_matmul_paired_stacked_launch(
    const void* x, const void* w_layer, const void* scale, const void* xsum,
    void* y, void* part, int M, int K, int Nh, int kchunk,
    int affine, int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w_layer);
  const float* sc = static_cast<const float*>(scale);
  const float* xs = static_cast<const float*>(xsum);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  float* pf = static_cast<float*>(part);
  if (affine && aligned)
    return launch<kAffine, true>(xb, wb, sc, xs, yb, pf, M, K, Nh, kchunk, s);
  if (affine)
    return launch<kAffine, false>(xb, wb, sc, xs, yb, pf, M, K, Nh, kchunk, s);
  if (aligned)
    return launch<kScale2, true>(xb, wb, sc, xs, yb, pf, M, K, Nh, kchunk, s);
  return launch<kScale2, false>(xb, wb, sc, xs, yb, pf, M, K, Nh, kchunk, s);
}
