// Weight-only INT8 matmul with a per-output-column scale (the int8 lm_head).
//
// Replaces: rsq_tpu/kernels/matmul_w4.py w8_matmul (:899),
//   Pallas body _w8_kernel (:875).
// Computes: out[m, n] = bf16((sum_k x[m, k] * w8[k, n]) * scale[n]) with bf16
//   x, int8 w8 widened exactly, and f32 accumulation: the reference's
//   jnp.dot(x, w.astype(bf16), preferred_element_type=f32) (matmul_w4.py
//   :886-888) with the sums in another order.
// Bound on this card: the weight bytes.  At the Llama-3-8B lm_head,
//   (8, 4096) x (4096, 128256), that is a 525 MB stream per call; the
//   arithmetic (2*M*K*N) is tiny beside it.
// Design: bf16 tensor cores, mma.sync.m16n8k16 (f32 accumulate).  Every
//   int8 value is exact in bf16, and so is its product with a bf16 x.
//   - The operands are swapped: 16 output columns are the mma's m side and
//     the <= 8 activation rows its n side, so no tensor-core work is spent
//     on padding rows.
//   - A block of 4 warps owns 128 columns; each warp 32, as two mma tiles.
//     The mma's row i and reduction index kappa are free to stand for any
//     column and k, so thread (g = lane/4, t = lane%4) is given columns
//     4g..4g+3 and k = 4t..4t+3 of each 16-k step: it reads one 32-bit word
//     of 4 columns from each of 4 weight rows and widens every byte to
//     bf16 in registers (a byte under the f32 magic 2^23, minus the magic,
//     is exact; its upper half is the bf16), and its x fragment is 4
//     consecutive k of one row, one 8-byte load.
//   - Weights stay in their (K, N) layout and are read once, through a
//     4-stage cp.async ring of 64-row tiles in shared memory: 16-byte
//     copies where N % 16 == 0, else 4-byte ones (N % 4 == 0); the weight
//     tile's 16-byte chunks are XOR-swizzled by row, so the warp's word
//     reads fall on 32 distinct banks.  x rides in the same ring.
//   - One pass over K per block (1002 blocks at N = 128256): the sum
//     order is fixed and runs repeat bit for bit.  M > 8 keeps 2 or 4
//     tiles of 8 rows per block and loops over them; the ragged last
//     column tile and rows past M are zero-filled and masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "smem_ring.cuh"

namespace {

using namespace smem_ring;

constexpr int THREADS = 128;        // 4 warps
constexpr int NT = 128;             // output columns per block
constexpr int KS = 64;              // k rows per pipeline stage
constexpr int STAGES = 4;
constexpr int XP = KS * 2 + 32;     // x row pitch in bytes (conflict-free reads)

// Byte offset of (row, col) in a weight tile: thread t reads rows 4t..4t+3
__device__ __forceinline__ int wswz(int row, int col) {
  return swizzle<NT, 2>(row, col);
}

// Signed byte c of w (pre-XORed with 0x80808080) as a float, exactly.
__device__ __forceinline__ float byte_f32(uint32_t w, int c) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | c)) - 8388736.0f;
}

// Two exact small-integer floats -> bf16x2 (their upper halves), lo first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// MT tiles of 8 activation rows per block; CH the weight copy size (16, 4).
template <int MT, int CH>
__global__ void __launch_bounds__(THREADS)
w8_main(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w8,
        const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
        int M, int K, int N) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ws = smem;                               // STAGES x KS x NT
  uint8_t* xs = smem + STAGES * KS * NT;            // STAGES x 8MT x XP
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * NT, m0 = blockIdx.y * 8 * MT;
  const int nst = (K + KS - 1) / KS;

  auto load = [&](int st, int slot) {
    const int k0 = st * KS;
    uint8_t* wd = ws + slot * KS * NT;
    for (int c = tid; c < KS * NT / CH; c += THREADS) {
      const int row = c / (NT / CH), col = (c % (NT / CH)) * CH;
      const int k = k0 + row, n = n0 + col;
      const bool ok = k < K && n < N;
      cp_async(wd + wswz(row, col), ok ? w8 + (size_t)k * N + n : w8,
               ok ? CH : 0, CH);
    }
    uint8_t* xd = xs + slot * 8 * MT * XP;
    for (int c = tid; c < 8 * MT * (KS / 8); c += THREADS) {
      const int r = c / (KS / 8), kk = (c % (KS / 8)) * 8;
      const int m = m0 + r, k = k0 + kk;
      const bool ok = m < M && k < K;                // K % 8 == 0
      cp_async(xd + r * XP + kk * 2, ok ? x + (size_t)m * K + k : x,
               ok ? 16 : 0, 16);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][u][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s, s);
    cp_commit();
  }
  const int wcol = 32 * w + 4 * g;                  // this thread's columns
  for (int it = 0; it < nst; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < nst) load(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_commit();
    const uint8_t* W = ws + (it % STAGES) * KS * NT;
    const uint8_t* X = xs + (it % STAGES) * 8 * MT * XP;
#pragma unroll
    for (int s = 0; s < KS / 16; ++s) {
      uint32_t wr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wr[r] = *reinterpret_cast<const uint32_t*>(
                    W + wswz(16 * s + 4 * t + r, wcol)) ^ 0x80808080u;
      // a[c][i]: column 4g+c, k pair i (k 4t..4t+1, then 4t+2..4t+3)
      uint32_t a[4][2];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        a[c][0] = pack_bf16(byte_f32(wr[0], c), byte_f32(wr[1], c));
        a[c][1] = pack_bf16(byte_f32(wr[2], c), byte_f32(wr[3], c));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            X + (8 * i + g) * XP + (16 * s + 4 * t) * 2);
#pragma unroll
        for (int u = 0; u < 2; ++u)
          mma(acc[i][u], a[2 * u][0], a[2 * u + 1][0], a[2 * u][1],
              a[2 * u + 1][1], b.x, b.y);
      }
    }
  }
  cp_wait<0>();

  // acc[i][u]: c0, c1 = column 4g+2u, rows 2t, 2t+1; c2, c3 = column 4g+2u+1
  const int n = n0 + wcol;
  if (n >= N) return;                               // N % 4 == 0
  const float sc[4] = {scale[n], scale[n + 1], scale[n + 2], scale[n + 3]};
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * i + 2 * t + h;
      if (m >= M) continue;
      __nv_bfloat162 lo = __halves2bfloat162(
          __float2bfloat16_rn(__fmul_rn(acc[i][0][h], sc[0])),
          __float2bfloat16_rn(__fmul_rn(acc[i][0][2 + h], sc[1])));
      __nv_bfloat162 hi = __halves2bfloat162(
          __float2bfloat16_rn(__fmul_rn(acc[i][1][h], sc[2])),
          __float2bfloat16_rn(__fmul_rn(acc[i][1][2 + h], sc[3])));
      uint2 v;
      v.x = *reinterpret_cast<uint32_t*>(&lo);
      v.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out + (size_t)m * N + n) = v;
    }
}

template <int MT, int CH>
int launch(const void* x, const void* w8, const void* scale, void* out, int M,
           int K, int N, cudaStream_t s) {
  const int smem = STAGES * (KS * NT + 8 * MT * XP);
  static bool ready = false;
  const cudaError_t e = allow_smem(w8_main<MT, CH>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + NT - 1) / NT, (M + 8 * MT - 1) / (8 * MT));
  w8_main<MT, CH><<<grid, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w8),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      M, K, N);
  return (int)cudaGetLastError();
}

template <int CH>
int launch_m(const void* x, const void* w8, const void* scale, void* out,
             int M, int K, int N, cudaStream_t s) {
  if (M <= 8) return launch<1, CH>(x, w8, scale, out, M, K, N, s);
  if (M <= 16) return launch<2, CH>(x, w8, scale, out, M, K, N, s);
  return launch<4, CH>(x, w8, scale, out, M, K, N, s);
}

}  // namespace

// Needs K % 8 == 0, N % 4 == 0, x 16-byte aligned and w8 4-byte aligned
// (the wrapper checks); wide16 = N % 16 == 0 and w8 16-byte aligned.
extern "C" int w8_matmul_launch(const void* x, const void* w8,
                                const void* scale, void* out, int M, int K,
                                int N, int wide16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide16 ? launch_m<16>(x, w8, scale, out, M, K, N, s)
                : launch_m<4>(x, w8, scale, out, M, K, N, s);
}
