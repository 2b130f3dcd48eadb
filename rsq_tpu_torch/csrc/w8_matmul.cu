// Weight-only INT8 matmul with a per-output-column scale (the int8 lm_head).
//
// Replaces: rsq_tpu/kernels/matmul_w4.py w8_matmul (:899),
//   Pallas body _w8_kernel (:875).
// Computes: out[m, n] = bf16((sum_k x[m, k] * w8[k, n]) * scale[n]) with bf16
//   x, int8 w8 widened exactly, and f32 accumulation.
// Bound on this card: the weight bytes.  At the Llama-3-8B lm_head,
//   (8, 4096) x (4096, 128256), that is a 525 MB stream per call; the
//   arithmetic (2*M*K*N) is tiny beside it.
// Design: each thread owns 4 adjacent output columns and walks K with one
//   coalesced 32-bit load per row (neighbouring threads read neighbouring
//   words of the row), keeping 8 rows x 4 columns of f32 sums in registers;
//   x for the block's 8 rows is staged through shared memory.  No split over
//   K: N is wide enough to fill the card, and a single pass keeps the sum
//   order fixed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MT = 8;
constexpr int THREADS = 64;
constexpr int COLS = 4 * THREADS;
constexpr int KSTAGE = 256;

__global__ void __launch_bounds__(THREADS)
w8_main(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w8,
        const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
        int M, int K, int N) {
  __shared__ float xs[MT][KSTAGE];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * COLS + 4 * tid;      // N % 4 == 0
  const int m0 = blockIdx.y * MT;
  const bool col_ok = n < N;
  float acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;

  for (int ks = 0; ks < K; ks += KSTAGE) {
    const int kn = min(KSTAGE, K - ks);
    __syncthreads();
    for (int i = tid; i < MT * KSTAGE; i += THREADS) {
      const int r = i / KSTAGE, k = i % KSTAGE;
      const int m = m0 + r;
      xs[r][k] = (m < M && k < kn) ? __bfloat162float(x[(size_t)m * K + ks + k])
                                   : 0.0f;
    }
    __syncthreads();
    if (!col_ok) continue;
    const int8_t* p = w8 + (size_t)ks * N + n;
#pragma unroll 8
    for (int k = 0; k < kn; ++k) {
      const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(p + (size_t)k * N));
      float wf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wf[j] = (float)(int8_t)(w >> (8 * j));
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float a = xs[r][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(a, wf[j], acc[r][j]);
      }
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(size_t)m * N + n + j] =
          __float2bfloat16_rn(__fmul_rn(acc[r][j], scale[n + j]));
  }
}

}  // namespace

extern "C" int w8_matmul_launch(const void* x, const void* w8,
                                const void* scale, void* out, int M, int K,
                                int N, void* stream) {
  dim3 grid((N + COLS - 1) / COLS, (M + MT - 1) / MT);
  w8_main<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w8),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      M, K, N);
  return (int)cudaGetLastError();
}
