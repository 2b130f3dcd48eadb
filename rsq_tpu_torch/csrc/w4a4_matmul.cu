// W4A4 matmul against one layer of stacked plane-major INT4 weights.
//
// Replaces: rsq_tpu/kernels/matmul_w4.py w4a4_matmul_paired_stacked (:559),
//   Pallas body _w4a4_kernel_i8_pref (:523); and, on an L = 1 view of
//   unstacked weights, w4a4_matmul_paired (:458) with both of its bodies,
//   _w4a4_kernel_i8 (:369, decode) and _w4a4_kernel (:401, bf16, prefill):
//   all three sum the same integer products exactly.
// Computes: xq = clip(rint(x * (1/xs)), -8, 7) per row (xs = per-token
//   absmax*clip/7, computed by the caller), acc = xq . W (exact int32),
//   out[m, p, j] = bf16(float(acc) * xs[m] * scale2[p, j]).
//   Weight byte (k, j) holds output j in its low nibble and output Nh + j in
//   its high nibble, both two's-complement int4 (plane-major layout).
// Bound on this card: at decode (M = 8) the weight bytes -- K*Nh per call,
//   about 109 MB per Llama-3-8B layer -- so the card's memory rate.  At
//   prefill (M = 512..1024) the integer operations (2*M*K*2Nh).
// Design: each thread owns 4 adjacent packed columns and streams them down
//   K with 32-bit coalesced loads, 4 rows at a time; a 4x4 byte transpose
//   (__byte_perm) turns them into one word of 4 consecutive k per column.
//   Masking a word with 0xF0F0F0F0 (after a 4-bit shift for the low plane)
//   leaves each nibble as a signed byte worth 16*q, so one __dp4a per
//   (row, column, plane) accumulates 16x the exact dot with no unpacking
//   and no +8 bias; the epilogue shifts the 16 back out.  A block covers 8
//   activation rows and a slice of K; slices are summed with int32 atomics
//   (exact and order-independent), so small-N decode shapes still launch
//   enough blocks to keep the memory system busy.  No tensor cores yet:
//   prefill re-reads each weight tile once per 8 rows (mma.sync / wgmma
//   s8 tiles are later work).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MT = 8;          // activation rows per block
constexpr int THREADS = 128;   // each owns 4 packed columns
constexpr int COLS = 4 * THREADS;
constexpr int KSTAGE = 64;     // k values of x quantized into smem per stage

__global__ void __launch_bounds__(THREADS)
w4a4_main(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xs,
          const uint8_t* __restrict__ wp, int32_t* __restrict__ acc,
          int M, int K, int Nh, int kchunk) {
  __shared__ int32_t xq_s[MT][KSTAGE / 4];
  const int tid = threadIdx.x;
  const int c = blockIdx.x * COLS + 4 * tid;      // first packed column
  const int m0 = blockIdx.y * MT;
  const int k0 = blockIdx.z * kchunk;
  const int k1 = min(K, k0 + kchunk);
  const bool col_ok = c < Nh;                     // Nh % 4 == 0

  int32_t alo[MT][4], ahi[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) { alo[r][j] = 0; ahi[r][j] = 0; }

  for (int ks = k0; ks < k1; ks += KSTAGE) {
    const int kn = min(KSTAGE, k1 - ks);          // multiple of 4
    __syncthreads();
    // quantize x[m0:m0+8, ks:ks+kn] into packed int8 words
    for (int w = tid; w < MT * (KSTAGE / 4); w += THREADS) {
      const int r = w / (KSTAGE / 4), kw = w % (KSTAGE / 4);
      const int m = m0 + r;
      uint32_t word = 0;
      if (m < M && 4 * kw < kn) {
        const float inv = 1.0f / xs[m];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = __bfloat162float(x[(size_t)m * K + ks + 4 * kw + i]);
          v = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -8.0f), 7.0f);
          word |= ((uint32_t)(int32_t)v & 0xFFu) << (8 * i);
        }
      }
      xq_s[r][kw] = (int32_t)word;
    }
    __syncthreads();
    if (!col_ok) continue;
    const uint8_t* base = wp + (size_t)ks * Nh + c;
#pragma unroll 4
    for (int kw = 0; kw < kn / 4; ++kw) {
      const uint8_t* p = base + (size_t)(4 * kw) * Nh;
      const uint32_t w0 = __ldg(reinterpret_cast<const uint32_t*>(p));
      const uint32_t w1 = __ldg(reinterpret_cast<const uint32_t*>(p + Nh));
      const uint32_t w2 = __ldg(reinterpret_cast<const uint32_t*>(p + 2 * (size_t)Nh));
      const uint32_t w3 = __ldg(reinterpret_cast<const uint32_t*>(p + 3 * (size_t)Nh));
      // 4x4 byte transpose: col[j] = bytes (k..k+3) of packed column c+j
      const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
      const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
      const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
      const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
      uint32_t col[4];
      col[0] = __byte_perm(t0, t2, 0x5410);
      col[1] = __byte_perm(t0, t2, 0x7632);
      col[2] = __byte_perm(t1, t3, 0x5410);
      col[3] = __byte_perm(t1, t3, 0x7632);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lo16 = (int)((col[j] << 4) & 0xF0F0F0F0u);  // 16 * q_lo
        const int hi16 = (int)(col[j] & 0xF0F0F0F0u);         // 16 * q_hi
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const int a = xq_s[r][kw];
          alo[r][j] = __dp4a(a, lo16, alo[r][j]);
          ahi[r][j] = __dp4a(a, hi16, ahi[r][j]);
        }
      }
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
    int32_t* row = acc + (size_t)m * 2 * Nh;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      atomicAdd(row + c + j, alo[r][j]);
      atomicAdd(row + Nh + c + j, ahi[r][j]);
    }
  }
}

__global__ void w4a4_epilogue(const int32_t* __restrict__ acc,
                              const float* __restrict__ xs,
                              const float* __restrict__ scale2,
                              __nv_bfloat16* __restrict__ out, int M, int Nh) {
  const size_t n = (size_t)M * 2 * Nh;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / (2 * (size_t)Nh));
    const int pj = (int)(i % (2 * (size_t)Nh));     // plane * Nh + j
    const float a = (float)(acc[i] >> 4);           // undo the 16x nibble scale
    out[i] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(a, xs[m]), scale2[pj]));
  }
}

}  // namespace

extern "C" int w4a4_matmul_paired_stacked_launch(
    const void* x, const void* xs, const void* wp_layer, const void* scale2,
    void* acc, void* out, int M, int K, int Nh, int kchunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)M * 2 * Nh * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Nh + COLS - 1) / COLS, (M + MT - 1) / MT,
            (K + kchunk - 1) / kchunk);
  w4a4_main<<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(wp_layer), static_cast<int32_t*>(acc),
      M, K, Nh, kchunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)M * 2 * Nh;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  w4a4_epilogue<<<blocks, 256, 0, s>>>(
      static_cast<const int32_t*>(acc), static_cast<const float*>(xs),
      static_cast<const float*>(scale2), static_cast<__nv_bfloat16*>(out),
      M, Nh);
  return (int)cudaGetLastError();
}
