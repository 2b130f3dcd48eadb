// Decode-token prep: RoPE(q, k) -> per-head Walsh-Hadamard(q, k) ->
// asymmetric INT4 quant-pack of k and v, plus the dequantized k/v that the
// cache will hold.
//
// Replaces: rsq_tpu/kernels/kv_cache.py decode_prep (:180),
//   Pallas body _decode_prep_kernel (:120).
// Computes, per (batch row, head), in f32 with the reference's rounding
//   points: RoPE x*cos + rot*sin (rot = cat(-x[D/2:], x[:D/2])) then a bf16
//   round-trip; the unnormalised butterfly (pairs (i, i+h) -> (a+b, a-b),
//   the add DAG of core.hadamard.fwht), times 1/sqrt(D), bf16 round-trip;
//   for k and v: scale = max(xmax - xmin, 1e-5) * f32(1/15) (the
//   reference's `/ 15.0` as XLA compiles it under jit), zero = -xmin,
//   u = clip(rint((x + zero)/scale), 0, 15), self = u*scale - zero; byte i of
//   the codes holds u[i] | u[i + D/2] << 4.  v is neither rotated nor rope'd.
//   The TPU kernel's 128-lane broadcast of the codes is a layout artifact
//   and is not reproduced: codes are (B, Hkv, D/2), params (B, Hkv, 2).
// Bound on this card: launch latency -- a decode step moves a few tens of
//   KB here (B*(Hq + 2*Hkv)*D bf16 in, about twice that out).
// Design: one block per (row, head) with one thread per element; the
//   butterfly runs in shared memory, one pair per thread per stage, so
//   every output is the same single add/sub as the reference.  Every
//   multiply-add is written with __fmul_rn/__fadd_rn so the compiler cannot
//   contract it into an FMA; divisions are IEEE (no fast math).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAXD = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void decode_prep_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ qh,
    float* __restrict__ k_self, float* __restrict__ v_self,
    uint8_t* __restrict__ kq, float* __restrict__ kp, uint8_t* __restrict__ vq,
    float* __restrict__ vp, int Hq, int Hkv, int D, int kv_had,
    float inv_sqrt_d, float inv15) {
  __shared__ float buf[MAXD];
  __shared__ float red_max[MAXD], red_min[MAXD];
  const int heads = Hq + 2 * Hkv;
  const int b = blockIdx.x / heads;
  const int hs = blockIdx.x % heads;     // [0, Hq): q, then k, then v
  const int i = threadIdx.x;
  const int half = D / 2;
  const bool is_q = hs < Hq, is_k = !is_q && hs < Hq + Hkv;
  const int h = is_q ? hs : (is_k ? hs - Hq : hs - Hq - Hkv);
  const __nv_bfloat16* src =
      is_q ? q + ((size_t)b * Hq + h) * D
           : (is_k ? k : v) + ((size_t)b * Hkv + h) * D;

  float y = __bfloat162float(src[i]);
  if (is_q || is_k) {
    const float rot = i < half ? -__bfloat162float(src[i + half])
                               : __bfloat162float(src[i - half]);
    y = bf16_round(__fadd_rn(__fmul_rn(y, cos_t[(size_t)b * D + i]),
                             __fmul_rn(rot, sin_t[(size_t)b * D + i])));
    if (kv_had) {
      buf[i] = y;
      for (int s = 1; s < D; s *= 2) {
        __syncthreads();
        if ((i & s) == 0) {
          const float a = buf[i], c = buf[i + s];
          buf[i] = __fadd_rn(a, c);
          buf[i + s] = __fsub_rn(a, c);
        }
      }
      __syncthreads();
      y = bf16_round(__fmul_rn(buf[i], inv_sqrt_d));
    }
  }
  if (is_q) {
    qh[((size_t)b * Hq + h) * D + i] = __float2bfloat16_rn(y);
    return;   // q blocks take no part in the reductions below
  }
  // per-(row, head) min/max over D (exact in any order)
  red_max[i] = y;
  red_min[i] = y;
  for (int s = D / 2; s > 0; s /= 2) {
    __syncthreads();
    if (i < s) {
      red_max[i] = fmaxf(red_max[i], red_max[i + s]);
      red_min[i] = fminf(red_min[i], red_min[i + s]);
    }
  }
  __syncthreads();
  const float xmax = red_max[0], xmin = red_min[0];
  const float scale = __fmul_rn(fmaxf(__fsub_rn(xmax, xmin), 1e-5f), inv15);
  const float zero = -xmin;
  const float u = fminf(fmaxf(rintf(__fdiv_rn(__fadd_rn(y, zero), scale)),
                              0.0f), 15.0f);
  const size_t row = (size_t)b * Hkv + h;
  (is_k ? k_self : v_self)[row * D + i] = __fsub_rn(__fmul_rn(u, scale), zero);
  buf[i] = u;
  __syncthreads();
  if (i < half) {
    (is_k ? kq : vq)[row * half + i] =
        (uint8_t)((int)buf[i] | ((int)buf[i + half] << 4));
  } else if (i == half) {
    float* par = (is_k ? kp : vp) + row * 2;
    par[0] = scale;
    par[1] = zero;
  }
}

}  // namespace

extern "C" int decode_prep_launch(
    const void* q, const void* k, const void* v, const void* cos_t,
    const void* sin_t, void* qh, void* k_self, void* v_self, void* kq,
    void* kp, void* vq, void* vp, int B, int Hq, int Hkv, int D, int kv_had,
    float inv_sqrt_d, float inv15, void* stream) {
  decode_prep_kernel<<<B * (Hq + 2 * Hkv), D, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(qh),
      static_cast<float*>(k_self), static_cast<float*>(v_self),
      static_cast<uint8_t*>(kq), static_cast<float*>(kp),
      static_cast<uint8_t*>(vq), static_cast<float*>(vp), Hq, Hkv, D, kv_had,
      inv_sqrt_d, inv15);
  return (int)cudaGetLastError();
}
