// Decode-token prep: RoPE(q, k) -> per-head Walsh-Hadamard(q, k) ->
// asymmetric INT4 quant-pack of k and v, plus the dequantized k/v that the
// cache will hold.
//
// Replaces: rsq_tpu/kernels/kv_cache.py decode_prep (:180),
//   Pallas body _decode_prep_kernel (:120).
// Computes, per (batch row, head), in f32 with the reference's rounding
//   points: RoPE x*cos + rot*sin (rot = cat(-x[D/2:], x[:D/2])) then a bf16
//   round-trip; the unnormalised butterfly (pairs (i, i+h) -> (a+b, a-b)
//   for h = 1, 2, ..., D/2, the add DAG of core.hadamard.fwht), times
//   1/sqrt(D), bf16 round-trip; for k and v: scale = max(xmax - xmin, 1e-5)
//   * f32(1/15) (the reference's `/ 15.0` as XLA compiles it under jit),
//   zero = -xmin, u = clip(rint((x + zero)/scale), 0, 15), self = u*scale -
//   zero; byte i of the codes holds u[i] | u[i + D/2] << 4.  v is neither
//   rotated nor rope'd.  The max and min keep a NaN, as jnp.max and
//   torch.amax do, and so does the 1e-5 floor: a k or v row with a NaN gets
//   NaN scale, zero and self values (its codes are undefined in the
//   reference too).  The TPU kernel's 128-lane broadcast of the codes is a
//   layout artifact and is not reproduced: codes are (B, Hkv, D/2), params
//   (B, Hkv, 2).
// Bound on this card: launch latency -- a decode step moves a few tens of
//   KB here (B*(Hq + 2*Hkv)*D bf16 in, about twice that out).
// Design:
// - One warp per (batch row, head), no shared memory and no block barrier.
//   A lane holds EPL = D/32 consecutive elements (D >= 32), or one element
//   on D lanes (D < 32).  Butterfly stages whose partner lies in the same
//   lane (h < EPL) run in registers; the others are one __shfl_xor_sync
//   each, lane distance h/EPL.  Each output of each stage is the same
//   single __fadd_rn/__fsub_rn of the same two values as in fwht, so the
//   bits do not change.  RoPE's partner x[i +- D/2] and the code byte's
//   high nibble u[i + D/2] sit in the same register of lane ^ (lanes/2):
//   one shuffle each.  The min and max are one warp reduction each
//   (__reduce_max_sync on ints ordered as the floats, exact in any order).
// - A block per (row, kv head) group: G = Hq/Hkv q warps, a k warp and a v
//   warp (Llama-3-8B at B = 8: 64 blocks of 6 warps); above 16 jobs a warp
//   takes several.
// - q, k and v are read in place through their strides (struct Rows): the
//   plane-major segments of the fused qkv output need no copy.
// - Every multiply-add is written with __fmul_rn/__fadd_rn so the compiler
//   cannot contract it into an FMA; divisions are IEEE (no fast math).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 16;

// An operand read in place: element c = head*D + d of row b lies at
// base + b*sb + (c / w)*sw + c % w.  A (B, H, D) tensor has w = D, sw its
// head stride; a plane-major segment (B, 2, nh) of the fused qkv output
// has w = nh, sw its plane stride.  w is a multiple of the elements a lane
// holds, so a lane's elements lie in one chunk.
struct Rows {
  const __nv_bfloat16* base;
  long long sb, sw;
  int w;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// An int whose signed order is the float order (-0 below +0), so that the
// warp's min and max are one integer reduction each; NaN is handled apart.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

template <int EPL>
__global__ void __launch_bounds__(MAX_WARPS * 32) decode_prep_kernel(
    Rows q, Rows k, Rows v, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ qh,
    float* __restrict__ k_self, float* __restrict__ v_self,
    uint8_t* __restrict__ kq, float* __restrict__ kp, uint8_t* __restrict__ vq,
    float* __restrict__ vp, int Hkv, int G, int D, int kv_had,
    float inv_sqrt_d, float inv15) {
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int lane = threadIdx.x & 31;
  const int lanes = D / EPL;             // lanes that hold a head
  const int half = lanes / 2;            // lane distance of d and d + D/2
  const bool live = lane < lanes;
  const bool low = (lane & half) == 0;   // holds d < D/2
  const int e0 = lane * EPL;             // this lane's first element

  float cs[EPL], sn[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    cs[j] = live ? cos_t[(size_t)b * D + e0 + j] : 0.0f;
    sn[j] = live ? sin_t[(size_t)b * D + e0 + j] : 0.0f;
  }

  for (int job = threadIdx.x >> 5; job < G + 2; job += blockDim.x >> 5) {
    const bool is_q = job < G, is_k = job == G;
    const Rows src = is_q ? q : (is_k ? k : v);
    const int head = is_q ? h * G + job : h;
    const int c = head * D + e0;
    const __nv_bfloat16* p =
        src.base + b * src.sb + (long long)(c / src.w) * src.sw + c % src.w;
    float y[EPL];
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      y[j] = live ? __bfloat162float(p[j]) : 0.0f;

    if (job <= G) {                      // q and k: rope, then the butterfly
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const float o = __shfl_xor_sync(FULL, y[j], half);
        const float rot = low ? -o : o;
        y[j] = bf16_round(__fadd_rn(__fmul_rn(y[j], cs[j]),
                                    __fmul_rn(rot, sn[j])));
      }
      if (kv_had) {
#pragma unroll
        for (int s = 1; s < EPL; s *= 2)     // partners in this lane
#pragma unroll
          for (int j = 0; j < EPL; ++j)
            if ((j & s) == 0) {
              const float a = y[j], e = y[j + s];
              y[j] = __fadd_rn(a, e);
              y[j + s] = __fsub_rn(a, e);
            }
        for (int m = 1; m < lanes; m *= 2)   // partners m lanes away
#pragma unroll
          for (int j = 0; j < EPL; ++j) {
            const float o = __shfl_xor_sync(FULL, y[j], m);
            y[j] = (lane & m) ? __fsub_rn(o, y[j]) : __fadd_rn(y[j], o);
          }
#pragma unroll
        for (int j = 0; j < EPL; ++j)
          y[j] = bf16_round(__fmul_rn(y[j], inv_sqrt_d));
      }
    }
    if (is_q) {
      if (live) {
        __nv_bfloat16* out = qh + ((size_t)b * Hkv * G + head) * D + e0;
#pragma unroll
        for (int j = 0; j < EPL; ++j) out[j] = __float2bfloat16_rn(y[j]);
      }
      continue;
    }

    // per-(row, head) min/max over D: exact in any order; a NaN anywhere
    // makes both NaN, as jnp.max/jnp.min and torch.amax/amin do
    int kmax = INT_MIN, kmin = INT_MAX;
    bool nan = false;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      nan |= y[j] != y[j];
      if (live) {
        kmax = max(kmax, order_key(y[j]));
        kmin = min(kmin, order_key(y[j]));
      }
    }
    nan = __any_sync(FULL, live && nan);
    kmax = __reduce_max_sync(FULL, kmax);
    kmin = __reduce_min_sync(FULL, kmin);
    const float xmax = nan ? __int_as_float(0x7fc00000) : from_key(kmax);
    const float xmin = nan ? __int_as_float(0x7fc00000) : from_key(kmin);
    // the 1e-5 floor keeps a NaN too (torch.clamp, jnp.maximum)
    const float range = __fsub_rn(xmax, xmin);
    const float scale =
        __fmul_rn((range > 1e-5f || range != range) ? range : 1e-5f, inv15);
    const float zero = -xmin;
    const size_t row = (size_t)b * Hkv + h;
    float* self = (is_k ? k_self : v_self) + row * D + e0;
    int u[EPL];
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const float uf = fminf(
          fmaxf(rintf(__fdiv_rn(__fadd_rn(y[j], zero), scale)), 0.0f), 15.0f);
      u[j] = (int)uf;
      if (live) self[j] = __fsub_rn(__fmul_rn(uf, scale), zero);
    }
    uint8_t* codes = (is_k ? kq : vq) + row * (D / 2) + e0;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int hi = __shfl_xor_sync(FULL, u[j], half);
      if (live && low) codes[j] = (uint8_t)(u[j] | (hi << 4));
    }
    if (lane == 0) {
      float* par = (is_k ? kp : vp) + row * 2;
      par[0] = scale;
      par[1] = zero;
    }
  }
}

template <int EPL>
cudaError_t launch(const Rows& q, const Rows& k, const Rows& v,
                   const float* cos_t, const float* sin_t, void* qh,
                   void* k_self, void* v_self, void* kq, void* kp, void* vq,
                   void* vp, int B, int Hkv, int G, int D, int kv_had,
                   float inv_sqrt_d, float inv15, cudaStream_t stream) {
  const int warps = G + 2 < MAX_WARPS ? G + 2 : MAX_WARPS;
  decode_prep_kernel<EPL><<<B * Hkv, warps * 32, 0, stream>>>(
      q, k, v, cos_t, sin_t, static_cast<__nv_bfloat16*>(qh),
      static_cast<float*>(k_self), static_cast<float*>(v_self),
      static_cast<uint8_t*>(kq), static_cast<float*>(kp),
      static_cast<uint8_t*>(vq), static_cast<float*>(vp), Hkv, G, D, kv_had,
      inv_sqrt_d, inv15);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (pointer, row stride, chunk width, chunk stride) each, in bf16
// elements (struct Rows).  Needs a power-of-2 D in [2, 256], Hq = G*Hkv,
// chunk widths that are multiples of max(1, D/32) (the wrapper checks).
extern "C" int decode_prep_launch(
    const void* q, long long q_sb, int q_w, long long q_sw, const void* k,
    long long k_sb, int k_w, long long k_sw, const void* v, long long v_sb,
    int v_w, long long v_sw, const void* cos_t, const void* sin_t, void* qh,
    void* k_self, void* v_self, void* kq, void* kp, void* vq, void* vp, int B,
    int Hkv, int G, int D, int kv_had, float inv_sqrt_d, float inv15,
    void* stream) {
  if (D < 2 || D > 256 || (D & (D - 1)) != 0 || G < 1)
    return (int)cudaErrorInvalidValue;
  const Rows rq{static_cast<const __nv_bfloat16*>(q), q_sb, q_sw, q_w};
  const Rows rk{static_cast<const __nv_bfloat16*>(k), k_sb, k_sw, k_w};
  const Rows rv{static_cast<const __nv_bfloat16*>(v), v_sb, v_sw, v_w};
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (D) {
    case 256:
      e = launch<8>(rq, rk, rv, c, s, qh, k_self, v_self, kq, kp, vq, vp, B,
                    Hkv, G, D, kv_had, inv_sqrt_d, inv15, st);
      break;
    case 128:
      e = launch<4>(rq, rk, rv, c, s, qh, k_self, v_self, kq, kp, vq, vp, B,
                    Hkv, G, D, kv_had, inv_sqrt_d, inv15, st);
      break;
    case 64:
      e = launch<2>(rq, rk, rv, c, s, qh, k_self, v_self, kq, kp, vq, vp, B,
                    Hkv, G, D, kv_had, inv_sqrt_d, inv15, st);
      break;
    default:
      e = launch<1>(rq, rk, rv, c, s, qh, k_self, v_self, kq, kp, vq, vp, B,
                    Hkv, G, D, kv_had, inv_sqrt_d, inv15, st);
  }
  return (int)e;
}
