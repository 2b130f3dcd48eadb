// Paged INT4 decode attention with the new token folded in and appended.
//
// Replaces: rsq_tpu/kernels/paged_kv.py int4_paged_decode_attention_self_append
//   (:463) -- both its grid kernel _paged_kernel_self_append (:388) and its
//   one-grid-step twin _paged_kernel_self_append_flat (:580), which compute
//   the same function (the split exists only for TPU grid-step overhead).
// Computes, per batch row b and kv head h, for the G = Hq/Hkv query rows of
//   that head (q pre-scaled by sm_scale in f32), over the cached tokens
//   pos < lengths[b] found through the page table, the reference's
//   _attend_tile (kernels/kv_cache.py:265-371) rounding points:
//     logits = raw*ks - qsum*kz, raw = bf16(q) . u (or, with int8_qk,
//       int_dot(q_i8, u) * qs with qs = max|q| * f32(1/127), the reference's
//       `/ 127.0` as XLA compiles it under jit), masked with -1e30;
//     online softmax (m, l); ps = bf16(p*vs); acc = acc*alpha + ps.u_v - sum(p*vz)
//   then _self_fold_finalize (:435-471): one more softmax step over the new
//   token's dequantized (k_self, v_self) with the f32 q, out = bf16(acc/l).
//   Finally the new token's codes and (scale, zero) are written in place at
//   (layer, ptab[b, len // page], h, :, len % page).
// Bound on this card: the pool bytes of the cached tokens (D/2 code bytes
//   plus 8 parameter bytes per token, for k and for v, per kv head) -- about
//   4.7 MB per Llama-3-8B layer at B=8, fill 512.
// Design: one block of 128 threads per (b, kv head).  It walks the row's
//   tokens in 128-token tiles (a page is a multiple of 128, so a tile never
//   straddles pages): a tile's codes and parameters are staged in shared
//   memory with coalesced loads; thread t scores token t for all G rows;
//   block reductions give the tile max and sums; thread d then accumulates
//   output dimension d.  The V tile is stored token-major, one row per
//   token padded to VROW bytes, so that loop's reads (neighbouring threads,
//   neighbouring d) and the staging stores (neighbouring threads,
//   neighbouring tokens) each fall on distinct shared-memory banks.  The append writes one column after the block's
//   reads, so nothing is staged and no write window can be lost.  Rows of
//   length 0 (idle engine slots) all point at the engine's null page and
//   write its column 0 concurrently: a benign race, since no row ever reads
//   that page.  First version: no split over tiles, so B*Hkv blocks only.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int T = 128;        // tokens per tile == threads per block
constexpr int NW = T / 32;
constexpr int MAXD = 128;
constexpr int MAXG = 8;
constexpr int VROW = MAXD / 2 + 4;   // 17 words: row t starts at bank 17t % 32
constexpr float MASK_VALUE = -1e30f;

// All-reduce G values across the block: warp shuffles, then every thread
// combines the NW warp partials in the same fixed order.
template <bool IS_MAX>
__device__ __forceinline__ void block_allreduce(float (&v)[MAXG], int G,
                                                float (*sbuf)[MAXG]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int g = 0; g < G; ++g) {
    float x = v[g];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, o);
      x = IS_MAX ? fmaxf(x, y) : __fadd_rn(x, y);
    }
    if (lane == 0) sbuf[w][g] = x;
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    float x = sbuf[0][g];
    for (int j = 1; j < NW; ++j)
      x = IS_MAX ? fmaxf(x, sbuf[j][g]) : __fadd_rn(x, sbuf[j][g]);
    v[g] = x;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(T)
paged_attn_self_append(
    const __nv_bfloat16* __restrict__ q, uint8_t* __restrict__ kq,
    float* __restrict__ kp, uint8_t* __restrict__ vq, float* __restrict__ vp,
    const int32_t* __restrict__ ptab, const int32_t* __restrict__ lengths,
    const float* __restrict__ k_self, const float* __restrict__ v_self,
    const uint8_t* __restrict__ nkq, const float* __restrict__ nkp,
    const uint8_t* __restrict__ nvq, const float* __restrict__ nvp,
    __nv_bfloat16* __restrict__ out, int layer, int P, int Hkv, int G, int D,
    int page, int NP, float sm_scale, int int8_qk, float inv127) {
  __shared__ float qf[MAXG][MAXD];      // f32 q * sm_scale
  __shared__ float qd[MAXG][MAXD];      // q as the QK dot sees it
  __shared__ float qsum_s[MAXG], qs_s[MAXG];
  __shared__ uint8_t kt[MAXD / 2][T], vt[T][VROW];
  __shared__ float kpar[2][T], vpar[2][T];
  __shared__ float ps[MAXG][T];
  __shared__ float sbuf[NW][MAXG];

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int D2 = D / 2;
  const int Hq = Hkv * G;
  const int len = lengths[b];

  for (int i = tid; i < G * D; i += T) {
    const int g = i / D, d = i % D;
    qf[g][d] = __fmul_rn(
        __bfloat162float(q[((size_t)b * Hq + h * G + g) * D + d]), sm_scale);
  }
  __syncthreads();
  if (tid < G) {
    const int g = tid;
    if (int8_qk) {
      float qmax = 0.0f;
      for (int d = 0; d < D; ++d) qmax = fmaxf(qmax, fabsf(qf[g][d]));
      const float qs = qmax == 0.0f ? 1.0f : __fmul_rn(qmax, inv127);
      float isum = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float qi = fminf(fmaxf(rintf(__fdiv_rn(qf[g][d], qs)), -127.0f),
                               127.0f);
        qd[g][d] = qi;
        isum += qi;                       // integers: exact in any order
      }
      qs_s[g] = qs;
      qsum_s[g] = __fmul_rn(isum, qs);
    } else {
      float s = 0.0f;
      for (int d = 0; d < D; ++d) {
        s = __fadd_rn(s, qf[g][d]);
        qd[g][d] = __bfloat162float(__float2bfloat16_rn(qf[g][d]));
      }
      qs_s[g] = 1.0f;
      qsum_s[g] = s;
    }
  }
  __syncthreads();

  float m[MAXG], l[MAXG], acc[MAXG];
  for (int g = 0; g < MAXG; ++g) { m[g] = -INFINITY; l[g] = 0.0f; acc[g] = 0.0f; }

  const size_t head_stride = (size_t)D2 * page;      // codes per (page, head)
  const int len_tab = min(len, NP * page);           // never past the table
  for (int t0 = 0; t0 < len_tab; t0 += T) {
    const int pid = ptab[(size_t)b * NP + t0 / page];
    const int col0 = t0 % page;
    const size_t pbase = ((size_t)layer * P + pid) * Hkv + h;
    const uint8_t* ksrc = kq + pbase * head_stride + col0;
    const uint8_t* vsrc = vq + pbase * head_stride + col0;
    for (int i = tid; i < D2 * T; i += T) {
      const int d2 = i / T, t = i % T;
      kt[d2][t] = ksrc[(size_t)d2 * page + t];
      vt[t][d2] = vsrc[(size_t)d2 * page + t];
    }
    const float* kps = kp + pbase * 2 * page + col0;
    const float* vps = vp + pbase * 2 * page + col0;
    kpar[0][tid] = kps[tid];
    kpar[1][tid] = kps[page + tid];
    vpar[0][tid] = vps[tid];
    vpar[1][tid] = vps[page + tid];
    __syncthreads();

    // scores of token t for every query row
    const int t = tid;
    const bool valid = t0 + t < len;
    float lg[MAXG];
    for (int g = 0; g < G; ++g) {
      float raw = 0.0f;
      if (int8_qk) {
        int ir = 0;
        for (int d2 = 0; d2 < D2; ++d2) {
          const int byte = kt[d2][t];
          ir += (int)qd[g][d2] * (byte & 15) + (int)qd[g][d2 + D2] * (byte >> 4);
        }
        raw = __fmul_rn((float)ir, qs_s[g]);
      } else {
        // bf16 q times a 4-bit code is exact in f32, so fmaf == mul + add
        for (int d2 = 0; d2 < D2; ++d2) raw = fmaf(qd[g][d2], (float)(kt[d2][t] & 15), raw);
        for (int d2 = 0; d2 < D2; ++d2) raw = fmaf(qd[g][d2 + D2], (float)(kt[d2][t] >> 4), raw);
      }
      const float x = __fsub_rn(__fmul_rn(raw, kpar[0][t]),
                                __fmul_rn(qsum_s[g], kpar[1][t]));
      lg[g] = valid ? x : MASK_VALUE;
    }
    float mc[MAXG];
    for (int g = 0; g < G; ++g) mc[g] = lg[g];
    block_allreduce<true>(mc, G, sbuf);
    float alpha[MAXG], p[MAXG], pz[MAXG];
    for (int g = 0; g < G; ++g) {
      const float mn = fmaxf(m[g], mc[g]);
      alpha[g] = expf(m[g] - mn);
      m[g] = mn;
      p[g] = expf(lg[g] - mn);
      ps[g][t] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(p[g], vpar[0][t])));
      pz[g] = __fmul_rn(p[g], vpar[1][t]);
    }
    block_allreduce<false>(p, G, sbuf);    // p -> sum(p); also orders ps writes
    block_allreduce<false>(pz, G, sbuf);
    for (int g = 0; g < G; ++g) l[g] = __fadd_rn(__fmul_rn(alpha[g], l[g]), p[g]);

    if (tid < D) {
      const int d = tid;
      const bool hi = d >= D2;
      const int d2 = hi ? d - D2 : d;
      for (int g = 0; g < G; ++g) {
        float tv = 0.0f;
        for (int j = 0; j < T; ++j) {
          const int byte = vt[j][d2];
          tv = fmaf(ps[g][j], (float)(hi ? byte >> 4 : byte & 15), tv);
        }
        acc[g] = __fsub_rn(__fadd_rn(__fmul_rn(acc[g], alpha[g]), tv), pz[g]);
      }
    }
    __syncthreads();   // tiles are overwritten by the next iteration
  }

  // fold the new token (f32 q against the dequantized k_self / v_self)
  const size_t srow = ((size_t)b * Hkv + h) * D;
  if (tid < D) {
    const int d = tid;
    const float vs = v_self[srow + d];
    for (int g = 0; g < G; ++g) {
      float lgs = 0.0f;
      for (int e = 0; e < D; ++e) lgs = __fadd_rn(lgs, __fmul_rn(qf[g][e], k_self[srow + e]));
      const float mf = fmaxf(m[g], lgs);
      const float alpha = expf(m[g] - mf);
      const float p = expf(lgs - mf);
      const float lf = __fadd_rn(__fmul_rn(l[g], alpha), p);
      const float a = __fadd_rn(__fmul_rn(acc[g], alpha), __fmul_rn(p, vs));
      out[((size_t)b * Hq + h * G + g) * D + d] = __float2bfloat16_rn(__fdiv_rn(a, lf));
    }
  }

  // append the new token's column in place (all reads of this row are done)
  const int wslot = min(len / page, NP - 1);
  const int wpid = ptab[(size_t)b * NP + wslot];
  const int col = len % page;
  const size_t wbase = ((size_t)layer * P + wpid) * Hkv + h;
  const size_t nrow = (size_t)b * Hkv + h;
  for (int d2 = tid; d2 < D2; d2 += T) {
    kq[wbase * head_stride + (size_t)d2 * page + col] = nkq[nrow * D2 + d2];
    vq[wbase * head_stride + (size_t)d2 * page + col] = nvq[nrow * D2 + d2];
  }
  if (tid < 2) {
    kp[wbase * 2 * page + (size_t)tid * page + col] = nkp[nrow * 2 + tid];
    vp[wbase * 2 * page + (size_t)tid * page + col] = nvp[nrow * 2 + tid];
  }
}

}  // namespace

extern "C" int paged_attention_self_append_launch(
    const void* q, void* kq, void* kp, void* vq, void* vp, const void* ptab,
    const void* lengths, const void* k_self, const void* v_self,
    const void* nkq, const void* nkp, const void* nvq, const void* nvp,
    void* out, int B, int layer, int P, int Hkv, int G, int D, int page,
    int NP, float sm_scale, int int8_qk, float inv127, void* stream) {
  paged_attn_self_append<<<B * Hkv, T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<uint8_t*>(kq),
      static_cast<float*>(kp), static_cast<uint8_t*>(vq),
      static_cast<float*>(vp), static_cast<const int32_t*>(ptab),
      static_cast<const int32_t*>(lengths), static_cast<const float*>(k_self),
      static_cast<const float*>(v_self), static_cast<const uint8_t*>(nkq),
      static_cast<const float*>(nkp), static_cast<const uint8_t*>(nvq),
      static_cast<const float*>(nvp), static_cast<__nv_bfloat16*>(out), layer,
      P, Hkv, G, D, page, NP, sm_scale, int8_qk, inv127);
  return (int)cudaGetLastError();
}
