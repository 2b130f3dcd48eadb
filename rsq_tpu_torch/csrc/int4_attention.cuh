// Device body shared by the two INT4 decode-attention kernels that fold the
// new token in and append it: the paged one (paged_attention.cu) and the
// contiguous-slot one (contiguous_attention.cu).  They differ only in where
// row b's tokens live, so the body is templated on an addressing functor
// and the two cannot drift apart.
//
// Computes, per batch row b and kv head h, for the G = Hq/Hkv query rows of
//   that head (q pre-scaled by sm_scale in f32), over the cached tokens
//   pos < len, the reference's _attend_tile (rsq_tpu/kernels/kv_cache.py
//   :265-371) rounding points:
//     logits = raw*ks - qsum*kz, raw = bf16(q) . u (or, with int8_qk,
//       int_dot(q_i8, u) * qs with qs = max|q| * f32(1/127), the reference's
//       `/ 127.0` as XLA compiles it under jit), masked with -1e30;
//     online softmax (m, l); ps = bf16(p*vs); acc = acc*alpha + ps.u_v - sum(p*vz)
//   then _self_fold_finalize (:435-471): one more softmax step over the new
//   token's dequantized (k_self, v_self) with the f32 q, out = bf16(acc/l).
//   Finally the new token's codes and (scale, zero) are written in place at
//   the column the functor names.
// Design: one block of T = 128 threads per (b, kv head).  It walks the row's
//   tokens in 128-token tiles: a tile's codes and parameters are staged in
//   shared memory with coalesced loads (tokens past len are not read and
//   stage as zeros); thread t scores token t for all G rows; block
//   reductions give the tile max and sums; thread d then accumulates output
//   dimension d.  The V tile is stored token-major, one row per token padded
//   to VROW bytes, so that loop's reads (neighbouring threads, neighbouring
//   d) and the staging stores (neighbouring threads, neighbouring tokens)
//   each fall on distinct shared-memory banks.  The append writes one column
//   after the block's reads, so nothing is staged and no write can be lost.
//
// Addressing functor (the codes and parameters of one (b, h) share it):
//   int cap() const              tokens the row can address (reads stop there)
//   int stride() const           elements between rows d2 (and param rows)
//   size_t codes(int t) const    offset of (d2 = 0, token t) in kq / vq; a
//                                tile of 128 tokens from t is contiguous
//   size_t params(int t) const   offset of (row 0, token t) in kp / vp
//   bool append(int len, size_t* c, size_t* p) const
//                                the new token's column; false: write nothing

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace int4_attention {

constexpr int T = 128;        // tokens per tile == threads per block
constexpr int NW = T / 32;
constexpr int MAXD = 128;
constexpr int MAXG = 8;
constexpr int VROW = MAXD / 2 + 4;   // 17 words: row t starts at bank 17t % 32
constexpr float MASK_VALUE = -1e30f;

struct Args {
  const __nv_bfloat16* q;     // (B, Hq, D)
  uint8_t* kq;                // codes, updated in place
  float* kp;                  // (scale, zero), updated in place
  uint8_t* vq;
  float* vp;
  const int32_t* lengths;     // (B,) cached tokens
  const float* k_self;        // (B, Hkv, D) dequantized new token
  const float* v_self;
  const uint8_t* nkq;         // (B, Hkv, D/2) its codes
  const float* nkp;           // (B, Hkv, 2) its (scale, zero)
  const uint8_t* nvq;
  const float* nvp;
  __nv_bfloat16* out;         // (B, Hq, D)
  int Hkv, G, D;
  float sm_scale;
  int int8_qk;
  float inv127;
};

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

template <class Addr>
__device__ __forceinline__ void self_append(const Args& a, const Addr& at,
                                            int b, int h) {
  __shared__ float qf[MAXG][MAXD];      // f32 q * sm_scale
  __shared__ float qd[MAXG][MAXD];      // q as the QK dot sees it
  __shared__ float qsum_s[MAXG], qs_s[MAXG];
  __shared__ uint8_t kt[MAXD / 2][T], vt[T][VROW];
  __shared__ float kpar[2][T], vpar[2][T];
  __shared__ float ps[MAXG][T];
  __shared__ float sbuf[NW][MAXG];

  const int tid = threadIdx.x;
  const int G = a.G, D = a.D, D2 = a.D / 2;
  const int Hq = a.Hkv * G;
  const int len = a.lengths[b];
  const int stride = at.stride();

  for (int i = tid; i < G * D; i += T) {
    const int g = i / D, d = i % D;
    qf[g][d] = __fmul_rn(
        __bfloat162float(a.q[((size_t)b * Hq + h * G + g) * D + d]), a.sm_scale);
  }
  __syncthreads();
  if (tid < G) {
    const int g = tid;
    if (a.int8_qk) {
      float qmax = 0.0f;
      for (int d = 0; d < D; ++d) qmax = fmaxf(qmax, fabsf(qf[g][d]));
      const float qs = qmax == 0.0f ? 1.0f : __fmul_rn(qmax, a.inv127);
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

  const int len_tab = min(len, at.cap());            // never past the row
  for (int t0 = 0; t0 < len_tab; t0 += T) {
    const int nt = min(T, len_tab - t0);             // cached tokens in the tile
    const size_t cbase = at.codes(t0);
    for (int i = tid; i < D2 * T; i += T) {
      const int d2 = i / T, t = i % T;
      const bool ok = t < nt;
      kt[d2][t] = ok ? a.kq[cbase + (size_t)d2 * stride + t] : 0;
      vt[t][d2] = ok ? a.vq[cbase + (size_t)d2 * stride + t] : 0;
    }
    const size_t pbase = at.params(t0);
    const bool tok = tid < nt;
    kpar[0][tid] = tok ? a.kp[pbase + tid] : 0.0f;
    kpar[1][tid] = tok ? a.kp[pbase + stride + tid] : 0.0f;
    vpar[0][tid] = tok ? a.vp[pbase + tid] : 0.0f;
    vpar[1][tid] = tok ? a.vp[pbase + stride + tid] : 0.0f;
    __syncthreads();

    // scores of token t for every query row
    const int t = tid;
    float lg[MAXG];
    for (int g = 0; g < G; ++g) {
      float raw = 0.0f;
      if (a.int8_qk) {
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
      lg[g] = tok ? x : MASK_VALUE;
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
  const size_t srow = ((size_t)b * a.Hkv + h) * D;
  if (tid < D) {
    const int d = tid;
    const float vs = a.v_self[srow + d];
    for (int g = 0; g < G; ++g) {
      float lgs = 0.0f;
      for (int e = 0; e < D; ++e) lgs = __fadd_rn(lgs, __fmul_rn(qf[g][e], a.k_self[srow + e]));
      const float mf = fmaxf(m[g], lgs);
      const float alpha = expf(m[g] - mf);
      const float p = expf(lgs - mf);
      const float lf = __fadd_rn(__fmul_rn(l[g], alpha), p);
      const float v = __fadd_rn(__fmul_rn(acc[g], alpha), __fmul_rn(p, vs));
      a.out[((size_t)b * Hq + h * G + g) * D + d] = __float2bfloat16_rn(__fdiv_rn(v, lf));
    }
  }

  // append the new token's column in place (all reads of this row are done)
  size_t wc, wp;
  if (!at.append(len, &wc, &wp)) return;
  const size_t nrow = (size_t)b * a.Hkv + h;
  for (int d2 = tid; d2 < D2; d2 += T) {
    a.kq[wc + (size_t)d2 * stride] = a.nkq[nrow * D2 + d2];
    a.vq[wc + (size_t)d2 * stride] = a.nvq[nrow * D2 + d2];
  }
  if (tid < 2) {
    a.kp[wp + (size_t)tid * stride] = a.nkp[nrow * 2 + tid];
    a.vp[wp + (size_t)tid * stride] = a.nvp[nrow * 2 + tid];
  }
}

}  // namespace int4_attention
