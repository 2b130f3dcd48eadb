// Device bodies shared by the INT4 decode-attention kernels: the paged ones
// (paged_attention.cu) and the contiguous-slot ones (contiguous_attention.cu),
// each in three forms -- `self_append`, which folds the new token in and
// appends it; `read_only_self`, the same fold over a cache it only reads;
// and `read_only`, which attends over the cached tokens and emits the
// softmax state.  The kernels differ only in where row b's tokens live, so
// the bodies are templated on an addressing functor; every form runs the
// one tile loop (`attend_cached`) and the two folding forms the one fold
// (`fold_self`), so none of the six can drift from the others.
//
// attend_cached computes, per batch row b and kv head h, for the G = Hq/Hkv
//   query rows of that head (q pre-scaled by sm_scale in f32), over the
//   cached tokens pos < len, the reference's _attend_tile
//   (rsq_tpu/kernels/kv_cache.py :265-371) rounding points:
//     logits = raw*ks - qsum*kz, raw = bf16(q) . u (or, with int8_qk,
//       int_dot(q_i8, u) * qs with qs = max|q| * f32(1/127), the reference's
//       `/ 127.0` as XLA compiles it under jit), masked with -1e30;
//     online softmax (m, l); ps = bf16(p*vs); acc = acc*alpha + ps.u_v - sum(p*vz)
// fold_self is _self_fold_finalize (:435-471, mix=False): one more softmax
//   step over the new token's dequantized (k_self, v_self) with the f32 q,
//   out = bf16(acc/l).  A row of length 0 gives out = v_self.
// self_append runs it, then writes the new token's codes and (scale, zero)
//   in place at the column the functor names; read_only_self runs it alone.
// read_only writes out = bf16(acc/l) and, where asked, the state m and l
//   (the reference's _decode_kernel_pref, :374-432).  A row of length 0
//   reads nothing: out = bf16(0/0) = NaN, m = -inf, l = 0 (the serving
//   paths never read such a row: they append before they attend).
// Design: one block of T = 128 threads per (b, kv head).  It walks the row's
//   tokens in 128-token tiles: thread t stages token t of the tile (its codes
//   and parameters, found through the functor one token at a time, so a
//   tile may straddle pages of any size) into shared memory; neighbouring
//   threads load neighbouring tokens, coalesced within a page.  Tokens past
//   len are not read and stage as zeros.  Thread t scores token t for all G
//   rows; block reductions give the tile max and sums; thread d then
//   accumulates output dimension d.  The V tile is stored token-major, one
//   row per token padded to VROW bytes, so that loop's reads (neighbouring
//   threads, neighbouring d) and the staging stores (neighbouring threads,
//   neighbouring tokens) each fall on distinct shared-memory banks.  The
//   append writes one column after the block's reads, so nothing is staged
//   and no write can be lost.
//
// Addressing functor (the codes and parameters of one (b, h) share it):
//   int cap() const              tokens the row can address (reads stop there)
//   int stride() const           elements between rows d2 (and param rows)
//   size_t codes(int t) const    offset of (d2 = 0, token t) in kq / vq
//   size_t params(int t) const   offset of (row 0, token t) in kp / vp
//   bool append(int len, size_t* c, size_t* p) const
//                                the new token's column; false: write nothing
//                                (self_append only)

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
  uint8_t* kq;                // codes (updated in place by self_append)
  float* kp;                  // (scale, zero)
  uint8_t* vq;
  float* vp;
  const int32_t* lengths;     // (B,) cached tokens
  const float* k_self;        // (B, Hkv, D) dequantized new token (self_append)
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
  float* m_out;               // (B, Hkv, G) softmax state (read_only; may be null)
  float* l_out;
};

// The fields every launcher sets.  The new token's (k_self .. nvp) and the
// state outputs (m_out, l_out) stay null: self_args fills the first, a
// read-only launcher that wants the state the second.  The read-only form
// never writes the codes or parameters.
inline Args make_args(const void* q, const void* kq, const void* kp,
                      const void* vq, const void* vp, const void* lengths,
                      void* out, int Hkv, int G, int D, float sm_scale,
                      int int8_qk, float inv127) {
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kq = static_cast<uint8_t*>(const_cast<void*>(kq));
  a.kp = static_cast<float*>(const_cast<void*>(kp));
  a.vq = static_cast<uint8_t*>(const_cast<void*>(vq));
  a.vp = static_cast<float*>(const_cast<void*>(vp));
  a.lengths = static_cast<const int32_t*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.Hkv = Hkv; a.G = G; a.D = D;
  a.sm_scale = sm_scale; a.int8_qk = int8_qk; a.inv127 = inv127;
  return a;
}

// make_args plus the new token of the self-append form.
inline Args self_args(const void* q, void* kq, void* kp, void* vq, void* vp,
                      const void* lengths, const void* k_self,
                      const void* v_self, const void* nkq, const void* nkp,
                      const void* nvq, const void* nvp, void* out, int Hkv,
                      int G, int D, float sm_scale, int int8_qk,
                      float inv127) {
  Args a = make_args(q, kq, kp, vq, vp, lengths, out, Hkv, G, D, sm_scale,
                     int8_qk, inv127);
  a.k_self = static_cast<const float*>(k_self);
  a.v_self = static_cast<const float*>(v_self);
  a.nkq = static_cast<const uint8_t*>(nkq);
  a.nkp = static_cast<const float*>(nkp);
  a.nvq = static_cast<const uint8_t*>(nvq);
  a.nvp = static_cast<const float*>(nvp);
  return a;
}

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

// The tile loop over row b's cached tokens for kv head h.  Fills qf with the
// f32 q * sm_scale and leaves the online-softmax state in m, l (the same in
// every thread) and acc (output dimension tid, for tid < D).
template <class Addr>
__device__ __forceinline__ void attend_cached(const Args& a, const Addr& at,
                                              int b, int h, int len,
                                              float (*qf)[MAXD],
                                              float (&m)[MAXG],
                                              float (&l)[MAXG],
                                              float (&acc)[MAXG]) {
  __shared__ float qd[MAXG][MAXD];      // q as the QK dot sees it
  __shared__ float qsum_s[MAXG], qs_s[MAXG];
  __shared__ uint8_t kt[MAXD / 2][T], vt[T][VROW];
  __shared__ float kpar[2][T], vpar[2][T];
  __shared__ float ps[MAXG][T];
  __shared__ float sbuf[NW][MAXG];

  const int tid = threadIdx.x;
  const int G = a.G, D = a.D, D2 = a.D / 2;
  const int Hq = a.Hkv * G;
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

  for (int g = 0; g < MAXG; ++g) { m[g] = -INFINITY; l[g] = 0.0f; acc[g] = 0.0f; }

  const int len_tab = min(len, at.cap());            // never past the row
  for (int t0 = 0; t0 < len_tab; t0 += T) {
    // thread t stages token t0 + t of the tile
    const int t = tid;
    const bool tok = t < min(T, len_tab - t0);       // a cached token
    const size_t cb = tok ? at.codes(t0 + t) : 0;
    for (int d2 = 0; d2 < D2; ++d2) {
      kt[d2][t] = tok ? a.kq[cb + (size_t)d2 * stride] : 0;
      vt[t][d2] = tok ? a.vq[cb + (size_t)d2 * stride] : 0;
    }
    const size_t pb = tok ? at.params(t0 + t) : 0;
    kpar[0][t] = tok ? a.kp[pb] : 0.0f;
    kpar[1][t] = tok ? a.kp[pb + stride] : 0.0f;
    vpar[0][t] = tok ? a.vp[pb] : 0.0f;
    vpar[1][t] = tok ? a.vp[pb + stride] : 0.0f;
    __syncthreads();

    // scores of token t for every query row
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
}

// The reference's _self_fold_finalize: one more online-softmax step over the
// new token's dequantized (k_self, v_self) with the f32 q, then
// out = bf16(acc / l).  Thread d < D writes output dimension d.
__device__ __forceinline__ void fold_self(const Args& a, int b, int h,
                                          const float (*qf)[MAXD],
                                          const float (&m)[MAXG],
                                          const float (&l)[MAXG],
                                          const float (&acc)[MAXG]) {
  const int tid = threadIdx.x;
  const int G = a.G, D = a.D;
  const int Hq = a.Hkv * G;
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
}

template <class Addr>
__device__ __forceinline__ void self_append(const Args& a, const Addr& at,
                                            int b, int h) {
  __shared__ float qf[MAXG][MAXD];      // f32 q * sm_scale
  const int tid = threadIdx.x;
  const int D2 = a.D / 2;
  const int len = a.lengths[b];
  const int stride = at.stride();
  float m[MAXG], l[MAXG], acc[MAXG];
  attend_cached(a, at, b, h, len, qf, m, l, acc);
  fold_self(a, b, h, qf, m, l, acc);

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

template <class Addr>
__device__ __forceinline__ void read_only(const Args& a, const Addr& at,
                                          int b, int h) {
  __shared__ float qf[MAXG][MAXD];
  const int tid = threadIdx.x;
  const int G = a.G, D = a.D;
  const int Hq = a.Hkv * G;
  float m[MAXG], l[MAXG], acc[MAXG];
  attend_cached(a, at, b, h, a.lengths[b], qf, m, l, acc);
  if (tid < D) {
    for (int g = 0; g < G; ++g)
      a.out[((size_t)b * Hq + h * G + g) * D + tid] =
          __float2bfloat16_rn(__fdiv_rn(acc[g], l[g]));
  }
  if (tid == 0 && a.m_out != nullptr) {
    const size_t srow = ((size_t)b * a.Hkv + h) * G;
    for (int g = 0; g < G; ++g) {
      a.m_out[srow + g] = m[g];
      a.l_out[srow + g] = l[g];
    }
  }
}

template <class Addr>
__device__ __forceinline__ void read_only_self(const Args& a, const Addr& at,
                                               int b, int h) {
  __shared__ float qf[MAXG][MAXD];
  float m[MAXG], l[MAXG], acc[MAXG];
  attend_cached(a, at, b, h, a.lengths[b], qf, m, l, acc);
  fold_self(a, b, h, qf, m, l, acc);
}

}  // namespace int4_attention
