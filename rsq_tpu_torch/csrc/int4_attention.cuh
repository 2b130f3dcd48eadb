// Device bodies shared by the INT4 decode-attention kernels: the paged ones
// (paged_attention.cu) and the contiguous-slot ones (contiguous_attention.cu),
// each in three forms -- `self_append`, which folds the new token in and
// appends it; `read_only_self`, the same fold over a cache it only reads;
// and `read_only`, which attends over the cached tokens and emits the
// softmax state.  The kernels differ only in where row b's tokens live, so
// the body is templated on an addressing functor; all six run the one
// tile loop, merge and fold (`attend`), so none can drift from the others.
//
// Computes, per batch row b and kv head h, for the G = Hq/Hkv query rows of
//   that head (q pre-scaled by sm_scale in f32), over the cached tokens pos
//   < len, the reference's _attend_tile (rsq_tpu/kernels/kv_cache.py
//   :265-371) rounding points:
//     logits = raw*ks - qsum*kz, raw = bf16(q) . u (or, with int8_qk,
//       int_dot(q_i8, u) * qs with qs = max|q| * f32(1/127), the reference's
//       `/ 127.0` as XLA compiles it under jit), masked with -1e30;
//     online softmax (m, l); ps = bf16(p*vs); acc = acc*alpha + ps.u_v - sum(p*vz)
//   and the states of the row's parts merged (acc and l weighed by exp(m_r -
//   m)); then _self_fold_finalize (:435-471, mix=False): one more softmax
//   step over the new token's dequantized (k_self, v_self) with the f32 q,
//   out = bf16(acc/l).  A row of length 0 gives out = v_self.
// self_append runs it, then writes the new token's codes and (scale, zero)
//   in place at the column the functor names; read_only_self runs it alone.
// read_only writes out = bf16(acc/l) and, where asked, the state m and l
//   (the reference's _decode_kernel_pref, :374-432).  A row of length 0
//   reads nothing: out = bf16(0/0) = NaN, m = -inf, l = 0 (the serving
//   paths never read such a row: they append before they attend).
// Bound on this card: the cache bytes of the cached tokens (D/2 code bytes
//   and 8 parameter bytes per token, for k and for v, per kv head) -- about
//   4.7 MB per Llama-3-8B layer at B=8, fill 512, 0.0015 ms at 3.35 TB/s.
// Design, after bf16_attention.cu's:
//   - Each (b, kv head) row is split over the sequence by a thread-block
//     cluster of CL <= 8 blocks, sized by the wrapper from the tokens a row
//     can hold (S, or the page table's width x page), never from the
//     lengths, which live on the card.  Block r takes 64-token tiles
//     [r*T/CL, (r+1)*T/CL) of the row's T tiles (kv_cache.
//     int4_attention_chunks mirrors the split).
//   - A 3-stage cp.async ring (smem_ring.cuh) stages each tile's code rows
//     (D/2 rows of 64 bytes, pitch 80: conflict-free fragment reads) and
//     parameter rows in runs of W tokens that the functor addresses one at
//     a time, so a tile may straddle pages of any size (W = 16, 4 or 1
//     token, the widest that the row or page layout aligns: 16- and 4-byte
//     copies, or byte loads).  Bytes of tokens at or past the length are
//     zero-filled (cp.async's source size), never read.
//   - Each of the 4 warps owns 16 tokens of every tile and keeps its own
//     online-softmax state: no block-wide reductions in the loop.  Scores
//     on the tensor cores with the tokens on the m side and the <= 8 query
//     rows on the n side, the k index running over (d, d + D/2) pairs so
//     that one code byte gives two operands: with int8_qk an exact integer
//     dot, mma.sync.m16n8k32 u8 x s8 -> s32; else bf16 codes (0..15, exact)
//     times bf16(q) on m16n8k16 with f32 sums.  P.V on m16n8k16 with d on
//     the m side (low nibbles rows 0-7, high 8-15 of each 8-byte code run)
//     and bf16(p*vs) on the n side, turned from (token, row pairs) into
//     (row, token pairs) by movmatrix.trans.  A warp whose 16 tokens all lie
//     at or past the length skips the tile, so a state is either empty (m =
//     -inf, l = 0) or has a live token.
//   - The states merge in a fixed order, so runs repeat bit for bit: the 4
//     warps' in the block, then the CL blocks' in rank order through
//     distributed shared memory; an empty state weighs 0.  The blocks share
//     the row's output elements; each folds the new token into its own.
//     The self-append form's rank 0 writes the new column (int4_append.cuh,
//     a warp for k and one for v) after the cluster barrier that follows
//     every block's last read of the row, so no append is lost.  One
//     launch, no workspace.
//   - NaN: a query row with a NaN keeps it through the int8_qk scale (an
//     integer max of |q|'s bits), the running max (max.NaN) and the merges
//     (a state is empty only at l = 0), so that row's logits, m, l and
//     output come out NaN, as the plain version's amax and maximum give,
//     and the other rows of its (b, kv head) row are untouched.
//
// Addressing functor (the codes and parameters of one (b, h) share it):
//   int cap() const              tokens the row can address (reads stop there)
//   int stride() const           elements between rows d2 (and param rows)
//   size_t codes(int t) const    offset of (d2 = 0, token t) in kq / vq; the
//                                W tokens from a multiple of W lie contiguous
//   size_t params(int t) const   offset of (row 0, token t) in kp / vp
//   bool append(int len, size_t* c, size_t* p) const
//                                the new token's column; false: write nothing
//                                (self_append, and the standalone appends)

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "int4_append.cuh"
#include "max_nan.cuh"
#include "smem_ring.cuh"

namespace int4_attention {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int TT = 16 * NW;          // tokens per tile, 16 per warp
constexpr int MAXD = 128;
constexpr int MAXD2 = MAXD / 2;
constexpr int MAXG = 8;
constexpr int CP = TT + 16;          // code row pitch: rows 20 banks apart
constexpr int CODE_TILE = MAXD2 * CP;
constexpr int PAR_TILE = 2 * TT * 4;          // (scale, zero) rows, f32
constexpr int STAGE = 2 * CODE_TILE + 2 * PAR_TILE;
constexpr int STAGES = 3;
constexpr int MAXCL = 8;             // a portable cluster
constexpr float MASK_VALUE = -1e30f;

enum Form { kReadOnly = 0, kReadOnlySelf = 1, kSelfAppend = 2 };

struct Args {
  const __nv_bfloat16* q;     // (B, Hq, D)
  int4_append::Column c;      // the codes and (scale, zero) (updated in
                              // place by self_append) and the new token's
                              // (B, Hkv, D/2) codes and (B, Hkv, 2)
                              // parameters (self_append only)
  const int32_t* lengths;     // (B,) cached tokens
  const float* k_self;        // (B, Hkv, D) dequantized new token (self forms)
  const float* v_self;
  __nv_bfloat16* out;         // (B, Hq, D)
  int Hkv, G, D;
  float sm_scale;
  int int8_qk;
  float inv127;
  int width;                  // tokens per staged copy: 16, 4 or 1
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
                      int int8_qk, float inv127, int width) {
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.c = int4_append::column(kq, kp, vq, vp, nullptr, nullptr, nullptr,
                            nullptr);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.Hkv = Hkv; a.G = G; a.D = D;
  a.sm_scale = sm_scale; a.int8_qk = int8_qk; a.inv127 = inv127;
  a.width = width;
  return a;
}

// make_args plus the new token of the self-append form.
inline Args self_args(const void* q, void* kq, void* kp, void* vq, void* vp,
                      const void* lengths, const void* k_self,
                      const void* v_self, const void* nkq, const void* nkp,
                      const void* nvq, const void* nvp, void* out, int Hkv,
                      int G, int D, float sm_scale, int int8_qk,
                      float inv127, int width) {
  Args a = make_args(q, kq, kp, vq, vp, lengths, out, Hkv, G, D, sm_scale,
                     int8_qk, inv127, width);
  a.k_self = static_cast<const float*>(k_self);
  a.v_self = static_cast<const float*>(v_self);
  a.c = int4_append::column(kq, kp, vq, vp, nkq, nkp, nvq, nvp);
  return a;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_u8s8(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 8x8 bf16 matrix whose row lane/4 holds this thread's pair at columns
// 2*(lane%4), +1, transposed across the warp.
__device__ __forceinline__ uint32_t transpose8(uint32_t v) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(r) : "r"(v));
  return r;
}

// bf16(lo), bf16(hi) as one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16 pair (128 + a, 128 + b) -> (a, b), exactly
__device__ __forceinline__ uint32_t sub128(uint32_t v) {
  const __nv_bfloat162 k128 = __halves2bfloat162(
      __ushort_as_bfloat16(0x4300), __ushort_as_bfloat16(0x4300));
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), k128);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// One code byte -> its (low, high) nibbles as a bf16 pair
__device__ __forceinline__ uint32_t nib_pair(uint32_t byte) {
  return sub128((byte & 0x0Fu) | ((byte & 0xF0u) << 12) | 0x43004300u);
}

// Two code bytes (a 16-bit word) -> their low nibbles and their high
// nibbles, each as a bf16 pair in byte order
__device__ __forceinline__ void nib_pairs16(uint32_t w, uint32_t& lo,
                                            uint32_t& hi) {
  lo = sub128((w & 0x000Fu) | ((w & 0x0F00u) << 8) | 0x43004300u);
  hi = sub128(((w >> 4) & 0x000Fu) | ((w & 0xF000u) << 4) | 0x43004300u);
}

// Two code bytes -> u8 x4 (low x0, high x0, low x1, high x1)
__device__ __forceinline__ uint32_t nib_u8x4(uint32_t x0, uint32_t x1) {
  const uint32_t w = x0 | (x1 << 8);
  return __byte_perm(w & 0x0F0Fu, (w >> 4) & 0x0F0Fu, 0x5140);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Row b, kv head h of form FORM, run by block blockIdx.x (the cluster rank)
// of a (CL, B * Hkv) grid in clusters of (CL, 1, 1).
template <int FORM, class Addr>
__device__ __forceinline__ void attend(const Args& a, const Addr& at, int b,
                                       int h) {
  __shared__ __align__(16) uint8_t ring[STAGES * STAGE];
  __shared__ float qf[MAXG][MAXD];        // f32 q * sm_scale (the fold's)
  __shared__ uint16_t qd[MAXG][MAXD];     // bf16(q), or q_i8 in the low byte
  __shared__ float qsum_s[MAXG], qs_s[MAXG], lgs_s[MAXG];
  __shared__ float wm[NW][MAXG], wl[NW][MAXG];        // the warps' states
  __shared__ float bm[MAXG], bl[MAXG];                // the block's state
  __shared__ __align__(16) float bacc[MAXG][MAXD];

  using namespace smem_ring;
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = gridDim.x, rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int G = a.G, D = a.D, D2 = a.D / 2, Hq = a.Hkv * G;
  const int stride = at.stride(), W = a.width;
  const bool i8 = a.int8_qk != 0;
  const int len = max(0, min(a.lengths[b], at.cap()));   // never past the row
  const int ntiles = (len + TT - 1) / TT;
  const int j0 = rank * ntiles / CL, nt = (rank + 1) * ntiles / CL - j0;
  const size_t srow = ((size_t)b * a.Hkv + h) * D;

  // tile j into ring slot `slot`: runs of W tokens of each code and
  // parameter row, the bytes of tokens at or past the length zero-filled
  auto load = [&](int j, int slot) {
    uint8_t* kt = ring + slot * STAGE;
    uint8_t* vt = kt + CODE_TILE;
    float* kpar = reinterpret_cast<float*>(vt + CODE_TILE);
    float* vpar = kpar + 2 * TT;
    const int per_row = TT / W;
    for (int i = tid; i < D2 * per_row; i += THREADS) {
      const int r = i / per_row, c = i % per_row, tok = j * TT + c * W;
      const int n = max(0, min(W, len - tok));        // live tokens
      const size_t off = n > 0 ? at.codes(tok) + (size_t)r * stride : 0;
      uint8_t* kd = kt + r * CP + c * W;
      uint8_t* vd = vt + r * CP + c * W;
      if (W == 1) {
        *kd = n > 0 ? a.c.kq[off] : 0;
        *vd = n > 0 ? a.c.vq[off] : 0;
      } else {
        cp_async(kd, a.c.kq + off, n, W);
        cp_async(vd, a.c.vq + off, n, W);
      }
    }
    const int PW = W == 1 ? 1 : 4, pper = TT / PW;
    for (int i = tid; i < 2 * pper; i += THREADS) {
      const int r = i / pper, c = i % pper, tok = j * TT + c * PW;
      const int n = max(0, min(PW, len - tok));
      const size_t off = n > 0 ? at.params(tok) + (size_t)r * stride : 0;
      cp_async(kpar + r * TT + c * PW, a.c.kp + off, 4 * n, 4 * PW);
      cp_async(vpar + r * TT + c * PW, a.c.vp + off, 4 * n, 4 * PW);
    }
  };

  // the ring fills while q is prepared
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load(j0 + s, s);
    cp_commit();
  }

  // q rows w, w + NW (zero past G and D), lane d = lane + 32i
  for (int gg = w; gg < MAXG; gg += NW) {
    float v[MAXD / 32];
#pragma unroll
    for (int i = 0; i < MAXD / 32; ++i) {
      const int d = lane + 32 * i;
      v[i] = gg < G && d < D
          ? __fmul_rn(__bfloat162float(a.q[((size_t)b * Hq + h * G + gg) * D + d]),
                      a.sm_scale)
          : 0.0f;
      qf[gg][d] = v[i];
    }
    if (i8) {
      // max |q| as unsigned bits: a NaN's lie above +inf's, so the max
      // keeps it and the head's scale, logits and output come out NaN
      unsigned mb = 0;
#pragma unroll
      for (int i = 0; i < MAXD / 32; ++i)
        mb = max(mb, __float_as_uint(fabsf(v[i])));
      const float mx = __uint_as_float(__reduce_max_sync(0xffffffffu, mb));
      const float qs = mx == 0.0f ? 1.0f : __fmul_rn(mx, a.inv127);
      float isum = 0.0f;
#pragma unroll
      for (int i = 0; i < MAXD / 32; ++i) {
        const float qi = fminf(fmaxf(rintf(__fdiv_rn(v[i], qs)), -127.0f),
                               127.0f);
        qd[gg][lane + 32 * i] = (uint16_t)(uint8_t)(int8_t)(int)qi;
        isum += qi;                       // integers: exact in any order
      }
      isum = warp_sum(isum);
      if (lane == 0) {
        qs_s[gg] = qs;
        qsum_s[gg] = __fmul_rn(isum, qs);
      }
    } else {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < MAXD / 32; ++i) {
        s = __fadd_rn(s, v[i]);
        qd[gg][lane + 32 * i] =
            __bfloat16_as_ushort(__float2bfloat16_rn(v[i]));
      }
      s = warp_sum(s);
      if (lane == 0) {
        qs_s[gg] = 1.0f;
        qsum_s[gg] = s;
      }
    }
    if (FORM != kReadOnly) {              // the new token's logit
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < MAXD / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D) s = __fadd_rn(s, __fmul_rn(v[i], a.k_self[srow + d]));
      }
      s = warp_sum(s);
      if (lane == 0) lgs_s[gg] = s;
    }
  }
  __syncthreads();

  // B fragments of q (column g): k step s pairs code rows d2 with (d2, d2 +
  // D/2); bf16: rows 8s + t, +4; int8: rows 16s + t, +4, +8, +12
  auto qv = [&](int d2, int hi) -> uint32_t {
    return d2 < D2 ? qd[g][d2 + hi * D2] : 0u;
  };
  uint32_t qfr[8][2];
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (i8) {
        const int r = 16 * s + t + 8 * u;
        qfr[s][u] = s < 4 ? (qv(r, 0) & 0xFFu) | ((qv(r, 1) & 0xFFu) << 8) |
                                ((qv(r + 4, 0) & 0xFFu) << 16) |
                                ((qv(r + 4, 1) & 0xFFu) << 24)
                          : 0u;
      } else {
        const int r = 8 * s + t + 4 * u;
        qfr[s][u] = qv(r, 0) | (qv(r, 1) << 16);
      }
    }
  const float qs0 = qs_s[2 * t], qs1 = qs_s[2 * t + 1];
  const float qz0 = qsum_s[2 * t], qz1 = qsum_s[2 * t + 1];

  // this warp's state: rows 2t, 2t+1; acc[i]: d = 8i + g (c 0, 1) and
  // 8i + g + D/2 (c 2, 3) by those rows
  float m_[2] = {-INFINITY, -INFINITY}, l_[2] = {0.0f, 0.0f};
  float acc[MAXD2 / 8][4];
#pragma unroll
  for (int i = 0; i < MAXD2 / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  for (int jj = 0; jj < nt; ++jj) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (jj + STAGES - 1 < nt)
      load(j0 + jj + STAGES - 1, (jj + STAGES - 1) % STAGES);
    cp_commit();
    const int tok0 = (j0 + jj) * TT + 16 * w;       // the warp's tokens
    if (tok0 >= len) continue;
    const uint8_t* kt = ring + (jj % STAGES) * STAGE;
    const uint8_t* vt = kt + CODE_TILE;
    const float* kpar = reinterpret_cast<const float*>(vt + CODE_TILE);
    const float* vpar = kpar + 2 * TT;
    const int lt = 16 * w + g;                      // tokens lt, lt + 8

    // s: (token lt, rows 2t, 2t+1), then (token lt + 8, the same rows)
    float s[4];
    if (i8) {
      int ci[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (16 * ks < D2) {
          const uint8_t* r0 = kt + (16 * ks + t) * CP + lt;
          const uint32_t af[4] = {nib_u8x4(r0[0], r0[4 * CP]),
                                  nib_u8x4(r0[8], r0[4 * CP + 8]),
                                  nib_u8x4(r0[8 * CP], r0[12 * CP]),
                                  nib_u8x4(r0[8 * CP + 8], r0[12 * CP + 8])};
          mma_u8s8(ci, af, qfr[ks][0], qfr[ks][1]);
        }
      s[0] = __fmul_rn((float)ci[0], qs0);
      s[1] = __fmul_rn((float)ci[1], qs1);
      s[2] = __fmul_rn((float)ci[2], qs0);
      s[3] = __fmul_rn((float)ci[3], qs1);
    } else {
      s[0] = s[1] = s[2] = s[3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        if (8 * ks < D2) {
          const uint8_t* r0 = kt + (8 * ks + t) * CP + lt;
          const uint32_t af[4] = {nib_pair(r0[0]), nib_pair(r0[8]),
                                  nib_pair(r0[4 * CP]),
                                  nib_pair(r0[4 * CP + 8])};
          mma_bf16(s, af, qfr[ks][0], qfr[ks][1]);
        }
    }
    const float ks0 = kpar[lt], kz0 = kpar[TT + lt];
    const float ks1 = kpar[lt + 8], kz1 = kpar[TT + lt + 8];
    float lg[4] = {__fsub_rn(__fmul_rn(s[0], ks0), __fmul_rn(qz0, kz0)),
                   __fsub_rn(__fmul_rn(s[1], ks0), __fmul_rn(qz1, kz0)),
                   __fsub_rn(__fmul_rn(s[2], ks1), __fmul_rn(qz0, kz1)),
                   __fsub_rn(__fmul_rn(s[3], ks1), __fmul_rn(qz1, kz1))};
    if (tok0 + g >= len) lg[0] = lg[1] = MASK_VALUE;
    if (tok0 + g + 8 >= len) lg[2] = lg[3] = MASK_VALUE;
    float mx0 = max_nan(lg[0], lg[2]), mx1 = max_nan(lg[1], lg[3]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      mx0 = max_nan(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = max_nan(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = max_nan(m_[0], mx0), mn1 = max_nan(m_[1], mx1);
    const float al0 = expf(m_[0] - mn0), al1 = expf(m_[1] - mn1);
    const float p0 = expf(lg[0] - mn0), p1 = expf(lg[1] - mn1);
    const float p2 = expf(lg[2] - mn0), p3 = expf(lg[3] - mn1);
    const float vs0 = vpar[lt], vz0 = vpar[TT + lt];
    const float vs1 = vpar[lt + 8], vz1 = vpar[TT + lt + 8];
    float ps0 = __fadd_rn(p0, p2), ps1 = __fadd_rn(p1, p3);
    float z0 = __fadd_rn(__fmul_rn(p0, vz0), __fmul_rn(p2, vz1));
    float z1 = __fadd_rn(__fmul_rn(p1, vz0), __fmul_rn(p3, vz1));
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      ps0 = __fadd_rn(ps0, __shfl_xor_sync(0xffffffffu, ps0, o));
      ps1 = __fadd_rn(ps1, __shfl_xor_sync(0xffffffffu, ps1, o));
      z0 = __fadd_rn(z0, __shfl_xor_sync(0xffffffffu, z0, o));
      z1 = __fadd_rn(z1, __shfl_xor_sync(0xffffffffu, z1, o));
    }
    l_[0] = __fadd_rn(__fmul_rn(al0, l_[0]), ps0);
    l_[1] = __fadd_rn(__fmul_rn(al1, l_[1]), ps1);
    m_[0] = mn0;
    m_[1] = mn1;
    // bf16(p * vs) as (tokens 2t, 2t+1; row g), then tokens + 8
    const uint32_t b0 = transpose8(
        pack_bf16(__fmul_rn(p0, vs0), __fmul_rn(p1, vs0)));
    const uint32_t b1 = transpose8(
        pack_bf16(__fmul_rn(p2, vs1), __fmul_rn(p3, vs1)));
#pragma unroll
    for (int i = 0; i < MAXD2 / 8; ++i)
      if (8 * i < D2) {
        acc[i][0] = __fmul_rn(acc[i][0], al0);
        acc[i][1] = __fmul_rn(acc[i][1], al1);
        acc[i][2] = __fmul_rn(acc[i][2], al0);
        acc[i][3] = __fmul_rn(acc[i][3], al1);
        // V^T: code row 8i + g, the warp's tokens 2t, 2t+1 (then + 8)
        const uint8_t* vr = vt + (8 * i + g) * CP + 16 * w + 2 * t;
        uint32_t af[4];
        nib_pairs16(*reinterpret_cast<const uint16_t*>(vr), af[0], af[1]);
        nib_pairs16(*reinterpret_cast<const uint16_t*>(vr + 8), af[2], af[3]);
        mma_bf16(acc[i], af, b0, b1);
        acc[i][0] = __fsub_rn(acc[i][0], z0);
        acc[i][1] = __fsub_rn(acc[i][1], z1);
        acc[i][2] = __fsub_rn(acc[i][2], z0);
        acc[i][3] = __fsub_rn(acc[i][3], z1);
      }
  }
  cp_wait<0>();
  __syncthreads();                                  // the ring is idle

  // the warps' states into shared memory (acc in the idle ring), then the
  // block's: the warps merged in order, an empty one (l = 0) weighing 0; a
  // NaN state (l NaN) is merged, so the row's m, l and output stay NaN
  float* wacc = reinterpret_cast<float*>(ring);     // NW x MAXG x MAXD
  if (g == 0) {
    wm[w][2 * t] = m_[0]; wm[w][2 * t + 1] = m_[1];
    wl[w][2 * t] = l_[0]; wl[w][2 * t + 1] = l_[1];
  }
#pragma unroll
  for (int i = 0; i < MAXD2 / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (8 * i + g < D2)
        wacc[(w * MAXG + 2 * t + (c & 1)) * MAXD + 8 * i + g + (c >> 1) * D2] =
            acc[i][c];
  __syncthreads();
  for (int e = tid; e < G * D; e += THREADS) {
    const int row = e / D, d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int v = 0; v < NW; ++v)
      if (wl[v][row] != 0.0f) mx = max_nan(mx, wm[v][row]);
    float sa = 0.0f;
#pragma unroll
    for (int v = 0; v < NW; ++v)
      if (wl[v][row] != 0.0f)
        sa = __fadd_rn(sa, __fmul_rn(expf(wm[v][row] - mx),
                                     wacc[(v * MAXG + row) * MAXD + d]));
    bacc[row][d] = sa;
  }
  if (tid < G) {
    float mx = -INFINITY, l = 0.0f;
#pragma unroll
    for (int v = 0; v < NW; ++v)
      if (wl[v][tid] != 0.0f) mx = max_nan(mx, wm[v][tid]);
#pragma unroll
    for (int v = 0; v < NW; ++v)
      if (wl[v][tid] != 0.0f)
        l = __fadd_rn(l, __fmul_rn(expf(wm[v][tid] - mx), wl[v][tid]));
    bm[tid] = mx;
    bl[tid] = l;
  }

  // the row's state: the blocks merged in rank order; block r finishes
  // elements r*THREADS + tid, + CL*THREADS, ... (and folds the new token in)
  cluster.sync();
  for (int e = rank * THREADS + tid; e < G * D; e += CL * THREADS) {
    const int row = e / D, d = e % D;
    float mx = -INFINITY;
    for (int r = 0; r < CL; ++r)
      if (*cluster.map_shared_rank(&bl[row], r) != 0.0f)
        mx = max_nan(mx, *cluster.map_shared_rank(&bm[row], r));
    float sa = 0.0f, l = 0.0f;
    for (int r = 0; r < CL; ++r) {
      const float lr = *cluster.map_shared_rank(&bl[row], r);
      if (lr != 0.0f) {
        const float wt = expf(*cluster.map_shared_rank(&bm[row], r) - mx);
        sa = __fadd_rn(sa, __fmul_rn(wt, *cluster.map_shared_rank(&bacc[row][d], r)));
        l = __fadd_rn(l, __fmul_rn(wt, lr));
      }
    }
    __nv_bfloat16* o = a.out + ((size_t)b * Hq + h * G + row) * D + d;
    if (FORM == kReadOnly) {
      *o = __float2bfloat16_rn(__fdiv_rn(sa, l));
      if (d == 0 && a.m_out != nullptr) {
        a.m_out[((size_t)b * a.Hkv + h) * G + row] = mx;
        a.l_out[((size_t)b * a.Hkv + h) * G + row] = l;
      }
    } else {
      // _self_fold_finalize: one more step over the new token
      const float lgs = lgs_s[row];
      const float mf = max_nan(mx, lgs);
      const float alpha = expf(mx - mf), p = expf(lgs - mf);
      const float lf = __fadd_rn(__fmul_rn(l, alpha), p);
      const float v = __fadd_rn(__fmul_rn(sa, alpha),
                                __fmul_rn(p, a.v_self[srow + d]));
      *o = __float2bfloat16_rn(__fdiv_rn(v, lf));
    }
  }

  // append the new token's column in place (int4_append.cuh; warps 0 and
  // 1 of rank 0 write k and v): every block of the cluster has read its
  // last byte of this row before the barrier above
  if (FORM == kSelfAppend && rank == 0 && w < 2)
    int4_append::write_half(a.c, at, a.lengths[b], (size_t)b * a.Hkv + h,
                            D2, w);
  cluster.sync();                    // no block leaves while read from
}

// Launch `kernel` on a (cl, rows) grid in clusters of (cl, 1, 1).
template <typename... Params, typename... Ts>
inline int launch(void (*kernel)(Params...), int cl, int rows,
                  void* stream, Ts... args) {
  if (cl < 1 || cl > MAXCL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, rows, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace int4_attention
