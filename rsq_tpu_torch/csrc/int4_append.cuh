// The INT4 caches' one-column append, written once for every caller: the
// contiguous cache's append (row 7, kv_append in contiguous_attention.cu),
// the page pool's (row 21, paged_append in paged_attention.cu) and the
// self-appending attention's tail (rows 4 and 19, int4_attention.cuh).
//
// Computes, for one (b, kv head) row: the new token's D/2 code bytes
//   nkq[row, :] into kq[c + d2 * stride] and its (scale, zero) pair
//   nkp[row, :] into kp[p + j * stride], the same for v, where the
//   addressing functor's append(len, &c, &p) names the column and stride()
//   the distance between its rows (S, or the page); false writes nothing.
// Bound on this card: 2 * (D/2 + 8) bytes a row, so launch latency.
// Design: the time is a chain of dependent steps (the length, for pages
//   then the page id, then the address) ahead of stores that are each their
//   own 32-byte sector.  So a warp runs the chain once for half a row (k or
//   v), its lanes load the new code bytes before the chain resolves (two a
//   lane at D/2 = 64), then each lane stores its bytes down the column and
//   lanes 0 and 1 the parameters.  The standalone appends run one warp a
//   block on a (2 * Hkv, B) grid: no divide, and the stores spread over as
//   many SMs as there are warps (4 warps a block, a warp for all of a row,
//   or 4-byte words in place of bytes, measured no faster on the H100:
//   PERF.md section 6).

#pragma once

#include <stdint.h>

namespace int4_append {

// The caches an append writes and the new token it writes there; the
// attention kernels' Args carry the same struct.
struct Column {
  uint8_t* kq;                       // the caches, written in place
  float* kp;
  uint8_t* vq;
  float* vp;
  const uint8_t* nkq;                // (rows, D/2) the new token's codes
  const float* nkp;                  // (rows, 2) its (scale, zero)
  const uint8_t* nvq;
  const float* nvp;
};

inline Column column(const void* kq, const void* kp, const void* vq,
                     const void* vp, const void* nkq, const void* nkp,
                     const void* nvq, const void* nvp) {
  return {static_cast<uint8_t*>(const_cast<void*>(kq)),
          static_cast<float*>(const_cast<void*>(kp)),
          static_cast<uint8_t*>(const_cast<void*>(vq)),
          static_cast<float*>(const_cast<void*>(vp)),
          static_cast<const uint8_t*>(nkq), static_cast<const float*>(nkp),
          static_cast<const uint8_t*>(nvq), static_cast<const float*>(nvp)};
}

// Warp `half` (0: k, 1: v) writes that half of row `row`'s new column at
// length `len` through `at`: lane i the code bytes i, i + 32, ..., R a
// lane a pass (one pass up to D/2 = 64), then lanes 0 and 1 the (scale,
// zero) pair.  Every lane of the warp calls it.
template <class Addr>
__device__ __forceinline__ void write_half(const Column& a, const Addr& at,
                                           int len, size_t row, int D2,
                                           int half) {
  constexpr int R = 2;
  const int lane = threadIdx.x & 31;
  const uint8_t* src = (half ? a.nvq : a.nkq) + row * D2;
  uint8_t* dst = half ? a.vq : a.kq;
  uint8_t v[R];
  auto load = [&](int i0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + 32 * r + lane;
      if (i < D2) v[r] = src[i];
    }
  };
  size_t c, p;
  auto store = [&](int i0) {
    const size_t stride = at.stride();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + 32 * r + lane;
      if (i < D2) dst[c + (size_t)i * stride] = v[r];
    }
  };
  load(0);
  const float par = lane < 2 ? (half ? a.nvp : a.nkp)[row * 2 + lane] : 0.0f;
  if (!at.append(len, &c, &p)) return;     // the address chain, behind them
  store(0);
  for (int i0 = 32 * R; i0 < D2; i0 += 32 * R) {
    load(i0);
    store(i0);
  }
  if (lane < 2) (half ? a.vp : a.kp)[p + (size_t)lane * at.stride()] = par;
}

}  // namespace int4_append
