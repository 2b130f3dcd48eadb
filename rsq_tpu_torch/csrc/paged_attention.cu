// Paged INT4 decode attention with the new token folded in and appended.
//
// Replaces: rsq_tpu/kernels/paged_kv.py int4_paged_decode_attention_self_append
//   (:463) -- both its grid kernel _paged_kernel_self_append (:388) and its
//   one-grid-step twin _paged_kernel_self_append_flat (:580), which compute
//   the same function (the split exists only for TPU grid-step overhead).
// Computes: int4_attention.cuh's body over row b's cached tokens, found
//   through the page table; the new token goes to
//   (layer, ptab[b, len // page], h, :, len % page).
// Bound on this card: the pool bytes of the cached tokens (D/2 code bytes
//   plus 8 parameter bytes per token, for k and for v, per kv head) -- about
//   4.7 MB per Llama-3-8B layer at B=8, fill 512.
// Design: int4_attention.cuh, one block per (b, kv head), 128-token tiles (a
//   page is a multiple of 128, so a tile never straddles pages).  Rows of
//   length 0 (idle engine slots) all point at the engine's null page and
//   write its column 0 concurrently: a benign race, since no row ever reads
//   that page.  First version: no split over tiles, so B*Hkv blocks only.

#include "int4_attention.cuh"

namespace {

struct PagedAddr {
  const int32_t* row;   // this batch row's page ids
  int layer, P, Hkv, h, D2, page, NP;

  __device__ size_t head(int pid) const {
    return ((size_t)layer * P + pid) * Hkv + h;
  }
  __device__ int cap() const { return NP * page; }
  __device__ int stride() const { return page; }
  __device__ size_t codes(int t) const {
    return head(row[t / page]) * D2 * page + t % page;
  }
  __device__ size_t params(int t) const {
    return head(row[t / page]) * 2 * page + t % page;
  }
  __device__ bool append(int len, size_t* c, size_t* p) const {
    const size_t hb = head(row[min(len / page, NP - 1)]);
    *c = hb * D2 * page + len % page;
    *p = hb * 2 * page + len % page;
    return true;
  }
};

__global__ void __launch_bounds__(int4_attention::T)
paged_attn_self_append(int4_attention::Args a, const int32_t* __restrict__ ptab,
                       int layer, int P, int page, int NP) {
  const int b = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const PagedAddr at{ptab + (size_t)b * NP, layer, P, a.Hkv, h, a.D / 2, page,
                     NP};
  int4_attention::self_append(a, at, b, h);
}

}  // namespace

extern "C" int paged_attention_self_append_launch(
    const void* q, void* kq, void* kp, void* vq, void* vp, const void* ptab,
    const void* lengths, const void* k_self, const void* v_self,
    const void* nkq, const void* nkp, const void* nvq, const void* nvp,
    void* out, int B, int layer, int P, int Hkv, int G, int D, int page,
    int NP, float sm_scale, int int8_qk, float inv127, void* stream) {
  const int4_attention::Args a{
      static_cast<const __nv_bfloat16*>(q), static_cast<uint8_t*>(kq),
      static_cast<float*>(kp), static_cast<uint8_t*>(vq),
      static_cast<float*>(vp), static_cast<const int32_t*>(lengths),
      static_cast<const float*>(k_self), static_cast<const float*>(v_self),
      static_cast<const uint8_t*>(nkq), static_cast<const float*>(nkp),
      static_cast<const uint8_t*>(nvq), static_cast<const float*>(nvp),
      static_cast<__nv_bfloat16*>(out), Hkv, G, D, sm_scale, int8_qk, inv127};
  paged_attn_self_append<<<B * Hkv, int4_attention::T, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int32_t*>(ptab), layer, P, page, NP);
  return (int)cudaGetLastError();
}
