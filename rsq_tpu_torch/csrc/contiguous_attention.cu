// Contiguous-slot INT4 decode attention with the new token folded in and
// appended.
//
// Replaces: rsq_tpu/kernels/kv_cache.py int4_decode_attention_self_append
//   (:695), Pallas body _decode_kernel_self_append (:654).
// Computes: int4_attention.cuh's body (the same function as the paged
//   kernel) over row b's cached tokens, which lie contiguous along S in the
//   (L, B, Hkv, D/2, S) codes and (L, B, Hkv, 2, S) parameters at layer
//   `layer`; the new token's column (layer, b, h, :, len) is written in
//   place.  Exactly that column: the reference, when an append opens a
//   fresh 512-token chunk, also copies the previous chunk into the new
//   chunk's later lanes (never read, since they lie past the length); the
//   port does not copy them.  A row with len >= S writes nothing.
// Bound on this card: the cache bytes of the cached tokens -- about 4.7 MB
//   per Llama-3-8B layer at B=8, fill 512, the same as the paged kernel.
// Design: int4_attention.cuh, one block per (b, kv head), 128-token tiles
//   read with coalesced loads along S.

#include "int4_attention.cuh"

namespace {

struct ContiguousAddr {
  size_t head;   // (layer * B + b) * Hkv + h
  int D2, S;

  __device__ int cap() const { return S; }
  __device__ int stride() const { return S; }
  __device__ size_t codes(int t) const { return head * D2 * S + t; }
  __device__ size_t params(int t) const { return head * 2 * S + t; }
  __device__ bool append(int len, size_t* c, size_t* p) const {
    if (len >= S) return false;
    *c = codes(len);
    *p = params(len);
    return true;
  }
};

__global__ void __launch_bounds__(int4_attention::T)
contiguous_attn_self_append(int4_attention::Args a, int layer, int B, int S) {
  const int b = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const ContiguousAddr at{((size_t)layer * B + b) * a.Hkv + h, a.D / 2, S};
  int4_attention::self_append(a, at, b, h);
}

}  // namespace

extern "C" int contiguous_attention_self_append_launch(
    const void* q, void* kq, void* kp, void* vq, void* vp,
    const void* lengths, const void* k_self, const void* v_self,
    const void* nkq, const void* nkp, const void* nvq, const void* nvp,
    void* out, int B, int layer, int Hkv, int G, int D, int S,
    float sm_scale, int int8_qk, float inv127, void* stream) {
  const int4_attention::Args a{
      static_cast<const __nv_bfloat16*>(q), static_cast<uint8_t*>(kq),
      static_cast<float*>(kp), static_cast<uint8_t*>(vq),
      static_cast<float*>(vp), static_cast<const int32_t*>(lengths),
      static_cast<const float*>(k_self), static_cast<const float*>(v_self),
      static_cast<const uint8_t*>(nkq), static_cast<const float*>(nkp),
      static_cast<const uint8_t*>(nvq), static_cast<const float*>(nvp),
      static_cast<__nv_bfloat16*>(out), Hkv, G, D, sm_scale, int8_qk, inv127};
  contiguous_attn_self_append<<<B * Hkv, int4_attention::T, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      a, layer, B, S);
  return (int)cudaGetLastError();
}
