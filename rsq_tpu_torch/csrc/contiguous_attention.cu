// Contiguous-slot INT4 decode attention: with the new token folded in and
// appended (row 4 of the kernel table), read-only with the softmax state
// (row 2), and read-only with the new token folded in (row 3); and the
// contiguous cache's one-token append (row 7).
//
// Replaces: rsq_tpu/kernels/kv_cache.py
//   - int4_decode_attention_self_append (:695), Pallas body
//     _decode_kernel_self_append (:654);
//   - int4_decode_attention_stacked (:497), Pallas body _decode_kernel_pref
//     (:374), and through its L = 1 view int4_decode_attention (:244);
//   - int4_decode_attention_stacked_self (:580), Pallas body
//     _decode_kernel_pref_self (:474);
//   - kv_append_stacked (:1005), Pallas body _append_kernel (:979).
// Computes: int4_attention.cuh's bodies over row b's cached tokens, which
//   lie contiguous along S in the (L, B, Hkv, D/2, S) codes and
//   (L, B, Hkv, 2, S) parameters at layer `layer`.
//   self_append: the new token's column (layer, b, h, :, len) is written in
//   place.  Exactly that column: the reference, when an append opens a
//   fresh 512-token chunk, also copies the previous chunk into the new
//   chunk's later lanes (never read, since they lie past the length); the
//   port does not copy them.  A row with len >= S writes nothing.
//   read_only: out (B, Hq, D) bf16 and m, l (B, Hkv, G) f32; the cache is
//   only read.  A row of length 0: out NaN, m -inf, l 0.
//   read_only_self: out (B, Hq, D) bf16 with the new token folded in; the
//   cache is only read.  A row of length 0: out = v_self.
//   append: column pos[b] of each (layer, b, h) row of the four arrays, in
//   place, exactly that column (the reference's kernel rewrites the
//   128-lane window around it with the same values; nothing is staged
//   here).
// Bound on this card: the cache bytes of the cached tokens -- about 4.7 MB
//   per Llama-3-8B layer at B=8, fill 512, the same as the paged kernel;
//   the append, its 2 * B * Hkv * (D/2 + 8) bytes written, so launch
//   latency.
// Design: int4_attention.cuh, a cluster of blocks per (b, kv head) row
//   splitting it over the sequence, 64-token tiles copied in 16-byte runs
//   along S (S % 16 == 0).  The append is int4_append.cuh's column writer,
//   a warp per (b, h, k or v), on the address this file's functor gives.

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
    if ((unsigned)len >= (unsigned)S) return false;   // nothing past the row
    *c = codes(len);
    *p = params(len);
    return true;
  }
};

// grid (cl, B * Hkv) in clusters of (cl, 1, 1): one cluster per (b, h) row
template <int FORM>
__global__ void __launch_bounds__(int4_attention::THREADS)
contiguous_attn(int4_attention::Args a, int layer, int B, int S) {
  const int b = blockIdx.y / a.Hkv, h = blockIdx.y % a.Hkv;
  const ContiguousAddr at{((size_t)layer * B + b) * a.Hkv + h, a.D / 2, S};
  int4_attention::attend<FORM>(a, at, b, h);
}

// grid (2 * H, B) of one warp: block (2h + half, b) writes half `half` (k,
// v) of row (b, h)'s column pos[b] of layer `layer`
__global__ void __launch_bounds__(32)
kv_append(int4_append::Column a, const int32_t* __restrict__ pos, int B,
          int layer, int H, int D2, int S) {
  const int b = blockIdx.y, h = blockIdx.x >> 1;
  const ContiguousAddr at{((size_t)layer * B + b) * H + h, D2, S};
  int4_append::write_half(a, at, pos[b], (size_t)b * H + h, D2,
                          blockIdx.x & 1);
}

}  // namespace

// cl: blocks per (b, kv head) row (kv_cache.int4_attention_cluster);
// width: tokens per staged copy (kv_cache.int4_copy_width)
extern "C" int contiguous_attention_self_append_launch(
    const void* q, void* kq, void* kp, void* vq, void* vp,
    const void* lengths, const void* k_self, const void* v_self,
    const void* nkq, const void* nkp, const void* nvq, const void* nvp,
    void* out, int B, int layer, int Hkv, int G, int D, int S,
    float sm_scale, int int8_qk, float inv127, int cl, int width,
    void* stream) {
  const int4_attention::Args a = int4_attention::self_args(
      q, kq, kp, vq, vp, lengths, k_self, v_self, nkq, nkp, nvq, nvp, out,
      Hkv, G, D, sm_scale, int8_qk, inv127, width);
  return int4_attention::launch(
      contiguous_attn<int4_attention::kSelfAppend>, cl, B * Hkv, stream, a,
      layer, B, S);
}

extern "C" int contiguous_attention_read_only_launch(
    const void* q, const void* kq, const void* kp, const void* vq,
    const void* vp, const void* lengths, void* out, void* m, void* l, int B,
    int layer, int Hkv, int G, int D, int S, float sm_scale, int int8_qk,
    float inv127, int cl, int width, void* stream) {
  int4_attention::Args a = int4_attention::make_args(
      q, kq, kp, vq, vp, lengths, out, Hkv, G, D, sm_scale, int8_qk, inv127,
      width);
  a.m_out = static_cast<float*>(m);
  a.l_out = static_cast<float*>(l);
  return int4_attention::launch(
      contiguous_attn<int4_attention::kReadOnly>, cl, B * Hkv, stream, a,
      layer, B, S);
}

extern "C" int contiguous_attention_read_only_self_launch(
    const void* q, const void* kq, const void* kp, const void* vq,
    const void* vp, const void* lengths, const void* k_self,
    const void* v_self, void* out, int B, int layer, int Hkv, int G, int D,
    int S, float sm_scale, int int8_qk, float inv127, int cl, int width,
    void* stream) {
  int4_attention::Args a = int4_attention::make_args(
      q, kq, kp, vq, vp, lengths, out, Hkv, G, D, sm_scale, int8_qk, inv127,
      width);
  a.k_self = static_cast<const float*>(k_self);
  a.v_self = static_cast<const float*>(v_self);
  return int4_attention::launch(
      contiguous_attn<int4_attention::kReadOnlySelf>, cl, B * Hkv, stream, a,
      layer, B, S);
}

extern "C" int kv_append_launch(void* kq, void* kp, void* vq, void* vp,
                                const void* pos, const void* nkq,
                                const void* nkp, const void* nvq,
                                const void* nvp, int B, int layer, int H,
                                int D2, int S, void* stream) {
  kv_append<<<dim3(2 * H, B), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      int4_append::column(kq, kp, vq, vp, nkq, nkp, nvq, nvp),
      static_cast<const int32_t*>(pos), B, layer, H, D2, S);
  return (int)cudaGetLastError();
}
