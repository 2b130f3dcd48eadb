// Paged INT4 decode attention, and the paged pool append.
//
// Replaces: rsq_tpu/kernels/paged_kv.py
//   - int4_paged_decode_attention_self_append (:463) -- both its grid kernel
//     _paged_kernel_self_append (:388) and its one-grid-step twin
//     _paged_kernel_self_append_flat (:580), which compute the same function
//     (the split exists only for TPU grid-step overhead): row 19 (and 20);
//   - int4_paged_decode_attention_stacked (:283), Pallas body
//     _paged_kernel_fast, and through its L = 1 view
//     int4_paged_decode_attention (:262): row 17;
//   - int4_paged_decode_attention_stacked_self (:324), Pallas body
//     _paged_kernel_fast_self (:212): row 18;
//   - paged_append_pool (:801), Pallas body _paged_append_kernel (:776):
//     row 21.
// Computes:
//   self_append: int4_attention.cuh's body over row b's cached tokens, found
//     through the page table; the new token goes to
//     (layer, ptab[b, len // page], h, :, len % page).  Pages are multiples
//     of 128 here, as in the reference.
//   read_only: the same tile loop, no self term, no write: out (B, Hq, D)
//     bf16.  Any page size: a 64-token tile straddles up to 64 / page
//     pages, and each run of tokens is found through the table on its own.  A row
//     of length 0 gives out NaN (0/0); the serving path appends first, so
//     it never reads one.
//   read_only_self: the read-only tile loop, any page size, then the self
//     fold of self_append; no write.  A row of length 0 gives v_self.
//   append: one token per row b into (layer, ptab[b, pos // page], h, :,
//     pos % page) of the code and parameter pools, in place, exactly that
//     column (the reference's kernel rewrites its whole window; two rows
//     appending into one page at different lanes cannot lose a write here).
// Bound on this card: attention, the pool bytes of the cached tokens (D/2
//   code bytes plus 8 parameter bytes per token, for k and for v, per kv
//   head) -- about 4.7 MB per Llama-3-8B layer at B=8, fill 512; the append,
//   its 2 * B * Hkv * (D/2 + 8) bytes written, so launch latency.
// Design: int4_attention.cuh, a cluster of blocks per (b, kv head) row
//   splitting it over the sequence, 64-token tiles copied in runs of 16
//   tokens (4, or 1, where the page size does not align them), each run
//   found through the table.  The append is int4_append.cuh's column
//   writer, a warp per (b, h, k or v), on the address this file's functor
//   gives (the page slot clamped to the table).  Rows of length 0 (idle
//   engine slots) all point at the engine's null page and write its column
//   0 concurrently: a benign race, since no row ever reads that page's
//   content for a live token.

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

// grid (cl, B * Hkv) in clusters of (cl, 1, 1): one cluster per (b, h) row
template <int FORM>
__global__ void __launch_bounds__(int4_attention::THREADS)
paged_attn(int4_attention::Args a, const int32_t* __restrict__ ptab,
           int layer, int P, int page, int NP) {
  const int b = blockIdx.y / a.Hkv, h = blockIdx.y % a.Hkv;
  const PagedAddr at{ptab + (size_t)b * NP, layer, P, a.Hkv, h, a.D / 2, page,
                     NP};
  int4_attention::attend<FORM>(a, at, b, h);
}

// grid (2 * H, B) of one warp: block (2h + half, b) writes half `half` (k,
// v) of row (b, h)'s new column, page ptab[b, min(pos[b] / page, NP - 1)],
// lane pos[b] % page, of layer `layer`
__global__ void __launch_bounds__(32)
paged_append(int4_append::Column a, const int32_t* __restrict__ ptab,
             const int32_t* __restrict__ pos, int layer, int P, int H, int D2,
             int page, int NP) {
  const int b = blockIdx.y, h = blockIdx.x >> 1;
  const PagedAddr at{ptab + (size_t)b * NP, layer, P, H, h, D2, page, NP};
  int4_append::write_half(a, at, pos[b], (size_t)b * H + h, D2,
                          blockIdx.x & 1);
}

}  // namespace

// cl: blocks per (b, kv head) row (kv_cache.int4_attention_cluster of
// NP * page); width: tokens per staged copy (kv_cache.int4_copy_width)
extern "C" int paged_attention_self_append_launch(
    const void* q, void* kq, void* kp, void* vq, void* vp, const void* ptab,
    const void* lengths, const void* k_self, const void* v_self,
    const void* nkq, const void* nkp, const void* nvq, const void* nvp,
    void* out, int B, int layer, int P, int Hkv, int G, int D, int page,
    int NP, float sm_scale, int int8_qk, float inv127, int cl, int width,
    void* stream) {
  const int4_attention::Args a = int4_attention::self_args(
      q, kq, kp, vq, vp, lengths, k_self, v_self, nkq, nkp, nvq, nvp, out,
      Hkv, G, D, sm_scale, int8_qk, inv127, width);
  return int4_attention::launch(
      paged_attn<int4_attention::kSelfAppend>, cl, B * Hkv, stream, a,
      static_cast<const int32_t*>(ptab), layer, P, page, NP);
}

extern "C" int paged_attention_read_only_launch(
    const void* q, const void* kq, const void* kp, const void* vq,
    const void* vp, const void* ptab, const void* lengths, void* out, int B,
    int layer, int P, int Hkv, int G, int D, int page, int NP, float sm_scale,
    int int8_qk, float inv127, int cl, int width, void* stream) {
  const int4_attention::Args a = int4_attention::make_args(
      q, kq, kp, vq, vp, lengths, out, Hkv, G, D, sm_scale, int8_qk, inv127,
      width);
  return int4_attention::launch(
      paged_attn<int4_attention::kReadOnly>, cl, B * Hkv, stream, a,
      static_cast<const int32_t*>(ptab), layer, P, page, NP);
}

extern "C" int paged_attention_read_only_self_launch(
    const void* q, const void* kq, const void* kp, const void* vq,
    const void* vp, const void* ptab, const void* lengths,
    const void* k_self, const void* v_self, void* out, int B, int layer,
    int P, int Hkv, int G, int D, int page, int NP, float sm_scale,
    int int8_qk, float inv127, int cl, int width, void* stream) {
  int4_attention::Args a = int4_attention::make_args(
      q, kq, kp, vq, vp, lengths, out, Hkv, G, D, sm_scale, int8_qk, inv127,
      width);
  a.k_self = static_cast<const float*>(k_self);
  a.v_self = static_cast<const float*>(v_self);
  return int4_attention::launch(
      paged_attn<int4_attention::kReadOnlySelf>, cl, B * Hkv, stream, a,
      static_cast<const int32_t*>(ptab), layer, P, page, NP);
}

extern "C" int paged_append_pool_launch(
    void* kq, void* kp, void* vq, void* vp, const void* ptab, const void* pos,
    const void* nkq, const void* nkp, const void* nvq, const void* nvp, int B,
    int layer, int P, int H, int D2, int page, int NP, void* stream) {
  paged_append<<<dim3(2 * H, B), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      int4_append::column(kq, kp, vq, vp, nkq, nkp, nvq, nvp),
      static_cast<const int32_t*>(ptab), static_cast<const int32_t*>(pos),
      layer, P, H, D2, page, NP);
  return (int)cudaGetLastError();
}
