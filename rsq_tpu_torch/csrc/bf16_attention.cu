// bf16-cache decode attention (returning the online-softmax state) and the
// in-place bf16 one-token append.
//
// 1. bf16_decode_attn
//   Replaces: rsq_tpu/kernels/kv_cache.py bf16_decode_attention_stacked
//     (:849), Pallas body _decode_kernel_bf16_pref (:792).
//   Computes, per batch row b and kv head h, for its G query rows, over the
//     cached tokens pos < lengths[b] of layer `layer` of the (L, B, Hkv, S, D)
//     bf16 cache, with the reference's rounding points: q * sm_scale in f32,
//     cast to bf16; logits = bf16 q . bf16 k summed in f32, masked with
//     -1e30; online softmax in f32 (m, l); acc = acc*alpha + bf16(p) . v
//     summed in f32; out = bf16(acc / l), plus m and l.  A row of length 0
//     gives m = -inf, l = 0 and out = 0/0, as the reference does; the caller
//     (merge_self_attention) masks it.
//   Bound on this card: the cache bytes of the cached tokens (2*D bytes for
//     k and for v per token and kv head) -- 8.4 MB per Llama-3-8B layer at
//     B=8, fill 512.
//   Design: one block of 128 threads per (b, kv head) walks the row's tokens
//     in 64-token tiles, staged in shared memory with 16-byte coalesced
//     loads (tokens past the length are not read and stage as zeros).  The
//     K tile's rows are padded to 65 words, so the score loop (neighbouring
//     threads on neighbouring tokens) reads distinct banks; each warp then
//     owns query rows for the tile's max and sums (shuffles); thread d
//     accumulates output dimension d.  The reference's padding of G to 8
//     rows is a TPU layout artifact and is not copied.  No tensor cores and
//     no split over tiles yet: B*Hkv blocks.
//
// 2. kv_append_bf16
//   Replaces: rsq_tpu/kernels/kv_cache.py kv_append_stacked_bf16 (:937),
//     Pallas body _append_kernel_bf16 (:917).
//   Computes: k[layer, b, :, pos[b], :] = nk[b, :, 0, :] (and v), in place.
//     The reference's 16-row read-modify-write window is a Mosaic tile
//     artifact; this kernel writes exactly one row per (b, head).  A row
//     with pos outside [0, S) writes nothing.
//   Bound on this card: 4*B*H*D bytes read and written -- trivial; launch
//     latency dominates.
//   Design: one block per batch row copies its H*D values of k and of v.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int TT = 64;          // tokens per tile
constexpr int MAXD = 128;
constexpr int MAXG = 8;
constexpr int KROW = MAXD / 2 + 1;   // words per staged K row (65: bank t + d/2)
constexpr float MASK_VALUE = -1e30f;

__global__ void __launch_bounds__(THREADS)
bf16_decode_attn(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k_all,
                 const __nv_bfloat16* __restrict__ v_all,
                 const int32_t* __restrict__ lengths,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int B, int layer, int Hkv, int G,
                 int D, int S, float sm_scale) {
  __shared__ float qd[MAXG][MAXD];                    // bf16(q * sm_scale)
  __shared__ uint32_t kt[TT * KROW];                  // bf16 pairs, padded rows
  __shared__ __align__(16) __nv_bfloat16 vt[TT][MAXD];
  __shared__ float sc[MAXG][TT];                      // scores, then bf16(p)
  __shared__ float ms[MAXG], ls[MAXG], al[MAXG];

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G;
  const int len = min(lengths[b], S);
  const int D2 = D / 2, C = D / 8;                    // 16-byte chunks per token
  const size_t head = (((size_t)layer * B + b) * Hkv + h) * (size_t)S * D;

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    const float x = __fmul_rn(
        __bfloat162float(q[((size_t)b * Hq + h * G + g) * D + d]), sm_scale);
    qd[g][d] = __bfloat162float(__float2bfloat16_rn(x));
  }
  if (tid < G) { ms[tid] = -INFINITY; ls[tid] = 0.0f; }
  float acc[MAXG];
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.0f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += TT) {
    const int nt = min(TT, len - t0);
    for (int i = tid; i < TT * C; i += THREADS) {
      const int t = i / C, c = i % C;
      uint4 kw = make_uint4(0, 0, 0, 0), vw = make_uint4(0, 0, 0, 0);
      if (t < nt) {
        const size_t off = head + (size_t)(t0 + t) * D + 8 * c;
        kw = __ldg(reinterpret_cast<const uint4*>(k_all + off));
        vw = __ldg(reinterpret_cast<const uint4*>(v_all + off));
      }
      uint32_t* kr = kt + t * KROW + 4 * c;
      kr[0] = kw.x; kr[1] = kw.y; kr[2] = kw.z; kr[3] = kw.w;
      *reinterpret_cast<uint4*>(&vt[t][8 * c]) = vw;
    }
    __syncthreads();

    // scores: (token, row) pairs, neighbouring threads on neighbouring tokens
    for (int i = tid; i < TT * G; i += THREADS) {
      const int t = i % TT, g = i / TT;
      float s = 0.0f;
      const uint32_t* kr = kt + t * KROW;
      for (int d2 = 0; d2 < D2; ++d2) {
        const uint32_t w = kr[d2];
        // bf16 x bf16 is exact in f32, so fmaf == mul + add
        s = fmaf(qd[g][2 * d2], __uint_as_float(w << 16), s);
        s = fmaf(qd[g][2 * d2 + 1], __uint_as_float(w & 0xffff0000u), s);
      }
      sc[g][t] = t < nt ? s : MASK_VALUE;
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w + NW, ...
    for (int g = warp; g < G; g += NW) {
      const float s0 = sc[g][lane], s1 = sc[g][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[g];
      const float mn = fmaxf(m_old, mx);
      const float p0 = expf(s0 - mn), p1 = expf(s1 - mn);
      float ps = __fadd_rn(p0, p1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, o));
      sc[g][lane] = __bfloat162float(__float2bfloat16_rn(p0));
      sc[g][lane + 32] = __bfloat162float(__float2bfloat16_rn(p1));
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - mn);
        al[g] = alpha;
        ms[g] = mn;
        ls[g] = __fadd_rn(__fmul_rn(alpha, ls[g]), ps);
      }
    }
    __syncthreads();

    if (tid < D) {
      const int d = tid;
      for (int g = 0; g < G; ++g) {
        float tv = 0.0f;
        for (int j = 0; j < TT; ++j)
          tv = fmaf(sc[g][j], __bfloat162float(vt[j][d]), tv);
        acc[g] = __fadd_rn(__fmul_rn(acc[g], al[g]), tv);
      }
    }
    __syncthreads();   // tiles and sc are overwritten by the next iteration
  }

  if (tid < D) {
    for (int g = 0; g < G; ++g)
      out[((size_t)b * Hq + h * G + g) * D + tid] =
          __float2bfloat16_rn(__fdiv_rn(acc[g], ls[g]));
  }
  if (tid < G) {
    m_out[((size_t)b * Hkv + h) * G + tid] = ms[tid];
    l_out[((size_t)b * Hkv + h) * G + tid] = ls[tid];
  }
}

__global__ void kv_append_bf16(__nv_bfloat16* __restrict__ k_all,
                               __nv_bfloat16* __restrict__ v_all,
                               const __nv_bfloat16* __restrict__ nk,
                               const __nv_bfloat16* __restrict__ nv,
                               const int32_t* __restrict__ pos, int B,
                               int layer, int H, int D, int S) {
  const int b = blockIdx.x;
  const int p = pos[b];
  if (p < 0 || p >= S) return;
  for (int i = threadIdx.x; i < H * D; i += blockDim.x) {
    const int h = i / D, d = i % D;
    const size_t dst = ((((size_t)layer * B + b) * H + h) * S + p) * D + d;
    k_all[dst] = nk[((size_t)b * H + h) * D + d];
    v_all[dst] = nv[((size_t)b * H + h) * D + d];
  }
}

}  // namespace

extern "C" int bf16_decode_attention_launch(
    const void* q, const void* k_all, const void* v_all, const void* lengths,
    void* out, void* m, void* l, int B, int layer, int Hkv, int G, int D,
    int S, float sm_scale, void* stream) {
  bf16_decode_attn<<<B * Hkv, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_all),
      static_cast<const __nv_bfloat16*>(v_all),
      static_cast<const int32_t*>(lengths), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(m), static_cast<float*>(l), B, layer, Hkv, G, D, S,
      sm_scale);
  return (int)cudaGetLastError();
}

extern "C" int kv_append_bf16_launch(void* k_all, void* v_all, const void* nk,
                                     const void* nv, const void* pos, int B,
                                     int layer, int H, int D, int S,
                                     void* stream) {
  kv_append_bf16<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(k_all), static_cast<__nv_bfloat16*>(v_all),
      static_cast<const __nv_bfloat16*>(nk),
      static_cast<const __nv_bfloat16*>(nv), static_cast<const int32_t*>(pos),
      B, layer, H, D, S);
  return (int)cudaGetLastError();
}
