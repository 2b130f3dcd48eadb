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
//     k and for v per token and kv head) -- 16.8 MB per Llama-3-8B layer at
//     B=8 and 4,096 cached tokens, 0.005 ms at 3.35 TB/s.
//   Design:
//   - Each (b, kv head) row is split over the sequence by a thread-block
//     cluster of CL <= 8 blocks (the wrapper sizes CL from S, the longest a
//     row can be, at 4 tiles a block: the lengths live on the card; 4 at
//     S = 1024, where 8 blocks of 68 KB a row take more than one wave).
//     Block r of the cluster takes 64-token tiles [r*T/CL, (r+1)*T/CL) of
//     the row's T tiles, so a short row leaves some blocks empty.
//   - The tiles are double-buffered in shared memory with cp.async
//     (smem_ring.cuh): 16-byte copies of whole rows, tokens at or past the
//     length (and d past D) zero-filled and never read from the cache.
//     Rows are 256 bytes with their 16-byte chunks XOR-swizzled by the
//     token's low 3 bits, so ldmatrix's 8 row reads hit distinct banks.
//   - Each of the 4 warps owns 16 tokens of every tile and keeps its own
//     online-softmax state, so the tile loop has no block-wide reductions.
//     Scores on mma.sync.m16n8k16 (bf16 in, f32 sums): the warp's 16
//     tokens are the m side (K rows by ldmatrix), the G <= 8 query rows the
//     n side (bf16(q*sm_scale) held in registers, rows past G zero).  Each
//     thread then holds 2 tokens x 2 rows; the row max and sum take three
//     shuffles.  P.V on the same mma with d as the m side: V^T is the A
//     operand (16 d by ldmatrix.trans from the token-major tile) and
//     bf16(p) the B operand, turned from (token, row pairs) into (row,
//     token pairs) by one movmatrix.trans per 8 tokens.  A warp whose 16
//     tokens all lie at or past the length skips the tile, so a state is
//     either empty (m = -inf, l = 0) or has a live token.
//   - The states merge in a fixed order, so runs repeat bit for bit: the
//     4 warps' in the block, then the CL blocks' in rank order through
//     distributed shared memory.  An empty state weighs 0 (exp(-inf -
//     -inf) would be NaN); a row whose states are all empty keeps m = -inf,
//     l = 0 and out = 0/0.  One launch, no workspace.
//   - NaN: the maxima are max.NaN (fmaxf drops a NaN) and a state is empty
//     only at l = 0 (a NaN l is merged), so a query row with a NaN gives
//     NaN in its out, m and l, and no other row changes, as in the plain
//     version and the reference.
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
//   Design: one thread per E-element chunk of a (b, head) row, each copying
//     that chunk of k and of v with one load and one store each: 16-byte
//     copies (E = 8) where D and every address allow, else 4 or 2 bytes,
//     a rule the wrapper fixes before the launch (a D = 128 row is 16
//     threads; Llama-3-8B at B = 8 is 1,024 threads in 16 blocks).  One
//     divide a thread, none per element.  nk and nv are read through their
//     (b, head) strides with a unit stride on D, so the decode step's
//     transposed roped key goes in without a copy.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "max_nan.cuh"
#include "smem_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace smem_ring;

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int TT = 16 * NW;         // tokens per tile, 16 per warp
constexpr int MAXD = 128;
constexpr int MAXG = 8;
constexpr int ROWB = MAXD * 2;      // bytes per staged token row
constexpr int TILE = TT * ROWB;     // bytes per staged K (or V) tile
constexpr int STAGES = 2;
constexpr int SMEM = STAGES * 2 * TILE;
constexpr int MAXCL = 8;            // a portable cluster
constexpr float MASK_VALUE = -1e30f;

// Byte offset of 16-byte chunk c of token row t in a staged tile
__device__ __forceinline__ int tswz(int t, int c) {
  return t * ROWB + ((c ^ (t & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint8_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const uint8_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s) : "memory");
}

// The 8x8 bf16 matrix whose row lane/4 holds this thread's pair at columns
// 2*(lane%4), +1, transposed across the warp.
__device__ __forceinline__ uint32_t transpose8(uint32_t v) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(r) : "r"(v));
  return r;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(lo), bf16(hi) as one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid (CL, B*Hkv) in clusters of (CL, 1, 1); dynamic shared memory SMEM
__global__ void __launch_bounds__(THREADS)
bf16_decode_attn(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k_all,
                 const __nv_bfloat16* __restrict__ v_all,
                 const int32_t* __restrict__ lengths,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int B, int layer, int Hkv, int G,
                 int D, int S, float sm_scale) {
  extern __shared__ __align__(16) uint8_t ring[];     // STAGES x (K, V) tiles
  __shared__ float wm[NW][MAXG], wl[NW][MAXG];        // the warps' states
  __shared__ float bm[MAXG], bl[MAXG];                // the block's state
  __shared__ __align__(16) float bacc[MAXG][MAXD];

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = gridDim.x, rank = (int)cluster.block_rank();
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Hq = Hkv * G;
  const int len = max(0, min(lengths[b], S));
  const int ntiles = (len + TT - 1) / TT;
  const int j0 = rank * ntiles / CL, j1 = (rank + 1) * ntiles / CL;
  const int C = ((D + 15) & ~15) / 8;                 // staged chunks a row
  const size_t head = (((size_t)layer * B + b) * Hkv + h) * (size_t)S * D;

  // tile j into ring slot `slot`; chunks at or past the length or D are
  // zero-filled without reading the cache
  auto load = [&](int j, int slot) {
    uint8_t* kd = ring + slot * 2 * TILE;
    uint8_t* vd = kd + TILE;
    for (int i = tid; i < TT * C; i += THREADS) {
      const int tk = i / C, c = i % C, pos = j * TT + tk;
      const bool ok = pos < len && 8 * c < D;
      const size_t off = head + (ok ? (size_t)pos * D + 8 * c : 0);
      cp_async(kd + tswz(tk, c), k_all + off, ok ? 16 : 0, 16);
      cp_async(vd + tswz(tk, c), v_all + off, ok ? 16 : 0, 16);
    }
  };

  // B fragments of bf16(q * sm_scale): row g, d = 16ks + 2t (+8), +1
  uint32_t qf[MAXD / 16][2];
#pragma unroll
  for (int ks = 0; ks < MAXD / 16; ++ks)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int d = 16 * ks + 8 * hh + 2 * t;
      float x0 = 0.0f, x1 = 0.0f;
      if (g < G && d < D) {                           // D % 8 == 0
        const __nv_bfloat16* qr = q + ((size_t)b * Hq + h * G + g) * D + d;
        x0 = __fmul_rn(__bfloat162float(qr[0]), sm_scale);
        x1 = __fmul_rn(__bfloat162float(qr[1]), sm_scale);
      }
      qf[ks][hh] = pack_bf16(x0, x1);
    }

  // this warp's state: rows 2t, 2t+1; acc[i]: d = 16i + g (+8) by row
  float m_[2] = {-INFINITY, -INFINITY}, l_[2] = {0.0f, 0.0f};
  float acc[MAXD / 16][4];
#pragma unroll
  for (int i = 0; i < MAXD / 16; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  // ldmatrix rows of this lane: K (m = token) and V^T (k = token) tiles
  const int krow = 16 * w + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int kch = lane >> 4;
  const int vrow = 16 * w + (lane & 7) + (lane >> 4) * 8;
  const int vch = (lane >> 3) & 1;

  if (j0 < j1) load(j0, 0);
  cp_commit();
  if (j0 + 1 < j1) load(j0 + 1, 1);
  cp_commit();
  for (int j = j0; j < j1; ++j) {
    const int slot = (j - j0) & 1;
    cp_wait<1>();
    __syncthreads();
    const int tok0 = j * TT + 16 * w;                 // the warp's tokens
    if (tok0 < len) {
      const uint8_t* kt = ring + slot * 2 * TILE;
      const uint8_t* vt = kt + TILE;
      // s: (token g, rows 2t, 2t+1), then (token g + 8, the same rows)
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < MAXD / 16; ++ks)
        if (16 * ks < D) {
          uint32_t a[4];
          ldsm_x4(a, kt + tswz(krow, 2 * ks + kch));
          mma(s, a, qf[ks][0], qf[ks][1]);
        }
      if (tok0 + g >= len) s[0] = s[1] = MASK_VALUE;
      if (tok0 + g + 8 >= len) s[2] = s[3] = MASK_VALUE;
      float mx0 = max_nan(s[0], s[2]), mx1 = max_nan(s[1], s[3]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        mx0 = max_nan(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = max_nan(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = max_nan(m_[0], mx0), mn1 = max_nan(m_[1], mx1);
      const float al0 = expf(m_[0] - mn0), al1 = expf(m_[1] - mn1);
      const float p0 = expf(s[0] - mn0), p1 = expf(s[1] - mn1);
      const float p2 = expf(s[2] - mn0), p3 = expf(s[3] - mn1);
      float ps0 = __fadd_rn(p0, p2), ps1 = __fadd_rn(p1, p3);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        ps0 = __fadd_rn(ps0, __shfl_xor_sync(0xffffffffu, ps0, o));
        ps1 = __fadd_rn(ps1, __shfl_xor_sync(0xffffffffu, ps1, o));
      }
      l_[0] = __fadd_rn(__fmul_rn(al0, l_[0]), ps0);
      l_[1] = __fadd_rn(__fmul_rn(al1, l_[1]), ps1);
      m_[0] = mn0;
      m_[1] = mn1;
      // bf16(p) as (tokens 2t, 2t+1; row g), then tokens + 8
      const uint32_t b0 = transpose8(pack_bf16(p0, p1));
      const uint32_t b1 = transpose8(pack_bf16(p2, p3));
#pragma unroll
      for (int i = 0; i < MAXD / 16; ++i)
        if (16 * i < D) {
          acc[i][0] = __fmul_rn(acc[i][0], al0);
          acc[i][1] = __fmul_rn(acc[i][1], al1);
          acc[i][2] = __fmul_rn(acc[i][2], al0);
          acc[i][3] = __fmul_rn(acc[i][3], al1);
          uint32_t a[4];
          ldsm_x4_trans(a, vt + tswz(vrow, 2 * i + vch));
          mma(acc[i], a, b0, b1);
        }
    }
    __syncthreads();                                  // slot read by all
    if (j + 2 < j1) load(j + 2, slot);
    cp_commit();
  }
  cp_wait<0>();

  // the warps' states into shared memory (acc in the idle ring), then the
  // block's: the warps merged in order, an empty one (l = 0) weighing 0; a
  // NaN state (l NaN) is merged, so the row's m, l and output stay NaN
  float* wacc = reinterpret_cast<float*>(ring);       // NW x MAXG x MAXD
  if (g == 0) {
    wm[w][2 * t] = m_[0]; wm[w][2 * t + 1] = m_[1];
    wl[w][2 * t] = l_[0]; wl[w][2 * t + 1] = l_[1];
  }
#pragma unroll
  for (int i = 0; i < MAXD / 16; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 16 * i + g + (c >> 1) * 8, row = 2 * t + (c & 1);
      if (d < D) wacc[(w * MAXG + row) * MAXD + d] = acc[i][c];
    }
  __syncthreads();
  for (int e = tid; e < G * D; e += THREADS) {
    const int row = e / D, d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int v = 0; v < NW; ++v)
      if (wl[v][row] != 0.0f) mx = max_nan(mx, wm[v][row]);
    float a = 0.0f;
#pragma unroll
    for (int v = 0; v < NW; ++v)
      if (wl[v][row] != 0.0f)
        a = __fadd_rn(a, __fmul_rn(expf(wm[v][row] - mx),
                                   wacc[(v * MAXG + row) * MAXD + d]));
    bacc[row][d] = a;
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
  // elements r*THREADS + tid, + CL*THREADS, ...
  cluster.sync();
  for (int e = rank * THREADS + tid; e < G * D; e += CL * THREADS) {
    const int row = e / D, d = e % D;
    float mx = -INFINITY;
    for (int r = 0; r < CL; ++r)
      if (*cluster.map_shared_rank(&bl[row], r) != 0.0f)
        mx = max_nan(mx, *cluster.map_shared_rank(&bm[row], r));
    float a = 0.0f, l = 0.0f;
    for (int r = 0; r < CL; ++r) {
      const float lr = *cluster.map_shared_rank(&bl[row], r);
      if (lr != 0.0f) {
        const float wt = expf(*cluster.map_shared_rank(&bm[row], r) - mx);
        const float ar = *cluster.map_shared_rank(&bacc[row][d], r);
        a = __fadd_rn(a, __fmul_rn(wt, ar));
        l = __fadd_rn(l, __fmul_rn(wt, lr));
      }
    }
    out[((size_t)b * Hq + h * G + row) * D + d] =
        __float2bfloat16_rn(__fdiv_rn(a, l));
    if (d == 0) {
      m_out[((size_t)b * Hkv + h) * G + row] = mx;
      l_out[((size_t)b * Hkv + h) * G + row] = l;
    }
  }
  cluster.sync();                    // no block leaves while read from
}

// E bf16 values a thread copies, as one load and one store of U
template <int E> struct Chunk;
template <> struct Chunk<8> { using U = uint4; };
template <> struct Chunk<2> { using U = uint32_t; };
template <> struct Chunk<1> { using U = uint16_t; };

template <int E>
__global__ void kv_append_bf16(__nv_bfloat16* __restrict__ k_all,
                               __nv_bfloat16* __restrict__ v_all,
                               const __nv_bfloat16* __restrict__ nk,
                               const __nv_bfloat16* __restrict__ nv,
                               const int32_t* __restrict__ pos, int B,
                               int layer, int H, int D, int S, long long nk_sb,
                               long long nk_sh, long long nv_sb,
                               long long nv_sh) {
  using U = typename Chunk<E>::U;
  const int chunks = D / E;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * H * chunks) return;
  const int r = t / chunks, d = (t - r * chunks) * E;
  const int b = r / H, h = r - b * H;
  const int p = pos[b];
  const U kx = *reinterpret_cast<const U*>(nk + b * nk_sb + h * nk_sh + d);
  const U vx = *reinterpret_cast<const U*>(nv + b * nv_sb + h * nv_sh + d);
  if (p < 0 || p >= S) return;
  const size_t dst = ((((size_t)layer * B + b) * H + h) * S + p) * D + d;
  *reinterpret_cast<U*>(k_all + dst) = kx;
  *reinterpret_cast<U*>(v_all + dst) = vx;
}

}  // namespace

// cl: blocks per (b, kv head) row, 1..8, one cluster.  Needs D <= 128 and
// D % 8 == 0, G <= 8, contiguous caches (the wrapper checks).
extern "C" int bf16_decode_attention_launch(
    const void* q, const void* k_all, const void* v_all, const void* lengths,
    void* out, void* m, void* l, int B, int layer, int Hkv, int G, int D,
    int S, float sm_scale, int cl, void* stream) {
  if (cl < 1 || cl > MAXCL || D > MAXD || D % 8 != 0 || G > MAXG)
    return (int)cudaErrorInvalidValue;
  static bool ready = false;
  cudaError_t e = allow_smem(bf16_decode_attn, SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, B * Hkv, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, bf16_decode_attn, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_all),
      static_cast<const __nv_bfloat16*>(v_all),
      static_cast<const int32_t*>(lengths), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(m), static_cast<float*>(l), B, layer, Hkv, G, D, S,
      sm_scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// e: bf16 values a thread copies, 8, 2 or 1; D % e == 0, and every base
// pointer and nk/nv stride aligned to e values (the wrapper picks e).
extern "C" int kv_append_bf16_launch(void* k_all, void* v_all, const void* nk,
                                     const void* nv, const void* pos, int B,
                                     int layer, int H, int D, int S,
                                     long long nk_sb, long long nk_sh,
                                     long long nv_sb, long long nv_sh, int e,
                                     void* stream) {
  if ((e != 8 && e != 2 && e != 1) || D % e != 0)
    return (int)cudaErrorInvalidValue;
  constexpr int T = 64;
  const int n = B * H * (D / e);
  const dim3 grid((n + T - 1) / T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<__nv_bfloat16*>(k_all);
  auto* v = static_cast<__nv_bfloat16*>(v_all);
  auto* a = static_cast<const __nv_bfloat16*>(nk);
  auto* c = static_cast<const __nv_bfloat16*>(nv);
  auto* ps = static_cast<const int32_t*>(pos);
  if (e == 8)
    kv_append_bf16<8><<<grid, T, 0, st>>>(k, v, a, c, ps, B, layer, H, D, S,
                                          nk_sb, nk_sh, nv_sb, nv_sh);
  else if (e == 2)
    kv_append_bf16<2><<<grid, T, 0, st>>>(k, v, a, c, ps, B, layer, H, D, S,
                                          nk_sb, nk_sh, nv_sb, nv_sh);
  else
    kv_append_bf16<1><<<grid, T, 0, st>>>(k, v, a, c, ps, B, layer, H, D, S,
                                          nk_sb, nk_sh, nv_sb, nv_sh);
  return (int)cudaGetLastError();
}
