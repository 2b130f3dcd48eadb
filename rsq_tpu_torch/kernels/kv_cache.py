"""KV-cache pieces of the serving paths (the port of
rsq_tpu.kernels.kv_cache).

INT4 cache layout (sequence in the last axis, as in the reference): codes
uint8 (..., D/2, S) with the low nibble holding d < D/2 and the high nibble
d + D/2; params f32 (..., 2, S) = (scale, zero), dequant u*scale - zero.
The contiguous slot cache is (L, B, Hkv, D/2, S) and (L, B, Hkv, 2, S).
The bf16 cache is token-major: (L, B, Hkv, S, D).

Kernels, each with its plain version here:
- decode_prep (csrc/decode_prep.cu)
- int4_decode_attention_self_append, int4_decode_attention_stacked
  (read-only, with its L = 1 view int4_decode_attention),
  int4_decode_attention_stacked_self (read-only, the new token folded in)
  and kv_append_stacked (the one-token append)
  (csrc/contiguous_attention.cu); the first equals the third followed by
  the fourth
- bf16_decode_attention_stacked, kv_append_stacked_bf16
  (csrc/bf16_attention.cu)
attend_tile / self_fold_finalize are the plain math of both INT4 attention
kernels (csrc/int4_attention.cuh), following the reference's _attend_tile
and _self_fold_finalize rounding points.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rsq_tpu_torch.core.hadamard import fwht
from rsq_tpu_torch.core.numerics import div_const, recip_f32
from rsq_tpu_torch.kernels import (LAUNCHES, cuda_build, on_cuda, ptr,
                                   require, stream)

MASK_VALUE = -1e30


def _unpack_u4(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """uint8 codes -> f32 unsigned nibbles, low plane first along `dim`."""
    return torch.cat([packed & 0x0F, packed >> 4], dim=dim).float()


def asym_quant_pack_head(x):
    """x: (..., D) -> (packed uint8 (..., D/2), params (..., 2) f32):
    per-(token, head) asymmetric int4 over D, planar nibble packing."""
    xf = x.float()
    xmax = xf.amax(dim=-1, keepdim=True)
    xmin = xf.amin(dim=-1, keepdim=True)
    scale = div_const(torch.clamp(xmax - xmin, min=1e-5), 15.0)
    zero = -xmin
    u = torch.clamp(torch.round((xf + zero) / scale), 0, 15).to(torch.uint8)
    d = u.shape[-1]
    packed = u[..., : d // 2] | (u[..., d // 2:] << 4)
    return packed, torch.cat([scale, zero], dim=-1)


def unpack_dequant_head(packed, params):
    """Inverse of asym_quant_pack_head -> f32 (..., D)."""
    u = _unpack_u4(packed, dim=-1)
    return u * params[..., 0:1] - params[..., 1:2]


def to_lane_major(packed, params):
    """(B, H, S, D/2)+(B, H, S, 2) -> (B, H, D/2, S)+(B, H, 2, S)."""
    return packed.transpose(-1, -2), params.transpose(-1, -2)


# ---------------------------------------------------------------------------
# decode_prep
# ---------------------------------------------------------------------------

def decode_prep_plain(q, k, v, cos, sin, kv_had: bool = True):
    """Plain PyTorch version of decode_prep (same rounding points), on the
    same operands (materialized here as (B, H, D))."""
    D = cos.shape[-1]
    half = D // 2
    q, k, v = (t.reshape(t.shape[0], -1, D) for t in (q, k, v))
    c, s = cos.float()[:, None, :], sin.float()[:, None, :]

    def rope(x):
        xf = x.float()
        rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
        return (xf * c + rot * s).to(x.dtype).float()

    def had(x):
        return (fwht(x) * (1.0 / math.sqrt(D))).to(torch.bfloat16).float()

    qf, kf = rope(q), rope(k)
    if kv_had:
        qf, kf = had(qf), had(kf)

    def qpack(x):
        packed, params = asym_quant_pack_head(x)
        return unpack_dequant_head(packed, params), packed, params

    k_self, nkq, nkp = qpack(kf)
    v_self, nvq, nvp = qpack(v.float())
    return qf.to(q.dtype), k_self, v_self, nkq, nkp, nvq, nvp


def _prep_rows(t, D: int, per_lane: int):
    """t (B, N) or (B, X, Y) read in place by the decode_prep kernel: row b,
    flattened, holds the heads in order.  Returns (tensor, row stride,
    chunk width Y, chunk stride), in elements; copies only a t whose last
    axis is strided or whose chunks would split a lane's per_lane
    elements."""
    if t.dim() == 2:
        t = t[:, None]
    if t.stride(2) != 1 or t.shape[2] % per_lane:
        t = t.reshape(t.shape[0], -1, D).contiguous()
    return t, t.stride(0), t.shape[2], t.stride(1)


def decode_prep(q, k, v, cos, sin, kv_had: bool = True):
    """Fused decode-token prep: RoPE(q, k) -> per-head Hadamard(q, k) ->
    asymmetric INT4 quant-pack(k, v) + dequantized self values.

    q: bf16 (B, Hq * D), or (B, X, Y) with X * Y = Hq * D, whose rows,
    flattened, hold the Hq heads of D = cos.shape[1] values in order: (B,
    Hq, D), or a plane-major segment (B, 2, Hq * D / 2) of the fused qkv
    output (logical column c at plane c // nh, column c % nh).  k, v
    likewise with Hkv heads.  Read in place through their strides.
    cos/sin: (B, D) f32.  Returns (qh (B, Hq, D) bf16, k_self, v_self (B,
    Hkv, D) f32, nkq (B, Hkv, D/2) u8, nkp (B, Hkv, 2) f32, nvq, nvp)."""
    require(cos.dim() == 2 and sin.shape == cos.shape, "cos/sin (B, D)")
    B, D = cos.shape
    require(all(t.dim() in (2, 3) and t.shape[0] == B for t in (q, k, v)),
            "q/k/v (B, N) or (B, X, Y)")
    require(k.shape == v.shape, "k/v shape mismatch")
    Hq, Hkv = q.shape[1:].numel() // D, k.shape[1:].numel() // D
    require(Hq * D == q.shape[1:].numel() and Hkv * D == k.shape[1:].numel()
            and Hkv > 0,
            f"q/k/v rows must hold whole heads of head_dim {D}")
    require(q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16
            and v.dtype == torch.bfloat16, "q/k/v must be bf16")
    if not on_cuda((q, k, v, cos, sin)):
        return decode_prep_plain(q, k, v, cos, sin, kv_had)
    require(D & (D - 1) == 0 and 2 <= D <= 256,
            "kernel needs a power-of-2 head_dim <= 256")
    require(Hq % Hkv == 0, "kernel needs Hq a multiple of Hkv")
    per_lane = max(1, D // 32)
    (q, *qr), (k, *kr), (v, *vr) = (_prep_rows(t, D, per_lane)
                                    for t in (q, k, v))
    cos, sin = cos.float().contiguous(), sin.float().contiguous()
    dev = q.device
    qh = torch.empty((B, Hq, D), dtype=torch.bfloat16, device=dev)
    k_self = torch.empty((B, Hkv, D), dtype=torch.float32, device=dev)
    v_self = torch.empty_like(k_self)
    nkq = torch.empty((B, Hkv, D // 2), dtype=torch.uint8, device=dev)
    nvq = torch.empty_like(nkq)
    nkp = torch.empty((B, Hkv, 2), dtype=torch.float32, device=dev)
    nvp = torch.empty_like(nkp)
    rows = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_longlong]
    fn = cuda_build.function(
        "decode_prep", "decode_prep_launch",
        rows * 3 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptr(q), *qr, ptr(k), *kr, ptr(v), *vr, ptr(cos), ptr(sin),
            ptr(qh), ptr(k_self), ptr(v_self), ptr(nkq), ptr(nkp), ptr(nvq),
            ptr(nvp), B, Hkv, Hq // Hkv, D, int(kv_had), 1.0 / math.sqrt(D),
            recip_f32(15.0), stream(q))
    cuda_build.check(rc, "decode_prep")
    LAUNCHES["decode_prep"] += 1
    return qh, k_self, v_self, nkq, nkp, nvq, nvp


# ---------------------------------------------------------------------------
# Attention math (plain version of the paged attention kernel)
# ---------------------------------------------------------------------------

def attend_tile(q_all, kq, kp, vq, vp, base, lengths, state, int8_qk=False):
    """One online-softmax step over a tile of cached tokens.

    q_all: (B, H, G, D) f32, pre-scaled by sm_scale; kq/vq: uint8
    (B, H, D/2, ch); kp/vp: (B, H, 2, ch) f32; base: position of the tile's
    first token; lengths: (B,) cached token counts; state = (m, l, acc)
    with m, l (B, H, G, 1) and acc (B, H, G, D).  Rows whose tile holds no
    cached token keep their state (the reference skips such tiles)."""
    m, l, acc = state
    ch = kq.shape[-1]
    ku = _unpack_u4(kq, dim=2)                              # (B, H, D, ch)
    if int8_qk:
        qmax = q_all.abs().amax(dim=-1, keepdim=True)
        qs = torch.where(qmax == 0, 1.0, div_const(qmax, 127.0))
        q_i8 = torch.clamp(torch.round(q_all / qs), -127, 127)
        raw = (q_i8 @ ku) * qs         # small integers: exact in f32
        qsum = q_i8.sum(dim=-1, keepdim=True) * qs
    else:
        qsum = q_all.sum(dim=-1, keepdim=True)
        raw = q_all.to(torch.bfloat16).float() @ ku
    ks, kz = kp[:, :, None, 0], kp[:, :, None, 1]           # (B, H, 1, ch)
    logits = raw * ks - qsum * kz
    pos = base + torch.arange(ch, device=q_all.device)
    live = pos[None, :] < lengths[:, None]                   # (B, ch)
    logits = torch.where(live[:, None, None, :], logits, MASK_VALUE)
    m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new)
    l_new = alpha * l + p.sum(dim=-1, keepdim=True)
    vu = _unpack_u4(vq, dim=2)                               # (B, H, D, ch)
    vs, vz = vp[:, :, None, 0], vp[:, :, None, 1]
    ps = (p * vs).to(torch.bfloat16).float()
    pz = (p * vz).sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + ps @ vu.transpose(-1, -2) - pz
    row = (lengths > base)[:, None, None, None]
    return (torch.where(row, m_new, m), torch.where(row, l_new, l),
            torch.where(row, acc_new, acc))


def self_fold_finalize(q_all, k_self, v_self, state):
    """One more softmax step over the new token's dequantized (k_self,
    v_self) (B, H, D) with the f32 q, then normalize -> (B, H, G, D) f32."""
    m, l, acc = state
    lg = (q_all * k_self[:, :, None, :]).sum(dim=-1, keepdim=True)
    m_fin = torch.maximum(m, lg)
    alpha = torch.exp(m - m_fin)
    p = torch.exp(lg - m_fin)
    l_fin = l * alpha + p
    return (acc * alpha + p * v_self[:, :, None, :]) / l_fin


def q_groups(q, Hkv, sm_scale=None):
    """(B, Hq, D) -> f32 (B, Hkv, G, D) pre-scaled by sm_scale.  The
    reference pads G to 8 rows for the TPU's sublanes; the port does not."""
    B, Hq, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    return (q.float() * sm_scale).reshape(B, Hkv, Hq // Hkv, D)


def empty_state(B, H, G, D, device):
    """Online-softmax state (m, l, acc) before any token."""
    return (torch.full((B, H, G, 1), -math.inf, device=device),
            torch.zeros((B, H, G, 1), device=device),
            torch.zeros((B, H, G, D), device=device))


def pick_chunk(S: int, target: int) -> int:
    """Largest sequence chunk <= target that divides S, preferring
    128-multiples (the reference's tiling of the contiguous cache)."""
    t = min(target, S)
    for c in range(t - t % 128, 0, -128):
        if S % c == 0:
            return c
    for c in range(t, 0, -1):
        if S % c == 0:
            return c
    return S


def merge_self_attention(out_old, m_old, l_old, q_scaled, k_self, v_self):
    """Fold the current token's self-attention term into a decode kernel's
    (out, m, l) state.  q_scaled: (B, Hkv, G, D) f32 already scaled by
    sm_scale; k_self/v_self: (B, Hkv, 1, D) values of the token being
    appended.  Returns (B, Hq, D) in out_old's dtype."""
    B, Hq, D = out_old.shape
    _, Hkv, G, _ = q_scaled.shape
    logit = (q_scaled * k_self.float()).sum(dim=-1)           # (B, Hkv, G)
    m_new = torch.maximum(m_old, logit)
    alpha = torch.exp(m_old - m_new)
    p = torch.exp(logit - m_new)
    w_old = (l_old * alpha)[..., None]
    o_old = out_old.float().reshape(B, Hkv, G, D)
    # w_old == 0 (empty cache): o_old is 0/0, so mask it out of the merge
    o_term = torch.where(w_old > 0, o_old * w_old, 0.0)
    merged = (o_term + p[..., None] * v_self.float()) / (w_old + p[..., None])
    return merged.reshape(B, Hq, D).to(out_old.dtype)


# ---------------------------------------------------------------------------
# Checks shared by the four INT4 attention wrappers (contiguous and paged)
# ---------------------------------------------------------------------------

def check_int4_attention(q, kq_all, kp_all, vq_all, vp_all, layer: int):
    """q (B, Hq, D) bf16 against stacked codes (L, R, Hkv, D/2, S) u8 and
    params (L, R, Hkv, 2, S) f32, R the cache's slots or the pool's pages.
    Returns (B, Hq, D, (L, R, Hkv, D/2, S))."""
    require(q.dim() == 3 and kq_all.dim() == 5, "q (B, Hq, D), caches 5-D")
    B, Hq, D = q.shape
    L, R, Hkv, D2, S = kq_all.shape
    require(D == 2 * D2 and Hq % Hkv == 0, "head shapes disagree")
    require(0 <= layer < L, f"layer {layer} out of range {L}")
    require(q.dtype == torch.bfloat16, "q must be bf16")
    require(kq_all.dtype == torch.uint8 and vq_all.dtype == torch.uint8
            and kp_all.dtype == torch.float32 and vp_all.dtype == torch.float32,
            "cache dtypes: u8 codes, f32 params")
    require(kp_all.shape == (L, R, Hkv, 2, S) and vq_all.shape == kq_all.shape
            and vp_all.shape == kp_all.shape, "cache shapes disagree")
    return B, Hq, D, kq_all.shape


def kernel_operands(q, caches, sm_scale):
    """What every INT4 attention kernel needs besides the checks above:
    head_dim <= 128 and G <= 8, caches read (and written) in place, so
    contiguous.  Returns (q contiguous, G, sm_scale, 1/sqrt(D) by
    default)."""
    _, Hq, D = q.shape
    G = Hq // caches[0].shape[2]
    require(D <= 128 and G <= 8, "kernel needs head_dim <= 128, Hq/Hkv <= 8")
    require(all(t.is_contiguous() for t in caches),
            "caches must be contiguous (the kernel addresses them in place)")
    return (q.contiguous(), G,
            1.0 / math.sqrt(D) if sm_scale is None else sm_scale)


# The INT4 kernels' sequence split (csrc/int4_attention.cuh): 64-token
# tiles, at most 8 blocks (one cluster) per (b, kv head) row, sized so that
# the longest row the cache can hold (S, or the page table's width x page)
# gives each block at most INT4_TILES_PER_BLOCK tiles; tools/sweep_sizing.py
# times the choices (PERF.md section 6).
INT4_TILE = 64
INT4_TILES_PER_BLOCK = 4
INT4_MAX_CLUSTER = 8


def _cluster(cap: int, tile: int, per_block: int, most: int) -> int:
    tiles = -(-cap // tile)
    return max(1, min(most, -(-tiles // per_block)))


def _tile_chunks(length: int, cap: int, cl: int, tile: int):
    n = max(0, min(length, cap))
    T = -(-n // tile)
    return [(min(n, r * T // cl * tile), min(n, (r + 1) * T // cl * tile))
            for r in range(cl)]


def int4_attention_cluster(cap: int) -> int:
    """Blocks per (b, kv head) row of the INT4 decode attention kernels for
    rows that can hold `cap` tokens.  Sized from the shape, not from the
    lengths: they live on the card, and reading them would cost the step a
    sync (and break a CUDA graph's capture)."""
    return _cluster(cap, INT4_TILE, INT4_TILES_PER_BLOCK, INT4_MAX_CLUSTER)


def int4_attention_chunks(length: int, cap: int, cl: int):
    """The token ranges [start, end) the cl blocks of one row read, in rank
    order, as the INT4 kernels split them: block r takes 64-token tiles
    [r*T//cl, (r+1)*T//cl) of the row's T tiles, cut at the length."""
    return _tile_chunks(length, cap, cl, INT4_TILE)


def int4_copy_width(run: int, caches) -> int:
    """Tokens per staged copy of the INT4 kernels over caches (kq, kp, vq,
    vp): 16 (16-byte code copies) or 4 (4-byte ones) where every run of
    `run` contiguous tokens (S, or a page) starts so aligned, else 1 (byte
    loads); the parameters go in 16-byte copies of 4 tokens beside the
    first two, 4-byte ones beside the last."""
    kq, kp, vq, vp = caches
    params16 = kp.data_ptr() % 16 == 0 and vp.data_ptr() % 16 == 0
    for width in (16, 4):
        if (run % width == 0 and params16 and kq.data_ptr() % width == 0
                and vq.data_ptr() % width == 0):
            return width
    return 1


def int4_split(cap: int, run: int, caches):
    """(blocks per row, tokens per staged copy) of the INT4 kernels for rows
    of up to `cap` tokens held in runs of `run` contiguous tokens (S and S
    for contiguous slots; the table's width x page, and page, for pages)."""
    return int4_attention_cluster(cap), int4_copy_width(run, caches)


# ---------------------------------------------------------------------------
# Contiguous INT4 attention with self fold and in-place append
# ---------------------------------------------------------------------------

def append_columns_plain(kq, kp, vq, vp, layer, pos, nkq, nkp, nvq, nvp):
    """Plain PyTorch version of the contiguous append: one indexed
    assignment per cache, column pos[b] of each (layer, b, h) row; new
    values (B, H, D/2) u8 and (B, H, 2) f32."""
    rows = torch.arange(kq.shape[1], device=kq.device)
    pos = pos.to(torch.int64)
    kq[layer, rows, :, :, pos] = nkq
    kp[layer, rows, :, :, pos] = nkp.to(kp.dtype)
    vq[layer, rows, :, :, pos] = nvq
    vp[layer, rows, :, :, pos] = nvp.to(vp.dtype)


def decode_attention_self_plain(q, kq_all, kp_all, vq_all, vp_all, layer,
                                lengths, k_self, v_self, sm_scale=None,
                                int8_qk=False):
    """Plain PyTorch version of int4_decode_attention_stacked_self: one
    attend_tile over the row's cache, then the self fold."""
    B, Hq, D = q.shape
    Hkv = kq_all.shape[2]
    qg = q_groups(q, Hkv, sm_scale)
    state = attend_tile(qg, kq_all[layer], kp_all[layer], vq_all[layer],
                        vp_all[layer], 0, lengths.to(torch.int64),
                        empty_state(B, Hkv, qg.shape[2], D, q.device),
                        int8_qk=int8_qk)
    out = self_fold_finalize(qg, k_self.float(), v_self.float(), state)
    return out.reshape(B, Hq, D).to(q.dtype)


def self_append_plain(q, kq_all, kp_all, vq_all, vp_all, layer, lengths,
                      k_self, v_self, nkq, nkp, nvq, nvp, sm_scale=None,
                      int8_qk=False):
    """Plain PyTorch version: the self-folding attention over the row's
    cache, then the in-place append of exactly one column."""
    out = decode_attention_self_plain(q, kq_all, kp_all, vq_all, vp_all,
                                      layer, lengths, k_self, v_self,
                                      sm_scale, int8_qk)
    append_columns_plain(kq_all, kp_all, vq_all, vp_all, layer, lengths, nkq,
                         nkp, nvq, nvp)
    return out


def int4_decode_attention_self_append(q, kq_all, kp_all, vq_all, vp_all,
                                      layer: int, lengths, k_self, v_self,
                                      nkq, nkp, nvq, nvp, sm_scale=None,
                                      int8_qk: bool = False):
    """Self-folding decode attention over the contiguous slot cache + the
    in-place append of the new token at position lengths[b] (< S).

    q: (B, Hq, D) bf16, already per-head Hadamard-rotated like the keys;
    caches (L, B, Hkv, D/2, S) u8 and (L, B, Hkv, 2, S) f32, updated in
    place (the reference aliases them); lengths (B,) cached tokens;
    k_self/v_self (B, Hkv, D) f32 dequantized new token; nkq/nvq
    (B, Hkv, D/2) u8, nkp/nvp (B, Hkv, 2) f32 its cache contents.  Returns
    out (B, Hq, D) bf16.  The reference also copies stale lanes into a
    freshly opened 512-chunk past the length; the port writes only the
    new column."""
    B, Hq, D, (L, Bc, Hkv, D2, S) = check_int4_attention(
        q, kq_all, kp_all, vq_all, vp_all, layer)
    require(Bc == B and lengths.shape == (B,), "cache slots, lengths (B,)")
    require(nkq.shape == (B, Hkv, D2) and nkp.shape == (B, Hkv, 2)
            and k_self.shape == (B, Hkv, D), "new-token shapes")
    tensors = (q, kq_all, kp_all, vq_all, vp_all, lengths, k_self, v_self,
               nkq, nkp, nvq, nvp)
    if not on_cuda(tensors):
        return self_append_plain(q, kq_all, kp_all, vq_all, vp_all, layer,
                                 lengths, k_self, v_self, nkq, nkp, nvq, nvp,
                                 sm_scale=sm_scale, int8_qk=int8_qk)
    q, G, sm_scale = kernel_operands(q, (kq_all, kp_all, vq_all, vp_all),
                                     sm_scale)
    lens = lengths.to(torch.int32).contiguous()
    k_self, v_self = k_self.float().contiguous(), v_self.float().contiguous()
    nkq, nvq = nkq.contiguous(), nvq.contiguous()
    nkp, nvp = nkp.float().contiguous(), nvp.float().contiguous()
    out = torch.empty_like(q)
    fn = cuda_build.function(
        "contiguous_attention", "contiguous_attention_self_append_launch",
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    rc = fn(ptr(q), ptr(kq_all), ptr(kp_all), ptr(vq_all), ptr(vp_all),
            ptr(lens), ptr(k_self), ptr(v_self), ptr(nkq), ptr(nkp),
            ptr(nvq), ptr(nvp), ptr(out), B, layer, Hkv, G, D, S, sm_scale,
            int(int8_qk), recip_f32(127.0),
            *int4_split(S, S, (kq_all, kp_all, vq_all, vp_all)), stream(q))
    cuda_build.check(rc, "int4_decode_attention_self_append")
    LAUNCHES["int4_decode_attention_self_append"] += 1
    return out


# ---------------------------------------------------------------------------
# Contiguous INT4 attention, read-only, returning (out, m, l)
# ---------------------------------------------------------------------------

def finalize_read(q, state):
    """(m, l, acc) of attend_tile -> (out (B, Hq, D) in q's dtype, m, l
    (B, Hkv, G) f32): out = acc / l, one rounding.  A row that read no
    token keeps m = -inf, l = 0 and gives out = 0/0."""
    m, l, acc = state
    out = (acc / l).to(q.dtype).reshape(q.shape)
    return out, m[..., 0], l[..., 0]


def decode_attention_plain(q, kq_all, kp_all, vq_all, vp_all, layer, lengths,
                           sm_scale=None, int8_qk=False):
    """Plain PyTorch version of int4_decode_attention_stacked: one
    attend_tile over the row's whole cache."""
    B, _, D = q.shape
    Hkv = kq_all.shape[2]
    qg = q_groups(q, Hkv, sm_scale)
    state = attend_tile(qg, kq_all[layer], kp_all[layer], vq_all[layer],
                        vp_all[layer], 0, lengths.to(torch.int64),
                        empty_state(B, Hkv, qg.shape[2], D, q.device),
                        int8_qk=int8_qk)
    return finalize_read(q, state)


def int4_decode_attention_stacked(q, kq_all, kp_all, vq_all, vp_all,
                                  layer: int, lengths, sm_scale=None,
                                  int8_qk: bool = False):
    """Decode attention against layer `layer` of the stacked contiguous
    INT4 cache (L, B, Hkv, D/2, S) u8 + (L, B, Hkv, 2, S) f32, read in place
    and never written, over the lengths[b] cached tokens.  q: (B, Hq, D)
    bf16, already per-head Hadamard-rotated like the keys.  Returns (out
    (B, Hq, D) bf16, m (B, Hkv, G) f32, l (B, Hkv, G) f32), the online-
    softmax state.  A row of length 0 gives out NaN, m -inf, l 0."""
    B, Hq, D, (L, Bc, Hkv, D2, S) = check_int4_attention(
        q, kq_all, kp_all, vq_all, vp_all, layer)
    require(Bc == B and lengths.shape == (B,), "cache slots, lengths (B,)")
    if not on_cuda((q, kq_all, kp_all, vq_all, vp_all, lengths)):
        return decode_attention_plain(q, kq_all, kp_all, vq_all, vp_all,
                                      layer, lengths, sm_scale, int8_qk)
    q, G, sm_scale = kernel_operands(q, (kq_all, kp_all, vq_all, vp_all),
                                     sm_scale)
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    m = torch.empty((B, Hkv, G), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = cuda_build.function(
        "contiguous_attention", "contiguous_attention_read_only_launch",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    rc = fn(ptr(q), ptr(kq_all), ptr(kp_all), ptr(vq_all), ptr(vp_all),
            ptr(lens), ptr(out), ptr(m), ptr(l), B, layer, Hkv, G, D, S,
            sm_scale, int(int8_qk), recip_f32(127.0),
            *int4_split(S, S, (kq_all, kp_all, vq_all, vp_all)), stream(q))
    cuda_build.check(rc, "int4_decode_attention_stacked")
    LAUNCHES["int4_decode_attention_stacked"] += 1
    return out, m, l


def int4_decode_attention(q, kq, kp, vq, vp, lengths, sm_scale=None):
    """One layer's cache (B, Hkv, D/2, S) + (B, Hkv, 2, S): the stacked
    function on the L = 1 view (no copy), default QK (bf16 q, f32 sums).
    Returns out (B, Hq, D) bf16."""
    return int4_decode_attention_stacked(q, kq[None], kp[None], vq[None],
                                         vp[None], 0, lengths,
                                         sm_scale=sm_scale)[0]


def int4_decode_attention_stacked_self(q, kq_all, kp_all, vq_all, vp_all,
                                       layer: int, lengths, k_self, v_self,
                                       *, sm_scale=None, chunk: int = 512,
                                       int8_qk: bool = False):
    """Decode attention against layer `layer` of the stacked contiguous
    INT4 cache, read in place and never written, with the new token's
    dequantized (k_self, v_self) (B, Hkv, D) f32 folded in as one more
    online-softmax step.  q: (B, Hq, D) bf16, already per-head
    Hadamard-rotated like the keys; lengths (B,) cached tokens.  Returns
    out (B, Hq, D) bf16, normalized; a row of length 0 gives v_self.
    `chunk` is the reference's sequence tiling: the port tiles by 64
    tokens whatever it is."""
    B, Hq, D, (L, Bc, Hkv, D2, S) = check_int4_attention(
        q, kq_all, kp_all, vq_all, vp_all, layer)
    require(Bc == B and lengths.shape == (B,), "cache slots, lengths (B,)")
    require(k_self.shape == (B, Hkv, D) and v_self.shape == (B, Hkv, D),
            "k_self/v_self (B, Hkv, D)")
    require(chunk > 0, f"chunk {chunk} must be positive")
    tensors = (q, kq_all, kp_all, vq_all, vp_all, lengths, k_self, v_self)
    if not on_cuda(tensors):
        return decode_attention_self_plain(q, kq_all, kp_all, vq_all, vp_all,
                                           layer, lengths, k_self, v_self,
                                           sm_scale, int8_qk)
    q, G, sm_scale = kernel_operands(q, (kq_all, kp_all, vq_all, vp_all),
                                     sm_scale)
    lens = lengths.to(torch.int32).contiguous()
    k_self, v_self = k_self.float().contiguous(), v_self.float().contiguous()
    out = torch.empty_like(q)
    fn = cuda_build.function(
        "contiguous_attention", "contiguous_attention_read_only_self_launch",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    rc = fn(ptr(q), ptr(kq_all), ptr(kp_all), ptr(vq_all), ptr(vp_all),
            ptr(lens), ptr(k_self), ptr(v_self), ptr(out), B, layer, Hkv, G,
            D, S, sm_scale, int(int8_qk), recip_f32(127.0),
            *int4_split(S, S, (kq_all, kp_all, vq_all, vp_all)), stream(q))
    cuda_build.check(rc, "int4_decode_attention_stacked_self")
    LAUNCHES["int4_decode_attention_stacked_self"] += 1
    return out


# ---------------------------------------------------------------------------
# bf16 cache: decode attention returning (out, m, l), and the append
# ---------------------------------------------------------------------------

def bf16_decode_attention_plain(q, k_all, v_all, layer, lengths,
                                sm_scale=None):
    """Plain PyTorch version: the kernel's rounding points over the whole
    cache in one tile; rows of length 0 keep m = -inf, l = 0, out = 0/0."""
    B, Hq, D = q.shape
    Hkv = k_all.shape[2]
    qb = q_groups(q, Hkv, sm_scale).to(torch.bfloat16).float()
    k = k_all[layer].float()                                # (B, H, S, D)
    logits = qb @ k.transpose(-1, -2)                       # (B, H, G, S)
    live = torch.arange(k.shape[2], device=q.device)[None, :] \
        < lengths.to(torch.int64)[:, None]
    logits = torch.where(live[:, None, None, :], logits, MASK_VALUE)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(torch.bfloat16).float() @ v_all[layer].float()
    m0, l0, acc0 = empty_state(B, Hkv, qb.shape[2], D, q.device)
    row = (lengths > 0)[:, None, None, None]
    m, l, acc = (torch.where(row, m, m0), torch.where(row, l, l0),
                 torch.where(row, acc, acc0))
    out = (acc / l).to(q.dtype).reshape(B, Hq, D)
    return out, m[..., 0], l[..., 0]


# the CUDA kernel's sequence split: 64-token tiles, at most 8 blocks (one
# cluster) per (b, kv head) row, sized so that the longest row a cache of
# S tokens can hold gives each block at most 4 tiles.  On the H100 at
# B=8, Hkv=8, S=1024, 4 tiles a block (4 blocks a row) beat 2 (8 blocks,
# more than one wave of 68 KB blocks) and 8 (2 blocks): PERF.md §6.
BF16_TILE = 64
BF16_TILES_PER_BLOCK = 4
BF16_MAX_CLUSTER = 8


def bf16_attention_cluster(S: int) -> int:
    """Blocks per (b, kv head) row of the bf16 decode attention kernel for
    a cache of S tokens.  Sized from S, not from the lengths: they live on
    the card, and reading them would cost the step a sync."""
    return _cluster(S, BF16_TILE, BF16_TILES_PER_BLOCK, BF16_MAX_CLUSTER)


def bf16_attention_chunks(length: int, S: int, cl: int):
    """The token ranges [start, end) the cl blocks of one row read, in rank
    order, as the kernel splits them: block r takes 64-token tiles
    [r*T//cl, (r+1)*T//cl) of the row's T tiles, cut at the length."""
    return _tile_chunks(length, S, cl, BF16_TILE)


def bf16_decode_attention_stacked(q, k_all, v_all, layer: int, lengths,
                                  sm_scale=None):
    """Decode attention against layer `layer` of the stacked bf16 cache
    k_all/v_all (L, B, Hkv, S, D), read in place, over the lengths[b]
    cached tokens.  q: (B, Hq, D) bf16.  Returns (out (B, Hq, D) bf16,
    m (B, Hkv, G) f32, l (B, Hkv, G) f32), the online-softmax state that
    merge_self_attention folds the new token into."""
    require(q.dim() == 3 and k_all.dim() == 5, "q (B, Hq, D), caches 5-D")
    B, Hq, D = q.shape
    L, Bc, Hkv, S, Dk = k_all.shape
    require(Bc == B and Dk == D and Hq % Hkv == 0, "head shapes disagree")
    require(v_all.shape == k_all.shape, "k/v caches disagree")
    require(0 <= layer < L, f"layer {layer} out of range {L}")
    require(lengths.shape == (B,), "lengths (B,)")
    require(q.dtype == torch.bfloat16 and k_all.dtype == torch.bfloat16
            and v_all.dtype == torch.bfloat16, "q and caches must be bf16")
    if not on_cuda((q, k_all, v_all, lengths)):
        return bf16_decode_attention_plain(q, k_all, v_all, layer, lengths,
                                           sm_scale)
    G = Hq // Hkv
    require(D <= 128 and D % 8 == 0 and G <= 8,
            "kernel needs head_dim <= 128 (a multiple of 8), Hq/Hkv <= 8")
    require(k_all.is_contiguous() and v_all.is_contiguous(),
            "caches must be contiguous")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    q = q.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    m = torch.empty((B, Hkv, G), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = cuda_build.function(
        "bf16_attention", "bf16_decode_attention_launch",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    rc = fn(ptr(q), ptr(k_all), ptr(v_all), ptr(lens), ptr(out), ptr(m),
            ptr(l), B, layer, Hkv, G, D, S, sm_scale,
            bf16_attention_cluster(S), stream(q))
    cuda_build.check(rc, "bf16_decode_attention_stacked")
    LAUNCHES["bf16_decode_attention_stacked"] += 1
    return out, m, l


def kv_append_bf16_plain(k, v, layer, pos, nk, nv):
    """Plain PyTorch version: one indexed assignment per cache."""
    rows = torch.arange(k.shape[1], device=k.device)
    pos = pos.to(torch.int64)
    k[layer, rows, :, pos] = nk[:, :, 0].to(k.dtype)
    v[layer, rows, :, pos] = nv[:, :, 0].to(v.dtype)


def _bf16_chunk(D: int, tensors, strides) -> int:
    """bf16 values per copy of the append kernel: 8 (16 bytes) where D, the
    base pointers and the strides allow, else 2 (4 bytes), else 1."""
    for e in (8, 2):
        if (D % e == 0 and all(t.data_ptr() % (2 * e) == 0 for t in tensors)
                and all(s % e == 0 for s in strides)):
            return e
    return 1


def kv_append_stacked_bf16(k, v, layer: int, pos, nk, nv):
    """Write one token per sequence into layer `layer` of the stacked bf16
    cache in place (the reference aliases it): k/v (L, B, H, S, D) with
    S % 16 == 0, as the reference requires; pos (B,) write positions
    (< S): a position outside [0, S) raises on the CPU; on the card, where
    checking it would stall the host, the kernel writes nothing for that
    row.  nk/nv (B, H, 1, D), read in place through their strides when
    D's is 1."""
    require(k.dim() == 5 and v.shape == k.shape, "k/v (L, B, H, S, D)")
    L, B, H, S, D = k.shape
    # mirrored: the reference asserts full 16-row windows (kv_cache.py:946)
    require(S % 16 == 0, f"bf16 cache max_seq {S} must be a multiple of 16 "
            "(as in the reference)")
    require(0 <= layer < L, f"layer {layer} out of range {L}")
    require(pos.shape == (B,) and nk.shape == (B, H, 1, D)
            and nv.shape == nk.shape, "pos (B,), nk/nv (B, H, 1, D)")
    if not on_cuda((k, v, pos, nk, nv)):
        require(bool(((pos >= 0) & (pos < S)).all()),
                f"positions must be in [0, max_seq {S})")
        kv_append_bf16_plain(k, v, layer, pos, nk, nv)
        return
    require(k.dtype == torch.bfloat16 and v.dtype == torch.bfloat16,
            "kernel needs a bf16 cache")
    require(k.is_contiguous() and v.is_contiguous(),
            "caches must be contiguous (they are updated in place)")
    nk, nv = (t.to(torch.bfloat16) for t in (nk, nv))
    nk, nv = (t if t.stride(3) == 1 else t.contiguous() for t in (nk, nv))
    strides = (nk.stride(0), nk.stride(1), nv.stride(0), nv.stride(1))
    e = _bf16_chunk(D, (k, v, nk, nv), strides)
    p = pos.to(torch.int32).contiguous()
    fn = cuda_build.function(
        "bf16_attention", "kv_append_bf16_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
        + [ctypes.c_int, ctypes.c_void_p])
    rc = fn(ptr(k), ptr(v), ptr(nk), ptr(nv), ptr(p), B, layer, H, D, S,
            *strides, e, stream(k))
    cuda_build.check(rc, "kv_append_stacked_bf16")
    LAUNCHES["kv_append_stacked_bf16"] += 1


# ---------------------------------------------------------------------------
# INT4 cache: the one-token append
# ---------------------------------------------------------------------------

def kv_append_stacked_plain(kq, kp, vq, vp, layer, pos, nkq, nkp, nvq, nvp):
    """Plain PyTorch version of kv_append_stacked: one indexed assignment
    per cache, lane-major new values (B, H, D/2, 1) and (B, H, 2, 1)."""
    append_columns_plain(kq, kp, vq, vp, layer, pos, nkq[..., 0],
                         nkp[..., 0], nvq[..., 0], nvp[..., 0])
    return kq, kp, vq, vp


def kv_append_stacked(kq, kp, vq, vp, layer: int, pos, nkq, nkp, nvq, nvp):
    """Write one token per sequence into layer `layer` of the stacked INT4
    cache in place (the reference aliases it): kq/vq (L, B, H, D/2, S) u8,
    kp/vp (L, B, H, 2, S) f32; pos (B,) write positions (< S); nkq/nvq
    (B, H, D/2, 1) u8 and nkp/nvp (B, H, 2, 1) f32, lane-major as the
    reference takes them.  Exactly column pos[b] is written (the reference
    rewrites the 128-lane window around it with the same values).  A
    position outside [0, S) raises on the CPU; on the card, where checking
    it would stall the host, the kernel writes nothing for that row.
    Returns the four caches."""
    require(kq.dim() == 5 and vq.shape == kq.shape, "codes (L, B, H, D/2, S)")
    L, B, H, D2, S = kq.shape
    require(kp.shape == (L, B, H, 2, S) and vp.shape == kp.shape,
            "params (L, B, H, 2, S)")
    require(0 <= layer < L, f"layer {layer} out of range {L}")
    require(pos.shape == (B,), "pos (B,)")
    require(nkq.shape == (B, H, D2, 1) and nvq.shape == nkq.shape
            and nkp.shape == (B, H, 2, 1) and nvp.shape == nkp.shape,
            "nkq/nvq (B, H, D/2, 1), nkp/nvp (B, H, 2, 1)")
    require(kq.dtype == torch.uint8 and vq.dtype == torch.uint8
            and kp.dtype == torch.float32 and vp.dtype == torch.float32,
            "cache dtypes: u8 codes, f32 params")
    tensors = (kq, kp, vq, vp, pos, nkq, nkp, nvq, nvp)
    if not on_cuda(tensors):
        require(bool(((pos >= 0) & (pos < S)).all()),
                f"positions must be in [0, max_seq {S})")
        return kv_append_stacked_plain(kq, kp, vq, vp, layer, pos, nkq, nkp,
                                       nvq, nvp)
    require(all(t.is_contiguous() for t in (kq, kp, vq, vp)),
            "caches must be contiguous (they are updated in place)")
    p = pos.to(torch.int32).contiguous()
    nkq, nvq = nkq.to(torch.uint8).contiguous(), nvq.to(torch.uint8).contiguous()
    nkp, nvp = nkp.float().contiguous(), nvp.float().contiguous()
    fn = cuda_build.function(
        "contiguous_attention", "kv_append_launch",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    rc = fn(ptr(kq), ptr(kp), ptr(vq), ptr(vp), ptr(p), ptr(nkq), ptr(nkp),
            ptr(nvq), ptr(nvp), B, layer, H, D2, S, stream(kq))
    cuda_build.check(rc, "kv_append_stacked")
    LAUNCHES["kv_append_stacked"] += 1
    return kq, kp, vq, vp
