"""INT4 KV-cache pieces (the port of the parts of rsq_tpu.kernels.kv_cache
on the paged serving path).

Cache layout (sequence in the last axis, as in the reference): codes
uint8 (..., D/2, S) with the low nibble holding d < D/2 and the high nibble
d + D/2; params f32 (..., 2, S) = (scale, zero), dequant u*scale - zero.

Kernel: decode_prep (csrc/decode_prep.cu), with its plain version here.
attend_tile / self_fold_finalize are the plain math of the paged attention
kernel (csrc/paged_attention.cu), following the reference's _attend_tile and
_self_fold_finalize rounding points.
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
    """Plain PyTorch version of decode_prep (same rounding points)."""
    D = q.shape[-1]
    half = D // 2
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


def decode_prep(q, k, v, cos, sin, kv_had: bool = True):
    """Fused decode-token prep: RoPE(q, k) -> per-head Hadamard(q, k) ->
    asymmetric INT4 quant-pack(k, v) + dequantized self values.

    q: (B, Hq, D) bf16; k/v: (B, Hkv, D) bf16; cos/sin: (B, D) f32.
    Returns (qh (B, Hq, D) bf16, k_self, v_self (B, Hkv, D) f32,
    nkq (B, Hkv, D/2) u8, nkp (B, Hkv, 2) f32, nvq, nvp)."""
    require(q.dim() == 3 and k.shape == v.shape and k.dim() == 3,
            "q (B, Hq, D), k/v (B, Hkv, D)")
    B, Hq, D = q.shape
    Hkv = k.shape[1]
    require(k.shape[0] == B and k.shape[2] == D, "k/v shape mismatch")
    require(cos.shape == (B, D) and sin.shape == (B, D), "cos/sin (B, D)")
    require(q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16
            and v.dtype == torch.bfloat16, "q/k/v must be bf16")
    if not on_cuda((q, k, v, cos, sin)):
        return decode_prep_plain(q, k, v, cos, sin, kv_had)
    require(D & (D - 1) == 0 and 2 <= D <= 256,
            "kernel needs a power-of-2 head_dim <= 256")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cos, sin = cos.float().contiguous(), sin.float().contiguous()
    dev = q.device
    qh = torch.empty_like(q)
    k_self = torch.empty((B, Hkv, D), dtype=torch.float32, device=dev)
    v_self = torch.empty_like(k_self)
    nkq = torch.empty((B, Hkv, D // 2), dtype=torch.uint8, device=dev)
    nvq = torch.empty_like(nkq)
    nkp = torch.empty((B, Hkv, 2), dtype=torch.float32, device=dev)
    nvp = torch.empty_like(nkp)
    fn = cuda_build.function(
        "decode_prep", "decode_prep_launch",
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptr(q), ptr(k), ptr(v), ptr(cos), ptr(sin), ptr(qh), ptr(k_self),
            ptr(v_self), ptr(nkq), ptr(nkp), ptr(nvq), ptr(nvp), B, Hq, Hkv, D,
            int(kv_had), 1.0 / math.sqrt(D), recip_f32(15.0), stream(q))
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
