"""Quantizer primitives on tensors (the port of rsq_tpu.core.quant).

Sym/asym quant-dequant, int4 packing, per-token activation quantization and
the per-channel weight quantizer with its MSE grid-shrink clip search, as
stateless functions.  Rounding follows the reference: `torch.round` is
round-half-to-even like `jnp.round`; where the reference runs under jit, a
division by a constant is a multiplication by its f32 reciprocal
(`core.numerics.div_const`), a division by a tensor a true division.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rsq_tpu_torch.core.numerics import div_const, recip_f32


def minq_maxq(bits: int, sym: bool) -> tuple[int, int]:
    """Integer grid endpoints: [-2^(b-1), 2^(b-1)-1] symmetric, [0, 2^b-1]
    asymmetric."""
    if sym:
        maxq = 2 ** (bits - 1) - 1
        return -maxq - 1, maxq
    return 0, 2 ** bits - 1


def sym_quant(x, scale, maxq):
    """Round-to-nearest onto the symmetric grid; float-valued ints."""
    return torch.clamp(torch.round(x / scale), -(maxq + 1), maxq)


def sym_dequant(q, scale):
    return scale * q


def sym_quant_dequant(x, scale, maxq):
    return sym_dequant(sym_quant(x, scale, maxq), scale)


def asym_quant(x, scale, zero, maxq):
    return torch.clamp(torch.round(x / scale) + zero, 0, maxq)


def asym_dequant(q, scale, zero):
    return scale * (q - zero)


def asym_quant_dequant(x, scale, zero, maxq):
    return asym_dequant(asym_quant(x, scale, zero, maxq), scale, zero)


def pack_int4(q) -> torch.Tensor:
    """Signed int4 values ([-8, 7], any int dtype) packed in pairs along the
    last axis into uint8: low nibble the even index, high nibble the odd."""
    u = q.to(torch.int16)
    u = torch.where(u < 0, u + 16, u).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(p) -> torch.Tensor:
    """Inverse of pack_int4; int8 in [-8, 7]."""
    lo = (p & 0x0F).to(torch.int8)
    hi = ((p >> 4) & 0x0F).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 p.shape[-1] * 2)


# ---------------------------------------------------------------------------
# Activation quantization (per token or per token group), runtime scales
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ActQuantConfig:
    """One activation-quantization site; bits == 16 is a no-op, groupsize
    -1 is per token over the whole feature dim."""
    bits: int = 16
    sym: bool = True
    groupsize: int = -1
    clip_ratio: float = 1.0

    @property
    def enabled(self) -> bool:
        return self.bits < 16


def act_quant_params(x, cfg: ActQuantConfig):
    """Per-token (or per-token-group) (scale, zero), broadcastable against
    x (per token: (..., 1); groupwise: (..., d/g, 1) of the grouped view).
    Per token the min is clamped to <= 0 and the max to >= 0; a zero row
    gets scale 1 (sym) or the [-1, 1] range (asym)."""
    _, maxq = minq_maxq(cfg.bits, cfg.sym)
    xf = x.float()
    if cfg.groupsize > 0:
        xf = xf.reshape(*x.shape[:-1], x.shape[-1] // cfg.groupsize,
                        cfg.groupsize)
        xmax = xf.amax(-1, keepdim=True) * cfg.clip_ratio
        xmin = xf.amin(-1, keepdim=True) * cfg.clip_ratio
    else:
        xmax = torch.clamp(xf.amax(-1, keepdim=True), min=0.0) * cfg.clip_ratio
        xmin = torch.clamp(xf.amin(-1, keepdim=True), max=0.0) * cfg.clip_ratio
    if cfg.sym:
        xabs = torch.maximum(xmin.abs(), xmax)
        scale = torch.where(xabs == 0, 1.0, div_const(xabs, maxq))
        return scale, torch.zeros_like(scale)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    scale = div_const(xmax - xmin, maxq)
    return scale, torch.round(-xmin / scale)


def act_fake_quant(x, cfg: ActQuantConfig):
    """Quantize-dequantize activations with runtime per-token scales."""
    if not cfg.enabled:
        return x
    _, maxq = minq_maxq(cfg.bits, cfg.sym)
    scale, zero = act_quant_params(x, cfg)
    xf = x.float()
    if cfg.groupsize > 0:
        xf = xf.reshape(*x.shape[:-1], x.shape[-1] // cfg.groupsize,
                        cfg.groupsize)
    y = (sym_quant_dequant(xf, scale, maxq) if cfg.sym
         else asym_quant_dequant(xf, scale, zero, maxq))
    return y.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Weight quantization: per-channel minmax, optional MSE grid-shrink search
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WeightQuantConfig:
    """One linear's weight quantizer: MSE clip search with norm 2.4 over a
    shrink grid when mse is set; nf selects the NormalFloat codebook."""
    bits: int = 4
    sym: bool = True
    perchannel: bool = True
    mse: bool = False
    norm: float = 2.4
    grid: int = 100
    maxshrink: float = 0.8
    nf: bool = False

    @property
    def enabled(self) -> bool:
        return self.bits < 16


def _params_from_range(lo, hi, cfg: WeightQuantConfig, maxq: int):
    if cfg.nf:
        from rsq_tpu_torch.core.nf import grid_max
        amax = torch.clamp(torch.maximum(lo.abs(), hi), min=1e-5)
        return div_const(amax, grid_max(cfg.bits)), torch.zeros_like(amax)
    if cfg.sym:
        amax = torch.clamp(torch.maximum(lo.abs(), hi), min=1e-5)
        return div_const(amax, maxq), torch.zeros_like(amax)
    degenerate = (lo == 0) & (hi == 0)
    lo = torch.where(degenerate, -1.0, lo)
    hi = torch.where(degenerate, 1.0, hi)
    scale = div_const(torch.clamp(hi - lo, min=1e-5), maxq)
    return scale, torch.round(-lo / scale)


def _qdq(Wf, scale, zero, cfg: WeightQuantConfig, maxq: int):
    if cfg.nf:
        from rsq_tpu_torch.core.nf import nf_quant_dequant
        return nf_quant_dequant(Wf, cfg.bits, scale)
    if cfg.sym:
        return sym_quant_dequant(Wf, scale, maxq)
    return asym_quant_dequant(Wf, scale, zero, maxq)


def weight_quant_params(W, cfg: WeightQuantConfig):
    """Per-output-row (scale, zero), each (rows, 1), of W (rows, cols).
    With cfg.mse, the grid-shrink clip search: shrink p = 1 - i/grid for i
    in [0, maxshrink*grid), scored by sum |qdq(W) - W|^norm per row, the
    best shrink kept (a strictly smaller score wins, as in the reference)."""
    _, maxq = minq_maxq(cfg.bits, cfg.sym)
    Wf = W.float()
    if not cfg.perchannel:
        Wf = Wf.reshape(1, -1)
    xmin = torch.clamp(Wf.amin(1), max=0.0)
    xmax = torch.clamp(Wf.amax(1), min=0.0)
    scale, zero = _params_from_range(xmin, xmax, cfg, maxq)
    if cfg.mse:
        best = torch.full_like(xmin, float("inf"))
        step = np.float32(recip_f32(cfg.grid))
        for i in range(int(cfg.maxshrink * cfg.grid)):
            p = float(np.float32(1.0) - np.float32(i) * step)
            s1, z1 = _params_from_range(p * xmin, p * xmax, cfg, maxq)
            q = _qdq(Wf, s1[:, None], z1[:, None], cfg, maxq)
            err = ((q - Wf).abs() ** cfg.norm).sum(1)
            better = err < best
            best = torch.where(better, err, best)
            scale = torch.where(better, s1, scale)
            zero = torch.where(better, z1, zero)
    if not cfg.perchannel:
        scale = scale.expand(W.shape[0])
        zero = zero.expand(W.shape[0])
    return scale[:, None], zero[:, None]


def weight_fake_quant(W, scale, zero, cfg: WeightQuantConfig):
    """Quantize-dequantize W with fixed per-row params."""
    if not cfg.enabled:
        return W
    _, maxq = minq_maxq(cfg.bits, cfg.sym)
    return _qdq(W.float(), scale, zero, cfg, maxq).to(W.dtype)


def weight_quantize_store(W, scale, zero, cfg: WeightQuantConfig):
    """Integer codes of W for storage and serving, int8: symmetric codes
    zero-centred, asymmetric ones in [0, maxq]."""
    _, maxq = minq_maxq(cfg.bits, cfg.sym)
    Wf = W.float()
    q = (sym_quant(Wf, scale, maxq) if cfg.sym
         else asym_quant(Wf, scale, zero, maxq))
    return q.to(torch.int8)
