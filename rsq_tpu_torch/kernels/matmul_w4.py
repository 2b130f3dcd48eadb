"""INT4/INT8 weight packing and the two matmul kernels of the serving path
(the port of rsq_tpu.kernels.matmul_w4).

Packing (host-side tensor code): "planar" int4 W (K, N) -> uint8 (K, N/2),
where byte (k, g*P + j) holds outputs (k, g*2P + j) [low nibble] and
(k, g*2P + P + j) [high nibble], P = PACK_GROUP/2.

Kernels, each with its plain PyTorch version beside it:
- w4a4_matmul_paired_stacked and, on an L = 1 view of unstacked weights,
  w4a4_matmul_paired (w4a4_matmul un-pairs it): csrc/w4a4_matmul.cu
- w4_matmul_paired_stacked, w4_affine_matmul_stacked and, on L = 1 views,
  w4_matmul_paired, w4_affine_matmul and w4_matmul (the int4 lm_head):
  csrc/w4_matmul.cu, a weight stream at M <= 16 and TMA + wgmma beyond,
  with two epilogues
- w16_matmul_stacked: csrc/w16_matmul.cu
- w8_matmul: csrc/w8_matmul.cu
The unstacked functions take the reference's `decode` (and W4A4's
`mxu_int8`) hints and ignore them: they pick the TPU kernel's tiles and
MXU path, and the port's kernels size their launch from M themselves.
"""

from __future__ import annotations

import ctypes

import torch

from rsq_tpu_torch.core.numerics import div, folded_mul_div, mul_div_const
from rsq_tpu_torch.kernels import LAUNCHES, cuda_build, on_cuda, ptr, require, stream


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

# planar pairing group: each byte's two nibbles are outputs (2j, 2j+1)
PACK_GROUP = 2


def _nibbles(wq: torch.Tensor) -> torch.Tensor:
    """int values in [-8, 7] -> uint8 two's-complement nibbles."""
    w = wq.to(torch.int16)
    return torch.where(w < 0, w + 16, w).to(torch.uint8)


def pack_w4_planar(wq: torch.Tensor) -> torch.Tensor:
    """wq: int values in [-8, 7], shape (..., N) with N even -> uint8 (..., N/2)."""
    u = _nibbles(wq)
    n = u.shape[-1]
    g = PACK_GROUP
    ug = u.reshape(*u.shape[:-1], n // g, 2, g // 2)
    return (ug[..., 0, :] | (ug[..., 1, :] << 4)).reshape(*u.shape[:-1], n // 2)


def _sign4(u: torch.Tensor) -> torch.Tensor:
    s = u.to(torch.int8)
    return torch.where(s >= 8, s - 16, s)


def unpack_w4_planar(p: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_w4_planar; returns int8 (..., N)."""
    n = p.shape[-1] * 2
    g = PACK_GROUP
    pg = p.reshape(*p.shape[:-1], n // g, g // 2)
    out = torch.stack([_sign4(pg & 0x0F), _sign4(pg >> 4)], dim=-2)
    return out.reshape(*p.shape[:-1], n)


def pair_scales(scale: torch.Tensor) -> torch.Tensor:
    """(N,) per-output scales -> (2, N/2) aligned with the packed planes."""
    n = scale.shape[-1]
    g = PACK_GROUP
    s = scale.reshape(n // g, 2, g // 2)
    return s.movedim(1, 0).reshape(2, n // 2)


def unpair_outputs(y3: torch.Tensor) -> torch.Tensor:
    """(M, 2, N/2) plane-paired kernel output -> (M, N)."""
    m, n = y3.shape[0], y3.shape[-1] * 2
    g = PACK_GROUP
    return y3.reshape(m, 2, n // g, g // 2).movedim(1, 2).reshape(m, n)


def w8_quantize(w: torch.Tensor, axis: int = 0):
    """Per-output-channel symmetric int8 of a dense (K, N) matrix (axis =
    reduction axis) -> (w8 int8, scale (N,) f32)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axis)
    scale = torch.where(absmax == 0, 1.0, div(absmax, 127.0))
    w8 = torch.clamp(torch.round(wf / scale), -127, 127)
    return w8.to(torch.int8), scale.float()


def token_scales(x: torch.Tensor, clip_ratio: float = 1.0) -> torch.Tensor:
    """Per-token activation scale (M, 1) f32: absmax*clip/7, 1 where 0,
    rounded as the jitted reference rounds it (one folded constant)."""
    absmax = x.float().abs().amax(dim=1, keepdim=True)
    return torch.where(absmax == 0, 1.0, mul_div_const(absmax, clip_ratio, 7.0))


def _split_k(blocks: int, K: int, per_sm: int = 4, most: int = 1 << 30,
             step: int = 64):
    """Split K (in `step`-value steps, into at most `most` slices) until
    about `per_sm` blocks per SM of the 132 are in flight, for a launch of
    `blocks` output blocks: (nsplit, kchunk), kchunk a multiple of `step`
    and nsplit = ceil(K / kchunk).  The kernels sum the slices in a fixed
    order, so runs repeat bit for bit."""
    nsplit = max(1, min(-(-132 * per_sm // blocks), most, -(-K // step)))
    kchunk = -(-K // nsplit)
    kchunk = -(-kchunk // step) * step
    return -(-K // kchunk), kchunk


# tensor maps of stacked weights for the TMA kernels, one per (library,
# address, shape, box rows): a map holds only those, so a reused address
# stays valid
_MAPS: dict[tuple, ctypes.Array] = {}
_MAPS_MAX = 512


def _tensor_map(lib: str, symbol: str, w_all, *box):
    """The tensor map that library `lib`'s `symbol` encodes for the stacked
    weights w_all (L, K, N) (and the box arguments `box`), cached."""
    L, K, N = w_all.shape
    key = (lib, w_all.data_ptr(), L, K, N, *box)
    m = _MAPS.get(key)
    if m is None:
        if len(_MAPS) >= _MAPS_MAX:
            _MAPS.clear()
        m = ctypes.create_string_buffer(128)      # sizeof(CUtensorMap)
        fn = cuda_build.function(
            lib, symbol,
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * (3 + len(box)))
        cuda_build.check(fn(m, ptr(w_all), L, K, N, *box),
                         f"{symbol} tensor map")
        _MAPS[key] = m
    return m


# ---------------------------------------------------------------------------
# W4A4 against stacked plane-major weights
# ---------------------------------------------------------------------------

def w4a4_matmul_paired_stacked_plain(x, wp_all, scale2, layer, xs):
    """Plain PyTorch version: same quantization (multiply by the inverse
    scale, round half to even), exact integer products (small integers in
    f32 sum exactly: |acc| <= K*64 < 2^24), same epilogue order."""
    inv = torch.reciprocal(xs)
    xq = torch.clamp(torch.round(x.float() * inv), -8, 7)
    w = wp_all[layer].to(torch.int32)
    lo = ((w << 28) >> 28).float()
    hi = ((w << 24) >> 28).float()
    acc = torch.stack([xq @ lo, xq @ hi], dim=1)          # (M, 2, Nh)
    return (acc * xs[:, :, None] * scale2).to(torch.bfloat16)


def _w4a4_launch(x, wp_all, scale2, layer, xs, clip_ratio, name):
    """Launch csrc/w4a4_matmul.cu on layer `layer` of wp_all, read in place;
    counts one launch of `name`.  xs: the (M, 1) per-token scales, or None
    to have the kernel compute them from x and clip_ratio (only at M <= 16;
    the caller passes them beyond).  One kernel launch, no workspace: a K
    split (decode shapes) is reduced inside it."""
    M, K = x.shape
    Nh = wp_all.shape[2]
    require(K % 8 == 0 and Nh % 4 == 0, "kernel needs K % 8 == 0, Nh % 4 == 0")
    require(x.is_contiguous() and wp_all.is_contiguous(), "contiguous inputs")
    require(x.data_ptr() % 16 == 0, "kernel needs a 16-byte aligned x")
    wl = wp_all[layer]
    require(wl.data_ptr() % 4 == 0, "kernel needs 4-byte aligned weights")
    # 16-byte weight copies where rows allow them, else 4-byte ones
    wide16 = Nh % 16 == 0 and wl.data_ptr() % 16 == 0
    # tiles of 8 activation rows per block: 1 at decode, up to 8 at prefill
    mt = 1 if M <= 8 else 2 if M <= 16 else 4 if M <= 32 else 8
    require(xs is not None or mt <= 2, "the kernel computes xs at M <= 16 only")
    # a K split is reduced in one thread-block cluster: 8 blocks at most,
    # about 2 blocks per SM
    nsplit, kchunk = (_split_k(-(-Nh // 128) * -(-M // (8 * mt)), K,
                               per_sm=2, most=8) if mt <= 2 else (1, K))
    out = torch.empty((M, 2, Nh), dtype=torch.bfloat16, device=x.device)
    fn = cuda_build.function(
        "w4a4_matmul", "w4a4_matmul_paired_stacked_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptr(x), None if xs is None else ptr(xs), ptr(wl), ptr(scale2),
            ptr(out), M, K, Nh, kchunk, nsplit, mt, int(wide16),
            folded_mul_div(clip_ratio, 7.0), stream(x))
    cuda_build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def w4a4_matmul_paired_stacked(x, wp_all, scale2, layer: int,
                               clip_ratio: float = 1.0):
    """W4A4 matmul against layer `layer` of stacked plane-major weights
    wp_all (L, K, Nh) uint8, read in place (no copy of the layer).
    x: (M, K) bf16; scale2: (2, Nh) f32 for this layer.  Returns the
    plane-paired output (M, 2, Nh) bf16.  The per-token scale is computed
    inside the kernel at decode (M <= 16) and here in plain PyTorch beyond
    (one pass over x); the kernel quantizes x with it, multiplies in the
    integer domain and applies the dual-scale epilogue.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    require(x.dim() == 2 and wp_all.dim() == 3, "x (M, K), wp_all (L, K, Nh)")
    M, K = x.shape
    L, Kw, Nh = wp_all.shape
    require(K == Kw, f"K mismatch {K} vs {Kw}")
    require(0 <= layer < L, f"layer {layer} out of range {L}")
    require(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    require(wp_all.dtype == torch.uint8, "wp_all must be uint8")
    require(scale2.shape == (2, Nh) and scale2.dtype == torch.float32,
             f"scale2 must be (2, {Nh}) f32")
    if not on_cuda((x, wp_all, scale2)):
        return w4a4_matmul_paired_stacked_plain(
            x, wp_all, scale2, layer, token_scales(x, clip_ratio))
    # at decode (M <= 16) the kernel computes the token scales itself
    xs = None if M <= 16 else token_scales(x, clip_ratio).reshape(M)
    return _w4a4_launch(x, wp_all, scale2.contiguous(), layer, xs,
                        clip_ratio, "w4a4_matmul_paired_stacked")


def w4a4_matmul_paired_plain(x, w_packed, scale2, xs):
    """Plain PyTorch version of w4a4_matmul_paired (xs: (M, 1) f32)."""
    return w4a4_matmul_paired_stacked_plain(x, w_packed[None], scale2, 0, xs)


def w4a4_matmul_paired(x, w_packed, scale2, token_scale=None, *,
                       clip_ratio: float = 1.0, decode=None, mxu_int8=None):
    """W4A4 matmul against unstacked packed weights w_packed (K, Nh) uint8,
    paired scales scale2 (2, Nh) f32: (M, 2, Nh) bf16 for x (M, K) bf16.
    The per-token scale is absmax*clip/7 of each row of x, or token_scale
    (M, 1) when given (the reference passes the tensor-parallel global
    absmax there).  The TPU kernel has an int8 body for decode and a bf16
    one for prefill; both sum the same integer products exactly, so the one
    CUDA kernel (row 12's, on the L = 1 view w_packed[None], no copy)
    reproduces both: `decode` and `mxu_int8` change nothing here."""
    require(x.dim() == 2 and w_packed.dim() == 2, "x (M, K), w_packed (K, Nh)")
    M, K = x.shape
    Kw, Nh = w_packed.shape
    require(K == Kw, f"K mismatch {K} vs {Kw}")
    require(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    require(w_packed.dtype == torch.uint8, "w_packed must be uint8")
    require(scale2.shape == (2, Nh) and scale2.dtype == torch.float32,
            f"scale2 must be (2, {Nh}) f32")
    xs = None if token_scale is None else token_scale.float().reshape(M, 1)
    if not on_cuda((x, w_packed, scale2) + (() if xs is None else (xs,))):
        return w4a4_matmul_paired_plain(
            x, w_packed, scale2,
            token_scales(x, clip_ratio) if xs is None else xs)
    # at decode (M <= 16) the kernel computes the token scales itself
    if xs is None and M > 16:
        xs = token_scales(x, clip_ratio)
    return _w4a4_launch(x.contiguous(), w_packed[None], scale2.contiguous(),
                        0, None if xs is None else xs.reshape(M).contiguous(),
                        clip_ratio, "w4a4_matmul_paired")


def w4a4_matmul(x, w_packed, scale, token_scale=None, *,
                clip_ratio: float = 1.0, decode=None, mxu_int8=None):
    """W4A4 matmul against adjacent-planar packed weights (K, N/2) with
    per-column scales (N,): w4a4_matmul_paired on the paired scales, the
    output un-paired to (M, N) bf16."""
    return unpair_outputs(w4a4_matmul_paired(
        x, w_packed, pair_scales(scale), token_scale, clip_ratio=clip_ratio))


# ---------------------------------------------------------------------------
# Weight-only W4 (bf16 activations) against stacked packed weights
# ---------------------------------------------------------------------------

def _w4_acc(x, wl):
    """f32 sums x @ q for both nibble planes of packed weights wl (K, Nh):
    (M, 2, Nh).  bf16 x int4 products are exact in f32."""
    w = wl.to(torch.int32)
    xf = x.float()
    return torch.stack([xf @ ((w << 28) >> 28).float(),
                        xf @ ((w << 24) >> 28).float()], dim=1)


def _w4_check(x, wp_all, layer):
    require(x.dim() == 2 and wp_all.dim() == 3, "x (M, K), wp_all (L, K, Nh)")
    L, K, Nh = wp_all.shape
    require(x.shape[1] == K, f"K mismatch {x.shape[1]} vs {K}")
    require(0 <= layer < L, f"layer {layer} out of range {L}")
    require(wp_all.dtype == torch.uint8, "wp_all must be uint8")
    return Nh


# the weight-only kernel's shape rule and K split (csrc/w4_matmul.cu): M <=
# 16 streams the weights through blocks of 128 packed columns; M > 16 runs
# TMA and wgmma on tiles of 64 or 128 rows x 128 packed columns
# (w4_tma_rows) where the tensor maps can address the weights.  W4_WAVE:
# the stream's K split is the largest power of two (at most 8) that keeps
# the blocks within one wave, one an SM, but at least 2 where the column
# tiles are fewer than the SMs: on the H100 the 24-tile qkv took 0.0116 ms
# split 4 ways against 0.0141 5 ways and 0.0123 8 ways, the 112-tile
# up|gate 0.0308 split in two against 0.0302 whole and 0.0387 4 ways
# (tools/sweep_sizing.py, PERF.md section 6).
W4_STREAM_COLUMNS = 128
W4_WAVE = 132


def w4_uses_tma(M: int, Nh: int, w_ptr: int) -> bool:
    """True where the weight-only kernel takes its TMA path: M > 16, Nh %
    16 == 0 and a 16-byte aligned stacked base.  Fixed by the shape before
    the launch; every other shape streams the weights through mma.sync."""
    return M > 16 and Nh % 16 == 0 and w_ptr % 16 == 0


def w4_tma_rows(M: int, Nh: int) -> int:
    """Rows of x a block of the weight-only kernel's TMA path takes: 128,
    or 64 where the 64-row tiles fill the card in fewer waves than the
    128-row ones take at 1.6x a 64-row tile's time (on the H100, M=1024:
    o 0.0582 ms at 128 rows against 0.0733 at 64, qkv 0.1148 against 0.1113
    -- 192 tiles, two waves -- and k|v 0.0422 against 0.0246: PERF.md
    section 6)."""
    def cost(rows, weight):
        return -(-(-(-M // rows) * -(-Nh // 128)) // 132) * weight
    return 128 if cost(128, 1.6) <= cost(64, 1.0) else 64


def w4_split(M: int, K: int, Nh: int, tma: bool):
    """(nsplit, kchunk) of the weight-only kernel's K split, reduced inside
    one thread-block cluster: at most 8 slices of a multiple of 64 rows
    (128 for the stream's stages).  The stream splits as W4_WAVE says; the
    TMA path only where its tiles leave SMs idle, and never past one
    wave."""
    if tma:
        tiles = -(-M // w4_tma_rows(M, Nh)) * -(-Nh // 128)
        return _split_k(tiles, K, per_sm=1, most=max(1, min(8, 132 // tiles)))
    blocks = -(-Nh // W4_STREAM_COLUMNS) * -(-M // (8 if M <= 8 else 16))
    fit = min(8, W4_WAVE // blocks)
    most = max(2 if blocks < W4_WAVE else 1, 1 << max(0, fit.bit_length() - 1))
    # whole 128-row stages, so no slice's last tile reaches into the next
    return _split_k(blocks, K, per_sm=8, most=most, step=128)


def _w4_launch(x, w_all, layer, scale, xsum, *, affine, adjacent):
    """Launch csrc/w4_matmul.cu on layer `layer` of w_all (L, K, Nh), read
    in place.  scale: indexed as the output (paired (2, Nh) or, adjacent,
    natural (N,) f32), or the layer's 0-d sh (affine) with the (M,) f32 row
    sums xsum, None to have the kernel take them (M <= 16).  Returns (M, 2 *
    Nh) bf16, columns plane-paired or adjacent (2j + p).  One launch."""
    M, K = x.shape
    Nh = w_all.shape[2]
    require(x.dtype == torch.bfloat16, f"kernel needs bf16 x, got {x.dtype}")
    require(K % 8 == 0, "kernel needs K % 8 == 0")
    require(w_all.is_contiguous() and scale.is_contiguous(),
            "contiguous weights")
    require(xsum is not None or not affine or M <= 16,
            "the kernel takes the row sums at M <= 16 only")
    x = x.contiguous()
    require(x.data_ptr() % 16 == 0, "kernel needs a 16-byte aligned x")
    tma = w4_uses_tma(M, Nh, w_all.data_ptr())
    nsplit, kchunk = w4_split(M, K, Nh, tma)
    # tensor maps where they can address the weights: 64-row boxes for the
    # M > 16 kernel, 128-row ones for the stream; else the stream's byte
    # loads
    wmap = smap = None
    if tma:
        wmap = _tensor_map("w4_matmul", "w4_weight_map", w_all, 64)
    elif w4_uses_tma(17, Nh, w_all.data_ptr()):
        smap = _tensor_map("w4_matmul", "w4_weight_map", w_all, 128)
    out = torch.empty((M, 2 * Nh), dtype=torch.bfloat16, device=x.device)
    fn = cuda_build.function(
        "w4_matmul", "w4_matmul_launch",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    rc = fn(ptr(x), ptr(w_all[layer]), wmap, smap, ptr(scale),
            None if xsum is None else ptr(xsum), ptr(out), M, K, Nh, layer,
            kchunk, nsplit, int(affine), int(adjacent), w4_tma_rows(M, Nh),
            stream(x))
    cuda_build.check(rc, "w4_matmul")
    return out


def w4_matmul_paired_stacked_plain(x, wp_all, scale2, layer):
    """Plain PyTorch version: f32 sums, the paired-scale epilogue, one
    rounding to x's dtype."""
    return (_w4_acc(x, wp_all[layer]) * scale2).to(x.dtype)


def w4_matmul_paired_stacked(x, wp_all, scale2, layer: int):
    """Weight-only W4 matmul against layer `layer` of stacked packed weights
    wp_all (L, K, Nh) uint8, read in place (no copy of the layer).  x: (M, K)
    bf16; scale2: (2, Nh) f32, this layer's paired per-column scales.
    Returns the plane-paired output (M, 2, Nh) in x's dtype.  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    Nh = _w4_check(x, wp_all, layer)
    require(scale2.shape == (2, Nh) and scale2.dtype == torch.float32,
            f"scale2 must be (2, {Nh}) f32")
    if not on_cuda((x, wp_all, scale2)):
        return w4_matmul_paired_stacked_plain(x, wp_all, scale2, layer)
    out = _w4_launch(x, wp_all, layer, scale2.contiguous(), None,
                     affine=False, adjacent=False)
    LAUNCHES["w4_matmul_paired_stacked"] += 1
    return out.reshape(x.shape[0], 2, Nh)


def w4_matmul_paired_plain(x, w_packed, scale2):
    """Plain PyTorch version of w4_matmul_paired."""
    return w4_matmul_paired_stacked_plain(x, w_packed[None], scale2, 0)


def w4_matmul_paired(x, w_packed, scale2, *, decode=None):
    """Weight-only W4 matmul against unstacked packed weights w_packed
    (K, Nh) uint8 with paired scales scale2 (2, Nh) f32: the plane-paired
    (M, 2, Nh) output in x's dtype.  Row 13's kernel on the L = 1 view
    (read in place, any even N, no padding)."""
    require(w_packed.dim() == 2, "w_packed (K, Nh)")
    Nh = _w4_check(x, w_packed[None], 0)
    require(scale2.shape == (2, Nh) and scale2.dtype == torch.float32,
            f"scale2 must be (2, {Nh}) f32")
    if not on_cuda((x, w_packed, scale2)):
        return w4_matmul_paired_plain(x, w_packed, scale2)
    out = _w4_launch(x, w_packed[None], 0, scale2.contiguous(), None,
                     affine=False, adjacent=False)
    LAUNCHES["w4_matmul_paired"] += 1
    return out.reshape(x.shape[0], 2, Nh)


def row_sums(x):
    """The affine kernel's rank-1 operand: f32 row sums of x, (M,)."""
    return torch.sum(x, dim=1, dtype=torch.float32)


# The affine format's offset: E8P re-encodes to v = (q + 0.5) * sh
# (quantize/ldlq._affine_int4_table); csrc/w4_matmul.cu's kZero.
AFFINE_ZERO = 0.5


def w4_affine_matmul_stacked_plain(x, wp_all, sh_all, layer, xsum=None):
    """Plain PyTorch version, plane-paired (M, 2, Nh): f32 sums, then
    (acc + 0.5 * xsum) * sh in the reference's order, one rounding."""
    xsum = row_sums(x) if xsum is None else xsum
    acc = _w4_acc(x, wp_all[layer])
    return ((acc + AFFINE_ZERO * xsum[:, None, None])
            * sh_all[layer]).to(x.dtype)


def w4_affine_matmul_stacked(x, wp_all, sh_all, layer: int,
                             plane_major: bool = False):
    """y = x @ ((unpack(W) + 0.5) * sh_all[layer]) against layer `layer` of
    stacked packed weights (L, K, Nh) with per-layer scalar scales sh_all
    (L,) f32: the E8P serving route (weights re-encoded losslessly to affine
    int4).  The constant offset folds into a rank-1 term: y = (x @ q + 0.5
    * sum_k x) * sh, the f32 row sums taken inside the kernel at M <= 16
    and here beyond.  The kernel reads sh from device memory.  plane_major:
    byte j holds natural outputs (j, j + Nh), so the un-pairing is a
    reshape; else the adjacent layout's interleave (both written by the
    kernel itself).  Returns (M, 2 * Nh) in x's dtype."""
    Nh = _w4_check(x, wp_all, layer)
    require(sh_all.shape == (wp_all.shape[0],) and sh_all.dtype == torch.float32,
            "sh_all must be (L,) f32")
    if not on_cuda((x, wp_all, sh_all)):
        y3 = w4_affine_matmul_stacked_plain(x, wp_all, sh_all, layer)
        return (y3.reshape(y3.shape[0], 2 * Nh) if plane_major
                else unpair_outputs(y3))
    # at decode (M <= 16) the kernel takes the row sums itself
    y = _w4_launch(x, wp_all, layer, sh_all[layer],
                   None if x.shape[0] <= 16 else row_sums(x), affine=True,
                   adjacent=not plane_major)
    LAUNCHES["w4_affine_matmul_stacked"] += 1
    return y


def w4_affine_matmul_plain(x, w_packed, sh, xsum=None):
    """Plain PyTorch version of w4_affine_matmul, plane-paired (M, 2, Nh)."""
    return w4_affine_matmul_stacked_plain(x, w_packed[None], sh.reshape(1), 0,
                                          xsum)


def w4_affine_matmul(x, w_packed, sh, *, decode=None, plane_major: bool = False):
    """y = x @ ((unpack(W) + 0.5) * sh) against unstacked packed weights
    w_packed (K, Nh) with the per-tensor scale sh (a 0-d f32 tensor, read
    by the kernel from device memory): row 14's kernel on the L = 1 view.
    The row sums of the rank-1 term are taken in f32, here (as the
    reference does, outside its kernel) beyond M = 16 and inside the
    kernel at decode.  Returns (M, 2 * Nh) in x's dtype,
    un-paired by a reshape (plane_major) or the adjacent interleave."""
    require(w_packed.dim() == 2, "w_packed (K, Nh)")
    Nh = _w4_check(x, w_packed[None], 0)
    sh = torch.as_tensor(sh, dtype=torch.float32, device=w_packed.device)
    require(sh.numel() == 1, "sh must be one per-tensor scale")
    if not on_cuda((x, w_packed, sh)):
        y3 = w4_affine_matmul_plain(x, w_packed, sh)
        return (y3.reshape(y3.shape[0], 2 * Nh) if plane_major
                else unpair_outputs(y3))
    # at decode (M <= 16) the kernel takes the row sums itself
    y = _w4_launch(x, w_packed[None], 0, sh.reshape(()).contiguous(),
                   None if x.shape[0] <= 16 else row_sums(x), affine=True,
                   adjacent=not plane_major)
    LAUNCHES["w4_affine_matmul"] += 1
    return y


def w4_matmul_plain(x, w_packed, scale):
    """Plain PyTorch version of w4_matmul."""
    return unpair_outputs(w4_matmul_paired_stacked_plain(
        x, w_packed[None], pair_scales(scale), 0))


def w4_matmul(x, w_packed, scale):
    """y = x @ dequant(W) for adjacent-planar packed weights w_packed (K,
    N/2) uint8 with per-column f32 scales (N,): the int4 lm_head.  Runs the
    weight-only kernel on an L = 1 view, writing the adjacent columns with
    the natural scales; any even N (no padding of the weights).  Returns
    (M, N) in x's dtype."""
    require(w_packed.dim() == 2, "w_packed (K, N/2)")
    Nh = _w4_check(x, w_packed[None], 0)
    require(scale.shape == (2 * Nh,) and scale.dtype == torch.float32,
            f"scale must be ({2 * Nh},) f32")
    if not on_cuda((x, w_packed, scale)):
        return w4_matmul_plain(x, w_packed, scale)
    # the kernel writes the adjacent layout with the natural scales: no
    # pairing of the scales, no un-pairing of the output
    y = _w4_launch(x, w_packed[None], 0, scale.contiguous(), None,
                   affine=False, adjacent=True)
    LAUNCHES["w4_matmul"] += 1
    return y


# ---------------------------------------------------------------------------
# Dense 16-bit weights, stacked
# ---------------------------------------------------------------------------

def w16_matmul_stacked_plain(x, w_all, layer, out_dtype):
    """Plain PyTorch version: f32 products and sums, one rounding."""
    return (x.float() @ w_all[layer].float()).to(out_dtype)


def w16_matmul_stacked(x, w_all, layer: int, out_dtype=None):
    """y = x @ w_all[layer] for stacked dense (L, K, N) weights, the layer
    read in place (no copy), f32 accumulation.  x: (M, K), cast to the
    weights' dtype first when they differ (as the reference does); output
    in out_dtype or x's dtype.  On the card: M <= 16 streams the weights,
    M > 16 runs TMA and wgmma, each with K split over a cluster where the
    output tiles cannot fill the card; one launch either way."""
    require(x.dim() == 2 and w_all.dim() == 3, "x (M, K), w_all (L, K, N)")
    M, K = x.shape
    L, Kw, N = w_all.shape
    require(K == Kw, f"K mismatch {K} vs {Kw}")
    require(0 <= layer < L, f"layer {layer} out of range {L}")
    out_dtype = out_dtype or x.dtype
    if w_all.dtype != x.dtype:
        x = x.to(w_all.dtype)
    if not on_cuda((x, w_all)):
        return w16_matmul_stacked_plain(x, w_all, layer, out_dtype)
    require(w_all.dtype == torch.bfloat16, "kernel needs bf16 weights")
    require(out_dtype in (torch.bfloat16, torch.float32),
            "kernel writes bf16 or f32")
    require(K % 8 == 0 and N % 8 == 0, "kernel needs K % 8 == 0, N % 8 == 0")
    require(w_all.is_contiguous(), "w_all must be contiguous")
    x = x.contiguous()
    require(x.data_ptr() % 16 == 0 and w_all.data_ptr() % 16 == 0,
            "kernel needs 16-byte aligned x and w_all")
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M <= 16:
        wmap = None
        # about one block an SM: on the H100 a decode layer took 0.187 ms
        # so against 0.190-0.205 at 2-4 blocks an SM (PERF.md §6)
        nsplit, kchunk = _split_k(-(-N // 128), K, per_sm=1, most=8)
    else:
        wmap = _tensor_map("w16_matmul", "w16_weight_map", w_all)
        # 128 x 128 tiles, one block an SM: K is split only where the tiles
        # leave SMs idle, and never past one wave
        tiles = -(-M // 128) * -(-N // 128)
        nsplit, kchunk = _split_k(tiles, K, per_sm=1,
                                  most=max(1, min(8, 132 // tiles)))
    fn = cuda_build.function(
        "w16_matmul", "w16_matmul_stacked_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    rc = fn(ptr(x), ptr(w_all[layer]), wmap, ptr(y), M, K, N, layer, kchunk,
            nsplit, int(out_dtype == torch.float32), stream(x))
    cuda_build.check(rc, "w16_matmul_stacked")
    LAUNCHES["w16_matmul_stacked"] += 1
    return y


# ---------------------------------------------------------------------------
# INT8 weight-only (lm_head)
# ---------------------------------------------------------------------------

def w8_matmul_plain(x, w8, scale):
    """Plain PyTorch version: f32 products and sums, per-column scale."""
    return ((x.float() @ w8.float()) * scale).to(torch.bfloat16)


def w8_matmul(x, w8, scale):
    """y = (x @ w8) * scale for dense int8 (K, N) weights with per-column
    f32 scales (N,); x: (M, K) bf16 -> (M, N) bf16."""
    require(x.dim() == 2 and w8.dim() == 2, "x (M, K), w8 (K, N)")
    M, K = x.shape
    Kw, N = w8.shape
    require(K == Kw, f"K mismatch {K} vs {Kw}")
    require(x.dtype == torch.bfloat16 and w8.dtype == torch.int8
             and scale.dtype == torch.float32 and scale.shape == (N,),
             "x bf16, w8 int8, scale (N,) f32")
    if not on_cuda((x, w8, scale)):
        return w8_matmul_plain(x, w8, scale)
    require(N % 4 == 0 and K % 8 == 0, "kernel needs N % 4 == 0, K % 8 == 0")
    require(x.is_contiguous() and w8.is_contiguous() and scale.is_contiguous(),
             "contiguous inputs")
    require(x.data_ptr() % 16 == 0 and w8.data_ptr() % 4 == 0,
            "kernel needs a 16-byte aligned x and 4-byte aligned weights")
    # 16-byte weight copies where rows allow them, else 4-byte ones
    wide16 = N % 16 == 0 and w8.data_ptr() % 16 == 0
    fn = cuda_build.function(
        "w8_matmul", "w8_matmul_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    rc = fn(ptr(x), ptr(w8), ptr(scale), ptr(out), M, K, N, int(wide16),
            stream(x))
    cuda_build.check(rc, "w8_matmul")
    LAUNCHES["w8_matmul"] += 1
    return out
