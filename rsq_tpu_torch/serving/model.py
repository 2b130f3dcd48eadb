"""Quantized serving forward (the port of rsq_tpu.serving.model's
single-device paths): the serving config, the lm_head, layer stacking,
the linear dispatch, and the contiguous slot cache.

Two families of entry points, as in the reference:
- per-layer, on unstacked params["layers"]: serving_linear(_fused),
  prefill and decode_step; and on stacked params the reference's
  layer-scanned forms, prefill_stacked and decode_step_stacked under
  RSQ_SCAN_DECODE=1, which run the same per-layer bodies on one layer's
  slice of the params and the cache at a time;
- the copy-free stacked fast path: prefill_fast, decode_step_stacked and
  generate, whose kernels index the stacked weights and cache by layer.

The cache is a dict of stacked (L, B, ...) tensors plus "length" (B,):
INT4 codes/params kq, kp, vq, vp (kv_int4) or bf16 k, v.  Where the
reference donates the cache to a jitted step, scatters into it or aliases
it into a kernel, the port updates the tensors in place (through views
where it works on one layer) and returns the same dict.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from rsq_tpu_torch import resolve_device
from rsq_tpu_torch.core.hadamard import (hadamard_transform_last,
                                         head_mixing_hadamard)
from rsq_tpu_torch.core.numerics import div, div_const
from rsq_tpu_torch.kernels import kv_cache as KVK
from rsq_tpu_torch.kernels.hadamard_mxu import hadamard_transform
from rsq_tpu_torch.kernels.matmul_w4 import (pack_w4_planar, pair_scales,
                                             unpair_outputs,
                                             w4_affine_matmul,
                                             w4_affine_matmul_stacked,
                                             w4_matmul, w4_matmul_paired,
                                             w4_matmul_paired_stacked,
                                             w4a4_matmul_paired,
                                             w4a4_matmul_paired_stacked,
                                             w8_matmul, w8_quantize,
                                             w16_matmul_stacked)
from rsq_tpu_torch.models import llama as M
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.quantize.ldlq import e8p_dequantize


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    model: ModelConfig
    a4: bool = True              # quantize activations into the matmul (W4A4)
    kv_int4: bool = True         # INT4 KV cache
    kv_hadamard: bool = True     # rotate K per head before caching
    online_had: bool = True      # o_proj / down_proj online Hadamards
    max_seq: int = 2048
    a_clip: float = 1.0
    # decode attention QK in int8 (q symmetric int8 per query row); the
    # library default stays off, as in the reference
    attn_int8_qk: bool = False

    @property
    def cfg(self) -> ModelConfig:
        return self.model


# ---------------------------------------------------------------------------
# Linear dispatch on unstacked params
# ---------------------------------------------------------------------------

def _segments(y3, widths, biases, planes: bool = False):
    """Plane-major paired output (M, 2, sum(widths)) of a fused call -> the
    list of its segments (M, 2 * width), each with its bias added.  With
    planes, each segment is the (M, 2, width) view of y3 itself (the decode
    step's decode_prep reads it in place; a bias, added as (2, width),
    makes a new tensor either way)."""
    outs, off = [], 0
    for nh, b in zip(widths, biases):
        seg = y3[:, :, off:off + nh]
        off += nh
        if not planes:
            seg = seg.reshape(y3.shape[0], 2 * nh)
        outs.append(seg if b is None
                    else seg + b.to(seg.dtype).reshape(seg.shape[1:]))
    return outs


def _linear(x2, p, sc: ServingConfig, layer: int | None = None,
            decode: bool | None = None, planes: bool = False):
    """x2 (M, K) against one linear's params p, dispatched on the layout in
    the reference's order: fused 'wp2' (a list of segment outputs), then
    plane-major 'wpm' (affine with 'sh', else W4A4 or weight-only), affine
    'sh' on adjacent 'wp', legacy E8P 'codes', adjacent 'wp' (W4A4 or
    weight-only, through pair_scales and an interleave), dense 'w'; then
    the bias.  layer: the layer of stacked (L, ...) params, read in place
    by the *_stacked kernels (the fast path); None for one layer's
    unstacked params (the per-layer path), whose kernels are the same ones
    on L = 1 views and count their own launches.  decode is the
    reference's tile hint, which the port's kernels do not need.  planes:
    fused segments as plane-major views (_segments)."""
    x2 = x2.contiguous()
    stacked = layer is not None

    def at(t):
        return t[layer] if stacked and t is not None else t

    def paired(w, scale2):                                   # (M, 2, Nh)
        if stacked:
            if sc.a4:
                return w4a4_matmul_paired_stacked(x2, w, scale2, layer,
                                                  clip_ratio=sc.a_clip)
            return w4_matmul_paired_stacked(x2, w, scale2, layer)
        if sc.a4:
            return w4a4_matmul_paired(x2, w, scale2, clip_ratio=sc.a_clip,
                                      decode=decode)
        return w4_matmul_paired(x2, w, scale2, decode=decode)

    def affine(w, plane_major=False):
        if stacked:
            return w4_affine_matmul_stacked(x2, w, p["sh"], layer,
                                            plane_major=plane_major)
        return w4_affine_matmul(x2, w, p["sh"], decode=decode,
                                plane_major=plane_major)

    if "wp2" in p:
        scale2 = torch.cat([at(s) for s in p["scales2"]], dim=1)
        return _segments(paired(p["wp2"], scale2),
                         [s.shape[-1] for s in p["scales2"]],
                         [at(b) for b in p["bs"]], planes=planes)
    if "wpm" in p:
        if "sh" in p:
            y = affine(p["wpm"], plane_major=True)
        else:
            y3 = paired(p["wpm"], at(p["scale2"]))
            y = y3.reshape(y3.shape[0], -1)
    elif "sh" in p:
        y = affine(p["wp"])
    elif "codes" in p:
        # legacy E8P layout: dequantize the grid and multiply (a plain
        # product, as in the reference)
        w = e8p_dequantize(at(p["codes"]), at(p["e8p_scale"]))   # (out, in)
        y = x2 @ w.T.to(x2.dtype)
    elif "wp" in p:
        y = unpair_outputs(paired(p["wp"], pair_scales(at(p["scale"]))))
    elif stacked:
        # dense 16-bit weights (the reference ignores a4 here too)
        y = w16_matmul_stacked(x2, p["w"], layer)
    else:
        # dense weights: a plain product, as the reference leaves it to XLA
        y = x2 @ p["w"].to(x2.dtype)
    if p.get("b") is not None:
        y = y + at(p["b"]).to(y.dtype)
    return y


def serving_linear(x, p, sc: ServingConfig, tp_axis: str | None = None,
                   decode: bool | None = None):
    """x (..., K) against one linear's unstacked params p (_linear's
    layouts but the fused one).  Returns (..., N)."""
    if tp_axis is not None:
        raise NotImplementedError(
            "tp_axis: tensor-parallel linears are not ported yet (ROADMAP "
            "queue 1 item 17)")
    y = _linear(x.reshape(-1, x.shape[-1]), p, sc, decode=decode)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def serving_linear_fused(x, p, sc: ServingConfig, decode: bool | None = None):
    """Fused concatenated packed linears (fuse_for_decode's 'wp2' layout,
    plane-major per segment): one kernel call over the concatenated
    outputs, then each segment un-paired by a reshape and its bias added.
    Returns the list of (..., N_seg) outputs."""
    segs = _linear(x.reshape(-1, x.shape[-1]), p, sc, decode=decode)
    return [seg.reshape(*x.shape[:-1], seg.shape[-1]) for seg in segs]


def lm_head_logits(params, x):
    """(..., d) -> (..., V): the int8 or int4 kernel when the head is
    quantized."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if "lm_head_q" in params:
        y = w8_matmul(x2.to(torch.bfloat16).contiguous(), params["lm_head_q"],
                      params["lm_head_scale"])
    elif "lm_head_wp" in params:
        y = w4_matmul(x2.to(torch.bfloat16), params["lm_head_wp"],
                      params["lm_head_scale4"])
    else:
        y = x2 @ params["lm_head"].to(x2.dtype)
    return y.reshape(*lead, y.shape[-1])


def quantize_lm_head(params, bits: int = 8):
    """Per-channel symmetric int8 ("lm_head_q", "lm_head_scale") or int4
    ("lm_head_wp" adjacent-planar, "lm_head_scale4") lm_head in place of
    "lm_head".  The reference runs this outside jit, so its divisions are
    IEEE divisions (core.numerics.div)."""
    out = dict(params)
    W = out.pop("lm_head")
    if bits == 8:
        w8, scale = w8_quantize(W)
        out["lm_head_q"] = w8
        out["lm_head_scale"] = scale
    elif bits == 4:
        Wf = W.float()
        absmax = Wf.abs().amax(dim=0)
        scale = torch.where(absmax == 0, 1.0, div(absmax, 7.0))
        codes = torch.clamp(torch.round(Wf / scale[None, :]), -8, 7)
        out["lm_head_wp"] = pack_w4_planar(codes.to(torch.int8))
        out["lm_head_scale4"] = scale.float()
    else:
        raise ValueError(f"lm_head bits must be 8 or 4, got {bits}")
    return out


def _stack(xs):
    first = xs[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in xs]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([x[i] for x in xs]) for i in range(len(first))]
    return torch.stack(xs)


def stack_layer_params(params):
    """params["layers"] (list of identical pytrees) -> params["layers_stacked"]
    with (L, ...) leaves."""
    out = dict(params)
    out["layers_stacked"] = _stack(out.pop("layers"))
    return out


def _layer_of(tree, i):
    """Layer i of a stacked pytree: views of the (L, ...) leaves, no copy."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layer_of(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layer_of(v, i) for v in tree]
    return tree[i]


def unstack_layer_params(params):
    """Inverse of stack_layer_params: params["layers"] as a list of per-layer
    pytrees whose tensors are views of the stacked ones (no copy)."""
    out = dict(params)
    ls = out.pop("layers_stacked")
    L = next(_leaves(ls)).shape[0]
    out["layers"] = [_layer_of(ls, i) for i in range(L)]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _sl(p, i):
    """Slice an optional stacked leaf."""
    return None if p is None else p[i]


def _linear_fast(x2, p, i: int, sc: ServingConfig):
    """Linear against stacked params p at layer i (_linear's dispatch):
    fused entries ('wp2') return the list of segment outputs; every other
    entry returns one."""
    return _linear(x2, p, sc, layer=i)


def _fast_path_helpers(cfg: ModelConfig):
    """(heads, kv heads, o_proj head mixer, down_proj mixer) of the
    single-device fast path (tensor parallelism is not ported yet)."""
    hd = cfg.head_dim_

    def mix_heads(a):
        return head_mixing_hadamard(a, head_dim=hd)

    return (cfg.num_attention_heads, cfg.num_key_value_heads, mix_heads,
            hadamard_transform)


def qkv_fast(ls, h2d, i: int, sc: ServingConfig):
    """(q, k, v) of layer i for (tokens, d) rows: one fused call, whose
    outputs are its (tokens, 2, width / 2) plane-major views (decode_prep
    reads them in place; every other caller reshapes them to heads), or
    three calls of (tokens, width) each."""
    if "qkv" in ls:
        return _linear(h2d, ls["qkv"], sc, layer=i, planes=True)
    return [_linear_fast(h2d, ls[n], i, sc) for n in ("q", "k", "v")]


def attn_out_fast(ls, i: int, x, attn, sc: ServingConfig, mix_heads):
    """x + o_proj(attn) for attn (B, s, Hq*D) against x (B, s, d)."""
    if sc.online_had:
        attn = mix_heads(attn)
    o = _linear_fast(attn.reshape(-1, attn.shape[-1]), ls["o"], i, sc)
    return x + o.reshape(x.shape).to(x.dtype)


def mlp_fast(ls, i: int, x, cfg: ModelConfig, sc: ServingConfig, mix_act):
    """Post-attention half of layer i on x (B, s, d)."""
    h2 = M.rms_norm(x, _sl(ls.get("post_norm"), i), cfg.rms_norm_eps)
    h2d = h2.reshape(-1, h2.shape[-1])
    if "upgate" in ls:
        up, gate = _linear_fast(h2d, ls["upgate"], i, sc)
    else:
        up, gate = (_linear_fast(h2d, ls[n], i, sc) for n in ("up", "gate"))
    act = torch.nn.functional.silu(gate.float()).to(h2.dtype) * up
    if sc.online_had:
        act = mix_act(act)
    down = _linear_fast(act, ls["down"], i, sc)
    return x + down.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Contiguous slot cache
# ---------------------------------------------------------------------------

def init_cache(sc: ServingConfig, batch: int, dtype=torch.bfloat16,
               device="cuda"):
    """Empty cache of `batch` slots of sc.max_seq tokens: INT4 (zero codes,
    unit params) with kv_int4, else dense `dtype`."""
    dev = resolve_device(device)
    cfg = sc.cfg
    L, H, D, S = (cfg.num_layers, cfg.num_key_value_heads, cfg.head_dim_,
                  sc.max_seq)
    length = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if sc.kv_int4:
        return {
            "kq": torch.zeros((L, batch, H, D // 2, S), dtype=torch.uint8,
                              device=dev),
            "kp": torch.ones((L, batch, H, 2, S), dtype=torch.float32,
                             device=dev),
            "vq": torch.zeros((L, batch, H, D // 2, S), dtype=torch.uint8,
                              device=dev),
            "vp": torch.ones((L, batch, H, 2, S), dtype=torch.float32,
                             device=dev),
            "length": length,
        }
    return {"k": torch.zeros((L, batch, H, S, D), dtype=dtype, device=dev),
            "v": torch.zeros((L, batch, H, S, D), dtype=dtype, device=dev),
            "length": length}


# ---------------------------------------------------------------------------
# Per-layer forwards on unstacked params (and their layer-scanned forms)
# ---------------------------------------------------------------------------

def _cache_slices(cache):
    """Split the per-layer arrays (leading dim L) from the shared length."""
    return {k: v for k, v in cache.items() if k != "length"}, cache["length"]


def _layer_cache(cache, layer: int):
    """One layer's cache arrays as views: writes land in the stacked cache."""
    return {k: v[layer] for k, v in _cache_slices(cache)[0].items()}


def _write_prefill_slice(cslice, k, v, sc: ServingConfig):
    """k/v (B, S_prompt, H, D) post-rope into positions [0, S_prompt) of one
    layer's cache views (INT4: K Hadamard-rotated, both quantized)."""
    kb, vb = k.transpose(1, 2), v.transpose(1, 2)            # (B, H, S, D)
    S = kb.shape[2]
    if not sc.kv_int4:
        cslice["k"][:, :, :S] = kb.to(cslice["k"].dtype)
        cslice["v"][:, :, :S] = vb.to(cslice["v"].dtype)
        return
    if sc.kv_hadamard:
        kb = hadamard_transform_last(kb)
    kq, kp = KVK.to_lane_major(*KVK.asym_quant_pack_head(kb))
    vq, vp = KVK.to_lane_major(*KVK.asym_quant_pack_head(vb))
    for name, val in (("kq", kq), ("kp", kp), ("vq", vq), ("vp", vp)):
        cslice[name][..., :S] = val


def _write_prefill(cache, layer: int, k, v, sc: ServingConfig):
    """k/v: (B, S_prompt, H, D) post-rope.  Writes positions [0, S_prompt)
    of layer `layer` in place."""
    _write_prefill_slice(_layer_cache(cache, layer), k, v, sc)
    return cache


def _append_slice(cslice, k, v, pos, sc: ServingConfig):
    """k/v (B, 1, H, D): one new token per row at positions pos (B,) of one
    layer's cache views; a plain indexed assignment, as the reference's
    scatter.  The advanced indices (rows, pos) are split by slices, so the
    broadcast row dim comes first in the indexed view, as in JAX."""
    kb, vb = k.transpose(1, 2), v.transpose(1, 2)            # (B, H, 1, D)
    B = kb.shape[0]
    pos = torch.broadcast_to(pos.to(torch.int64), (B,))
    bidx = torch.arange(B, device=kb.device)
    if not sc.kv_int4:
        cslice["k"][bidx, :, pos, :] = kb[:, :, 0, :].to(cslice["k"].dtype)
        cslice["v"][bidx, :, pos, :] = vb[:, :, 0, :].to(cslice["v"].dtype)
        return
    if sc.kv_hadamard:
        kb = hadamard_transform_last(kb)
    kq, kp = KVK.to_lane_major(*KVK.asym_quant_pack_head(kb))  # (B,H,D/2,1)
    vq, vp = KVK.to_lane_major(*KVK.asym_quant_pack_head(vb))
    for name, val in (("kq", kq), ("kp", kp), ("vq", vq), ("vp", vp)):
        cslice[name][bidx, :, :, pos] = val[..., 0].to(cslice[name].dtype)


def _append_decode(cache, layer: int, k, v, pos, sc: ServingConfig):
    """k/v: (B, 1, H, D) one new token per row; pos: (B,) per-row write
    positions (rows need not have equal lengths).  In place."""
    _append_slice(_layer_cache(cache, layer), k, v, pos, sc)
    return cache


def _qkv(lp, h, cfg: ModelConfig, sc: ServingConfig,
         decode: bool | None = None):
    b, s, _ = h.shape
    hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
    if "qkv" in lp:
        q, k, v = serving_linear_fused(h, lp["qkv"], sc, decode=decode)
    else:
        q, k, v = (serving_linear(h, lp[n], sc, decode=decode)
                   for n in ("q", "k", "v"))
    return (q.reshape(b, s, nq, hd), k.reshape(b, s, nkv, hd),
            v.reshape(b, s, nkv, hd))


def _mlp(lp, h, cfg: ModelConfig, sc: ServingConfig,
         decode: bool | None = None):
    if "upgate" in lp:
        up, gate = serving_linear_fused(h, lp["upgate"], sc, decode=decode)
    else:
        up, gate = (serving_linear(h, lp[n], sc, decode=decode)
                    for n in ("up", "gate"))
    act = torch.nn.functional.silu(gate.float()).to(h.dtype) * up
    if sc.online_had:
        act = hadamard_transform(act)
    return serving_linear(act, lp["down"], sc, decode=decode)


def _attn_out(lp, attn_flat, cfg: ModelConfig, sc: ServingConfig,
              decode: bool | None = None):
    if sc.online_had:
        attn_flat = head_mixing_hadamard(attn_flat, head_dim=cfg.head_dim_)
    return serving_linear(attn_flat, lp["o"], sc, decode=decode)


def _prefill_cache_slice(lp, x, cslice, cos, sin, mask, cfg, sc):
    """One layer of the prompt pass on its cache views: the layer's K/V
    written in place, attention over the prompt itself.  Returns (x,
    cslice)."""
    h = M.rms_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
    q, k, v = _qkv(lp, h, cfg, sc, decode=False)
    q = M.apply_rope(q, cos, sin)
    k = M.apply_rope(k, cos, sin)
    _write_prefill_slice(cslice, k, v, sc)
    nrep = cfg.num_attention_heads // cfg.num_key_value_heads
    attn = M.attention(q, M.repeat_kv(k, nrep), M.repeat_kv(v, nrep), mask)
    b, s = x.shape[:2]
    x = x + _attn_out(lp, attn.reshape(b, s, -1), cfg, sc, decode=False)
    h2 = M.rms_norm(x, lp.get("post_norm"), cfg.rms_norm_eps)
    return x + _mlp(lp, h2, cfg, sc, decode=False), cslice


def prefill_layer(lp, x, cache, layer, cos, sin, mask, cfg, sc):
    x, _ = _prefill_cache_slice(lp, x, _layer_cache(cache, layer), cos, sin,
                                mask, cfg, sc)
    return x, cache


def _decode_attention_bf16(q, k_cache, v_cache, lengths, cfg: ModelConfig):
    """The reference's plain bf16-cache decode attention (no kernel): q
    (B, 1, Hq, D) against one layer's (B, Hkv, S, D) cache over lengths."""
    b, hd = q.shape[0], cfg.head_dim_
    S = k_cache.shape[2]
    nrep = cfg.num_attention_heads // cfg.num_key_value_heads
    kf = k_cache.repeat_interleave(nrep, dim=1).float()      # (B, Hq, S, D)
    vf = v_cache.repeat_interleave(nrep, dim=1).float()
    qg = q.reshape(b, -1, hd).float()
    logits = div_const(torch.einsum("bhd,bhsd->bhs", qg, kf), math.sqrt(hd))
    valid = torch.arange(S, device=q.device)[None, None, :] \
        < lengths[:, None, None]
    p = torch.softmax(torch.where(valid, logits, -1e30), dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vf).to(q.dtype)


def _decode_cache_slice(lp, x, cslice, length, cos, sin, pos, cfg, sc):
    """decode_layer on one layer's cache views: the new token appended at
    pos (B,), then attention over length + 1 tokens (the INT4 cache through
    the read-only contiguous kernel, which reads the new token back from
    the cache).  Returns (x, cslice)."""
    b, hd = x.shape[0], cfg.head_dim_
    h = M.rms_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
    q, k, v = _qkv(lp, h, cfg, sc, decode=True)
    q = M.apply_rope(q, cos, sin)
    k = M.apply_rope(k, cos, sin)
    _append_slice(cslice, k, v, pos, sc)
    lengths = length + 1
    if sc.kv_int4:
        qh = q.reshape(b, -1, hd)
        if sc.kv_hadamard:
            qh = hadamard_transform_last(qh)
        attn = KVK.int4_decode_attention(qh, cslice["kq"], cslice["kp"],
                                         cslice["vq"], cslice["vp"], lengths)
    else:
        attn = _decode_attention_bf16(q, cslice["k"], cslice["v"], lengths,
                                      cfg)
    x = x + _attn_out(lp, attn.reshape(b, 1, -1), cfg, sc, decode=True)
    h2 = M.rms_norm(x, lp.get("post_norm"), cfg.rms_norm_eps)
    return x + _mlp(lp, h2, cfg, sc, decode=True), cslice


def decode_layer(lp, x, cache, layer, cos, sin, pos, cfg, sc):
    """x: (B, 1, d); pos: (B,) per-row current positions."""
    x, _ = _decode_cache_slice(lp, x, _layer_cache(cache, layer),
                               cache["length"], cos, sin, pos, cfg, sc)
    return x, cache


def _embed_prompt(params, input_ids, cfg: ModelConfig):
    s = input_ids.shape[1]
    x = params["embed"][input_ids].to(torch.bfloat16)
    cos, sin = M.rope_tables(cfg, torch.arange(s, device=input_ids.device))
    return x, cos, sin


def _embed_token(params, token_ids, pos, cfg: ModelConfig):
    x = params["embed"][token_ids][:, None, :].to(torch.bfloat16)
    cos, sin = M.rope_tables(cfg, pos)                       # (B, hd)
    return x, cos[:, None, :], sin[:, None, :]


def _last_logits(params, x, cfg: ModelConfig):
    x = M.rms_norm(x, params.get("final_norm"), cfg.rms_norm_eps)
    return lm_head_logits(params, x)[:, 0]


@torch.no_grad()
def prefill(params, cache, input_ids, sc: ServingConfig):
    """Prompt pass over unstacked params["layers"] for input_ids (B, s) of
    one length (cache updated in place).  Returns (last-position logits
    (B, V), cache)."""
    cfg = sc.cfg
    x, cos, sin = _embed_prompt(params, input_ids, cfg)
    for i, lp in enumerate(params["layers"]):
        x, cache = prefill_layer(lp, x, cache, i, cos, sin, None, cfg, sc)
    cache["length"] = cache["length"] + input_ids.shape[1]
    return _last_logits(params, x[:, -1:], cfg), cache


@torch.no_grad()
def decode_step(params, cache, token_ids, sc: ServingConfig):
    """One token per row (token_ids (B,)) over unstacked params["layers"];
    rows may have unequal lengths (per-row rope positions and appends).
    The cache is updated in place.  Returns (logits (B, V), cache)."""
    cfg = sc.cfg
    pos = cache["length"]
    x, cos, sin = _embed_token(params, token_ids, pos, cfg)
    for i, lp in enumerate(params["layers"]):
        x, cache = decode_layer(lp, x, cache, i, cos, sin, pos, cfg, sc)
    cache["length"] = cache["length"] + 1
    return _last_logits(params, x, cfg), cache


@torch.no_grad()
def prefill_stacked(params, cache, input_ids, sc: ServingConfig):
    """prefill over stacked params, one layer's slice of the params and the
    cache at a time (the reference's lax.scan; the port's slices are views,
    not copies).  Returns (last-position logits (B, V), cache)."""
    cfg = sc.cfg
    x, cos, sin = _embed_prompt(params, input_ids, cfg)
    per_layer, length = _cache_slices(cache)
    L = next(iter(per_layer.values())).shape[0]
    for i in range(L):
        x, _ = _prefill_cache_slice(_layer_of(params["layers_stacked"], i), x,
                                    _layer_cache(cache, i), cos, sin, None,
                                    cfg, sc)
    cache["length"] = length + input_ids.shape[1]
    return _last_logits(params, x[:, -1:], cfg), cache


def _decode_step_scan(params, cache, token_ids, sc: ServingConfig):
    """The reference's RSQ_SCAN_DECODE=1 branch: _decode_cache_slice on one
    layer's slice of the stacked params and cache at a time."""
    cfg = sc.cfg
    per_layer, length = _cache_slices(cache)
    x, cos, sin = _embed_token(params, token_ids, length, cfg)
    L = next(iter(per_layer.values())).shape[0]
    for i in range(L):
        x, _ = _decode_cache_slice(_layer_of(params["layers_stacked"], i), x,
                                   _layer_cache(cache, i), length, cos, sin,
                                   length, cfg, sc)
    cache["length"] = length + 1
    return _last_logits(params, x, cfg), cache


def _decode_step_fast(params, cache, token_ids, sc: ServingConfig):
    """One decode step over stacked params and the contiguous cache; rows
    may have unequal lengths.  Per layer: the qkv linear(s); then with the
    INT4 cache decode_prep and the attention kernel that folds the new
    token in and appends it, with the bf16 cache rope, the bf16 attention
    kernel over the old cache, merge_self_attention and then the append;
    then o, the MLP linears and the lm_head."""
    cfg = sc.cfg
    ls = params["layers_stacked"]
    kv4 = "kq" in cache
    L = cache["kq" if kv4 else "k"].shape[0]
    length = cache["length"]
    b = token_ids.shape[0]
    hd = cfg.head_dim_
    nq, nkv, mix_heads, mix_act = _fast_path_helpers(cfg)

    x = params["embed"][token_ids][:, None, :].to(torch.bfloat16)
    cos, sin = M.rope_tables(cfg, length)                    # (B, hd)
    for i in range(L):
        h = M.rms_norm(x, _sl(ls.get("input_norm"), i), cfg.rms_norm_eps)
        q, k, v = qkv_fast(ls, h.reshape(b, -1), i, sc)
        if kv4:
            qh, k_self, v_self, nkq, nkp, nvq, nvp = KVK.decode_prep(
                q, k, v, cos, sin, kv_had=sc.kv_hadamard)
            attn = KVK.int4_decode_attention_self_append(
                qh, cache["kq"], cache["kp"], cache["vq"], cache["vp"], i,
                length, k_self, v_self, nkq, nkp, nvq, nvp,
                int8_qk=sc.attn_int8_qk)
        else:
            # no Hadamard on the bf16 cache: prefill caches unrotated keys
            qk = M.apply_rope(torch.cat([q.reshape(b, 1, nq, hd),
                                         k.reshape(b, 1, nkv, hd)], dim=2),
                              cos[:, None], sin[:, None])
            vb = v.reshape(b, 1, nkv, hd).transpose(1, 2)   # (B, Hkv, 1, D)
            qh = qk[:, 0, :nq]
            kb = qk[:, :, nq:].transpose(1, 2)
            # attend over the old cache, fold the new token in, then append
            out_old, m_old, l_old = KVK.bf16_decode_attention_stacked(
                qh, cache["k"], cache["v"], i, length)
            qs = div_const(qh.float(), math.sqrt(hd)).reshape(
                b, nkv, nq // nkv, hd)
            attn = KVK.merge_self_attention(
                out_old, m_old, l_old, qs, kb.to(cache["k"].dtype).float(),
                vb.to(cache["v"].dtype).float())
            KVK.kv_append_stacked_bf16(cache["k"], cache["v"], i, length,
                                       kb, vb)
        x = attn_out_fast(ls, i, x, attn.reshape(b, 1, nq * hd), sc,
                          mix_heads)
        x = mlp_fast(ls, i, x, cfg, sc, mix_act)

    cache["length"] = length + 1
    x = M.rms_norm(x, params.get("final_norm"), cfg.rms_norm_eps)
    return lm_head_logits(params, x)[:, 0], cache


@torch.no_grad()
def decode_step_stacked(params, cache, token_ids, sc: ServingConfig):
    """One token per slot (token_ids (B,)); slots may have unequal lengths.
    The cache is updated in place (the reference donates it).  Returns
    (logits (B, V), cache).  RSQ_SCAN_DECODE=1 selects the reference's
    layer-scanned fallback (_decode_step_scan) over the copy-free fast
    path.  The reference reads the variable when it traces the step (a
    cached trace keeps its path); the port reads it on every call."""
    if os.environ.get("RSQ_SCAN_DECODE") == "1":
        return _decode_step_scan(params, cache, token_ids, sc)
    return _decode_step_fast(params, cache, token_ids, sc)


def _prefill_fast(params, cache, input_ids, sc: ServingConfig,
                  true_len: int | None = None):
    """Prompt pass over stacked params for input_ids (B, s), writing cache
    positions [0, s) of every row in place.  true_len: the real prompt
    length when input_ids is right-padded (the padding is causally
    invisible to the real tokens and lies past the length)."""
    cfg = sc.cfg
    ls = params["layers_stacked"]
    b, s = input_ids.shape
    hd = cfg.head_dim_
    nq, nkv, mix_heads, mix_act = _fast_path_helpers(cfg)
    nrep = nq // nkv
    kv4 = "kq" in cache
    L = cache["kq" if kv4 else "k"].shape[0]

    x, cos, sin = _embed_prompt(params, input_ids, cfg)
    for i in range(L):
        h = M.rms_norm(x, _sl(ls.get("input_norm"), i), cfg.rms_norm_eps)
        q, k, v = qkv_fast(ls, h.reshape(b * s, -1), i, sc)
        q = M.apply_rope(q.reshape(b, s, nq, hd), cos, sin)
        k = M.apply_rope(k.reshape(b, s, nkv, hd), cos, sin)
        v = v.reshape(b, s, nkv, hd)
        _write_prefill(cache, i, k, v, sc)
        attn = M.attention(q, M.repeat_kv(k, nrep), M.repeat_kv(v, nrep))
        x = attn_out_fast(ls, i, x, attn.reshape(b, s, nq * hd), sc,
                          mix_heads)
        x = mlp_fast(ls, i, x, cfg, sc, mix_act)

    tl = s if true_len is None else int(true_len)
    cache["length"] = cache["length"] + tl
    return _last_logits(params, x[:, tl - 1:tl], cfg), cache


@torch.no_grad()
def prefill_fast(params, cache, input_ids, sc: ServingConfig,
                 true_len: int | None = None):
    """Prefill (cache updated in place).  Returns (last-token logits
    (B, V), cache)."""
    return _prefill_fast(params, cache, input_ids, sc, true_len=true_len)


@torch.no_grad()
def generate(params, input_ids, sc: ServingConfig, max_new_tokens: int):
    """Greedy generation on the fast path (stacked or unstacked params, on
    the params' device): prefill, then decode_step_stacked on each argmax.
    Returns the new tokens (B, max_new_tokens)."""
    if "layers_stacked" not in params:
        params = stack_layer_params(params)
    dev = params["embed"].device
    ids = torch.as_tensor(input_ids, device=dev)
    cache = init_cache(sc, ids.shape[0], device=dev)
    logits, cache = prefill_fast(params, cache, ids, sc)
    tok = torch.argmax(logits, dim=-1)
    toks = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step_stacked(params, cache, tok, sc)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1)
