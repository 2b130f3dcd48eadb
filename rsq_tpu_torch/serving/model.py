"""Quantized serving forward (the port of rsq_tpu.serving.model's
single-device fast path): the serving config, the lm_head, layer
stacking, the per-layer linear dispatch, and the contiguous slot cache
path -- init_cache, prefill_fast, decode_step_stacked and generate.

The cache is a dict of stacked (L, B, ...) tensors plus "length" (B,):
INT4 codes/params kq, kp, vq, vp (kv_int4) or bf16 k, v.  Where the
reference donates the cache to a jitted step or aliases it into a kernel,
the port updates the tensors in place and returns the same dict.
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
                                             w4_affine_matmul_stacked,
                                             w4_matmul,
                                             w4_matmul_paired_stacked,
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


def _sl(p, i):
    """Slice an optional stacked leaf."""
    return None if p is None else p[i]


def _linear_fast(x2, p, i: int, sc: ServingConfig):
    """Linear against stacked params p at layer i, dispatched on the layout
    in the reference's order.  Fused entries ('wp2') return the list of
    segment outputs; every other entry returns one.  Plane-major entries
    ('wp2'/'wpm') un-pair with a reshape; legacy adjacent 'wp' entries pay
    pair_scales and an interleave."""
    x2 = x2.contiguous()
    if "wp2" in p:
        scale2 = torch.cat([s[i] for s in p["scales2"]], dim=1)
        if sc.a4:
            y3 = w4a4_matmul_paired_stacked(x2, p["wp2"], scale2, i,
                                            clip_ratio=sc.a_clip)
        else:
            y3 = w4_matmul_paired_stacked(x2, p["wp2"], scale2, i)
        outs, off = [], 0
        for s, b in zip(p["scales2"], p["bs"]):
            nh = s.shape[-1]
            seg = y3[:, :, off:off + nh].reshape(y3.shape[0], 2 * nh)
            off += nh
            if b is not None:
                seg = seg + b[i].to(seg.dtype)
            outs.append(seg)
        return outs
    if "wpm" in p:
        if "sh" in p:
            y = w4_affine_matmul_stacked(x2, p["wpm"], p["sh"], i,
                                         plane_major=True)
        else:
            if sc.a4:
                y3 = w4a4_matmul_paired_stacked(x2, p["wpm"], p["scale2"][i],
                                                i, clip_ratio=sc.a_clip)
            else:
                y3 = w4_matmul_paired_stacked(x2, p["wpm"], p["scale2"][i], i)
            y = y3.reshape(y3.shape[0], -1)
    elif "sh" in p:
        y = w4_affine_matmul_stacked(x2, p["wp"], p["sh"], i)
    elif "codes" in p:
        # legacy E8P layout (before the affine re-encoding): dequantize the
        # grid and multiply, a plain product as in the reference
        w = e8p_dequantize(p["codes"][i], p["e8p_scale"][i])   # (out, in)
        y = x2 @ w.T.to(x2.dtype)
    elif "wp" in p:
        scale2 = pair_scales(p["scale"][i])
        if sc.a4:
            y3 = w4a4_matmul_paired_stacked(x2, p["wp"], scale2, i,
                                            clip_ratio=sc.a_clip)
        else:
            y3 = w4_matmul_paired_stacked(x2, p["wp"], scale2, i)
        y = unpair_outputs(y3)
    else:
        # dense 16-bit weights (the reference ignores a4 here too)
        y = w16_matmul_stacked(x2, p["w"], i)
    if p.get("b") is not None:
        y = y + p["b"][i].to(y.dtype)
    return y


def _fast_path_helpers(cfg: ModelConfig):
    """(heads, kv heads, o_proj head mixer, down_proj mixer) of the
    single-device fast path (tensor parallelism is not ported yet)."""
    hd = cfg.head_dim_

    def mix_heads(a):
        return head_mixing_hadamard(a, head_dim=hd)

    return (cfg.num_attention_heads, cfg.num_key_value_heads, mix_heads,
            hadamard_transform)


def qkv_fast(ls, h2d, i: int, sc: ServingConfig):
    """(q, k, v) of layer i for (tokens, d) rows: one fused call or three."""
    if "qkv" in ls:
        return _linear_fast(h2d, ls["qkv"], i, sc)
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
                q.reshape(b, nq, hd), k.reshape(b, nkv, hd),
                v.reshape(b, nkv, hd), cos, sin, kv_had=sc.kv_hadamard)
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
    (logits (B, V), cache)."""
    if os.environ.get("RSQ_SCAN_DECODE") == "1":
        raise NotImplementedError(
            "RSQ_SCAN_DECODE=1 selects the reference's lax.scan decode, which "
            "runs the unstacked layer path and the read-only contiguous "
            "attention kernel (kernel table row 2); not ported yet")
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

    x = params["embed"][input_ids].to(torch.bfloat16)
    cos, sin = M.rope_tables(cfg, torch.arange(s, device=input_ids.device))
    for i in range(L):
        h = M.rms_norm(x, _sl(ls.get("input_norm"), i), cfg.rms_norm_eps)
        q, k, v = qkv_fast(ls, h.reshape(b * s, -1), i, sc)
        q = M.apply_rope(q.reshape(b, s, nq, hd), cos, sin)
        k = M.apply_rope(k.reshape(b, s, nkv, hd), cos, sin)
        v = v.reshape(b, s, nkv, hd)
        kb, vb = k.transpose(1, 2), v.transpose(1, 2)       # (B, H, s, D)
        if kv4:
            kk = hadamard_transform_last(kb) if sc.kv_hadamard else kb
            kq, kp = KVK.to_lane_major(*KVK.asym_quant_pack_head(kk))
            vq, vp = KVK.to_lane_major(*KVK.asym_quant_pack_head(vb))
            for name, val in (("kq", kq), ("kp", kp), ("vq", vq), ("vp", vp)):
                cache[name][i, ..., :s] = val
        else:
            cache["k"][i, :, :, :s] = kb.to(cache["k"].dtype)
            cache["v"][i, :, :, :s] = vb.to(cache["v"].dtype)
        attn = M.attention(q, M.repeat_kv(k, nrep), M.repeat_kv(v, nrep))
        x = attn_out_fast(ls, i, x, attn.reshape(b, s, nq * hd), sc,
                          mix_heads)
        x = mlp_fast(ls, i, x, cfg, sc, mix_act)

    tl = s if true_len is None else int(true_len)
    cache["length"] = cache["length"] + tl
    x = M.rms_norm(x[:, tl - 1:tl], params.get("final_norm"),
                   cfg.rms_norm_eps)
    return lm_head_logits(params, x)[:, 0], cache


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
