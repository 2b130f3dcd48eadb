"""Quantized serving forward pieces shared by the paged engine (the port of
the fast-path parts of rsq_tpu.serving.model): the serving config, the
lm_head, layer stacking and the per-layer linear dispatch."""

from __future__ import annotations

import dataclasses

import torch

from rsq_tpu_torch.core.hadamard import head_mixing_hadamard
from rsq_tpu_torch.kernels.hadamard_mxu import hadamard_transform
from rsq_tpu_torch.kernels.matmul_w4 import (w4a4_matmul_paired_stacked,
                                             w8_matmul, w8_quantize)
from rsq_tpu_torch.models.config import ModelConfig


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
    """(..., d) -> (..., V): the int8 kernel when the head is quantized."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if "lm_head_q" in params:
        y = w8_matmul(x2.to(torch.bfloat16).contiguous(), params["lm_head_q"],
                      params["lm_head_scale"])
    elif "lm_head_wp" in params:
        raise NotImplementedError("int4 lm_head is not ported yet")
    else:
        y = x2 @ params["lm_head"].to(x2.dtype)
    return y.reshape(*lead, y.shape[-1])


def quantize_lm_head(params, bits: int = 8):
    """Per-channel symmetric int8 lm_head ("lm_head" -> "lm_head_q",
    "lm_head_scale").  The int4 head is not ported yet."""
    if bits != 8:
        raise NotImplementedError(f"lm_head bits={bits} is not ported yet")
    out = dict(params)
    w8, scale = w8_quantize(out.pop("lm_head"))
    out["lm_head_q"] = w8
    out["lm_head_scale"] = scale
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
    """Linear against stacked params p at layer i.  Fused entries ('wp2')
    return the list of segment outputs; 'wpm' entries return one output.
    Only the W4A4 plane-major path is ported."""
    if not sc.a4 or not ("wp2" in p or ("wpm" in p and "sh" not in p)):
        raise NotImplementedError(
            "only W4A4 plane-major ('wp2'/'wpm') serving linears are ported")
    x2 = x2.contiguous()
    if "wp2" in p:
        scale2 = torch.cat([s[i] for s in p["scales2"]], dim=1)
        y3 = w4a4_matmul_paired_stacked(x2, p["wp2"], scale2, i,
                                        clip_ratio=sc.a_clip)
        outs, off = [], 0
        for s, b in zip(p["scales2"], p["bs"]):
            nh = s.shape[-1]
            seg = y3[:, :, off:off + nh].reshape(y3.shape[0], 2 * nh)
            off += nh
            if b is not None:
                seg = seg + b[i].to(seg.dtype)
            outs.append(seg)
        return outs
    y3 = w4a4_matmul_paired_stacked(x2, p["wpm"], p["scale2"][i], i,
                                    clip_ratio=sc.a_clip)
    y = y3.reshape(y3.shape[0], -1)
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
