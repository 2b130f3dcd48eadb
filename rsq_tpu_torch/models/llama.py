"""Functional Llama-family decoder (the port of rsq_tpu.models.llama):
the building blocks the serving path uses, and the fake-quant forward that
the quantization pipeline and the evaluator run.  Layouts follow the
reference: activations (batch, seq, heads, head_dim), weights (in, out).

Param tree (torch tensors):
  {"embed": (V, d),
   "layers": [{"input_norm": (d,)|None, "post_norm": (d,)|None,
               "q","k","v","o","up","gate","down": {"w": (in, out),
                                                    "b": (out,)|None}}, ...],
   "final_norm": (d,)|None, "lm_head": (d, V)}
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rsq_tpu_torch.core.hadamard import (
    hadamard_transform_last, head_mixing_hadamard, matmul_hadU)
from rsq_tpu_torch.core.numerics import div_const
from rsq_tpu_torch.core.quant import ActQuantConfig, act_fake_quant
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.models.policy import QuantPolicy

LINEAR_NAMES = ("q", "k", "v", "o", "up", "gate", "down")
GROUPS = (("q", "k", "v"), ("o",), ("up", "gate"), ("down",))


def rms_norm(x, weight, eps):
    """RMSNorm in f32; weight=None is the weightless RMSN used after
    rotation fusion."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    if weight is not None:
        xf = xf * weight.float()
    return xf.to(x.dtype)


def rope_frequencies(cfg: ModelConfig) -> np.ndarray:
    """Inverse frequencies, with optional Llama-3.1 scaling."""
    hd = cfg.head_dim_
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    s = cfg.rope_scaling
    if s is not None:
        low_wl = s.original_max_position_embeddings / s.low_freq_factor
        high_wl = s.original_max_position_embeddings / s.high_freq_factor
        wl = 2 * np.pi / inv
        smooth = (s.original_max_position_embeddings / wl - s.low_freq_factor) / (
            s.high_freq_factor - s.low_freq_factor)
        inv = np.where(wl > low_wl, inv / s.factor,
                       np.where(wl < high_wl, inv,
                                (1 - smooth) * inv / s.factor + smooth * inv))
    return inv.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rope_inv(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    """rope_frequencies on `device`, uploaded once (not once per step)."""
    return torch.as_tensor(rope_frequencies(cfg), device=device)


def rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin of shape (len(positions), head_dim), HF half-split layout."""
    inv = _rope_inv(cfg, positions.device)
    angles = positions.float()[:, None] * inv[None, :]
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x, cos, sin):
    """Rotate-half RoPE in f32, cast back. x: (..., seq, heads, head_dim);
    cos/sin: (seq, head_dim)."""
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * c + rotated.float() * s).to(x.dtype)


def repeat_kv(x, n_rep: int):
    """(b, s, kv_heads, d) -> (b, s, kv_heads*n_rep, d)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def causal_mask(seq_len: int, device, dtype=torch.float32):
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    return torch.where(j <= i, 0.0, torch.finfo(dtype).min).to(dtype)


def attention_scores(q, k, mask):
    """softmax(q k^T / sqrt(d) + mask) in f32; q, k: (b, s, h, d) with h
    already repeated; (b, h, s, s) probabilities."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return torch.softmax(div_const(logits, math.sqrt(d)) + mask, dim=-1)


def attention_dense(q, k, v, mask):
    """softmax(q k^T / sqrt(d) + mask) v with f32 scores.  Plain products on
    purpose: scaled_dot_product_attention rounds differently."""
    probs = attention_scores(q, k, mask)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(v.dtype)


def attention_chunked(q, k, v, q_chunk: int = 512, k_chunk: int = 1024):
    """Causal flash-style attention without the (H, L, L) score matrix:
    query chunks, online softmax over key chunks (f32)."""
    b, s, h, d = q.shape
    qc, kc = min(q_chunk, s), min(k_chunk, s)
    sm = 1.0 / math.sqrt(d)
    out = torch.empty(b, s, h, d, dtype=v.dtype, device=q.device)
    neg = torch.finfo(torch.float32).min
    for q0 in range(0, s, qc):
        qf = q[:, q0:q0 + qc].float() * sm
        nq = qf.shape[1]
        m = torch.full((b, h, nq), -math.inf, device=q.device)
        l = torch.zeros((b, h, nq), device=q.device)
        acc = torch.zeros((b, h, nq, d), device=q.device)
        qpos = q0 + torch.arange(nq, device=q.device)[:, None]
        for k0 in range(0, min(q0 + nq, s), kc):
            kb = k[:, k0:k0 + kc].float()
            vb = v[:, k0:k0 + kc].float()
            logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
            kpos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            logits = torch.where(kpos <= qpos, logits, neg)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                        p, vb)
            m = m_new
        res = acc / l[..., None].clamp_min(1e-30)
        out[:, q0:q0 + nq] = res.transpose(1, 2).to(v.dtype)
    return out


def attention(q, k, v, mask=None, chunk_threshold: int = 2048):
    """mask=None: plain causal (chunked from `chunk_threshold` on, dense
    below).  An explicit mask always takes the dense path."""
    s = q.shape[1]
    if mask is not None:
        return attention_dense(q, k, v, mask)
    if s < chunk_threshold:
        return attention_dense(q, k, v, causal_mask(s, q.device))
    return attention_chunked(q, k, v)


# ---------------------------------------------------------------------------
# The fake-quant forward
# ---------------------------------------------------------------------------

def linear(x, p, quant: ActQuantConfig | None = None):
    """Quantize the input (when configured), then x @ W (+ b)."""
    if quant is not None:
        x = act_fake_quant(x, quant)
    y = x @ p["w"].to(x.dtype)
    if p.get("b") is not None:
        y = y + p["b"].to(y.dtype)
    return y


def _k_fake_quant(k, kcfg):
    """Post-RoPE K quantization: per token across all heads (groupsize -1)
    or per head (groupsize == head_dim)."""
    b, s, h, d = k.shape
    acfg = ActQuantConfig(bits=kcfg.bits, sym=kcfg.sym,
                          clip_ratio=kcfg.clip_ratio)
    if kcfg.groupsize == -1:
        return act_fake_quant(k.reshape(b, s, h * d), acfg).reshape(k.shape)
    if kcfg.groupsize != d:
        raise ValueError("the K cache quantizes per token or per head only")
    return act_fake_quant(k, acfg)


def _had_dtype(policy: QuantPolicy):
    return torch.float32 if policy.fp32_had else None


def qkv_rope(lp, h, cos, sin, cfg: ModelConfig, quant=None):
    """q and k (b, s, heads, head_dim) with RoPE and v (b, s, kv_dim) from
    the normalized input h, `quant` on the linears' input."""
    b, s, _ = h.shape
    hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, \
        cfg.num_key_value_heads
    q = apply_rope(linear(h, lp["q"], quant).reshape(b, s, nq, hd), cos, sin)
    k = apply_rope(linear(h, lp["k"], quant).reshape(b, s, nkv, hd), cos,
                   sin)
    return q, k, linear(h, lp["v"], quant)


def attn_block(lp, h, cos, sin, cfg: ModelConfig, policy: QuantPolicy,
               mask=None, return_probs: bool = False):
    """Self-attention on the normalized input h: (output before the
    residual, probabilities or None)."""
    b, s, _ = h.shape
    hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, \
        cfg.num_key_value_heads
    q, k, v = qkv_rope(lp, h, cos, sin, cfg, policy.a)
    v = act_fake_quant(v, policy.v).reshape(b, s, nkv, hd)
    if policy.k.enabled:
        q = hadamard_transform_last(q, dtype=_had_dtype(policy))
        k = hadamard_transform_last(k, dtype=_had_dtype(policy))
        k = _k_fake_quant(k, policy.k)
    k = repeat_kv(k, nq // nkv)
    v = repeat_kv(v, nq // nkv)
    probs = None
    if return_probs:
        probs = attention_scores(q, k, causal_mask(s, h.device)
                                 if mask is None else mask)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(v.dtype)
    else:
        attn = attention(q, k, v, mask)
    attn = attn.reshape(b, s, nq * hd)
    if policy.online_had_o:
        attn = head_mixing_hadamard(attn, head_dim=hd,
                                    dtype=_had_dtype(policy))
    return linear(attn, lp["o"], policy.a), probs


def mlp_block(lp, h, policy: QuantPolicy):
    up = linear(h, lp["up"], policy.a)
    gate = linear(h, lp["gate"], policy.a)
    act = torch.nn.functional.silu(gate.float()).to(h.dtype) * up
    if policy.online_had_down:
        act = matmul_hadU(act, dtype=_had_dtype(policy))
    return linear(act, lp["down"], policy.a_down_)


def layer_forward(lp, x, cos, sin, cfg: ModelConfig, policy: QuantPolicy,
                  mask=None, return_probs: bool = False, layer: int = 0):
    """One decoder layer, x: (b, s, d).  `layer` keeps the family
    dispatch's signature; the Llama family does not use it."""
    h = rms_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
    attn_out, probs = attn_block(lp, h, cos, sin, cfg, policy, mask,
                                 return_probs)
    x = x + attn_out
    h2 = rms_norm(x, lp.get("post_norm"), cfg.rms_norm_eps)
    x = x + mlp_block(lp, h2, policy)
    return (x, probs) if return_probs else x


def embed(params, input_ids):
    return params["embed"][input_ids]


def head(params, x, cfg: ModelConfig):
    x = rms_norm(x, params.get("final_norm"), cfg.rms_norm_eps)
    return x @ params["lm_head"].to(x.dtype)


def forward(params, input_ids, cfg: ModelConfig, policy: QuantPolicy):
    """The full forward to logits; input_ids (b, s) on the params' device."""
    x = embed(params, input_ids)
    cos, sin = rope_tables(cfg, torch.arange(input_ids.shape[1],
                                             device=input_ids.device))
    for lp in params["layers"]:
        x = layer_forward(lp, x, cos, sin, cfg, policy)
    return head(params, x, cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                dtype=torch.float32, scale: float = 0.02):
    """Random params, N(0, scale^2) weights, unit norms, zero biases, made
    from `generator` on its device (a CPU generator seeded 0 by default)."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    dev = g.device

    def w(shape):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def lin(in_d, out_d, bias):
        return {"w": w((in_d, out_d)),
                "b": torch.zeros(out_d, dtype=dtype, device=dev)
                if bias else None}

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "input_norm": torch.ones(d, dtype=dtype, device=dev),
            "post_norm": torch.ones(d, dtype=dtype, device=dev),
            "q": lin(d, cfg.q_dim, cfg.attention_bias),
            "k": lin(d, cfg.kv_dim, cfg.attention_bias),
            "v": lin(d, cfg.kv_dim, cfg.attention_bias),
            "o": lin(cfg.q_dim, d, False),
            "up": lin(d, f, False),
            "gate": lin(d, f, False),
            "down": lin(f, d, False),
        })
    return {"embed": w((v, d)), "layers": layers,
            "final_norm": torch.ones(d, dtype=dtype, device=dev),
            "lm_head": w((d, v))}
