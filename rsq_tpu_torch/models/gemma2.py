"""Functional Gemma-2 decoder (the port of rsq_tpu.models.gemma2;
google/gemma-2-9b-it and -27b-it).  The reference quantizes Gemma-2 with
GPTQ or RTN but never rotates it (its post-sub-block norms sit between
each linear and the residual add, so no rotation commutes through them):
quantize/rotation.py refuses it, as the reference's does.

What differs from the Llama family, all of it data in ModelConfig:
  - the embedding scaled by sqrt(hidden_size), rounded to the activation
    dtype first;
  - RMSNorm with the (1 + w) convention, in f32;
  - four norms a layer: input, post-attention (on the attention's output,
    before the residual add), pre-feedforward and post-feedforward;
  - a GeGLU MLP, gelu_tanh(gate) * up;
  - the attention scale query_pre_attn_scalar**-0.5, not head_dim's;
  - tanh(x/c)*c softcaps on the attention logits and the final logits;
  - the sliding window on even layers (HF's layout);
  - tied embeddings.

Param tree: models/llama.py's, each layer with "input_norm",
"post_attn_norm", "pre_ff_norm" and "post_ff_norm" (d,) in place of
input_norm and post_norm.
"""

from __future__ import annotations

import torch

from rsq_tpu_torch.core.hadamard import (
    hadamard_transform_last, head_mixing_hadamard, matmul_hadU)
from rsq_tpu_torch.core.quant import act_fake_quant
from rsq_tpu_torch.models import llama as M
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.models.policy import QuantPolicy

LINEAR_NAMES = ("q", "k", "v", "o", "up", "gate", "down")
GROUPS = (("q", "k", "v"), ("o",), ("up", "gate"), ("down",))
NORMS = ("input_norm", "post_attn_norm", "pre_ff_norm", "post_ff_norm")
NEG = torch.finfo(torch.float32).min


def rms_norm(x, weight, eps):
    """Gemma's convention, x_hat * (1 + w), in f32; None is weightless."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if weight is not None:
        xf = xf * (1.0 + weight.float())
    return xf.to(x.dtype)


def _softcap(logits, cap):
    return logits if cap is None else torch.tanh(logits / cap) * cap


def _scale(cfg: ModelConfig) -> float:
    return (cfg.query_pre_attn_scalar or cfg.head_dim_) ** -0.5


def _window(cfg: ModelConfig, layer: int):
    """The sliding window of this layer, None on odd layers (HF Gemma2:
    `sliding_window if not bool(layer_idx % 2)`)."""
    return cfg.sliding_window if cfg.sliding_window is not None \
        and layer % 2 == 0 else None


def _mask_for_layer(s: int, layer: int, cfg: ModelConfig, device="cpu"):
    """The additive causal mask, windowed on even layers."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    ok = j <= i
    window = _window(cfg, layer)
    if window is not None:
        ok = ok & (i - j < window)
    return torch.where(ok, 0.0, NEG)


def attention_scores(q, k, mask, cfg: ModelConfig):
    """softmax(softcap(q k^T * scale) + mask) in f32; heads already
    repeated."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * _scale(cfg)
    return torch.softmax(_softcap(logits, cfg.attn_logit_softcap) + mask,
                         dim=-1)


def attention_chunked(q, k, v, cfg: ModelConfig, layer: int,
                      q_chunk: int = 512, k_chunk: int = 1024):
    """Flash-style online-softmax attention with Gemma's scale, softcap and
    window: query chunks, and for each the key chunks up to its last row
    (the reference's trip count, windowed chunks included), f32, l
    floored at 1e-30."""
    b, s, h, d = q.shape
    qc, kc = min(q_chunk, s), min(k_chunk, s)
    nk = -(-s // kc)
    scale, cap, window = _scale(cfg), cfg.attn_logit_softcap, \
        _window(cfg, layer)
    out = torch.empty(b, s, h, d, dtype=v.dtype, device=q.device)
    for q0 in range(0, s, qc):
        qf = q[:, q0:q0 + qc].float() * scale
        nq = qf.shape[1]
        m = torch.full((b, h, nq), -torch.inf, device=q.device)
        l = torch.zeros((b, h, nq), device=q.device)
        acc = torch.zeros((b, h, nq, d), device=q.device)
        qpos = q0 + torch.arange(nq, device=q.device)[:, None]
        for j in range(min((q0 + qc + kc - 1) // kc, nk)):
            kb = k[:, j * kc:(j + 1) * kc].float()
            vb = v[:, j * kc:(j + 1) * kc].float()
            logits = _softcap(torch.einsum("bqhd,bkhd->bhqk", qf, kb), cap)
            kpos = j * kc + torch.arange(kb.shape[1], device=q.device)[None]
            ok = kpos <= qpos
            if window is not None:
                ok = ok & (qpos - kpos < window)
            logits = torch.where(ok, logits, NEG)
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


def attention(q, k, v, cfg: ModelConfig, layer: int, mask=None,
              chunk_threshold: int = 2048):
    """mask=None: the layer's own causal (windowed) attention, chunked from
    `chunk_threshold` tokens on; an explicit mask takes the dense path."""
    s = q.shape[1]
    if mask is None and s >= chunk_threshold:
        return attention_chunked(q, k, v, cfg, layer)
    if mask is None:
        mask = _mask_for_layer(s, layer, cfg, q.device)
    probs = attention_scores(q, k, mask, cfg)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(v.dtype)


def attn_block(lp, h, cos, sin, cfg: ModelConfig, policy: QuantPolicy,
               layer: int, mask=None, return_probs: bool = False):
    b, s, _ = h.shape
    hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, \
        cfg.num_key_value_heads
    q, k, v = M.qkv_rope(lp, h, cos, sin, cfg, policy.a)
    v = act_fake_quant(v, policy.v).reshape(b, s, nkv, hd)
    if policy.k.enabled:
        q = hadamard_transform_last(q, dtype=M._had_dtype(policy))
        k = hadamard_transform_last(k, dtype=M._had_dtype(policy))
        k = M._k_fake_quant(k, policy.k)
    k = M.repeat_kv(k, nq // nkv)
    v = M.repeat_kv(v, nq // nkv)
    probs = None
    if return_probs:
        probs = attention_scores(q, k, _mask_for_layer(s, layer, cfg,
                                                       h.device)
                                 if mask is None else mask, cfg)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(v.dtype)
    else:
        attn = attention(q, k, v, cfg, layer, mask)
    attn = attn.reshape(b, s, nq * hd)
    if policy.online_had_o:
        attn = head_mixing_hadamard(attn, head_dim=hd,
                                    dtype=M._had_dtype(policy))
    return M.linear(attn, lp["o"], policy.a), probs


def _geglu(lp, h, quant=None):
    up = M.linear(h, lp["up"], quant)
    gate = M.linear(h, lp["gate"], quant)
    return torch.nn.functional.gelu(gate.float(), approximate="tanh").to(
        h.dtype) * up


def mlp_block(lp, h, policy: QuantPolicy):
    act = _geglu(lp, h, policy.a)
    if policy.online_had_down:
        act = matmul_hadU(act, dtype=M._had_dtype(policy))
    return M.linear(act, lp["down"], policy.a_down_)


def layer_forward(lp, x, cos, sin, cfg: ModelConfig, policy: QuantPolicy,
                  mask=None, return_probs: bool = False, layer: int = 0):
    """One Gemma-2 layer: the post-norms act on the sub-blocks' outputs."""
    eps = cfg.rms_norm_eps
    h = rms_norm(x, lp.get("input_norm"), eps)
    attn_out, probs = attn_block(lp, h, cos, sin, cfg, policy, layer, mask,
                                 return_probs)
    x = x + rms_norm(attn_out, lp.get("post_attn_norm"), eps)
    mlp_out = mlp_block(lp, rms_norm(x, lp.get("pre_ff_norm"), eps), policy)
    x = x + rms_norm(mlp_out, lp.get("post_ff_norm"), eps)
    return (x, probs) if return_probs else x


def group_input(lp, x, cos, sin, cfg: ModelConfig, policy: QuantPolicy,
                group: tuple[str, ...], mask=None, layer: int = 0):
    """The activation that feeds `group`'s linears (after the online
    Hadamards, before any activation quantizer)."""
    eps = cfg.rms_norm_eps
    h = rms_norm(x, lp.get("input_norm"), eps)
    if group == ("q", "k", "v"):
        return h
    b, s, _ = x.shape
    hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, \
        cfg.num_key_value_heads
    q, k, v = M.qkv_rope(lp, h, cos, sin, cfg)
    k = M.repeat_kv(k, nq // nkv)
    v = M.repeat_kv(v.reshape(b, s, nkv, hd), nq // nkv)
    attn = attention(q, k, v, cfg, layer, mask).reshape(b, s, nq * hd)
    if policy.online_had_o:
        attn = head_mixing_hadamard(attn, head_dim=hd,
                                    dtype=M._had_dtype(policy))
    if group == ("o",):
        return attn
    x2 = x + rms_norm(M.linear(attn, lp["o"]), lp.get("post_attn_norm"), eps)
    h2 = rms_norm(x2, lp.get("pre_ff_norm"), eps)
    if group == ("up", "gate"):
        return h2
    if group != ("down",):
        raise ValueError(f"unknown projection group {group}")
    act = _geglu(lp, h2)
    return matmul_hadU(act, dtype=M._had_dtype(policy)) \
        if policy.online_had_down else act


def embed(params, input_ids, cfg: ModelConfig):
    """Token embeddings times sqrt(hidden_size) (Gemma's normalizer, in
    the embedding's dtype)."""
    x = params["embed"][input_ids]
    return x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype,
                            device=x.device)


def head(params, x, cfg: ModelConfig):
    x = rms_norm(x, params.get("final_norm"), cfg.rms_norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    return _softcap(logits.float(), cfg.final_logit_softcap).to(logits.dtype)


def forward(params, input_ids, cfg: ModelConfig, policy: QuantPolicy):
    x = embed(params, input_ids, cfg)
    cos, sin = M.rope_tables(cfg, torch.arange(input_ids.shape[1],
                                               device=input_ids.device))
    for i, lp in enumerate(params["layers"]):
        x = layer_forward(lp, x, cos, sin, cfg, policy, layer=i)
    return head(params, x, cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                dtype=torch.float32, scale: float = 0.02):
    """Random params from `generator` on its device: N(0, scale^2)
    weights, zero norm weights ((1 + w) = 1), no biases, the lm_head a
    transposed view of the embedding (always tied)."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    dev = g.device

    def w(shape):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def lin(in_d, out_d):
        return {"w": w((in_d, out_d)), "b": None}

    def zeros():
        return torch.zeros(d, dtype=dtype, device=dev)

    layers = [{**{n: zeros() for n in NORMS},
               "q": lin(d, cfg.q_dim), "k": lin(d, cfg.kv_dim),
               "v": lin(d, cfg.kv_dim), "o": lin(cfg.q_dim, d),
               "up": lin(d, f), "gate": lin(d, f), "down": lin(f, d)}
              for _ in range(cfg.num_layers)]
    emb = w((v, d))
    return {"embed": emb, "layers": layers, "final_norm": zeros(),
            "lm_head": emb.T}
