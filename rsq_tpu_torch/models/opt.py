"""Functional OPT-family decoder (the port of rsq_tpu.models.opt), the
reference's debug family (opt-125m).  What differs from the Llama family:

  - learned positional embeddings at the HF offset of 2, added at embed
    time (no RoPE);
  - LayerNorm with weight and bias instead of RMSNorm.  After rotation
    fusion it becomes the weightless RMSN, as Llama's does: the embeddings
    are mean-centred and the mean-subtraction is baked into o and fc2
    (quantize/rotation.py);
  - biased q/k/v/o, MHA (kv heads == heads);
  - a two-linear ReLU MLP, fc1 -> relu -> fc2.

Param tree (torch tensors):
  {"embed": (V, d), "embed_pos": (P + 2, d),
   "layers": [{"input_norm": {"w", "b"}|None, "post_norm": {"w", "b"}|None,
               "q","k","v","o","fc1","fc2": {"w": (in, out), "b": (out,)}},
              ...],
   "final_norm": {"w", "b"}|None, "lm_head": (d, V),
   ["lm_head_bias": (V,), the final LayerNorm's bias after fusion]}

The quantization policy (activation quantizers at every linear input, the
online Hadamards on o and fc2 when rotated, post-"rope" K quantization)
acts as in models/llama.py.
"""

from __future__ import annotations

import torch

from rsq_tpu_torch.core.hadamard import (
    hadamard_transform_last, head_mixing_hadamard, matmul_hadU)
from rsq_tpu_torch.core.quant import act_fake_quant
from rsq_tpu_torch.models import llama as M
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.models.policy import QuantPolicy

LINEAR_NAMES = ("q", "k", "v", "o", "fc1", "fc2")
GROUPS = (("q", "k", "v"), ("o",), ("fc1",), ("fc2",))
POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding's offset


def layer_norm(x, p, eps):
    """LayerNorm in f32 with p = {"w", "b"}; p=None is the fused
    weightless RMSN."""
    if p is None:
        return M.rms_norm(x, None, eps)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p["w"].float() + p["b"].float()).to(x.dtype)


def embed(params, input_ids, cfg: ModelConfig | None = None):
    """Token plus learned positional embeddings (positions 0..s-1 at the
    offset 2)."""
    pos = torch.arange(input_ids.shape[-1], device=input_ids.device) \
        + POS_OFFSET
    return params["embed"][input_ids] + params["embed_pos"][pos]


def attn_block(lp, h, cfg: ModelConfig, policy: QuantPolicy, mask=None,
               return_probs: bool = False):
    b, s, _ = h.shape
    hd, nq = cfg.head_dim_, cfg.num_attention_heads
    q = M.linear(h, lp["q"], policy.a).reshape(b, s, nq, hd)
    k = M.linear(h, lp["k"], policy.a).reshape(b, s, nq, hd)
    v = act_fake_quant(M.linear(h, lp["v"], policy.a), policy.v).reshape(
        b, s, nq, hd)
    if policy.k.enabled:
        q = hadamard_transform_last(q, dtype=M._had_dtype(policy))
        k = hadamard_transform_last(k, dtype=M._had_dtype(policy))
        k = M._k_fake_quant(k, policy.k)
    probs = None
    if return_probs:
        probs = M.attention_scores(q, k, M.causal_mask(s, h.device)
                                   if mask is None else mask)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(v.dtype)
    else:
        attn = M.attention(q, k, v, mask)
    attn = attn.reshape(b, s, nq * hd)
    if policy.online_had_o:
        attn = head_mixing_hadamard(attn, head_dim=hd,
                                    dtype=M._had_dtype(policy))
    return M.linear(attn, lp["o"], policy.a), probs


def _fc1_act(lp, h, quant=None):
    return torch.relu(M.linear(h, lp["fc1"], quant))


def mlp_block(lp, h, policy: QuantPolicy):
    act = _fc1_act(lp, h, policy.a)
    if policy.online_had_down:
        act = matmul_hadU(act, dtype=M._had_dtype(policy))
    return M.linear(act, lp["fc2"], policy.a_down_)


def layer_forward(lp, x, cos, sin, cfg: ModelConfig, policy: QuantPolicy,
                  mask=None, return_probs: bool = False, layer: int = 0):
    """One decoder layer (cos, sin and layer keep the family dispatch's
    signature; OPT uses none of them)."""
    h = layer_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
    attn_out, probs = attn_block(lp, h, cfg, policy, mask, return_probs)
    x = x + attn_out
    h2 = layer_norm(x, lp.get("post_norm"), cfg.rms_norm_eps)
    x = x + mlp_block(lp, h2, policy)
    return (x, probs) if return_probs else x


def group_input(lp, x, cos, sin, cfg: ModelConfig, policy: QuantPolicy,
                group: tuple[str, ...], mask=None, layer: int = 0):
    """The activation that feeds `group`'s linears (the pipeline's capture
    points, after the online Hadamards)."""
    h = layer_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
    if group == ("q", "k", "v"):
        return h
    b, s, _ = x.shape
    hd, nq = cfg.head_dim_, cfg.num_attention_heads
    q = M.linear(h, lp["q"]).reshape(b, s, nq, hd)
    k = M.linear(h, lp["k"]).reshape(b, s, nq, hd)
    v = M.linear(h, lp["v"]).reshape(b, s, nq, hd)
    attn = M.attention(q, k, v, mask).reshape(b, s, nq * hd)
    if policy.online_had_o:
        attn = head_mixing_hadamard(attn, head_dim=hd,
                                    dtype=M._had_dtype(policy))
    if group == ("o",):
        return attn
    h2 = layer_norm(x + M.linear(attn, lp["o"]), lp.get("post_norm"),
                    cfg.rms_norm_eps)
    if group == ("fc1",):
        return h2
    if group != ("fc2",):
        raise ValueError(f"unknown projection group {group}")
    act = _fc1_act(lp, h2)
    return matmul_hadU(act, dtype=M._had_dtype(policy)) \
        if policy.online_had_down else act


def head(params, x, cfg: ModelConfig):
    """The final norm, the lm_head and (after fusion) its bias."""
    x = layer_norm(x, params.get("final_norm"), cfg.rms_norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    if params.get("lm_head_bias") is not None:
        logits = logits + params["lm_head_bias"].to(logits.dtype)
    return logits


def forward(params, input_ids, cfg: ModelConfig, policy: QuantPolicy):
    x = embed(params, input_ids)
    for lp in params["layers"]:
        x = layer_forward(lp, x, None, None, cfg, policy)
    return head(params, x, cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                dtype=torch.float32, scale: float = 0.02):
    """Random params from `generator` on its device: N(0, scale^2)
    weights and positions, zero biases, unit LayerNorms; the lm_head is a
    transposed view of the embedding when tied."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    dev = g.device

    def w(shape):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def lin(in_d, out_d):
        return {"w": w((in_d, out_d)),
                "b": torch.zeros(out_d, dtype=dtype, device=dev)}

    def norm():
        return {"w": torch.ones(d, dtype=dtype, device=dev),
                "b": torch.zeros(d, dtype=dtype, device=dev)}

    layers = [{"input_norm": norm(), "post_norm": norm(),
               "q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
               "o": lin(d, d), "fc1": lin(d, f), "fc2": lin(f, d)}
              for _ in range(cfg.num_layers)]
    emb = w((v, d))
    return {"embed": emb,
            "embed_pos": w((cfg.max_position_embeddings + POS_OFFSET, d)),
            "layers": layers, "final_norm": norm(),
            "lm_head": emb.T if cfg.tie_word_embeddings
            else w((d, v))}
