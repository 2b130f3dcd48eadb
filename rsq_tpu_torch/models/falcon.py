"""Functional Falcon-family decoder (the port of rsq_tpu.models.falcon),
the parallel-attention architecture.  What differs from the Llama family:

  - a parallel residual: one LayerNorm'd input feeds both the attention
    and the MLP, and the layer's output is x + attn(h) + mlp(h)
    (falcon-7b).  The 40B "new decoder architecture" has a second norm
    for the MLP (ln_mlp) in the same topology: `post_norm is not None`;
  - LayerNorm with weight and bias; after rotation fusion both norms are
    the weightless RMSN, as OPT's are (mean-centred embeddings, the mean
    baked out of o and fc2);
  - RoPE in the HF rotate-half layout, as Llama's;
  - MQA on falcon-7b (one kv head), GQA on 40B, both through repeat_kv;
  - a two-linear GELU MLP (exact erf), fc1 -> gelu -> fc2, no biases.

Param tree: models/opt.py's without embed_pos, the linears' "b" None
(fusion gives q/k/v/fc1 one).  `post_norm` None in the unfused model is
falcon-7b's shared norm; after fusion both layouts have input_norm and
post_norm None and the difference lives in fc1's weights.
"""

from __future__ import annotations

import torch

from rsq_tpu_torch.core.hadamard import hadamard_transform_last, matmul_hadU
from rsq_tpu_torch.core.quant import act_fake_quant
from rsq_tpu_torch.models import llama as M
from rsq_tpu_torch.models import opt as O
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.models.policy import QuantPolicy

LINEAR_NAMES = ("q", "k", "v", "o", "fc1", "fc2")
GROUPS = (("q", "k", "v"), ("o",), ("fc1",), ("fc2",))


def _mlp_input(lp, x, h_attn, cfg: ModelConfig):
    """The MLP's normalized input: falcon-7b shares the attention's
    LayerNorm output, the two-norm layout has its own ln_mlp."""
    if lp.get("post_norm") is None:
        return h_attn
    return O.layer_norm(x, lp["post_norm"], cfg.rms_norm_eps)


def attn_block(lp, h, cos, sin, cfg: ModelConfig, policy: QuantPolicy,
               mask=None, return_probs: bool = False):
    """Self-attention on the normalized input h (RoPE, MQA or GQA).  No
    online o-side Hadamard: 71 heads admit no head-mixing one, so the v/o
    pair is baked offline (rotation's per-head Hadamards on both)."""
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
        probs = M.attention_scores(q, k, M.causal_mask(s, h.device)
                                   if mask is None else mask)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(v.dtype)
    else:
        attn = M.attention(q, k, v, mask)
    return M.linear(attn.reshape(b, s, nq * hd), lp["o"], policy.a), probs


def _fc1_act(lp, h, quant=None):
    act = M.linear(h, lp["fc1"], quant)
    return torch.nn.functional.gelu(act.float()).to(h.dtype)


def mlp_block(lp, h, policy: QuantPolicy):
    act = _fc1_act(lp, h, policy.a)
    if policy.online_had_down:
        act = matmul_hadU(act, dtype=M._had_dtype(policy))
    return M.linear(act, lp["fc2"], policy.a_down_)


def layer_forward(lp, x, cos, sin, cfg: ModelConfig, policy: QuantPolicy,
                  mask=None, return_probs: bool = False, layer: int = 0):
    """One parallel layer: x + attn(LN(x)) + mlp(LN'(x))."""
    h = O.layer_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
    attn_out, probs = attn_block(lp, h, cos, sin, cfg, policy, mask,
                                 return_probs)
    x = x + attn_out + mlp_block(lp, _mlp_input(lp, x, h, cfg), policy)
    return (x, probs) if return_probs else x


def group_input(lp, x, cos, sin, cfg: ModelConfig, policy: QuantPolicy,
                group: tuple[str, ...], mask=None, layer: int = 0):
    """The activation that feeds `group`'s linears.  In the parallel
    topology fc1's input does not depend on the attention."""
    h = O.layer_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
    if group == ("q", "k", "v"):
        return h
    if group == ("fc1",):
        return _mlp_input(lp, x, h, cfg)
    if group == ("o",):
        b, s, _ = x.shape
        hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, \
            cfg.num_key_value_heads
        q, k, v = M.qkv_rope(lp, h, cos, sin, cfg)
        k = M.repeat_kv(k, nq // nkv)
        v = M.repeat_kv(v.reshape(b, s, nkv, hd), nq // nkv)
        # the raw attention output: its per-head rotation is offline
        return M.attention(q, k, v, mask).reshape(b, s, nq * hd)
    if group != ("fc2",):
        raise ValueError(f"unknown projection group {group}")
    act = _fc1_act(lp, _mlp_input(lp, x, h, cfg))
    return matmul_hadU(act, dtype=M._had_dtype(policy)) \
        if policy.online_had_down else act


def embed(params, input_ids, cfg: ModelConfig | None = None):
    return params["embed"][input_ids]


head = O.head


def forward(params, input_ids, cfg: ModelConfig, policy: QuantPolicy):
    x = embed(params, input_ids)
    cos, sin = M.rope_tables(cfg, torch.arange(input_ids.shape[1],
                                               device=input_ids.device))
    for lp in params["layers"]:
        x = layer_forward(lp, x, cos, sin, cfg, policy)
    return head(params, x, cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                dtype=torch.float32, scale: float = 0.02):
    """Random params from `generator` on its device: N(0, scale^2)
    weights, unit LayerNorms (a second one for the MLP on the two-norm
    layout), no linear biases; the lm_head is a transposed view of the
    embedding when tied."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    dev = g.device

    def w(shape):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def lin(in_d, out_d):
        return {"w": w((in_d, out_d)), "b": None}

    def norm():
        return {"w": torch.ones(d, dtype=dtype, device=dev),
                "b": torch.zeros(d, dtype=dtype, device=dev)}

    layers = [{"input_norm": norm(),
               "post_norm": norm() if cfg.falcon_two_norms else None,
               "q": lin(d, cfg.q_dim), "k": lin(d, cfg.kv_dim),
               "v": lin(d, cfg.kv_dim), "o": lin(cfg.q_dim, d),
               "fc1": lin(d, f), "fc2": lin(f, d)}
              for _ in range(cfg.num_layers)]
    emb = w((v, d))
    return {"embed": emb, "layers": layers, "final_norm": norm(),
            "lm_head": emb.T if cfg.tie_word_embeddings
            else w((d, v))}
