"""Hugging Face checkpoint ingest (the port of rsq_tpu.models.hf): a
transformers config and state dict -> ModelConfig and the port's param
tree, weights transposed to the (in, out) layout of models/llama.py, as
host tensors.

config_from_hf takes any object with a transformers config's attributes
and params_from_state_dict any mapping of tensors or arrays: neither needs
transformers.  load_hf alone imports it, to read a checkpoint from a local
directory (never from the hub).  llama, qwen2 (with its q/k/v biases),
mistral, opt (pre-LN, learned positions), gemma2 (four norms a layer) and
falcon (parallel attention, the fused query_key_value in all three of HF's
layouts) are read; any other model_type is read as llama, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from rsq_tpu_torch.models.config import ModelConfig, RopeScaling
from rsq_tpu_torch.models.family import LLAMA_FAMILY

_LAYER_KEYS = {
    "q": "self_attn.q_proj",
    "k": "self_attn.k_proj",
    "v": "self_attn.v_proj",
    "o": "self_attn.o_proj",
    "up": "mlp.up_proj",
    "gate": "mlp.gate_proj",
    "down": "mlp.down_proj",
}
_OPT_LAYER_KEYS = {
    "q": "self_attn.q_proj",
    "k": "self_attn.k_proj",
    "v": "self_attn.v_proj",
    "o": "self_attn.out_proj",
    "fc1": "fc1",
    "fc2": "fc2",
}
_GEMMA2_NORM_KEYS = {
    "input_norm": "input_layernorm",
    "post_attn_norm": "post_attention_layernorm",
    "pre_ff_norm": "pre_feedforward_layernorm",
    "post_ff_norm": "post_feedforward_layernorm",
}
FAMILIES = LLAMA_FAMILY + ("opt", "gemma2", "falcon")


def _falcon_config(c) -> ModelConfig:
    if not getattr(c, "parallel_attn", True):
        raise ValueError("sequential-residual Falcon variants (falcon-rw) "
                         "are not supported")
    new_arch = getattr(c, "new_decoder_architecture", False)
    nq = c.num_attention_heads
    nkv = c.num_kv_heads if new_arch else (1 if c.multi_query else nq)
    return ModelConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        intermediate_size=getattr(c, "ffn_hidden_size", 4 * c.hidden_size),
        num_layers=c.num_hidden_layers, num_attention_heads=nq,
        num_key_value_heads=nkv, head_dim=c.hidden_size // nq,
        rope_theta=getattr(c, "rope_theta", 10000.0),
        rms_norm_eps=c.layer_norm_epsilon,
        tie_word_embeddings=getattr(c, "tie_word_embeddings", True),
        max_position_embeddings=getattr(c, "max_position_embeddings", 2048),
        family="falcon", falcon_two_norms=new_arch)


def _gemma2_config(c) -> ModelConfig:
    return ModelConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        intermediate_size=c.intermediate_size,
        num_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads,
        num_key_value_heads=c.num_key_value_heads, head_dim=c.head_dim,
        rope_theta=getattr(c, "rope_theta", 10000.0),
        rms_norm_eps=c.rms_norm_eps, tie_word_embeddings=True,
        max_position_embeddings=c.max_position_embeddings, family="gemma2",
        query_pre_attn_scalar=float(c.query_pre_attn_scalar),
        attn_logit_softcap=c.attn_logit_softcapping,
        final_logit_softcap=c.final_logit_softcapping,
        sliding_window=c.sliding_window)


def _opt_config(c) -> ModelConfig:
    if not getattr(c, "do_layer_norm_before", True):
        raise ValueError("pre-LN OPT variants only (opt-350m is post-LN)")
    if c.word_embed_proj_dim != c.hidden_size:
        raise ValueError("OPT word_embed_proj_dim != hidden_size is not "
                         "supported")
    return ModelConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        intermediate_size=c.ffn_dim, num_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads,
        num_key_value_heads=c.num_attention_heads, rms_norm_eps=1e-5,
        attention_bias=True,
        tie_word_embeddings=getattr(c, "tie_word_embeddings", True),
        max_position_embeddings=c.max_position_embeddings, family="opt")


def config_from_hf(hf_config) -> ModelConfig:
    """Map a transformers config onto ModelConfig."""
    family = hf_config.model_type
    if family not in FAMILIES:
        family = "llama"
    if family == "falcon":
        return _falcon_config(hf_config)
    if family == "gemma2":
        return _gemma2_config(hf_config)
    if family == "opt":
        return _opt_config(hf_config)
    scaling = None
    rs = getattr(hf_config, "rope_scaling", None)
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        scaling = RopeScaling(
            factor=rs["factor"],
            low_freq_factor=rs["low_freq_factor"],
            high_freq_factor=rs["high_freq_factor"],
            original_max_position_embeddings=rs[
                "original_max_position_embeddings"])
    return ModelConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        num_key_value_heads=getattr(hf_config, "num_key_value_heads",
                                    hf_config.num_attention_heads),
        head_dim=getattr(hf_config, "head_dim", None),
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rope_scaling=scaling,
        rms_norm_eps=hf_config.rms_norm_eps,
        attention_bias=getattr(hf_config, "attention_bias",
                               family == "qwen2"),
        tie_word_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        max_position_embeddings=hf_config.max_position_embeddings,
        family=family)


def params_from_state_dict(sd, cfg: ModelConfig, dtype=torch.float32):
    """An HF state dict (torch tensors or numpy arrays, any float dtype)
    -> the port's param tree of host tensors in `dtype`, each value taken
    through f32 as the reference takes it.  The lm_head is a transposed
    view of the embedding when tied or absent (Gemma-2's always; no copy
    of a vocabulary-sized table on the host); a linear's bias is kept
    where the state dict has one (Falcon's never)."""

    def get(name):
        t = sd[name]
        if isinstance(t, torch.Tensor):
            t = t.detach().to("cpu", torch.float32)
        else:
            t = torch.from_numpy(np.asarray(t, dtype=np.float32))
        return t.to(dtype)

    def lin(prefix):
        return {"w": get(prefix + ".weight").T.contiguous(),
                "b": get(prefix + ".bias") if prefix + ".bias" in sd
                else None}

    def norm(prefix):
        return {"w": get(prefix + ".weight"), "b": get(prefix + ".bias")}

    def lm_head(embed):
        if cfg.tie_word_embeddings or "lm_head.weight" not in sd:
            return embed.T
        return get("lm_head.weight").T.contiguous()

    if cfg.family == "opt":
        return _opt_params(cfg, get, lin, norm, lm_head)
    if cfg.family == "falcon":
        return _falcon_params(cfg, get, norm, lm_head)
    layers = []
    for i in range(cfg.num_layers):
        base = f"model.layers.{i}."
        lp = {name: lin(base + hf) for name, hf in _LAYER_KEYS.items()}
        if cfg.family == "gemma2":
            for name, hf in _GEMMA2_NORM_KEYS.items():
                lp[name] = get(base + hf + ".weight")
        else:
            lp["input_norm"] = get(base + "input_layernorm.weight")
            lp["post_norm"] = get(base + "post_attention_layernorm.weight")
        layers.append(lp)
    embed = get("model.embed_tokens.weight")
    return {"embed": embed, "layers": layers,
            "final_norm": get("model.norm.weight"),
            "lm_head": embed.T if cfg.family == "gemma2"
            else lm_head(embed)}


def _opt_params(cfg, get, lin, norm, lm_head):
    layers = []
    for i in range(cfg.num_layers):
        base = f"model.decoder.layers.{i}."
        lp = {name: lin(base + hf) for name, hf in _OPT_LAYER_KEYS.items()}
        lp["input_norm"] = norm(base + "self_attn_layer_norm")
        lp["post_norm"] = norm(base + "final_layer_norm")
        layers.append(lp)
    embed = get("model.decoder.embed_tokens.weight")
    return {"embed": embed,
            "embed_pos": get("model.decoder.embed_positions.weight"),
            "layers": layers,
            "final_norm": norm("model.decoder.final_layer_norm"),
            "lm_head": lm_head(embed)}


def _split_falcon_qkv(W, cfg: ModelConfig):
    """HF Falcon's fused query_key_value weight ((out, in)) -> q, k, v in
    the (in, out) layout.  HF's layouts (modeling_falcon._split_heads):
      - new decoder architecture: per kv group [nq/nkv q heads, k, v];
      - multi-query: [nq q heads, k, v];
      - MHA: [q, k, v] interleaved per head."""
    hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, \
        cfg.num_key_value_heads
    d = W.shape[1]
    if cfg.falcon_two_norms:
        Wg = W.reshape(nkv, nq // nkv + 2, hd, d)
        q = Wg[:, :-2].reshape(nq * hd, d)
        k = Wg[:, -2].reshape(nkv * hd, d)
        v = Wg[:, -1].reshape(nkv * hd, d)
    elif nkv == 1:
        q, k, v = W[:nq * hd], W[nq * hd:(nq + 1) * hd], W[(nq + 1) * hd:]
    else:
        Wg = W.reshape(nq, 3, hd, d)
        q = Wg[:, 0].reshape(nq * hd, d)
        k = Wg[:, 1].reshape(nq * hd, d)
        v = Wg[:, 2].reshape(nq * hd, d)
    return q.T.contiguous(), k.T.contiguous(), v.T.contiguous()


def _falcon_params(cfg, get, norm, lm_head):
    def lin(name):                      # Falcon's linears carry no bias
        return {"w": get(name + ".weight").T.contiguous(), "b": None}

    layers = []
    for i in range(cfg.num_layers):
        base = f"transformer.h.{i}."
        q, k, v = _split_falcon_qkv(
            get(base + "self_attention.query_key_value.weight"), cfg)
        lp = {"q": {"w": q, "b": None}, "k": {"w": k, "b": None},
              "v": {"w": v, "b": None},
              "o": lin(base + "self_attention.dense"),
              "fc1": lin(base + "mlp.dense_h_to_4h"),
              "fc2": lin(base + "mlp.dense_4h_to_h")}
        if cfg.falcon_two_norms:
            lp["input_norm"] = norm(base + "ln_attn")
            lp["post_norm"] = norm(base + "ln_mlp")
        else:
            lp["input_norm"] = norm(base + "input_layernorm")
            lp["post_norm"] = None
        layers.append(lp)
    embed = get("transformer.word_embeddings.weight")
    return {"embed": embed, "layers": layers,
            "final_norm": norm("transformer.ln_f"), "lm_head": lm_head(embed)}


def from_hf_model(model):
    """(a transformers causal-LM module) -> (ModelConfig, param tree)."""
    cfg = config_from_hf(model.config)
    return cfg, params_from_state_dict(model.state_dict(), cfg)


def load_hf(path: str, dtype=torch.float32):
    """Read a Hugging Face checkpoint from a local directory (config and
    weights, in f32) -> (ModelConfig, param tree).  Needs transformers;
    nothing is fetched from the hub."""
    from transformers import AutoConfig, AutoModelForCausalLM

    hf_config = AutoConfig.from_pretrained(path, local_files_only=True)
    cfg = config_from_hf(hf_config)
    model = AutoModelForCausalLM.from_pretrained(
        path, torch_dtype=torch.float32, low_cpu_mem_usage=True,
        local_files_only=True)
    return cfg, params_from_state_dict(model.state_dict(), cfg, dtype=dtype)
