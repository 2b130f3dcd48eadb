"""Hugging Face checkpoint ingest for the Llama family (the port of
rsq_tpu.models.hf): a transformers config and state dict -> ModelConfig
and the port's param tree, weights transposed to the (in, out) layout of
models/llama.py, as host f32 tensors.

config_from_hf takes any object with a transformers config's attributes
and params_from_state_dict any mapping of tensors or arrays: neither needs
transformers.  load_hf alone imports it, to read a checkpoint from a local
directory (never from the hub).  llama, qwen2 (with its q/k/v biases) and
mistral are ported; OPT, Gemma-2 and Falcon raise (ROADMAP item 15), and
any other model_type is read as llama, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from rsq_tpu_torch.models.config import ModelConfig, RopeScaling

_LAYER_KEYS = {
    "q": "self_attn.q_proj",
    "k": "self_attn.k_proj",
    "v": "self_attn.v_proj",
    "o": "self_attn.o_proj",
    "up": "mlp.up_proj",
    "gate": "mlp.gate_proj",
    "down": "mlp.down_proj",
}
NOT_PORTED = ("opt", "gemma2", "falcon")


def config_from_hf(hf_config) -> ModelConfig:
    """Map a transformers config (llama, qwen2, mistral) onto ModelConfig."""
    family = hf_config.model_type
    if family in NOT_PORTED:
        raise NotImplementedError(
            f"model family {family!r} is not ported yet (ROADMAP item 15: "
            "OPT, Gemma-2 and Falcon); the port ingests the Llama family")
    if family not in ("llama", "qwen2", "mistral"):
        family = "llama"
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
    through f32 as the reference takes it.  The lm_head is the embedding's
    transpose when tied or absent; a linear's bias is kept where the state
    dict has one."""
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP item 15)")

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

    layers = []
    for i in range(cfg.num_layers):
        base = f"model.layers.{i}."
        lp = {name: lin(base + hf) for name, hf in _LAYER_KEYS.items()}
        lp["input_norm"] = get(base + "input_layernorm.weight")
        lp["post_norm"] = get(base + "post_attention_layernorm.weight")
        layers.append(lp)
    embed = get("model.embed_tokens.weight")
    if cfg.tie_word_embeddings or "lm_head.weight" not in sd:
        lm_head = embed.T.contiguous()
    else:
        lm_head = get("lm_head.weight").T.contiguous()
    return {"embed": embed, "layers": layers,
            "final_norm": get("model.norm.weight"), "lm_head": lm_head}


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
