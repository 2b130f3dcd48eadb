"""Family dispatch (the port of rsq_tpu.models.family): one call surface
over the Llama family (llama, qwen2, mistral), OPT, Gemma-2 and Falcon.
The family is a field of the frozen ModelConfig; `layer` carries the layer
index to the family whose forward depends on it (Gemma-2's alternating
sliding window), the others ignore it."""

from __future__ import annotations

import torch

from rsq_tpu_torch.models import falcon, gemma2, llama, opt
from rsq_tpu_torch.models.config import ModelConfig

LLAMA_FAMILY = ("llama", "qwen2", "mistral")


def module_for(cfg: ModelConfig):
    return {"opt": opt, "gemma2": gemma2, "falcon": falcon}.get(cfg.family,
                                                                 llama)


def groups_for(cfg: ModelConfig) -> tuple[tuple[str, ...], ...]:
    """Sequential projection groups of the layer-wise quantization (OPT
    and Falcon: qkv / o / fc1 / fc2)."""
    return module_for(cfg).GROUPS


def linear_names(cfg: ModelConfig) -> tuple[str, ...]:
    return module_for(cfg).LINEAR_NAMES


def pos_tables(cfg: ModelConfig, positions: torch.Tensor):
    """RoPE cos/sin tables, (None, None) for OPT's learned positions."""
    if cfg.family == "opt":
        return None, None
    return llama.rope_tables(cfg, positions)


def embed(params, input_ids, cfg: ModelConfig):
    if cfg.family in ("opt", "gemma2"):
        return module_for(cfg).embed(params, input_ids, cfg)
    return llama.embed(params, input_ids)      # Falcon's is Llama's


def layer_forward(lp, x, cos, sin, cfg: ModelConfig, policy, mask=None,
                  return_probs: bool = False, layer: int = 0):
    return module_for(cfg).layer_forward(lp, x, cos, sin, cfg, policy, mask,
                                         return_probs, layer=layer)


def group_input(lp, x, cos, sin, cfg: ModelConfig, policy, group, mask=None,
                layer: int = 0):
    mod = module_for(cfg)
    if mod is llama:
        from rsq_tpu_torch.quantize.pipeline import group_input as llama_input
        return llama_input(lp, x, cos, sin, cfg, policy, group, mask,
                           layer=layer)
    return mod.group_input(lp, x, cos, sin, cfg, policy, group, mask,
                           layer=layer)


def head(params, x, cfg: ModelConfig):
    return module_for(cfg).head(params, x, cfg)


def forward(params, input_ids, cfg: ModelConfig, policy):
    return module_for(cfg).forward(params, input_ids, cfg, policy)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                dtype=torch.float32, scale: float = 0.02):
    return module_for(cfg).init_params(cfg, generator, dtype=dtype,
                                       scale=scale)
