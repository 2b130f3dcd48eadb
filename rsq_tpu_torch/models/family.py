"""Family dispatch (the port of rsq_tpu.models.family), for the Llama
family (llama, qwen2, mistral; named random models or a local Hugging Face
checkpoint through models/hf.py).  OPT, Gemma-2 and Falcon are the open
half of ROADMAP item 15: asking for one raises."""

from __future__ import annotations

import torch

from rsq_tpu_torch.models import llama
from rsq_tpu_torch.models.config import ModelConfig

LLAMA_FAMILY = ("llama", "qwen2", "mistral")


def module_for(cfg: ModelConfig):
    if cfg.family not in LLAMA_FAMILY:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP item "
            "15, its second half: OPT, Gemma-2 and Falcon); the port runs "
            "the Llama family")
    return llama


def groups_for(cfg: ModelConfig) -> tuple[tuple[str, ...], ...]:
    """Sequential projection groups of the layer-wise quantization."""
    module_for(cfg)
    return (("q", "k", "v"), ("o",), ("up", "gate"), ("down",))


def linear_names(cfg: ModelConfig) -> tuple[str, ...]:
    return module_for(cfg).LINEAR_NAMES


def pos_tables(cfg: ModelConfig, positions: torch.Tensor):
    """RoPE cos/sin tables."""
    return module_for(cfg).rope_tables(cfg, positions)


def embed(params, input_ids, cfg: ModelConfig):
    return module_for(cfg).embed(params, input_ids)


def layer_forward(lp, x, cos, sin, cfg: ModelConfig, policy, mask=None,
                  return_probs: bool = False, layer: int = 0):
    return module_for(cfg).layer_forward(lp, x, cos, sin, cfg, policy, mask,
                                         return_probs, layer=layer)


def group_input(lp, x, cos, sin, cfg: ModelConfig, policy, group, mask=None,
                layer: int = 0):
    module_for(cfg)
    from rsq_tpu_torch.quantize.pipeline import group_input as llama_input
    return llama_input(lp, x, cos, sin, cfg, policy, group, mask, layer=layer)


def head(params, x, cfg: ModelConfig):
    return module_for(cfg).head(params, x, cfg)


def forward(params, input_ids, cfg: ModelConfig, policy):
    return module_for(cfg).forward(params, input_ids, cfg, policy)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                dtype=torch.float32, scale: float = 0.02):
    return module_for(cfg).init_params(cfg, generator, dtype=dtype,
                                       scale=scale)
