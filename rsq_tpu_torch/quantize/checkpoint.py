"""Quantized-checkpoint save and load (the port of
rsq_tpu.quantize.checkpoint, its npz + manifest format).

One directory with
  manifest.json   the model config, quantizer bits, meta, norms_fused
  arrays.npz      every array leaf: params and quantizer scales / zeros,
                  and the E8P codes of quantizers that hold them
A checkpoint written by either package loads in the other, bit for bit.
A LayerNorm ({w, b}) is saved as `<key>.w` and `<key>.b`, an RMSNorm as
`<key>`; OPT's `embed_pos` and the fused `lm_head_bias` are saved when
present, the linears under the family's names (fc1/fc2 on OPT and Falcon).
Port-only (ROADMAP section 3): an E8P quantizer's codes (rows, in/8) are
saved as `quant.<key>.codes` and load_quantized returns them, so the
checkpoint serves on the affine-W4 rows; the reference's loader reads
only scale and zero and ignores them, and never writes them.  Gemma-2's
post_attn_norm, pre_ff_norm and post_ff_norm are saved and loaded too;
the reference saves only input_norm and post_norm, so its checkpoint of a
Gemma-2 whose norm weights are not zero loses them, and its loader ignores
the port's.
The reference's orbax pair (sharded, multi-host) is not ported (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from rsq_tpu_torch.models.config import ModelConfig, RopeScaling
from rsq_tpu_torch.models.family import linear_names
from rsq_tpu_torch.models.gemma2 import NORMS as GEMMA_NORMS

_NORMS = ("input_norm", "post_norm")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _layer_norms(cfg: ModelConfig):
    return _NORMS + GEMMA_NORMS[1:] if cfg.family == "gemma2" else _NORMS


def _put_norm(arrays, key, norm):
    """A norm is a bare weight (RMSNorm) or {"w", "b"} (LayerNorm); None
    when fused."""
    if isinstance(norm, dict):
        arrays[key + ".w"] = _np(norm["w"])
        arrays[key + ".b"] = _np(norm["b"])
    elif norm is not None:
        arrays[key] = _np(norm)


def _flatten(params, quantizers, cfg: ModelConfig):
    arrays = {"embed": _np(params["embed"]),
              "lm_head": _np(params["lm_head"])}
    for key in ("embed_pos", "lm_head_bias"):
        if params.get(key) is not None:
            arrays[key] = _np(params[key])
    _put_norm(arrays, "final_norm", params.get("final_norm"))
    for i, lp in enumerate(params["layers"]):
        for norm in _layer_norms(cfg):
            _put_norm(arrays, f"layers.{i}.{norm}", lp.get(norm))
        for name in linear_names(cfg):
            arrays[f"layers.{i}.{name}.w"] = _np(lp[name]["w"])
            if lp[name].get("b") is not None:
                arrays[f"layers.{i}.{name}.b"] = _np(lp[name]["b"])
    for key, info in quantizers.items():
        arrays[f"quant.{key}.scale"] = _np(info["scale"])
        arrays[f"quant.{key}.zero"] = _np(info["zero"])
        if info.get("codes") is not None:
            arrays[f"quant.{key}.codes"] = _np(info["codes"])
    return arrays


def save_quantized(path: str, params, quantizers, cfg: ModelConfig,
                   meta: dict | None = None):
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "arrays.npz"),
             **_flatten(params, quantizers, cfg))
    manifest = {
        "model_config": dataclasses.asdict(cfg),
        "num_layers": cfg.num_layers,
        "quantizer_bits": {k: int(v["bits"]) for k, v in quantizers.items()},
        "meta": meta or {},
        "norms_fused": params["layers"][0].get("input_norm") is None,
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_quantized(path: str, dtype=torch.float32):
    """Returns (params, quantizers, cfg, manifest), the tensors on the host
    (float arrays cast to `dtype`); move them where they are used."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    cd = dict(manifest["model_config"])
    if cd.get("rope_scaling"):
        cd["rope_scaling"] = RopeScaling(**cd["rope_scaling"])
    cfg = ModelConfig(**cd)

    def arr(key, required=True):
        if key not in arrays:
            if required:
                raise KeyError(key)
            return None
        t = torch.from_numpy(arrays[key])
        return t.to(dtype) if t.is_floating_point() else t

    def norm(key):
        if f"{key}.w" in arrays:
            return {"w": arr(f"{key}.w"), "b": arr(f"{key}.b")}
        return arr(key, required=False)

    layers = []
    for i in range(cfg.num_layers):
        lp = {n: norm(f"layers.{i}.{n}") for n in _layer_norms(cfg)}
        for name in linear_names(cfg):
            lp[name] = {"w": arr(f"layers.{i}.{name}.w"),
                        "b": arr(f"layers.{i}.{name}.b", required=False)}
        layers.append(lp)
    params = {"embed": arr("embed"), "final_norm": norm("final_norm"),
              "lm_head": arr("lm_head"), "layers": layers}
    for key in ("embed_pos", "lm_head_bias"):
        if key in arrays:
            params[key] = arr(key)
    quantizers = {}
    for key, bits in manifest["quantizer_bits"].items():
        q = {"scale": torch.from_numpy(arrays[f"quant.{key}.scale"]),
             "zero": torch.from_numpy(arrays[f"quant.{key}.zero"]),
             "bits": bits}
        if f"quant.{key}.codes" in arrays:
            q["codes"] = torch.from_numpy(arrays[f"quant.{key}.codes"])
        quantizers[key] = q
    return params, quantizers, cfg, manifest
