"""The RSQ pipeline: rotate -> scale -> quantize, layer-streamed (the port
of rsq_tpu.quantize.pipeline).

Each decoder layer is a param dict; the inputs of its four projection
groups come from the family's explicit sub-forwards (models/family.py), in
the reference's order
  {q, k, v} -> {o} -> {up, gate} -> {down}   (OPT, Falcon: fc1, fc2),
each group's Hessian taken after the groups before it were replaced by
their quantized weights.  Memory: every weight stays parked on the host
and one layer at a time is staged on the device, quantized and parked
again; the calibration activations (N, L, d) live on the device.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from rsq_tpu_torch import resolve_device, tree_to
from rsq_tpu_torch.core.hadamard import (
    hadU_supported, head_mixing_hadamard, matmul_hadU)
from rsq_tpu_torch.core.quant import WeightQuantConfig
from rsq_tpu_torch.models import family
from rsq_tpu_torch.models import llama as M
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.models.policy import QuantPolicy
from rsq_tpu_torch.quantize import rotation
from rsq_tpu_torch.quantize.gptq import GPTQConfig, gptq_quantize, rtn_quantize
from rsq_tpu_torch.quantize.ldlq import ldlq_quantize
from rsq_tpu_torch.quantize.weighting import (
    WeightingConfig, calibration_mask, compute_sample_weight,
    token_frequencies)

logger = logging.getLogger(__name__)

# samples per device call of the weighting, Hessian and output passes
CHUNK = 8


@dataclasses.dataclass(frozen=True)
class RSQConfig:
    """Everything the reference's main.py reads from its flags, typed."""
    w: WeightQuantConfig = WeightQuantConfig(bits=4, sym=True, mse=False)
    gptq: GPTQConfig = GPTQConfig()
    weighting: WeightingConfig | None = None
    rotate: bool = False
    rotate_mode: str = "hadamard"
    rotation_seed: int = 0
    w_rtn: bool = False
    e8p: bool = False
    nsamples: int = 128
    seed: int = 0
    int8_down_proj: bool = False
    layers_dont_quantize: tuple[int, ...] = ()
    wbits_overrides: tuple[tuple[str, int], ...] = ()  # (name, bits)

    def bits_for(self, layer_idx: int, name: str) -> int:
        if layer_idx in self.layers_dont_quantize:
            return 16
        for n, b in self.wbits_overrides:
            if n == name:
                return b
        if self.int8_down_proj and name == "down":
            return 8
        return self.w.bits


def group_input(lp, x, cos, sin, cfg: ModelConfig, policy: QuantPolicy,
                group: tuple[str, ...], mask=None, layer: int = 0):
    """The Llama family's capture points (family.group_input dispatches
    the others to their modules): the activation that feeds `group`'s
    linears under the current weights, taken after the online Hadamards
    and before any activation quantizer (none is active during
    calibration)."""
    h = M.rms_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
    if group == ("q", "k", "v"):
        return h
    b, s, _ = x.shape
    hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, \
        cfg.num_key_value_heads
    dt = torch.float32 if policy.fp32_had else None
    q, k, v = M.qkv_rope(lp, h, cos, sin, cfg)
    attn = M.attention(q, M.repeat_kv(k, nq // nkv),
                       M.repeat_kv(v.reshape(b, s, nkv, hd), nq // nkv),
                       mask).reshape(b, s, nq * hd)
    if policy.online_had_o:
        attn = head_mixing_hadamard(attn, head_dim=hd, dtype=dt)
    if group == ("o",):
        return attn
    x2 = x + M.linear(attn, lp["o"])
    h2 = M.rms_norm(x2, lp.get("post_norm"), cfg.rms_norm_eps)
    if group == ("up", "gate"):
        return h2
    if group != ("down",):
        raise ValueError(f"unknown projection group {group}")
    act = torch.nn.functional.silu(M.linear(h2, lp["gate"]).float()).to(
        h2.dtype) * M.linear(h2, lp["up"])
    return matmul_hadU(act, dtype=dt) if policy.online_had_down else act


def _hessian_accumulate(H, lp, x, w, cos, sin, cfg, policy, group, mask,
                        layer=0):
    """H += the chunk's weighted X^T X for `group`, in place.  x: (C, L, d);
    w: (C, L) token weights normalized to mean 1 per sample."""
    inp = family.group_input(lp, x, cos, sin, cfg, policy, group, mask,
                             layer=layer).float() * torch.sqrt(w)[:, :, None]
    inp = inp.reshape(-1, inp.shape[-1])
    return H.addmm_(inp.T, inp)


def _layer_out(lp, x, cos, sin, cfg, policy, mask, layer=0):
    return family.layer_forward(lp, x, cos, sin, cfg, policy, mask,
                                layer=layer)


def _needs_out(wcfg: WeightingConfig) -> bool:
    return wcfg.method == "actdiff" or (
        wcfg.method in ("actnorm", "tokensim", "cluster", "dot")
        and wcfg.input_or_output != "input")


def _chunk_weights(lp, x, cos, sin, cfg, policy, mask, token_freq, wcfg,
                   layer=0):
    """Importance weights of a chunk of samples (C, L); the layer's output
    is computed only for the methods that read it."""
    outs = (_layer_out(lp, x, cos, sin, cfg, policy, mask, layer=layer)
            if _needs_out(wcfg) else None)
    return compute_sample_weight(lp, x, outs, token_freq, cfg, policy, wcfg,
                                 layer=layer)


def _calibration_policy(rsq: RSQConfig, cfg: ModelConfig) -> QuantPolicy:
    """Online Hadamards when rotated, no activation quantizers yet; the
    down Hadamard only where a construction exists."""
    return QuantPolicy(
        online_had_down=rsq.rotate and hadU_supported(cfg.intermediate_size),
        online_had_o=rsq.rotate, norms_fused=rsq.rotate)


def _calibration_attn_mask(rsq: RSQConfig, cfg: ModelConfig, L: int, dev):
    """The custom calibration attention (block / window / sink / ss) as an
    additive mask with causality, kept for the Hessian and output passes;
    None for plain causal attention (the model picks the chunked kernel for
    long sequences).  The reference adds its (L, L) masks to None and
    raises; here every custom mask gets the causal one added."""
    wcfg = rsq.weighting
    if wcfg is None or wcfg.custom_attn_type in (None, "topk"):
        return None
    cmask = calibration_mask(wcfg, L, cfg.num_attention_heads, dev)
    return torch.clamp(cmask + M.causal_mask(L, dev),
                       min=torch.finfo(torch.float32).min)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def quantize_model(params, cfg: ModelConfig, rsq: RSQConfig, calib_ids,
                   device="cuda", stats: dict | None = None):
    """Run the RSQ pipeline on `device`.

    params: the model's param tree (not mutated); calib_ids: (N, L) ints.
    Returns (new_params, quantizers): new_params parked on the host,
    quantizers {"layers.<i>.<name>": {scale, zero, bits}} with host
    tensors.  Under rsq.e8p each projection goes through LDLQ+E8P
    (ldlq_quantize, bits as bits_for gives them, as the reference records
    them) and its entry also holds "codes" (rows, in/8) int32: the
    reference keeps only scale, zero and bits, so its checkpoints never
    reach the E8P serving route; the port's do (ROADMAP section 3).  stats,
    when given, is filled with seconds per stage ("rotate_s", and per layer
    "weighting_s", "hessian_s", "gptq_s" and "gptq_s_by_proj", the
    quantizer's seconds whichever it is), the device synchronized before
    each reading."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    rng = np.random.default_rng(rsq.seed)

    def clock():
        if stats is not None:
            _sync(dev)
        return time.perf_counter()

    params = tree_to(params, "cpu")
    if rsq.rotate:
        t0 = clock()
        params, _ = rotation.rotate_model(params, cfg, mode=rsq.rotate_mode,
                                          seed=rsq.rotation_seed, device=dev)
        if stats is not None:
            stats["rotate_s"] = clock() - t0
        logger.info("rotation applied (mode=%s)", rsq.rotate_mode)

    calib_ids = np.asarray(calib_ids)[: rsq.nsamples]
    n, L = calib_ids.shape
    policy = _calibration_policy(rsq, cfg)
    cos, sin = family.pos_tables(cfg, torch.arange(L, device=dev))
    mask = _calibration_attn_mask(rsq, cfg, L, dev)
    token_freq = token_frequencies(calib_ids)
    inps = family.embed(params, torch.from_numpy(calib_ids).long(), cfg)

    # the sample shuffle, from the reference's generator
    perm = torch.from_numpy(rng.permutation(n))
    inps = inps[perm].to(dev)
    token_freq = token_freq[perm].to(dev)

    quantizers, new_layers, layer_stats = {}, [], []
    for i, lp in enumerate(params["layers"]):
        t_layer = clock()
        lp = tree_to(lp, dev)
        st = {"layer": i, "gptq_s_by_proj": {}}
        batch_w = None
        if rsq.weighting is not None:
            batch_w = torch.cat([
                _chunk_weights(lp, inps[j:j + CHUNK], cos, sin, cfg, policy,
                               mask, token_freq[j:j + CHUNK], rsq.weighting,
                               layer=i)
                for j in range(0, n, CHUNK)])
        t0 = clock()
        st["weighting_s"] = t0 - t_layer
        st["hessian_s"] = 0.0
        for group in family.groups_for(cfg):
            names = [g for g in group if rsq.bits_for(i, g) < 16]
            if not names:
                continue
            if batch_w is not None and rsq.weighting.applies_to(group):
                wts = batch_w / batch_w.mean(1, keepdim=True)
            else:
                wts = torch.ones((n, L), dtype=torch.float32, device=dev)
            d_in = lp[group[0]]["w"].shape[0]
            H = torch.zeros((d_in, d_in), dtype=torch.float32, device=dev)
            for j in range(0, n, CHUNK):
                _hessian_accumulate(H, lp, inps[j:j + CHUNK],
                                    wts[j:j + CHUNK], cos, sin, cfg, policy,
                                    group, mask, layer=i)
            H = H * (2.0 / n)
            t1 = clock()
            st["hessian_s"] += t1 - t0
            for name in names:
                bits = rsq.bits_for(i, name)
                wq = dataclasses.replace(rsq.w, bits=bits)
                Wt = lp[name]["w"].T          # GPTQ's (out, in)
                if rsq.e8p:
                    Qw, info = ldlq_quantize(
                        Wt, H, add_until_fail=rsq.gptq.add_until_fail,
                        device=dev)
                elif rsq.w_rtn:
                    Qw, info = rtn_quantize(Wt, wq, device=dev)
                else:
                    Qw, info = gptq_quantize(Wt, H, wq, rsq.gptq, device=dev)
                lp[name] = {"w": Qw.T.contiguous().to(lp[name]["w"].dtype),
                            "b": lp[name].get("b")}
                quantizers[f"layers.{i}.{name}"] = {
                    "scale": info["scale"].cpu(), "zero": info["zero"].cpu(),
                    "bits": bits}
                if "codes" in info:
                    # port-only: the reference drops the codes here
                    quantizers[f"layers.{i}.{name}"]["codes"] = \
                        info["codes"].cpu()
                t2 = clock()
                st["gptq_s_by_proj"][name] = t2 - t1
                t1 = t2
            del H
            t0 = clock()
        st["gptq_s"] = sum(st["gptq_s_by_proj"].values())
        # this layer's outputs under its quantized weights: the next inputs
        for j in range(0, n, CHUNK):
            inps[j:j + CHUNK] = _layer_out(lp, inps[j:j + CHUNK], cos, sin,
                                           cfg, policy, mask, layer=i)
        new_layers.append(tree_to(lp, "cpu"))
        del lp
        st["layer_s"] = clock() - t_layer
        layer_stats.append(st)
        logger.info("layer %d quantized in %.1fs", i, st["layer_s"])

    if stats is not None:
        stats["layers"] = layer_stats
    new_params = dict(params)
    new_params["layers"] = new_layers
    logger.info("quantization time: %.1fs", time.perf_counter() - t_start)
    return new_params, quantizers
