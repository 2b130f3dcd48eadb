"""Serving parameter conversion (the port of rsq_tpu.serving.params), plus
the bridge that carries the JAX package's serving pytree across.

Serving linear params: {"wp": uint8 (K, N/2) planar, "scale": f32 (N,),
"b": bf16 (N,) | None}; fuse_for_decode re-packs them plane-major
({"wp2", "scales2", "bs"} for fused q/k/v and up/gate, {"wpm", "scale2",
"b"} for o and down).  E8P (2-bit) linears are re-encoded losslessly to
affine int4, {"wp", "sh": f32 (), "b"} with w = (q + 0.5) * sh; they are
never fused and become {"wpm", "sh", "b"}.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rsq_tpu_torch import resolve_device
from rsq_tpu_torch.kernels.matmul_w4 import pack_w4_planar, unpack_w4_planar
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.quantize.ldlq import e8p_codes_to_int4

QUANT_NAMES = ("q", "k", "v", "o", "up", "gate", "down")


def _tensor(a, device, dtype=None):
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else to_tensor(np.asarray(a), device)
    return t.to(device=device, dtype=dtype or t.dtype)


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, bit for bit (bfloat16 arrays, as numpy holds them for
    JAX, travel through a uint16 view)."""
    a = np.array(a, order="C")           # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_numpy_params(tree, device="cuda"):
    """Carry a pytree of arrays (the JAX serving params or page pool; each
    leaf goes through np.asarray) onto `device` as torch tensors, bit for bit.
    Dicts, lists and None leaves keep their structure."""
    dev = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return to_tensor(np.asarray(x), dev)

    return conv(tree)


def pack_linear(p, scale_rows, device):
    """p: {"w": (K, N), "b"} fake-quant weights; scale_rows: (N,) or (N, 1)
    per-output-channel scale.  codes = clip(round(W / scale), -8, 7)."""
    scale = _tensor(scale_rows, device, torch.float32).reshape(-1)
    W = _tensor(p["w"], device, torch.float32)
    codes = torch.clamp(torch.round(W / scale[None, :]), -8, 7).to(torch.int8)
    b = p.get("b")
    return {"wp": pack_w4_planar(codes), "scale": scale,
            "b": None if b is None else _tensor(b, device, torch.bfloat16)}


def unpack_linear(sp):
    """Serving params -> dense dequantized (K, N) f32 weights (test oracle)."""
    return unpack_w4_planar(sp["wp"]).float() * sp["scale"][None, :]


def pack_linear_e8p(p, qinfo, device):
    """E8P serving params: codes (N, K/8) re-encoded losslessly to planar
    int4 with a constant +0.5 offset, w = (q + 0.5) * sh with sh =
    f32(scale) * 0.5 (ldlq.e8p_codes_to_int4), served by the affine-W4
    kernel at 4 bits per weight.  The codes are decoded on `device`."""
    dev = resolve_device(device)
    q = e8p_codes_to_int4(_tensor(qinfo["codes"], dev))   # (N, K) int4 values
    scale = _tensor(qinfo["scale"], dev, torch.float32).reshape(())
    b = p.get("b")
    return {"wp": pack_w4_planar(q.T.contiguous()),     # (K, N/2)
            "sh": scale * 0.5,
            "b": None if b is None else _tensor(b, dev, torch.bfloat16)}


def plane_scales(scale: torch.Tensor) -> torch.Tensor:
    """(N,) natural per-output scales -> (2, N/2) plane-major."""
    return scale.reshape(2, scale.shape[-1] // 2)


def repack_plane_major(wp: torch.Tensor) -> torch.Tensor:
    """Adjacent-planar packed uint8 (K, Nh) -> plane-major: byte j holds
    natural outputs j (low nibble) and j + Nh (high nibble), so the paired
    kernel output (M, 2, Nh) un-pairs with a reshape."""
    w = unpack_w4_planar(wp).to(torch.int16)
    u = torch.where(w < 0, w + 16, w).to(torch.uint8)
    nh = u.shape[-1] // 2
    return u[..., :nh] | (u[..., nh:] << 4)


def _fuse_packed(ps):
    """Concatenate packed linears (same K) along the packed-output axis,
    each segment re-packed plane-major."""
    return {
        "wp2": torch.cat([repack_plane_major(p["wp"]) for p in ps], dim=1),
        "scales2": [plane_scales(p["scale"]) for p in ps],
        "bs": [p.get("b") for p in ps],
    }


def fuse_for_decode(params):
    """Fuse q/k/v and up/gate into single plane-major kernel calls and
    convert the other packed linears to plane-major ("wpm").  E8P affine
    entries ("wp" + "sh", no "scale") never fuse: the paired kernel would
    drop their +0.5 offset; they become {"wpm", "sh", "b"}."""
    out = dict(params)
    layers = []
    for lp in params["layers"]:
        def packed(n):
            return (n in lp and "wp" in lp[n] and "scale" in lp[n]
                    and "sh" not in lp[n])

        nlp = dict(lp)
        if all(packed(n) for n in ("q", "k", "v")):
            nlp["qkv"] = _fuse_packed([lp["q"], lp["k"], lp["v"]])
            for n in ("q", "k", "v"):
                del nlp[n]
        if all(packed(n) for n in ("up", "gate")):
            nlp["upgate"] = _fuse_packed([lp["up"], lp["gate"]])
            for n in ("up", "gate"):
                del nlp[n]
        for name in list(nlp):
            e = nlp[name]
            if not (isinstance(e, dict) and "wp" in e):
                continue
            if "sh" in e:
                nlp[name] = {"wpm": repack_plane_major(e["wp"]),
                             "sh": e["sh"], "b": e.get("b")}
            elif "scale" in e:
                nlp[name] = {"wpm": repack_plane_major(e["wp"]),
                             "scale2": plane_scales(e["scale"]),
                             "b": e.get("b")}
        layers.append(nlp)
    out["layers"] = layers
    return out


def to_serving_params(params, quantizers, cfg: ModelConfig,
                      dtype=torch.bfloat16, device="cuda"):
    """Fake-quant model pytree (numpy arrays or tensors) + quantizer info ->
    packed serving pytree on `device`.  4-bit quantizer entries pack, E8P
    entries (with "codes") re-encode to affine int4; layers without one
    stay dense."""
    dev = resolve_device(device)
    out = {
        "embed": _tensor(params["embed"], dev, dtype),
        "final_norm": _tensor(params["final_norm"], dev, dtype),
        "lm_head": _tensor(params["lm_head"], dev, dtype),
        "layers": [],
    }
    for i, lp in enumerate(params["layers"]):
        slp = {name: _tensor(lp.get(name), dev, dtype)
               for name in ("input_norm", "post_norm")}
        for name in QUANT_NAMES:
            qinfo = quantizers.get(f"layers.{i}.{name}")
            if qinfo is not None and "codes" in qinfo:
                slp[name] = pack_linear_e8p(lp[name], qinfo, dev)
            elif qinfo is not None and qinfo["bits"] == 4:
                slp[name] = pack_linear(lp[name], qinfo["scale"], dev)
            else:
                slp[name] = {"w": _tensor(lp[name]["w"], dev, dtype),
                             "b": _tensor(lp[name].get("b"), dev, dtype)}
        out["layers"].append(slp)
    return out


def random_serving_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Stacked serving params with random plane-major packed weights, made
    on `device` from a seeded torch.Generator (the port's counterpart of
    bench.py's build_int4_params): no norms, fused qkv/up-gate, o/down
    plane-major, bf16 embedding with lm_head = embed.T (dense; quantize it
    with serving.model.quantize_lm_head)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    L = cfg.num_layers
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def bits(k, nh):
        return torch.randint(0, 256, (L, k, nh), dtype=torch.uint8,
                             generator=g, device=dev)

    def scales2(n, k):
        u = torch.rand((L, 2, n // 2), generator=g, device=dev)
        return (u + 0.5) / (7 * math.sqrt(k))

    def fused(k, ns):
        return {"wp2": bits(k, sum(ns) // 2),
                "scales2": [scales2(n, k) for n in ns], "bs": [None] * len(ns)}

    def plain(k, n):
        return {"wpm": bits(k, n // 2), "scale2": scales2(n, k), "b": None}

    stacked = {
        "input_norm": None, "post_norm": None,
        "qkv": fused(d, (cfg.q_dim, cfg.kv_dim, cfg.kv_dim)),
        "o": plain(cfg.q_dim, d),
        "upgate": fused(d, (f, f)), "down": plain(f, d),
    }
    emb = (torch.randn((v, d), generator=g, device=dev) * 0.01).to(torch.bfloat16)
    return {"embed": emb, "final_norm": None, "lm_head": emb.T.contiguous(),
            "layers_stacked": stacked}


def random_dense_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Stacked dense bf16 serving params made on `device` from a seeded
    torch.Generator (the port's counterpart of bench.py's
    build_bf16_params, the bf16 baseline): unfused q, k, v, o, up, gate,
    down as {"w": (L, K, N) bf16 at scale 0.1/sqrt(K), "b": None}, no
    norms, a bf16 embedding with lm_head = embed.T."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    L = cfg.num_layers
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def dense(k, n):
        w = torch.randn((L, k, n), generator=g, device=dev,
                        dtype=torch.bfloat16) * (0.1 / math.sqrt(k))
        return {"w": w, "b": None}

    stacked = {
        "input_norm": None, "post_norm": None,
        "q": dense(d, cfg.q_dim), "k": dense(d, cfg.kv_dim),
        "v": dense(d, cfg.kv_dim), "o": dense(cfg.q_dim, d),
        "up": dense(d, f), "gate": dense(d, f), "down": dense(f, d),
    }
    emb = (torch.randn((v, d), generator=g, device=dev) * 0.01).to(torch.bfloat16)
    return {"embed": emb, "final_norm": None, "lm_head": emb.T.contiguous(),
            "layers_stacked": stacked}
