"""QuaRot-style rotation as param-tree transforms (the port of
rsq_tpu.quantize.rotation), Llama family.

  fuse_norms   RMSNorm weights folded into the following linears, the
               embedding mean-centred; the norms become None (weightless).
  rotate       the global orthogonal Q on the embedding, lm_head and the
               residual-side dims of every linear, plus the exact Hadamards
               that pair with the forward's online transforms (per head on
               v's output, full on o's and down's input).
  post_rotate_after_load  only the exact-Hadamard part, for a checkpoint
               whose weights already hold Q.

The arithmetic is float64, as the reference's host numpy is, but on
`device` (the card unless the caller asks for the CPU): each tensor is
staged there, transformed, rounded to its own dtype after every transform
as the reference rounds, and parked back where it came from.  The linears
are (in, out), so with rotated activations a' = a Q the input side is
W' = Q^T W and the output side W' = W Q.
"""

from __future__ import annotations

import numpy as np
import torch

from rsq_tpu_torch import resolve_device, tree_to
from rsq_tpu_torch.core.hadamard import (
    get_orthogonal_matrix, hadU_supported, matmul_hadU_f64)
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.models.family import module_for

__all__ = ["fuse_norms", "rotate", "post_rotate_after_load", "rotate_model"]


def _set(p, key, x64):
    """p[key] = x64 rounded to p[key]'s dtype (it stays on x64's device)."""
    p[key] = x64.to(p[key].dtype)


def _fuse_layer(lp):
    """q/k/v rows times input_norm, up/gate rows times post_norm."""
    for norm, names in (("input_norm", ("q", "k", "v")),
                        ("post_norm", ("up", "gate"))):
        nw = lp[norm].double()
        for n in names:
            _set(lp[n], "w", lp[n]["w"].double() * nw[:, None])
        lp[norm] = None


def _rot_in(p, Q):
    _set(p, "w", Q.T @ p["w"].double())


def _rot_out(p, Q):
    _set(p, "w", p["w"].double() @ Q)
    if p.get("b") is not None:
        _set(p, "b", p["b"].double() @ Q)


def _had_in(p):
    """The exact Hadamard on the input dim (pairs with an online one)."""
    _set(p, "w", matmul_hadU_f64(p["w"].double().T).T)


def _had_out_per_head(p, head_dim: int):
    """Per-head exact Hadamard on the output dim (v_proj)."""
    W = p["w"].double()
    i, o = W.shape
    _set(p, "w", matmul_hadU_f64(W.reshape(i, o // head_dim, head_dim))
         .reshape(i, o))
    if p.get("b") is not None:
        _set(p, "b", matmul_hadU_f64(
            p["b"].double().reshape(o // head_dim, head_dim)).reshape(o))


def _had_layer(lp, cfg: ModelConfig):
    if hadU_supported(cfg.intermediate_size):
        _had_in(lp["down"])             # pairs with the online full Hadamard
    _had_out_per_head(lp["v"], cfg.head_dim_)
    _had_in(lp["o"])                    # pairs with the head-mixing one


def _rotate_layer(lp, cfg: ModelConfig, Q):
    for n in ("q", "k", "v", "up", "gate"):
        _rot_in(lp[n], Q)
    _rot_out(lp["o"], Q)
    _rot_out(lp["down"], Q)
    _had_layer(lp, cfg)


def _layers(params, dev, *steps):
    """Each layer staged on dev, the steps applied, parked back."""
    out = []
    for lp in params["layers"]:
        home = lp["q"]["w"].device
        lp = tree_to(lp, dev)
        for step in steps:
            step(lp)
        out.append(tree_to(lp, home))
    return out


def _embed(params, dev, Q=None, centre=False):
    E = params["embed"]
    x = E.to(dev, torch.float64)
    if centre:
        x = (x - x.mean(-1, keepdim=True)).to(E.dtype).double()
    if Q is not None:
        x = x @ Q
    return x.to(E.dtype).to(E.device)


def _lm_head(params, dev, Q=None, norm=None):
    W = params["lm_head"]
    x = W.to(dev, torch.float64)
    if norm is not None:
        x = (x * norm.to(dev, torch.float64)[:, None]).to(W.dtype).double()
    if Q is not None:
        x = Q.T @ x
    return x.to(W.dtype).to(W.device)


def fuse_norms(params, cfg: ModelConfig, device="cuda"):
    """A new param tree with every RMSNorm weight folded into the linears
    after it and the embedding mean-centred; input_norm, post_norm and
    final_norm become None."""
    module_for(cfg)
    dev = resolve_device(device)
    out = dict(params)
    out["embed"] = _embed(params, dev, centre=True)
    out["layers"] = _layers(params, dev, _fuse_layer)
    out["lm_head"] = _lm_head(params, dev, norm=params["final_norm"])
    out["final_norm"] = None
    return out


def rotate(params, cfg: ModelConfig, Q: np.ndarray, device="cuda"):
    """The global rotation Q and the exact Hadamards, on fused params."""
    module_for(cfg)
    dev = resolve_device(device)
    Qt = torch.as_tensor(Q, dtype=torch.float64, device=dev)
    out = dict(params)
    out["embed"] = _embed(params, dev, Q=Qt)
    out["lm_head"] = _lm_head(params, dev, Q=Qt)
    out["layers"] = _layers(params, dev,
                            lambda lp: _rotate_layer(lp, cfg, Qt))
    return out


def post_rotate_after_load(params, cfg: ModelConfig, device="cuda"):
    """The load path: Q is baked into the saved weights, so only the
    exact-Hadamard parts are applied again."""
    module_for(cfg)
    out = dict(params)
    out["layers"] = _layers(params, resolve_device(device),
                            lambda lp: _had_layer(lp, cfg))
    return out


def rotate_model(params, cfg: ModelConfig, mode: str = "hadamard",
                 seed: int = 0, device="cuda"):
    """fuse_norms then rotate with a fresh random orthogonal Q (a random
    Hadamard unless the hidden size has none), one tensor at a time on
    `device`.  Returns (params', Q), Q the float64 numpy matrix."""
    module_for(cfg)
    dev = resolve_device(device)
    if mode == "hadamard" and not hadU_supported(cfg.hidden_size):
        mode = "random"
    Q = get_orthogonal_matrix(cfg.hidden_size, mode=mode, seed=seed)
    Qt = torch.as_tensor(Q, dtype=torch.float64, device=dev)
    out = dict(params)
    out["embed"] = _embed(params, dev, Q=Qt, centre=True)
    out["lm_head"] = _lm_head(params, dev, Q=Qt, norm=params["final_norm"])
    out["final_norm"] = None
    out["layers"] = _layers(params, dev, _fuse_layer,
                            lambda lp: _rotate_layer(lp, cfg, Qt))
    del Qt
    return out, Q
