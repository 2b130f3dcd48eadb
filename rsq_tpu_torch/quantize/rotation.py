"""QuaRot-style rotation as param-tree transforms (the port of
rsq_tpu.quantize.rotation).

  fuse_norms   norm weights folded into the following linears, the
               embeddings mean-centred; the norms become None (weightless
               RMSN).  The LayerNorm families (OPT, Falcon) fold the norm's
               bias into the linears' biases too, and bake the mean
               subtraction into the linears that write the residual (o and
               fc2) so the stream stays zero-mean; the final LayerNorm's
               bias becomes `lm_head_bias`.
  rotate       the global orthogonal Q on the embeddings (OPT's positions
               too), lm_head and the residual-side dims of every linear,
               plus the exact Hadamards that pair with the forward's online
               transforms: per head on v's output, full on o's input (per
               head on Falcon's, whose 71 heads admit no head-mixing one,
               so that pair is wholly offline) and on down's / fc2's input
               where the intermediate size has a Hadamard (falcon-7b's
               18176 has none).
  post_rotate_after_load  only the exact-Hadamard part, for a checkpoint
               whose weights already hold Q.

Gemma-2 is refused, as the reference refuses it: its post-sub-block norms
sit between each linear and the residual add, so no rotation commutes
through them.

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

__all__ = ["fuse_norms", "rotate", "post_rotate_after_load", "rotate_model"]


LN_FAMILIES = ("opt", "falcon")


def _refuse_gemma(cfg: ModelConfig):
    if cfg.family == "gemma2":
        raise NotImplementedError(
            "rotation is not supported for Gemma-2 (post-block norms block "
            "QuaRot fusion); quantize with rotate=False, matching the "
            "reference's fuse_layer_norms contract")


def _mlp_names(cfg: ModelConfig):
    """(input-side MLP linears, the output-side one)."""
    return (("fc1",), "fc2") if cfg.family in LN_FAMILIES \
        else (("up", "gate"), "down")


def _set(p, key, x64):
    """p[key] = x64 rounded to p[key]'s dtype (it stays on x64's device)."""
    p[key] = x64.to(p[key].dtype)


def _fuse_rms(p, nw):
    """RMSNorm fusion: W's rows times the norm's weight."""
    _set(p, "w", p["w"].double() * nw.double()[:, None])


def _fuse_affine(p, norm):
    """LayerNorm fusion: W's rows times w, b' = b + b_ln @ W (the W before
    scaling); a linear without a bias gets one."""
    W = p["w"].double()
    b = norm["b"].double() @ W
    if p.get("b") is not None:
        b = p["b"].double() + b
    _set(p, "w", W * norm["w"].double()[:, None])
    p["b"] = b.to(p["w"].dtype)


def _bake_mean_out(p):
    """Output-mean subtraction baked into a linear that writes the
    residual: W' = W (I - 11^T / d), the bias mean-subtracted too."""
    W = p["w"].double()
    _set(p, "w", W - W.mean(-1, keepdim=True))
    if p.get("b") is not None:
        b = p["b"].double()
        _set(p, "b", b - b.mean())


def _fuse_layer(lp, cfg: ModelConfig):
    """One layer's norms into its linears; both norms become None."""
    if cfg.family in LN_FAMILIES:
        attn_side = [lp["q"], lp["k"], lp["v"]]
        if cfg.family == "falcon" and lp.get("post_norm") is None:
            attn_side.append(lp["fc1"])     # falcon-7b: the MLP shares it
        else:
            _fuse_affine(lp["fc1"], lp["post_norm"])
        for p in attn_side:
            _fuse_affine(p, lp["input_norm"])
        _bake_mean_out(lp["o"])
        _bake_mean_out(lp["fc2"])
    else:
        for n in ("q", "k", "v"):
            _fuse_rms(lp[n], lp["input_norm"])
        for n in ("up", "gate"):
            _fuse_rms(lp[n], lp["post_norm"])
    lp["input_norm"] = None
    lp["post_norm"] = None


def _rot_in(p, Q):
    _set(p, "w", Q.T @ p["w"].double())


def _rot_out(p, Q):
    _set(p, "w", p["w"].double() @ Q)
    if p.get("b") is not None:
        _set(p, "b", p["b"].double() @ Q)


def _had_in(p):
    """The exact Hadamard on the input dim (pairs with an online one)."""
    _set(p, "w", matmul_hadU_f64(p["w"].double().T).T)


def _had_in_per_head(p, head_dim: int):
    """Per-head exact Hadamard on the input dim (Falcon's o): with v's
    per-head one on the output side, attn blockdiag(H) blockdiag(H) W_o =
    attn W_o, no online transform."""
    W = p["w"].double()
    i, o = W.shape
    _set(p, "w", matmul_hadU_f64(
        W.reshape(i // head_dim, head_dim, o).transpose(-1, -2))
        .transpose(-1, -2).reshape(i, o))


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
        _had_in(lp[_mlp_names(cfg)[1]])  # pairs with the online full one
    _had_out_per_head(lp["v"], cfg.head_dim_)
    if cfg.family == "falcon":
        _had_in_per_head(lp["o"], cfg.head_dim_)
    else:
        _had_in(lp["o"])                # pairs with the head-mixing one


def _rotate_layer(lp, cfg: ModelConfig, Q):
    mlp_in, mlp_out = _mlp_names(cfg)
    for n in ("q", "k", "v") + mlp_in:
        _rot_in(lp[n], Q)
    _rot_out(lp["o"], Q)
    _rot_out(lp[mlp_out], Q)
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


def _f64(t, dev):
    """t staged on dev in its own dtype, then widened there (a blocking
    host-to-card copy with a dtype change widens on the host: twice the
    bytes, and a host pass over a vocabulary-sized table)."""
    return t.to(dev).double()


def _embed(params, dev, key="embed", Q=None, centre=False):
    """An embedding table (token or OPT's positions): mean-centred and/or
    rotated, rounded after each."""
    E = params[key]
    x = _f64(E, dev)
    if centre:
        x = (x - x.mean(-1, keepdim=True)).to(E.dtype).double()
    if Q is not None:
        x = x @ Q
    return x.to(E.dtype).to(E.device)


def _embeddings(out, params, dev, Q=None, centre=False):
    for key in ("embed", "embed_pos"):
        if params.get(key) is not None:
            out[key] = _embed(params, dev, key, Q, centre)


def _lm_head(out, params, dev, Q=None, norm=None):
    """The lm_head with the final norm folded in (a LayerNorm's bias into
    lm_head_bias) and/or rotated on its input side."""
    W = params["lm_head"]
    x = _f64(W, dev)
    if isinstance(norm, dict):
        b = _f64(norm["b"], dev) @ x
        if params.get("lm_head_bias") is not None:
            b = _f64(params["lm_head_bias"], dev) + b
        out["lm_head_bias"] = b.to(W.dtype).to(W.device)
        x = (x * _f64(norm["w"], dev)[:, None]).to(W.dtype).double()
    elif norm is not None:
        x = (x * _f64(norm, dev)[:, None]).to(W.dtype).double()
    if Q is not None:
        x = Q.T @ x
    out["lm_head"] = x.to(W.dtype).to(W.device)


def fuse_norms(params, cfg: ModelConfig, device="cuda"):
    """A new param tree with every norm folded into the linears after it
    and the embeddings mean-centred; input_norm, post_norm and final_norm
    become None."""
    _refuse_gemma(cfg)
    dev = resolve_device(device)
    out = dict(params)
    _embeddings(out, params, dev, centre=True)
    out["layers"] = _layers(params, dev, lambda lp: _fuse_layer(lp, cfg))
    _lm_head(out, params, dev, norm=params["final_norm"])
    out["final_norm"] = None
    return out


def rotate(params, cfg: ModelConfig, Q: np.ndarray, device="cuda"):
    """The global rotation Q and the exact Hadamards, on fused params."""
    _refuse_gemma(cfg)
    dev = resolve_device(device)
    Qt = torch.as_tensor(Q, dtype=torch.float64, device=dev)
    out = dict(params)
    _embeddings(out, params, dev, Q=Qt)
    _lm_head(out, params, dev, Q=Qt)
    out["layers"] = _layers(params, dev,
                            lambda lp: _rotate_layer(lp, cfg, Qt))
    return out


def post_rotate_after_load(params, cfg: ModelConfig, device="cuda"):
    """The load path: Q is baked into the saved weights, so only the
    exact-Hadamard parts are applied again."""
    out = dict(params)
    out["layers"] = _layers(params, resolve_device(device),
                            lambda lp: _had_layer(lp, cfg))
    return out


def rotate_model(params, cfg: ModelConfig, mode: str = "hadamard",
                 seed: int = 0, device="cuda"):
    """fuse_norms then rotate with a fresh random orthogonal Q (a random
    Hadamard unless the hidden size has none, as falcon-7b's 4544 has
    not), one tensor at a time on `device`.  Returns (params', Q), Q the
    float64 numpy matrix.  Gemma-2 raises NotImplementedError."""
    _refuse_gemma(cfg)
    dev = resolve_device(device)
    if mode == "hadamard" and not hadU_supported(cfg.hidden_size):
        mode = "random"
    Q = get_orthogonal_matrix(cfg.hidden_size, mode=mode, seed=seed)
    Qt = torch.as_tensor(Q, dtype=torch.float64, device=dev)
    out = dict(params)
    _embeddings(out, params, dev, Q=Qt, centre=True)
    _lm_head(out, params, dev, Q=Qt, norm=params["final_norm"])
    out["final_norm"] = None
    out["layers"] = _layers(params, dev, lambda lp: _fuse_layer(lp, cfg),
                            lambda lp: _rotate_layer(lp, cfg, Qt))
    del Qt
    return out, Q
