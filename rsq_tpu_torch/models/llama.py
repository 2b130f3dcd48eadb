"""Llama building blocks used by the serving path (the port of the serving
parts of rsq_tpu.models.llama).  Layouts follow the reference: activations
(batch, seq, heads, head_dim), weights (in, out)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rsq_tpu_torch.core.numerics import div_const
from rsq_tpu_torch.models.config import ModelConfig


def rms_norm(x, weight, eps):
    """RMSNorm in f32; weight=None is the weightless RMSN used after
    rotation fusion."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    if weight is not None:
        xf = xf * weight.float()
    return xf.to(x.dtype)


def rope_frequencies(cfg: ModelConfig) -> np.ndarray:
    """Inverse frequencies, with optional Llama-3.1 scaling."""
    hd = cfg.head_dim_
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    s = cfg.rope_scaling
    if s is not None:
        low_wl = s.original_max_position_embeddings / s.low_freq_factor
        high_wl = s.original_max_position_embeddings / s.high_freq_factor
        wl = 2 * np.pi / inv
        smooth = (s.original_max_position_embeddings / wl - s.low_freq_factor) / (
            s.high_freq_factor - s.low_freq_factor)
        inv = np.where(wl > low_wl, inv / s.factor,
                       np.where(wl < high_wl, inv,
                                (1 - smooth) * inv / s.factor + smooth * inv))
    return inv.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rope_inv(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    """rope_frequencies on `device`, uploaded once (not once per step)."""
    return torch.as_tensor(rope_frequencies(cfg), device=device)


def rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin of shape (len(positions), head_dim), HF half-split layout."""
    inv = _rope_inv(cfg, positions.device)
    angles = positions.float()[:, None] * inv[None, :]
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x, cos, sin):
    """Rotate-half RoPE in f32, cast back. x: (..., seq, heads, head_dim);
    cos/sin: (seq, head_dim)."""
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * c + rotated.float() * s).to(x.dtype)


def repeat_kv(x, n_rep: int):
    """(b, s, kv_heads, d) -> (b, s, kv_heads*n_rep, d)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def causal_mask(seq_len: int, device, dtype=torch.float32):
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    return torch.where(j <= i, 0.0, torch.finfo(dtype).min).to(dtype)


def attention_dense(q, k, v, mask):
    """softmax(q k^T / sqrt(d) + mask) v with f32 scores.  Plain products on
    purpose: scaled_dot_product_attention rounds differently."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(div_const(logits, math.sqrt(d)) + mask, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(v.dtype)


def attention_chunked(q, k, v, q_chunk: int = 512, k_chunk: int = 1024):
    """Causal flash-style attention without the (H, L, L) score matrix:
    query chunks, online softmax over key chunks (f32)."""
    b, s, h, d = q.shape
    qc, kc = min(q_chunk, s), min(k_chunk, s)
    sm = 1.0 / math.sqrt(d)
    out = torch.empty(b, s, h, d, dtype=v.dtype, device=q.device)
    neg = torch.finfo(torch.float32).min
    for q0 in range(0, s, qc):
        qf = q[:, q0:q0 + qc].float() * sm
        nq = qf.shape[1]
        m = torch.full((b, h, nq), -math.inf, device=q.device)
        l = torch.zeros((b, h, nq), device=q.device)
        acc = torch.zeros((b, h, nq, d), device=q.device)
        qpos = q0 + torch.arange(nq, device=q.device)[:, None]
        for k0 in range(0, min(q0 + nq, s), kc):
            kb = k[:, k0:k0 + kc].float()
            vb = v[:, k0:k0 + kc].float()
            logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
            kpos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            logits = torch.where(kpos <= qpos, logits, neg)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                        p, vb)
            m = m_new
        res = acc / l[..., None].clamp_min(1e-30)
        out[:, q0:q0 + nq] = res.transpose(1, 2).to(v.dtype)
    return out


def attention(q, k, v, mask=None, chunk_threshold: int = 2048):
    """mask=None: plain causal (chunked from `chunk_threshold` on, dense
    below).  An explicit mask always takes the dense path."""
    s = q.shape[1]
    if mask is not None:
        return attention_dense(q, k, v, mask)
    if s < chunk_threshold:
        return attention_dense(q, k, v, causal_mask(s, q.device))
    return attention_chunked(q, k, v)
