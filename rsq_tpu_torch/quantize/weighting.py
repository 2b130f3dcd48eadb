"""Token-importance weighting, the "S" of RSQ (the port of
rsq_tpu.quantize.weighting): per-token weights for each calibration sample
from one of eight methods, then the shared post-processing (scale ->
reverse -> position normalize -> min-max -> mask / truncate / bin).

  attncon   attention each token receives, summed over heads and queries
  heuristic fixed chunk masks ("first_half", "0_8", ...)
  actnorm   L2 norm of the layer's input (or output)
  actdiff   ||out - in|| per token
  tokenfreq corpus frequency of the token
  tokensim  mean pairwise squared distance
  cluster   squared distance to the nearest k-means centroid
  dot       Gram-row sums

Samples are batched: a (b, L, d) chunk gives (b, L) weights.  attncon
holds the chunk's (b, heads, L, L) f32 probabilities at once (4.3 GB for
8 samples of 2048 tokens at 32 heads; 9.5 GB at Falcon-7B's 71).
attncon reads each family's own attention: its input norm, RoPE but on
OPT, Gemma-2's scale, softcap and windowed mask on even layers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rsq_tpu_torch.models import gemma2 as G
from rsq_tpu_torch.models import llama as M
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.models.opt import layer_norm
from rsq_tpu_torch.models.policy import QuantPolicy


@dataclasses.dataclass(frozen=True)
class WeightingConfig:
    method: str = "attncon"
    min_value: float = 1.0
    max_value: float = 3.0
    normalize: str | None = "default"   # None | linear | sqrt | default
    scale: str | None = None            # None | square | sqrt
    num_bins: int | None = None
    masking: float | None = None
    truncate: float | None = None
    quantile_value: float | None = None
    reverse: bool = False
    input_or_output: str = "input"
    n_clusters: int = 100
    method_type: str = "first_half"     # heuristic masks
    apply_module: str = "all"           # "all" or "|"-separated substrings
    custom_attn_type: str | None = None  # block | window | topk | sink | ss
    attn_length: int | None = None
    num_sink_token: int = 8

    def applies_to(self, group_names) -> bool:
        if self.apply_module == "all":
            return True
        return any(tok in name for tok in self.apply_module.split("|")
                   for name in group_names)


# ---------------------------------------------------------------------------
# Post-processing, over the last axis (one row per sample)
# ---------------------------------------------------------------------------

def _minmax_normalize(w, cfg: WeightingConfig):
    if cfg.quantile_value is not None:
        q_hi = max(cfg.quantile_value, 1 - cfg.quantile_value)
        lo, hi = (torch.quantile(w, q, dim=-1, keepdim=True)
                  for q in (1 - q_hi, q_hi))
    else:
        lo, hi = w.amin(-1, keepdim=True), w.amax(-1, keepdim=True)
    # constant weights map to min_value: after the Hessian's mean-1
    # normalization that is no weighting at all
    w = (w - lo) / torch.clamp(hi - lo, min=1e-20)
    w = w * (cfg.max_value - cfg.min_value) + cfg.min_value
    return torch.clamp(w, cfg.min_value, cfg.max_value)


def _bin_values(w, cfg: WeightingConfig):
    nb = cfg.num_bins
    qs = torch.linspace(0.0, 1.0, nb + 1, device=w.device)[1:-1]
    thresholds = torch.quantile(w, qs, dim=-1).T.contiguous()  # (b, nb-1)
    vlist = torch.linspace(cfg.min_value, cfg.max_value, nb, device=w.device)
    return vlist[torch.searchsorted(thresholds, w.contiguous(), right=False)]


def _smallest(w, frac: float):
    """Indices of the int(L * frac) smallest entries of each row, in the
    order a stable ascending sort gives them."""
    k = int(w.shape[-1] * frac)
    return torch.argsort(w, dim=-1, stable=True)[..., :k]


def postprocess(w, cfg: WeightingConfig):
    """scale -> reverse -> position normalize -> min-max -> mask / truncate
    / bin, on (..., L) weights."""
    w = w.float()
    L = w.shape[-1]
    if cfg.scale == "square":
        w = w ** 2
    elif cfg.scale == "sqrt":
        w = w ** 0.5
    if cfg.reverse:
        w = -w
    if cfg.normalize in ("linear", "sqrt"):
        denom = torch.arange(L, 0, -1, dtype=torch.float32, device=w.device)
        if cfg.normalize == "sqrt":
            denom = torch.sqrt(denom)
        w = _minmax_normalize(w / denom, cfg)
    elif cfg.normalize == "default":
        w = _minmax_normalize(w, cfg)
    if cfg.masking is not None:
        w = torch.ones_like(w).scatter(-1, _smallest(w, cfg.masking), 0.0)
    elif cfg.truncate is not None:
        w = w.scatter(-1, _smallest(w, cfg.truncate), 0.0)
    elif cfg.num_bins is not None:
        w = _bin_values(w, cfg)
    return w


# ---------------------------------------------------------------------------
# Calibration-time attention masks, on pre-softmax logits (..., L, L)
# ---------------------------------------------------------------------------

NEG = -1e30


def _ij(L: int, device):
    i = torch.arange(L, device=device)[:, None]
    return i, i.T


def _where(allowed):
    return torch.where(allowed, 0.0, NEG)


def block_attn_mask(L: int, n: int, device="cpu"):
    i, j = _ij(L, device)
    return _where((i // n == j // n) & (j <= i))


def window_attn_mask(L: int, n: int, device="cpu"):
    i, j = _ij(L, device)
    d = i - j
    return _where((d >= 0) & (d < n))


def sink_attn_mask(L: int, n: int, n_sink: int, device="cpu"):
    i, j = _ij(L, device)
    d = i - j
    return _where((d >= 0) & ((d < n - n_sink) | (j < n_sink)))


def shift_attn_mask(L: int, n: int, device="cpu"):
    """Rolled block mask (the second half of the heads under "ss"): block
    membership and causality both on the rolled indices, so a shifted
    block may span the sequence's wrap."""
    idx = torch.roll(torch.arange(L, device=device), n // 2)
    allowed = ((idx[:, None] // n == idx[None, :] // n)
               & (idx[:, None] >= idx[None, :]))
    return _where(allowed)


def apply_topk_to_logits(logits, k: int):
    """Keep the top-k logits of each query row (and the diagonal), mask
    the rest."""
    L = logits.shape[-1]
    kth = torch.kthvalue(logits, L - k + 1, dim=-1, keepdim=True).values
    eye = torch.eye(L, dtype=torch.bool, device=logits.device)
    return torch.where((logits >= kth) | eye, logits, NEG)


def calibration_mask(cfg: WeightingConfig, L: int, num_heads: int,
                     device="cpu"):
    """A per-head (H, L, L) or shared (L, L) mask, None for plain causal,
    "topk" for the top-k rule (applied to logits)."""
    t, n = cfg.custom_attn_type, cfg.attn_length
    if t is None:
        return None
    if t == "block":
        return block_attn_mask(L, n, device)
    if t == "window":
        return window_attn_mask(L, n, device)
    if t == "sink":
        return sink_attn_mask(L, n, cfg.num_sink_token, device)
    if t == "ss":
        half = num_heads // 2
        return torch.cat([
            block_attn_mask(L, n, device).expand(half, L, L),
            shift_attn_mask(L, n, device).expand(num_heads - half, L, L)])
    if t == "topk":
        return "topk"
    raise ValueError(f"unknown custom_attn_type {t}")


# ---------------------------------------------------------------------------
# k-means (Lloyd's, first-k initialization) for cluster weighting
# ---------------------------------------------------------------------------

def _sqdist(x, c):
    """Squared distances (..., N, k) in the reference's expansion."""
    return (-2 * x @ c.transpose(-1, -2) + (x * x).sum(-1)[..., :, None]
            + (c * c).sum(-1)[..., None, :])


def kmeans(x, k: int, iters: int = 30):
    """x: (..., N, D).  (assignments, centroids), initialized from the
    first k points."""
    c = x[..., :k, :]
    a = None
    for _ in range(iters):
        a = torch.argmin(_sqdist(x, c), dim=-1)
        onehot = torch.nn.functional.one_hot(a, k).to(x.dtype)
        counts = torch.clamp(onehot.sum(-2), min=1.0)
        c = (onehot.transpose(-1, -2) @ x) / counts[..., :, None]
    return a, c


# ---------------------------------------------------------------------------
# Methods
# ---------------------------------------------------------------------------

def _attention_received(lp, x, cfg: ModelConfig, wcfg: WeightingConfig,
                        layer: int = 0):
    """Attention each key receives, summed over queries and then over heads
    in head order, from the layer's own q/k after its input norm (the
    family's norm; RoPE but on OPT; Gemma-2's scale, softcap and the
    layer's windowed mask).  x: (b, L, d) -> (b, L)."""
    b, L, _ = x.shape
    hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, \
        cfg.num_key_value_heads
    if cfg.family in ("opt", "falcon"):
        h = layer_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
    elif cfg.family == "gemma2":
        h = G.rms_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
    else:
        h = M.rms_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
    q = M.linear(h, lp["q"]).reshape(b, L, nq, hd)
    k = M.linear(h, lp["k"]).reshape(b, L, nkv, hd)
    if cfg.family != "opt":
        cos, sin = M.rope_tables(cfg, torch.arange(L, device=x.device))
        q, k = M.apply_rope(q, cos, sin), M.apply_rope(k, cos, sin)
    k = M.repeat_kv(k, nq // nkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if cfg.family == "gemma2":
        logits = G._softcap(logits * G._scale(cfg), cfg.attn_logit_softcap)
        logits.add_(G._mask_for_layer(L, layer, cfg, x.device))
    else:
        logits.mul_(float(np.float32(1.0) / np.sqrt(np.float32(hd))))
        logits.add_(M.causal_mask(L, x.device))
    cmask = calibration_mask(wcfg, L, nq, x.device)
    if isinstance(cmask, str):
        logits = apply_topk_to_logits(logits, wcfg.attn_length)
    elif cmask is not None:
        logits.add_(cmask)
    received = torch.softmax(logits, dim=-1).sum(-2)            # (b, h, L)
    del logits
    total = torch.zeros((b, L), dtype=torch.float32, device=x.device)
    for i in range(nq):
        total = total + received[:, i]
    return total


def heuristic_weight(L: int, method_type: str, device="cpu"):
    """Binary chunk masks."""
    w = torch.zeros(L, dtype=torch.float32, device=device)
    if method_type == "first_half":
        w[L // 2:] = 1.0
        return w
    if method_type == "second_half":
        w[:L // 2] = 1.0
        return w
    parts = [int(n) for n in method_type.split("_")]
    per = L // parts.pop(-1)
    for p in parts:
        w[p * per:(p + 1) * per] = 1.0
    return w


def compute_sample_weight(lp, x, out, token_freq, cfg: ModelConfig,
                          policy: QuantPolicy, wcfg: WeightingConfig,
                          layer: int = 0):
    """Per-token weights for a chunk of samples: x / out (b, L, d) the
    layer's input and output, token_freq (b, L).  Returns (b, L)."""
    m = wcfg.method
    t = (x if wcfg.input_or_output == "input" else out).float()
    if m == "attncon":
        w = _attention_received(lp, x, cfg, wcfg, layer)
    elif m == "heuristic":
        return heuristic_weight(x.shape[-2], wcfg.method_type,
                                x.device).expand(x.shape[:-1]).clone()
    elif m == "actnorm":
        w = torch.linalg.vector_norm(t, dim=-1)
    elif m == "actdiff":
        w = torch.linalg.vector_norm(x.float() - out.float(), dim=-1)
    elif m == "tokenfreq":
        w = token_freq.float()
    elif m == "tokensim":
        sq = (t * t).sum(-1)
        w = (-2 * t @ t.transpose(-1, -2) + sq[..., :, None]
             + sq[..., None, :]).mean(-1)
    elif m == "cluster":
        _, c = kmeans(t, wcfg.n_clusters)
        w = _sqdist(t, c).amin(-1)
    elif m == "dot":
        w = (t @ t.transpose(-1, -2)).sum(-1)
    else:
        raise ValueError(f"unknown weighting method {m}")
    return postprocess(w, wcfg)


def compute_batch_weighting(lp, inps, outs, token_freqs, cfg: ModelConfig,
                            policy: QuantPolicy, wcfg: WeightingConfig):
    """Weights for every calibration sample, one at a time: (N, L)."""
    return torch.cat([compute_sample_weight(
        lp, inps[j:j + 1], outs[j:j + 1], token_freqs[j:j + 1], cfg, policy,
        wcfg) for j in range(len(inps))])


def token_frequencies(input_ids) -> torch.Tensor:
    """Corpus frequency of the token at each position, (N, L) int32."""
    ids = torch.as_tensor(np.asarray(input_ids)).long()
    counts = torch.bincount(ids.reshape(-1))
    return counts[ids].to(torch.int32)
