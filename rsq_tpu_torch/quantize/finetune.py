"""Per-layer QAT finetuning of quantizer parameters, and optionally of the
weights (the port of rsq_tpu.quantize.finetune, on torch.optim).

After GPTQ, each layer's quantizer scales / zeros and (straight-through)
float weights are optimized against the layer-output MSE, with optional
attention-matrix and output self-similarity losses, early stopping on a
validation split, and separate learning rates for the quantizer and the
weight parameters (fake_quant/optimizers.py:173-415 of the method's
reference).

The trainable state is {name: {"w_fp", "scale", "zero"}} of leaf tensors;
the straight-through estimators are x + (f(x) - x).detach(); the
reference's two optax learning-rate groups are two torch.optim.Adam
parameter groups, the weight group frozen (no gradient, learning rate 0)
when train_weights is False.  One optimizer step per training sample, as
the reference's scan over minibatches of one; the forward is the port's
fake-quant Llama layer (models.llama), on `device`.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from rsq_tpu_torch import resolve_device
from rsq_tpu_torch.core.numerics import div_const
from rsq_tpu_torch.core.quant import minq_maxq
from rsq_tpu_torch.models import llama as M
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.models.policy import QuantPolicy

logger = logging.getLogger(__name__)

_LINEARS = ("q", "k", "v", "o", "up", "gate", "down")


def round_ste(x):
    """round(x) forward, identity gradient."""
    return x + (torch.round(x) - x).detach()


def clamp_ste(x, lo, hi):
    """clamp(x, lo, hi) forward, identity gradient."""
    return x + (torch.clamp(x, lo, hi) - x).detach()


def qat_fake_quant(w_fp, scale, zero, bits: int, sym: bool):
    """Differentiable fake quantization (QATQuantizedWeights.forward,
    quant_utils.py:35-43): gradients flow to w_fp through the STEs and to
    scale / zero through the dequantizing product."""
    _, maxq = minq_maxq(bits, sym)
    if sym:
        q = clamp_ste(round_ste(w_fp / scale), -(maxq + 1), maxq)
        return scale * q
    q = clamp_ste(round_ste(w_fp / scale) + zero, 0, maxq)
    return scale * (q - zero)


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    quant_lr: float = 1e-4
    weight_lr: float = 1e-5
    max_epochs: int = 10
    early_stop: int = 3
    batch_size: int = 1
    train_weights: bool = True
    self_similarity_loss: bool = False
    # attention-matrix loss (optimizers.py:146-168): match the quantized
    # layer's attention to the unquantized layer's on the same inputs --
    # KL on probabilities (attn_loss_on_prob) or MSE on causal-valid logits
    attn_loss: bool = False
    attn_loss_on_prob: bool = True
    attn_loss_weight: float = 1.0
    val_fraction: float = 0.25


def _trainable_from_layer(lp, quantizers, layer_idx: int, device=None):
    """{name: {w_fp, scale, zero}} f32 leaves of the quantized linears (the
    scales and zeros per output channel, (out, 1)); a 0-d zero becomes
    zeros."""
    state = {}
    for name in _LINEARS:
        info = quantizers.get(f"layers.{layer_idx}.{name}")
        if info is None or info["bits"] >= 16:
            continue
        scale = torch.as_tensor(info["scale"], dtype=torch.float32,
                                device=device).reshape(-1, 1)
        zero = torch.as_tensor(info["zero"], dtype=torch.float32,
                               device=device)
        zero = zero.reshape(-1, 1) if zero.dim() else torch.zeros_like(scale)
        state[name] = {
            "w_fp": lp[name]["w"].to(device, torch.float32, copy=True),
            "scale": scale.clone(), "zero": zero.clone()}
    return state


def _apply_trainable(lp, state, quantizers, layer_idx: int):
    """Layer params with QAT-quantized weights from the trainable state
    (the scales are per OUTPUT channel: the columns of the (in, out)
    layout)."""
    out = dict(lp)
    for name, st in state.items():
        bits = quantizers[f"layers.{layer_idx}.{name}"]["bits"]
        wq = qat_fake_quant(st["w_fp"].T, st["scale"], st["zero"], bits,
                            sym=True).T
        out[name] = {"w": wq, "b": lp[name].get("b")}
    return out


def _tensor(x) -> torch.Tensor:
    """A tensor as it is, an array copied into one."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def finetune_layer(lp, quantizers, layer_idx: int, inps, targets,
                   cfg: ModelConfig, policy: QuantPolicy,
                   ft: FinetuneConfig = FinetuneConfig(), device="cuda"):
    """Optimize one layer against target outputs on `device`.

    inps / targets: (N, L, d) arrays or tensors (calibration inputs and the
    desired layer outputs, usually the pre-quantization ones); the last
    max(1, int(N * val_fraction)) samples are the validation split.
    Returns (new_lp, info): new_lp's quantized linears hold the best
    state's dequantized weights in their original dtype, on `device`;
    info {"val_loss": best validation loss} or {"skipped": True}."""
    dev = resolve_device(device)
    inps = _tensor(inps).to(dev, torch.float32)
    targets = _tensor(targets).to(dev, torch.float32)
    n, L = inps.shape[0], inps.shape[1]
    n_val = max(1, int(n * ft.val_fraction))
    n_train = n - n_val
    cos, sin = M.rope_tables(cfg, torch.arange(L, device=dev))
    mask = M.causal_mask(L, dev)
    lp = {k: ({kk: None if vv is None else _tensor(vv).to(dev)
               for kk, vv in v.items()} if isinstance(v, dict)
              else None if v is None else _tensor(v).to(dev))
          for k, v in lp.items()}

    state = _trainable_from_layer(lp, quantizers, layer_idx, dev)
    if not state:
        return lp, {"skipped": True}
    quant_params = [st[k] for st in state.values() for k in ("scale", "zero")]
    weight_params = [st["w_fp"] for st in state.values()]
    for p in quant_params:
        p.requires_grad_(True)
    for p in weight_params:
        p.requires_grad_(ft.train_weights)
    opt = torch.optim.Adam([
        {"params": quant_params, "lr": ft.quant_lr},
        {"params": weight_params,
         "lr": ft.weight_lr if ft.train_weights else 0.0}])

    def attn_logits(lyr, x):
        """(b, h, L, L) masked attention logits of a layer on input x."""
        h = M.rms_norm(x, lyr.get("input_norm"), cfg.rms_norm_eps)
        b = x.shape[0]
        hd, nq, nkv = (cfg.head_dim_, cfg.num_attention_heads,
                       cfg.num_key_value_heads)
        q = M.apply_rope(M.linear(h, lyr["q"]).reshape(b, L, nq, hd), cos, sin)
        k = M.apply_rope(M.linear(h, lyr["k"]).reshape(b, L, nkv, hd), cos,
                         sin)
        k = M.repeat_kv(k, nq // nkv)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        return div_const(logits, math.sqrt(hd)) + mask

    def loss_fn(x, y):
        qlp = _apply_trainable(lp, state, quantizers, layer_idx)
        pred = M.layer_forward(qlp, x, cos, sin, cfg, policy, mask)
        mse = torch.mean((pred.float() - y.float()) ** 2)
        extra = 0.0
        if ft.attn_loss:
            pl_ = attn_logits(qlp, x)
            with torch.no_grad():
                tl = attn_logits(lp, x)
            if ft.attn_loss_on_prob:
                # KLDivLoss(log_target=True): sum p_t (log p_t - log p_q)
                lp_q = torch.log_softmax(pl_, dim=-1)
                lp_t = torch.log_softmax(tl, dim=-1)
                extra = extra + torch.mean(
                    torch.sum(torch.exp(lp_t) * (lp_t - lp_q), dim=-1))
            else:
                valid = mask > -1e10
                diff = torch.where(valid, pl_ - tl, 0.0)
                extra = extra + (torch.sum(diff ** 2)
                                 / torch.clamp(valid.sum(), min=1)
                                 / (pl_.shape[0] * pl_.shape[1]))
        if ft.self_similarity_loss:
            pf, yf = pred.float(), y.float()
            ps = torch.einsum("bld,bmd->blm", pf, pf)
            ts = torch.einsum("bld,bmd->blm", yf, yf)
            triu = torch.triu(torch.ones((L, L), dtype=torch.bool,
                                         device=dev), diagonal=1)
            # replaces the attention term, as the reference's does
            extra = torch.mean(torch.where(triu[None], (ps - ts) ** 2, 0.0))
        return mse + ft.attn_loss_weight * extra

    def val_loss():
        with torch.no_grad():
            return float(torch.stack([loss_fn(inps[j:j + 1],
                                              targets[j:j + 1])
                                      for j in range(n_train, n)]).mean())

    def snapshot():
        return {name: {k: v.detach().clone() for k, v in st.items()}
                for name, st in state.items()}

    best_val, best_state, bad = val_loss(), snapshot(), 0
    for epoch in range(ft.max_epochs):
        losses = []
        for j in range(n_train):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(inps[j:j + 1], targets[j:j + 1])
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        v = val_loss()
        logger.info("layer %d finetune epoch %d: train %.3e val %.3e",
                    layer_idx, epoch, float(torch.stack(losses).mean()), v)
        if v < best_val:
            best_val, best_state, bad = v, snapshot(), 0
        else:
            bad += 1
            if bad >= ft.early_stop:
                break

    with torch.no_grad():
        new_lp = _apply_trainable(lp, best_state, quantizers, layer_idx)
    # plain dequantized weights in the original dtype
    for name in best_state:
        new_lp[name] = {"w": new_lp[name]["w"].to(lp[name]["w"].dtype),
                        "b": lp[name].get("b")}
    return new_lp, {"val_loss": best_val}
