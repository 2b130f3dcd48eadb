"""GPTQ: Hessian accumulation and the blocked column solver (the port of
rsq_tpu.quantize.gptq).

- Hessian: H = (2/N) sum_j X_j^T diag(w_j / mean(w_j)) X_j in f32.
- Inverse factor: the torch chain the reference's own source takes,
  cholesky -> cholesky_inverse -> cholesky(upper), with damping
  percdamp * mean(diag H) and, under add_until_fail, k-fold damping retried
  until the factor exists (torch.linalg.cholesky_ex reports the failure).
  Nothing falls back to another device.
- Solver: a Python loop over column blocks and, inside each, over columns,
  as the upstream GPTQ runs it (the reference's lax.scan/fori_loop), with
  act-order and groups re-estimated from the block-start weights.  The
  column loop queues a few small kernels per column: on the card it is
  bound by the host.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from rsq_tpu_torch import resolve_device
from rsq_tpu_torch.core.quant import (
    WeightQuantConfig, asym_quant_dequant, minq_maxq, sym_quant_dequant,
    weight_fake_quant, weight_quant_params)

logger = logging.getLogger(__name__)


def hessian_from_inputs(xs, weighting=None):
    """H = (2/N) sum_j X_j^T diag(w_j) X_j over samples, f32 on the inputs'
    device.  xs: (N, L, d) or a list of (L, d); weighting (N, L) or None,
    each sample's weights normalized to mean 1 first."""
    n, d = len(xs), xs[0].shape[-1]
    H = torch.zeros((d, d), dtype=torch.float32, device=xs[0].device)
    for j in range(n):
        x = xs[j].float()
        if weighting is not None:
            w = weighting[j].float()
            x = x * torch.sqrt(w / w.mean())[:, None]
        H.addmm_(x.T, x)
    return H * (2.0 / n)


def prepare_hinv(H, percdamp: float = 0.01, add_until_fail: bool = False,
                 max_tries: int = 50):
    """Dead columns (zero diagonal) get a unit diagonal, then damping and
    the upper factor U with H^-1 = U^T U.  Returns (U, dead); the solver
    zeroes the weights of dead columns."""
    H = H.float().clone()
    diag = H.diagonal()
    dead = diag == 0
    diag[dead] = 1.0
    damp = percdamp * diag.mean()
    for k in range(1, (max_tries if add_until_fail else 1) + 1):
        Htry = H.clone()
        Htry.diagonal().add_(k * damp)
        L, info = torch.linalg.cholesky_ex(Htry)
        del Htry
        if int(info) == 0:
            U, info = torch.linalg.cholesky_ex(torch.cholesky_inverse(L),
                                               upper=True)
            if int(info) == 0 and bool(torch.isfinite(U).all()):
                if k > 1:
                    logger.warning("cholesky needed %d extra dampings", k)
                return U, dead
    raise FloatingPointError("cholesky failed even with extra damping")


@dataclasses.dataclass(frozen=True)
class GPTQConfig:
    blocksize: int = 128
    groupsize: int = -1
    actorder: bool = False
    percdamp: float = 0.01
    add_until_fail: bool = False


def _quant_dq(w, scale, zero, wq: WeightQuantConfig):
    """Quantize-dequantize one column (rows,) with per-row params."""
    if wq.nf:
        from rsq_tpu_torch.core.nf import nf_quant_dequant
        return nf_quant_dequant(w, wq.bits, scale)
    _, maxq = minq_maxq(wq.bits, wq.sym)
    if wq.sym:
        return sym_quant_dequant(w, scale, maxq)
    return asym_quant_dequant(w, scale, zero, maxq)


def _gptq_solve(W, U, scale, zero, wq: WeightQuantConfig, blocksize: int,
                groupsize: int):
    """W (rows, cols) f32 with cols a multiple of blocksize, updated in
    place; U the upper factor of H^-1.  Returns (Q, losses, scale, zero),
    Q the dequantized weights.  Group params come from the group's columns
    as of the start of their block (the reference's dynamic groups), a
    group reaching past the block taken from its last `groupsize` columns,
    as the reference's clamped slice does.  losses[:, c] = err_c^2 / 2,
    err_c = (w_c - q_c) / U[c, c]."""
    rows, cols = W.shape
    if groupsize > blocksize:
        raise ValueError(f"groupsize {groupsize} > blocksize {blocksize}")
    Q = torch.empty_like(W)
    losses = torch.empty_like(W)
    for i1 in range(0, cols, blocksize):
        i2 = i1 + blocksize
        W1 = W[:, i1:i2].clone()
        W1_start = W1.clone() if groupsize > 0 else None
        Err1 = torch.empty_like(W1)
        U1 = U[i1:i2, i1:i2]
        for i in range(blocksize):
            if groupsize > 0 and (i1 + i) % groupsize == 0:
                s0 = min(i, blocksize - groupsize)
                s, z = weight_quant_params(W1_start[:, s0:s0 + groupsize], wq)
                scale, zero = s[:, 0], z[:, 0]
            w = W1[:, i]
            q = _quant_dq(w, scale, zero, wq)
            err = (w - q) / U1[i, i]
            W1[:, i:].addr_(err, U1[i, i:], alpha=-1.0)
            Q[:, i1 + i] = q
            Err1[:, i] = err
        losses[:, i1:i2] = Err1 * Err1 / 2.0
        if i2 < cols:
            W[:, i2:].addmm_(Err1, U[i1:i2, i2:], alpha=-1.0)
    return Q, losses, scale, zero


def gptq_quantize(W, H, wq: WeightQuantConfig, cfg: GPTQConfig = GPTQConfig(),
                  device="cuda"):
    """Quantize W (out_features, in_features) against the Hessian H (in, in)
    on `device`.  Returns (Q, info): Q the dequantized weights in W's
    dtype, on `device`; info {scale, zero, losses}.  Act-order permutes the
    columns by decreasing diag(H) (stable order among equal entries)."""
    dev = resolve_device(device)
    orig_dtype = W.dtype
    Wf = W.to(dev, torch.float32, copy=True)
    H = H.to(dev, torch.float32)
    rows, cols = Wf.shape
    if cfg.groupsize <= 0:
        scale, zero = weight_quant_params(Wf, wq)
        scale0, zero0 = scale[:, 0], zero[:, 0]
    else:
        scale0 = torch.ones(rows, dtype=torch.float32, device=dev)
        zero0 = torch.zeros(rows, dtype=torch.float32, device=dev)

    perm = None
    if cfg.actorder:
        dead = H.diagonal() == 0
        perm = torch.argsort(-H.diagonal(), stable=True)
        Wf[:, dead] = 0.0
        Wf = Wf[:, perm]
        U, _ = prepare_hinv(H[perm][:, perm], cfg.percdamp,
                            cfg.add_until_fail)
    else:
        U, dead = prepare_hinv(H, cfg.percdamp, cfg.add_until_fail)
        Wf[:, dead] = 0.0
    del H

    pad = (-cols) % cfg.blocksize
    if pad:
        Wf = torch.nn.functional.pad(Wf, (0, pad))
        U = torch.nn.functional.pad(U, (0, pad, 0, pad))
        U.diagonal()[cols:] = 1.0

    Q, losses, scale, zero = _gptq_solve(Wf, U, scale0, zero0, wq,
                                         cfg.blocksize, cfg.groupsize)
    Q, losses = Q[:, :cols], losses[:, :cols]
    if perm is not None:
        invperm = torch.argsort(perm)
        Q, losses = Q[:, invperm], losses[:, invperm]
    if not bool(torch.isfinite(Q).all()):
        raise ValueError("NaN in quantized weights")
    return Q.to(orig_dtype), {"scale": scale, "zero": zero, "losses": losses}


def rtn_quantize(W, wq: WeightQuantConfig, device="cuda"):
    """Round-to-nearest with the per-row params (the reference's rtn_fwrd)."""
    W = W.to(resolve_device(device))
    scale, zero = weight_quant_params(W, wq)
    return weight_fake_quant(W, scale, zero, wq), {"scale": scale,
                                                   "zero": zero}


def quant_error(W, Q, H) -> float:
    """tr((W - Q) H (W - Q)^T), the objective GPTQ minimizes."""
    E = (W - Q).float()
    return float(((E @ H.float()) * E).sum())
