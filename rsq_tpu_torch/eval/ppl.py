"""Perplexity over a long token stream (the port of rsq_tpu.eval.ppl): the
stream cut into (nsamples, val_seqlen) rows, mean NLL over rows, exp.
`ppl_fullmodel` runs the whole forward per batch with the model on the
device; `ppl_streamed` keeps every batch's activations on the host and
stages one layer at a time.  Both go through models/family.py, so each
family builds its own causal mask (Gemma-2's windowed on even layers;
OPT's learned positions instead of RoPE tables).  The pipeline-parallel `ppl_pp` waits for
ROADMAP item 17."""

from __future__ import annotations

import logging

import numpy as np
import torch

from rsq_tpu_torch import resolve_device, tree_to
from rsq_tpu_torch.models import family as F
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.models.policy import QuantPolicy

logger = logging.getLogger(__name__)


def _nll(logits, ids):
    """Mean next-token NLL per row of (b, L) ids, as a host numpy array."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, ids[:, 1:, None])[..., 0]
    return nll.mean(1).cpu().numpy()


def _rows(token_stream, val_seqlen: int):
    stream = np.asarray(token_stream).reshape(-1)
    nsamples = stream.size // val_seqlen
    return stream[: nsamples * val_seqlen].reshape(nsamples, val_seqlen)


def ppl_fullmodel(params, cfg: ModelConfig, policy: QuantPolicy,
                  token_stream, val_seqlen: int, bsz: int = 8,
                  device="cuda") -> float:
    """PPL with the whole model on `device`; token_stream 1-D ints.  A
    ragged last batch is kept, as in the reference."""
    dev = resolve_device(device)
    ids = _rows(token_stream, val_seqlen)
    nsamples = len(ids)
    params = tree_to(params, dev)
    batches = list(range(0, nsamples - nsamples % bsz, bsz))
    rem = nsamples % bsz
    spans = [(s, s + bsz) for s in batches]
    if rem and nsamples >= bsz or (rem and not spans):
        spans.append((nsamples - rem, nsamples))
    nlls = []
    with torch.no_grad():
        for a, b in spans:
            batch = torch.from_numpy(ids[a:b]).long().to(dev)
            nlls.append(_nll(F.forward(params, batch, cfg, policy), batch))
    ppl = float(np.exp(np.concatenate(nlls).mean()))
    logger.info("PPL: %.3f", ppl)
    return ppl


def ppl_streamed(params, cfg: ModelConfig, policy: QuantPolicy,
                 token_stream, val_seqlen: int, bsz: int = 8,
                 device="cuda") -> float:
    """Layer-streamed PPL: all batches' activations stay on the host while
    one layer at a time runs on `device` (the big-model path)."""
    dev = resolve_device(device)
    ids = _rows(token_stream, val_seqlen)
    batches = [torch.from_numpy(ids[s: s + bsz]).long()
               for s in range(0, len(ids), bsz)]
    cos, sin = F.pos_tables(cfg, torch.arange(val_seqlen, device=dev))
    with torch.no_grad():
        acts = [F.embed(params, b, cfg) for b in batches]
        for i, lp in enumerate(params["layers"]):
            lp = tree_to(lp, dev)
            acts = [F.layer_forward(lp, a.to(dev), cos, sin, cfg, policy,
                                    layer=i).cpu() for a in acts]
        head = tree_to({k: v for k, v in params.items() if k != "layers"},
                       dev)
        nlls = [_nll(F.head(head, a.to(dev), cfg), b.to(dev))
                for a, b in zip(acts, batches)]
    ppl = float(np.exp(np.concatenate(nlls).mean()))
    logger.info("PPL (streamed): %.3f", ppl)
    return ppl
