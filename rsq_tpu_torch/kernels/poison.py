"""Poisoned caches for checking the INT4 attention kernels: every byte a
kernel must not read is 0xFF (codes) or NaN (parameters), so a stray read
shows as NaN in its output, which must still equal the plain version on
the clean cache.  Used by chip_smoke.py and tests/test_torch_cuda.py."""

import math

import torch


def poisoned(arrays, live):
    """Copies of (kq, kp, vq, vp) with every cell outside the mask `live`
    (broadcast over the layer, head and D/2-or-2 axes) poisoned."""
    return [torch.where(live, a, torch.full((), 255 if a.dtype == torch.uint8
                                            else math.nan, dtype=a.dtype,
                                            device=a.device))
            for a in arrays]


def slots_live(lengths, S, keep=0):
    """Contiguous cache (L, B, H, x, S): the first lengths[b] + keep
    columns of each row (keep = 1 spares the column an append writes)."""
    pos = torch.arange(S, device=lengths.device)
    return (pos[None, :] < lengths.long()[:, None] + keep)[None, :, None,
                                                           None, :]


def pages_live(ptab, lengths, P, page, keep=0):
    """Page pool (L, P, H, x, page): the cells holding tokens t <
    lengths[b] + keep of each row b through its table; every page no table
    names, and every other cell, is poisoned."""
    t = torch.arange(ptab.shape[1] * page, device=ptab.device)
    valid = t[None, :] < lengths.long()[:, None] + keep
    pid = ptab.long()[:, t // page]
    col = (t % page).expand_as(pid)
    live = torch.zeros((P, page), dtype=torch.bool, device=ptab.device)
    live[pid[valid], col[valid]] = True
    return live[None, :, None, None, :]
