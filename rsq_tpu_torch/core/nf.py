"""NormalFloat (NF-k) quantization (the port of rsq_tpu.core.nf).

Codebook: the inverse Gaussian CDF at evenly spaced quantiles clipped at
the NF4 offset, with 2^(k-1)-1 negative and 2^(k-1) nonnegative levels,
built on the host in float64 as the reference builds it; quantization
buckets against the midpoints between levels.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rsq_tpu_torch.core.numerics import div

NF_OFFSET = 0.9677083


@functools.lru_cache(maxsize=None)
def nf_codebook(bits: int) -> np.ndarray:
    """Quantile-of-Gaussian code values, float64."""
    from scipy.special import erfinv, ndtri
    sigma = -1.0 / (math.sqrt(2) * erfinv(1 - 2 * NF_OFFSET))
    left = np.linspace(1 - NF_OFFSET, 0.5, 2 ** (bits - 1))
    right = np.linspace(0.5, NF_OFFSET, 2 ** (bits - 1) + 1)
    q = np.concatenate([left[:-1], right])
    return (ndtri(q) * sigma).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _boundaries(bits: int) -> np.ndarray:
    v = nf_codebook(bits)
    return ((v[1:] + v[:-1]) / 2.0).astype(np.float64)


def grid_max(bits: int) -> float:
    v = nf_codebook(bits)
    return float(max(abs(v[0]), v[-1]))


def nf_quant(x, bits: int, scale):
    """x -> integer codes (indices into the codebook), int32."""
    b = torch.as_tensor(_boundaries(bits), dtype=torch.float32,
                        device=x.device)
    xs = x.float() / scale
    return torch.searchsorted(b, xs.contiguous(), right=False).to(torch.int32)


def nf_dequant(codes, bits: int, scale):
    v = torch.as_tensor(nf_codebook(bits), dtype=torch.float32,
                        device=codes.device)
    return v[codes.long()] * scale


def nf_quant_dequant(x, bits: int, scale):
    return nf_dequant(nf_quant(x, bits, scale), bits, scale)


def nf_find_scale(W, bits: int):
    """Per-row scale absmax / grid_max, (rows, 1) (a true division: the
    reference runs this outside jit)."""
    Wf = W.float()
    xmin = torch.clamp(Wf.amin(1), max=0.0)
    xmax = torch.clamp(Wf.amax(1), min=0.0)
    amax = torch.clamp(torch.maximum(xmin.abs(), xmax), min=1e-5)
    return div(amax, grid_max(bits))[:, None]
