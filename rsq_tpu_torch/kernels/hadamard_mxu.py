"""Two-factor Hadamard transform (the port of rsq_tpu.kernels.hadamard_mxu).

H_n = H_A (x) H_B with B a power of two <= 256: y = H_A . X . H_B as two
small dense products on the (rows, A, B) view.  The reference evaluates
them as XLA einsums (no Pallas kernel), so here they are torch matmuls.
Used for the down-projection's online Hadamard (n = 14336 = 56 * 256 at
Llama-3-8B, with the K=28 Paley block inside H_A).
"""

from __future__ import annotations

import functools
import math

import torch

from rsq_tpu_torch.core.hadamard import get_hadK, hadamard_matrix, is_pow2
from rsq_tpu_torch.core.numerics import div_const


@functools.lru_cache(maxsize=None)
def _split(n: int) -> tuple[int, int]:
    """n = A * B with B a power of two <= 256 and H_A constructible."""
    K, _ = get_hadK(n)
    pow2 = n // K
    B = min(pow2, 256)
    while B > 1 and not is_pow2(B):
        B //= 2
    return n // B, B


@functools.lru_cache(maxsize=None)
def _factors(n: int, dtype: torch.dtype, device: torch.device):
    """(A, B, H_A, H_B) with the +-1 factors as tensors on `device`, made
    once: an upload per call would be a blocking host-to-device copy that
    stops the host from queueing work ahead of the card."""
    A, B = _split(n)
    HA = torch.as_tensor(hadamard_matrix(A), dtype=dtype, device=device)
    HB = (torch.as_tensor(hadamard_matrix(B), dtype=dtype, device=device)
          if B > 1 else None)
    return A, B, HA, HB


def hadamard_transform(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Orthonormal Hadamard over the last axis (same operator as
    matmul_hadU).  bf16 input takes the reference's fast path: +-1 factors,
    f32 accumulation per factor, and a bf16 round-trip BETWEEN the two
    factors (hadamard_mxu.py:64-81); other dtypes run both factors in the
    compute dtype.  f32 products run in full f32 (TF32 stays off)."""
    n = x.shape[-1]
    if dtype is None and x.dtype == torch.bfloat16:
        A, B, HA, HB = _factors(n, torch.float32, x.device)
        xf = x.reshape(*x.shape[:-1], A, B)
        if HB is not None:
            xf = (xf.float() @ HB).to(torch.bfloat16)
        xf = HA @ xf.float()
        return div_const(xf.reshape(x.shape), math.sqrt(n)).to(x.dtype)
    compute_dtype = dtype or (torch.float32 if x.dtype != torch.float64
                              else x.dtype)
    A, B, HA, HB = _factors(n, compute_dtype, x.device)
    xf = x.to(compute_dtype).reshape(*x.shape[:-1], A, B)
    if HB is not None:
        xf = xf @ HB
    xf = HA @ xf
    return div_const(xf.reshape(x.shape), math.sqrt(n)).to(x.dtype)
