"""Rounding-exact helpers shared by the plain PyTorch versions.

Two kinds of scalar division appear in the reference, and they round
differently:

- Under jit, XLA's algebraic simplifier rewrites a division by a constant
  (`x / 7.0`, `x / math.sqrt(n)`) into a multiplication by the constant's
  f32 reciprocal.  Every reference function on the serving path runs
  jitted, so the port reproduces that with `div_const`, and the CUDA
  kernels take the same f32 reciprocals as arguments.
- Outside jit (e.g. quantize_lm_head on host params) the division is a true
  IEEE division: `div`.  PyTorch's CUDA division by a Python scalar would
  multiply by the reciprocal instead, so `div` divides by a 0-dim tensor on
  the operand's own device.
"""

from __future__ import annotations

import numpy as np
import torch


def recip_f32(c: float) -> float:
    """The f32 reciprocal XLA folds a division by the constant c into."""
    return float(np.float32(1.0) / np.float32(c))


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as the reference computes it under jit: x * f32(1/c)."""
    return x * recip_f32(c)


def folded_mul_div(c: float, d: float) -> float:
    """The one f32 constant XLA folds `* c / d` into: f32(f32(c) * f32(1/d))
    (the CUDA kernels take it as an argument)."""
    return float(np.float32(c) * np.float32(recip_f32(d)))


def mul_div_const(x: torch.Tensor, c: float, d: float) -> torch.Tensor:
    """x * c / d as the reference computes it under jit: XLA folds the two
    constants into one, x * f32(f32(c) * f32(1/d))."""
    return x * folded_mul_div(c, d)


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s with IEEE division in x's dtype, on any device."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)
