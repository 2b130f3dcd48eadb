"""The E8P lattice codebook of the 2-bit LDLQ path, as serving needs it
(the port of the codebook half of rsq_tpu.quantize.ldlq).

The codebook is 2^16 8-dim points built from the E8 lattice: the D8 "abs
grid" of half-integer vectors with norm^2 <= 10 plus 29 norm-12 vectors,
expanded by sign patterns with a parity bit and a +-1/4 coset shift
(ldlq_utils.py:23-113 of the method's reference).  Every grid value is an
odd multiple of 1/4 in [-11/4, 11/4], so a code decodes losslessly to
signed int4 as v = (q + 0.5) / 2: the serving re-encoding that lets the
affine-W4 kernel serve E8P weights at 4 bits each
(kernels.matmul_w4.w4_affine_matmul_stacked).

Construction is host numpy, once.  LDLQ itself (block_ldl, the rounding
scan, ldlq_quantize) is not here yet: it comes with the quantization
pipeline.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

CODESZ = 8


def _norm12() -> np.ndarray:
    """The 29 norm-12 E8+1/4 representatives: sign-permutation classes of
    |v| in {1/2, 3/2}^8 with six 3/2's, in the reference's order."""
    rows = [
        [3, 1, 1, 1, 3, 3, 3, 3], [1, 3, 1, 1, 3, 3, 3, 3],
        [1, 1, 3, 1, 3, 3, 3, 3], [1, 1, 1, 3, 3, 3, 3, 3],
        [3, 3, 3, 1, 3, 3, 1, 1], [3, 3, 3, 1, 3, 1, 3, 1],
        [3, 3, 3, 1, 1, 3, 3, 1], [3, 3, 3, 1, 3, 1, 1, 3],
        [3, 3, 3, 1, 1, 3, 1, 3], [3, 3, 3, 1, 1, 1, 3, 3],
        [3, 3, 1, 3, 3, 3, 1, 1], [3, 3, 1, 3, 3, 1, 3, 1],
        [3, 3, 1, 3, 1, 3, 3, 1], [3, 3, 1, 3, 3, 1, 1, 3],
        [3, 3, 1, 3, 1, 3, 1, 3], [3, 3, 1, 3, 1, 1, 3, 3],
        [3, 1, 3, 3, 3, 3, 1, 1], [3, 1, 3, 3, 3, 1, 3, 1],
        [3, 1, 3, 3, 1, 3, 3, 1], [3, 1, 3, 3, 3, 1, 1, 3],
        [3, 1, 3, 3, 1, 3, 1, 3], [1, 3, 3, 3, 1, 1, 3, 3],
        [1, 3, 3, 3, 3, 3, 1, 1], [1, 3, 3, 3, 3, 1, 3, 1],
        [1, 3, 3, 3, 1, 3, 3, 1], [1, 3, 3, 3, 3, 1, 1, 3],
        [1, 3, 3, 3, 1, 3, 1, 3], [1, 1, 3, 3, 1, 3, 3, 3],
        [3, 3, 1, 1, 3, 3, 3, 1],
    ]
    return np.asarray(rows, dtype=np.float64) / 2.0


@functools.lru_cache(maxsize=1)
def abs_grid() -> np.ndarray:
    """(256, 8): the distinct |.| patterns of D8+1/2 points with even sum
    and norm^2 <= 10, in ascending row order, then the 29 norm-12 rows.

    Every entry of such a point is +-{1/2, 3/2, 5/2, 7/2}, and flipping one
    sign moves the sum by an odd integer, so every magnitude pattern has an
    even-sum signing: the patterns are exactly the magnitude vectors with
    norm^2 <= 10.  Enumerated in lexicographic order, they come out sorted
    as the reference's unique-of-all-points does (4^8 rows, not 8^8)."""
    mags = np.array(list(itertools.product((0.5, 1.5, 2.5, 3.5),
                                           repeat=CODESZ)))
    d8abs = mags[(mags ** 2).sum(-1) <= 10]
    return np.concatenate([d8abs, _norm12()], axis=0)


@functools.lru_cache(maxsize=1)
def _full_grid():
    """The 2^16-entry codebook (65536, 8) f64 and its parity mask: code =
    (abs index << 8) | sign bits, decoded as the reference packs it
    (columns permuted [0,2,4,6,1,3,5,7], the 8th sign flipped on odd-sum
    rows, a parity bit folded into the signs, +-1/4 coset shift)."""
    ag = abs_grid()
    cba = ag[:, [0, 2, 4, 6, 1, 3, 5, 7]].copy()
    cba[:, 7] *= 1 - 2 * (cba.sum(1) % 2)
    codes = np.arange(1 << 16)
    signs = codes & 255
    absi = codes >> 8
    parity = np.zeros_like(signs)
    for i in range(8):
        parity ^= (signs >> i) & 1
    signs = signs ^ parity
    shuffle = [0, 4, 1, 5, 2, 6, 3, 7]
    vals = np.zeros((1 << 16, 8))
    for i in range(8):
        ii = shuffle[i]
        v = cba[absi, ii]
        s = ((signs >> ii) & 1).astype(bool)
        vals[:, i] = np.where(s, -v, v)
    vals += np.where(parity[:, None], -0.25, 0.25)
    return vals, parity.astype(bool)


def e8p_grid() -> np.ndarray:
    return _full_grid()[0]


@functools.lru_cache(maxsize=1)
def _affine_int4_table() -> np.ndarray:
    """(65536, 8) int8: each code's values as signed int4, v = (q + 0.5)/2
    with q = (4v - 1)/2 in [-6, 5].  Lossless."""
    q4 = np.round(e8p_grid() * 4.0).astype(np.int32)   # odd integers
    return ((q4 - 1) // 2).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _table_on(name: str, device: torch.device) -> torch.Tensor:
    """A codebook table on `device`, uploaded once (a copy per call would
    be a blocking host-to-device transfer)."""
    if name == "grid":
        return torch.as_tensor(e8p_grid(), dtype=torch.float32, device=device)
    return torch.as_tensor(_affine_int4_table(), device=device)


def _codes_tensor(codes) -> torch.Tensor:
    """Codes as int64 indices; numpy input lands on the CPU."""
    if isinstance(codes, torch.Tensor):
        return codes.to(torch.int64)
    return torch.from_numpy(np.asarray(codes).astype(np.int64))


def e8p_codes_to_int4(codes) -> torch.Tensor:
    """codes (rows, cols/8) -> signed int4 values q (rows, cols) int8, such
    that the dequantized weight is exactly (q + 0.5) * (scale / 2).  A
    tensor is decoded on its own device, numpy input on the CPU."""
    c = _codes_tensor(codes)
    q = _table_on("int4", c.device)[c]                  # (rows, m, 8)
    return q.reshape(q.shape[0], -1)


def e8p_dequantize(codes, scale) -> torch.Tensor:
    """Grid lookup dequantization (rows, cols/8) -> (rows, cols) f32, times
    the per-tensor scale (a float or a 0-d tensor)."""
    c = _codes_tensor(codes)
    vals = _table_on("grid", c.device)[c]               # (rows, m, 8)
    s = torch.as_tensor(scale, dtype=torch.float32, device=c.device)
    return vals.reshape(vals.shape[0], -1) * s
