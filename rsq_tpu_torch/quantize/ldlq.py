"""LDLQ adaptive rounding with the E8P lattice codebook, the 2-bit path
(the port of rsq_tpu.quantize.ldlq).

The codebook is 2^16 8-dim points built from the E8 lattice: the D8 "abs
grid" of half-integer vectors with norm^2 <= 10 plus 29 norm-12 vectors,
expanded by sign patterns with a parity bit and a +-1/4 coset shift
(ldlq_utils.py:23-113 of the method's reference).  Every grid value is an
odd multiple of 1/4 in [-11/4, 11/4], so a code decodes losslessly to
signed int4 as v = (q + 0.5) / 2: the serving re-encoding that lets the
affine-W4 kernel serve E8P weights at 4 bits each
(kernels.matmul_w4.w4_affine_matmul_stacked).  Construction is host numpy,
once; the tables go to each device once.

LDLQ (ldlq_quantize): W / scale (one per-tensor scale) is rounded 8
columns at a time, right to left, through a block-LDL factorization of
the Hessian (block_ldl), then `quip_tune_iters` refinement passes each
re-round every block against the Hessian-weighted residual
(ldlq_utils.py:281-320).  Each block is rounded by the two-coset
nearest-codeword search (quantize_e8p): one (rows, 8) x (8, 1366) product
per coset, both cosets in one batch.  Plain tensor code in float32 on the
caller's device: the scan is a Python loop over blocks, a few dozen small
launches a block, so on the card it is bound by the host and by the
residual's bytes (the reference's jitted fori_loop holds no Pallas kernel
either).  The returned info carries the codes, and quantize_model keeps
them (ROADMAP section 3, port-only behaviour): serving.params then serves
the checkpoint on the affine-W4 rows.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from rsq_tpu_torch import resolve_device

CODESZ = 8
_E8P_SCALE = 1.03


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
def search_grids():
    """(grid_part (1366, 8), its squared norms, part_abs_map, abs_odd), f64
    and host numpy: the codebook's parity points shifted +1/4, kept in the
    canonical sign region (at most one negative among the first 7, min >=
    -0.5), each mapped to its abs-grid row; abs_odd marks the abs rows of
    odd sum (ldlq_utils.py:185-208)."""
    ag = abs_grid()
    full, parity = _full_grid()
    gp = full[parity] + 0.25
    sel = ((gp[:, :7] < 0).sum(-1) <= 1) & (gp[:, :7].min(-1) >= -0.5)
    gp = gp[sel]
    gp_norm = (gp ** 2).sum(-1)
    d = 2 * np.abs(gp) @ ag.T - (ag ** 2).sum(-1)[None, :]
    part_abs_map = d.argmax(-1)
    abs_odd = ag.sum(-1) % 2 == 1
    return gp, gp_norm, part_abs_map, abs_odd


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


@functools.lru_cache(maxsize=None)
def _search_on(device: torch.device):
    """search_grids' tables on `device` as the search reads them (f32
    grid and norms, int64 map, bool parity), plus the sign-bit order and
    the bit weights, uploaded once."""
    gp, gpn, pam, odd = search_grids()
    t = functools.partial(torch.as_tensor, device=device)
    return (t(gp, dtype=torch.float32), t(gpn, dtype=torch.float32),
            t(pam, dtype=torch.int64), t(odd),
            t([0, 2, 4, 6, 1, 3, 5, 7], dtype=torch.int64),
            t([1 << i for i in range(CODESZ)], dtype=torch.int64))


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


# ---------------------------------------------------------------------------
# Nearest-codeword search
# ---------------------------------------------------------------------------

def quantize_e8p(X: torch.Tensor):
    """Round the rows of X (rows, 8) f32 to the E8P codebook with the
    two-coset search (ldlq_utils.py:246-279): each coset (X + 1/4, X - 1/4)
    is folded into the canonical sign region, rounded to grid_part by
    argmax 2 x.g - |g|^2, unfolded, and the nearer of the two wins (the
    minus coset on a tie).  Returns (values f32, codes int32), on X's
    device."""
    gp, gpn, pam, odd, order, bits = _search_on(X.device)
    Xs = torch.stack([X + 0.25, X - 0.25])          # (2, rows, 8)
    neg = Xs < 0
    flip = torch.where(neg.sum(-1) % 2 != 0, -1.0, 1.0)
    Xa = Xs.abs()
    Xa[..., 7] *= flip
    mask = 1 - 2 * neg.float()
    mask[..., 7] *= flip
    idx = torch.argmax(2.0 * Xa @ gp.T - gpn, dim=-1)
    rounded = gp[idx]
    vals = rounded * mask
    err = torch.linalg.vector_norm(Xs - vals, dim=-1)
    absi = pam[idx]
    sign = ((rounded < 0) ^ (mask < 0))[..., order]
    sign[..., 7] ^= odd[absi]
    sign[0, :, 0] ^= True                            # the +1/4 coset's parity
    codes = (absi << 8) + (sign * bits).sum(-1)
    plus = (err[0] < err[1])
    vals = torch.where(plus[:, None], vals[0] - 0.25, vals[1] + 0.25)
    return vals, torch.where(plus, codes[0], codes[1]).to(torch.int32)


# ---------------------------------------------------------------------------
# Block-LDL and LDLQ
# ---------------------------------------------------------------------------

def block_ldl(H: torch.Tensor, b: int, percdamp: float = 0.01,
              add_until_fail: bool = True, max_tries: int = 50):
    """H = L D L^T with L unit block-lower-triangular in blocks of b
    (ldlq_utils.py:116-150), f32 on H's device.  The damping percdamp *
    mean(diag H) is added to the diagonal once per try (cumulatively),
    up to max_tries under add_until_fail, until the Cholesky factor C
    exists; then D_i = C_ii C_ii^T and L = C with each block column times
    C_ii^-1.  Returns (L (n, n), D (n/b, b, b))."""
    n = H.shape[0]
    m = n // b
    Hj = H.float().clone()
    damp = percdamp * Hj.diagonal().mean()
    for _ in range(max_tries if add_until_fail else 1):
        Hj.diagonal().add_(damp)
        C, info = torch.linalg.cholesky_ex(Hj)
        if int(info) == 0 and bool(torch.isfinite(C).all()):
            break
    else:
        raise FloatingPointError("block_ldl: cholesky failed")
    DL = torch.stack([C[i * b:(i + 1) * b, i * b:(i + 1) * b]
                      for i in range(m)])           # (m, b, b)
    D = DL @ DL.transpose(1, 2)
    L = torch.einsum("nmb,mbc->nmc", C.reshape(n, m, b),
                     torch.linalg.inv(DL)).reshape(n, n)
    return L, D


def _ldlq_scan(Wr, Hr, L, quip_tune_iters: int = 10):
    """One backward pass over the n/8 blocks, right to left, then
    quip_tune_iters refinement passes; returns (hatWr (rows, n), codes
    (rows, n/8) int32).

    Backward pass: block k's target is its own columns plus the residual
    of the blocks to its right through L's rows below the block,
    Wr[:, c] + (Wr - hatWr)[:, c0+8:] @ L[c0+8:, c].  The reference
    multiplies the whole residual by L's column block masked to those
    rows; only they are read here, which roughly halves the bytes of the
    pass.  Refinement: hatWr[:, c] + ((Wr - hatWr) @ H[:, c]) @ H[c, c]^-1,
    the block inverses taken once for all passes (the reference takes them
    at every step)."""
    rows, n = Wr.shape
    m = n // CODESZ
    hatWr = torch.zeros_like(Wr)
    codes = torch.zeros((rows, m), dtype=torch.int32, device=Wr.device)
    for k in range(m - 1, -1, -1):
        c0, c1 = k * CODESZ, (k + 1) * CODESZ
        target = Wr[:, c0:c1] + (Wr[:, c1:] - hatWr[:, c1:]) @ L[c1:, c0:c1]
        hatWr[:, c0:c1], codes[:, k] = quantize_e8p(target)
    if quip_tune_iters:
        Hinv = torch.linalg.inv(torch.stack(
            [Hr[i * CODESZ:(i + 1) * CODESZ, i * CODESZ:(i + 1) * CODESZ]
             for i in range(m)]))
    for _ in range(quip_tune_iters):
        for k in range(m - 1, -1, -1):
            c0, c1 = k * CODESZ, (k + 1) * CODESZ
            target = hatWr[:, c0:c1] + ((Wr - hatWr) @ Hr[:, c0:c1]) @ Hinv[k]
            hatWr[:, c0:c1], codes[:, k] = quantize_e8p(target)
    return hatWr, codes


def e8p_scale(W: torch.Tensor, scale_override: float = 0.9) -> torch.Tensor:
    """Per-tensor scale ||W||_F / sqrt(numel) / override, with 1.03 when
    override <= 0 (E8PWeightQuantizer.find_params, ldlq_utils.py:427-441);
    a 0-d f32 tensor.  The norm is summed in float64 and rounded once, so
    the CPU and the card agree whatever order their reductions take (an
    f32 sum of a 256 x 1024 weight's squares differs between them by
    2e-6 relative)."""
    W64 = W.double()
    s = torch.linalg.vector_norm(W64) / math.sqrt(W64.numel())
    return (s / (scale_override if scale_override > 0 else _E8P_SCALE)
            ).float()


def ldlq_quantize(W, H, *, percdamp: float = 0.01, add_until_fail: bool = True,
                  quip_tune_iters: int = 10, scale_override: float = 0.9,
                  device="cuda"):
    """LDLQ+E8P quantization of W (rows, cols), cols a multiple of 8,
    against the Hessian H (cols, cols) on `device` (the counterpart of
    LDLQ.fasterquant, ldlq_utils.py:330-367).  Dead columns (zero diagonal)
    get a unit diagonal and zero weights.  Returns (Q, info): Q = hatW *
    scale in W's dtype on `device`, info {"scale": 0-d f32, "zero": 0-d
    f64 zero, "codes": (rows, cols/8) int32}, with Q == e8p_dequantize(
    codes, scale) bit for bit in f32."""
    dev = resolve_device(device)
    orig_dtype = W.dtype
    rows, cols = W.shape
    if cols % CODESZ:
        raise ValueError("in_features must be a multiple of 8 for E8P")
    Wf = W.to(dev, torch.float32, copy=True)
    Hf = H.to(dev, torch.float32, copy=True)
    diag = Hf.diagonal()
    dead = diag == 0
    diag[dead] = 1.0
    Wf[:, dead] = 0.0
    scale = e8p_scale(Wf, scale_override)
    L, _ = block_ldl(Hf, CODESZ, percdamp, add_until_fail)
    hatWr, codes = _ldlq_scan(Wf / scale, Hf, L,
                              quip_tune_iters=quip_tune_iters)
    Q = (hatWr * scale).to(orig_dtype)
    if not bool(torch.isfinite(Q).all()):
        raise ValueError("NaN in E8P-quantized weights")
    return Q, {"scale": scale,
               "zero": torch.zeros((), dtype=torch.float64, device=dev),
               "codes": codes}
