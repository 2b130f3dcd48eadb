"""Hadamard transforms (the port's copy of rsq_tpu.core.hadamard).

Base matrices of order K (Paley I / Paley II over GF(p^k), Sylvester
doubling) are constructed with numpy -- copied here so the port imports
nothing of the JAX package -- and the transforms run on torch tensors.
Llama-3-8B's intermediate size 14336 = 28 * 512 puts the K=28 Paley II
block on the serving path (the down-projection's online Hadamard).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rsq_tpu_torch.core.numerics import div_const


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


# ---------------------------------------------------------------------------
# Finite-field arithmetic (small GF(p^k)) for the Paley constructions.
# ---------------------------------------------------------------------------

def _factor_prime_power(q: int) -> tuple[int, int]:
    for p in range(2, q + 1):
        if q % p == 0:
            k = 0
            m = q
            while m % p == 0:
                m //= p
                k += 1
            if m != 1:
                raise ValueError(f"{q} is not a prime power")
            return p, k
    raise ValueError(f"bad q={q}")


def _find_irreducible_poly(p: int, k: int) -> tuple[int, ...]:
    """Monic degree-k irreducible polynomial over GF(p), as coefficient tuple
    (c_0, ..., c_{k-1}) of x^k = -(c_0 + c_1 x + ... + c_{k-1} x^{k-1})."""
    # Brute force over monic polynomials; irreducible iff it has no divisor
    # of degree <= k//2.  For the tiny fields we need (p^k <= 343) trial
    # division over all monic polys of low degree is instant.
    def polys(deg):
        # all polynomials of exactly degree `deg` (monic not required)
        for coeffs in np.ndindex(*([p] * deg)):
            yield coeffs

    def polydivmod(a, b):
        # a, b lists little-endian; b monic-ized; returns remainder
        a = list(a)
        db, da = len(b) - 1, len(a) - 1
        inv_lead = pow(b[-1], p - 2, p) if b[-1] != 1 else 1
        while da >= db and any(a):
            coef = a[da] * inv_lead % p
            for i in range(db + 1):
                a[da - db + i] = (a[da - db + i] - coef * b[i]) % p
            while a and a[-1] == 0:
                a.pop()
            da = len(a) - 1
        return a

    for tail in np.ndindex(*([p] * k)):
        cand = list(tail) + [1]  # monic degree k
        if cand[0] == 0:
            continue
        reducible = False
        for d in range(1, k // 2 + 1):
            for low in polys(d):
                div = list(low) + [1]  # monic degree d
                if not polydivmod(cand, div):
                    reducible = True
                    break
            if reducible:
                break
        if not reducible:
            return tuple(cand[:k])
    raise RuntimeError(f"no irreducible poly found for GF({p}^{k})")


def _gf_elements_and_mul(q: int):
    """Return (elements, mul) for GF(q): elements as ints 0..q-1 encoding
    base-p coefficient vectors; mul(a, b) multiplies in the field."""
    p, k = _factor_prime_power(q)
    if k == 1:
        return list(range(q)), lambda a, b: (a * b) % p

    red = _find_irreducible_poly(p, k)

    def decode(a):
        out = []
        for _ in range(k):
            out.append(a % p)
            a //= p
        return out

    def encode(c):
        v = 0
        for x in reversed(c):
            v = v * p + x
        return v

    def mul(a, b):
        ca, cb = decode(a), decode(b)
        prod = [0] * (2 * k - 1)
        for i, x in enumerate(ca):
            if x:
                for j, y in enumerate(cb):
                    prod[i + j] = (prod[i + j] + x * y) % p
        # reduce modulo x^k + red
        for d in range(2 * k - 2, k - 1, -1):
            c = prod[d]
            if c:
                prod[d] = 0
                for i in range(k):
                    prod[d - k + i] = (prod[d - k + i] - c * red[i]) % p
        return encode(prod[:k])

    return list(range(q)), mul


def _quadratic_character(q: int) -> np.ndarray:
    """chi over GF(q): chi[0]=0, chi[x]=+1 if x is a nonzero square else -1."""
    elems, mul = _gf_elements_and_mul(q)
    squares = {mul(x, x) for x in elems if x != 0}
    chi = np.full(q, -1, dtype=np.int64)
    chi[0] = 0
    for s in squares:
        chi[s] = 1
    return chi


def _gf_sub_table(q: int) -> np.ndarray:
    """table[i, j] = element index of (a_i - a_j) in GF(q)."""
    p, k = _factor_prime_power(q)
    idx = np.arange(q)
    if k == 1:
        return (idx[:, None] - idx[None, :]) % p
    # vectorized per-digit subtraction in base p
    digits = []
    a = idx.copy()
    for _ in range(k):
        digits.append(a % p)
        a //= p
    digits = np.stack(digits, axis=-1)  # (q, k)
    diff = (digits[:, None, :] - digits[None, :, :]) % p
    out = np.zeros((q, q), dtype=np.int64)
    for d in range(k - 1, -1, -1):
        out = out * p + diff[..., d]
    return out


def _jacobsthal(q: int) -> np.ndarray:
    """Q[i, j] = chi(a_i - a_j)."""
    chi = _quadratic_character(q)
    return chi[_gf_sub_table(q)]


def _paley_I(q: int) -> np.ndarray:
    """Hadamard matrix of order q+1 for prime power q == 3 (mod 4)."""
    assert q % 4 == 3
    n = q + 1
    Q = _jacobsthal(q)
    S = np.zeros((n, n), dtype=np.int64)
    S[0, 1:] = 1
    S[1:, 0] = -1
    S[1:, 1:] = Q
    H = S + np.eye(n, dtype=np.int64)
    return H


def _paley_II(q: int) -> np.ndarray:
    """Hadamard matrix of order 2(q+1) for prime power q == 1 (mod 4)."""
    assert q % 4 == 1
    n = q + 1
    Q = _jacobsthal(q)
    S = np.zeros((n, n), dtype=np.int64)
    S[0, 1:] = 1
    S[1:, 0] = 1
    S[1:, 1:] = Q
    A = np.array([[1, 1], [1, -1]], dtype=np.int64)
    B = np.array([[1, -1], [-1, -1]], dtype=np.int64)
    H = np.kron(S, A) + np.kron(np.eye(n, dtype=np.int64), B)
    return H


# odd part -> (construction, parameter)
_BASE_RECIPES = {
    1: None,
    3: ("I", 11),     # H12
    5: ("I", 19),     # H20
    7: ("II", 13),    # H28
    9: ("II", 17),    # H36
    11: ("I", 43),    # H44
    13: ("II", 25),   # H52 (GF(5^2))
    15: ("I", 59),    # H60
    21: ("I", 83),    # H84
    27: ("I", 107),   # H108
    33: ("I", 131),   # H132
    35: ("I", 139),   # H140
    37: ("II", 73),   # H148
    39: ("I", 311),   # H312 = 39 * 8
    43: ("I", 343),   # H344 = 43 * 8 (GF(7^3))
}


@functools.lru_cache(maxsize=None)
def _base_matrix(odd: int) -> np.ndarray | None:
    """Smallest constructible Hadamard matrix whose order has odd part `odd`."""
    recipe = _BASE_RECIPES.get(odd)
    if recipe is None:
        if odd == 1:
            return None
        raise ValueError(f"no Hadamard construction known here for odd part {odd}")
    kind, q = recipe
    H = _paley_I(q) if kind == "I" else _paley_II(q)
    n = H.shape[0]
    assert (H @ H.T == n * np.eye(n, dtype=np.int64)).all(), f"bad Hadamard {n}"
    return H


@functools.lru_cache(maxsize=None)
def get_hadK(n: int) -> tuple[int, np.ndarray | None]:
    """Factor n = K * 2^m with an available base block of order K.

    Returns (K, hadK) where hadK is the +-1 base matrix (float32) or None when
    n is a power of two (K == 1).  Counterpart of the reference's `get_hadK`
    (hadamard_utils.py:5-64), but table-free: any n whose odd part has a known
    construction is supported.
    """
    odd = n
    while odd % 2 == 0:
        odd //= 2
    if odd == 1:
        return 1, None
    H = _base_matrix(odd)
    K = H.shape[0]
    if n % K != 0 or not is_pow2(n // K):
        raise ValueError(f"size {n} not factorable as K*2^m with K={K}")
    return K, H.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hadamard_matrix(n: int, dtype=np.float64) -> np.ndarray:
    """Dense +-1 Hadamard matrix of order n (unnormalized), built as
    H_base kron H_sylvester. Matches the operator applied by matmul_hadU."""
    K, hadK = get_hadK(n)
    m = n // K
    H2 = np.array([[1.0, 1.0], [1.0, -1.0]])
    Hs = np.array([[1.0]])
    while Hs.shape[0] < m:
        Hs = np.kron(Hs, H2)
    if K == 1:
        return Hs.astype(dtype)
    return np.kron(hadK.astype(np.float64), Hs).astype(dtype)


def dense_hadamard(n: int) -> np.ndarray:
    """The unnormalized +-1 H_n (float32) that matmul_hadU applies as
    y = H_n @ x / sqrt(n): the dense oracle for the transforms below."""
    return hadamard_matrix(n, np.float32)


# ---------------------------------------------------------------------------
# Transforms on torch tensors
# ---------------------------------------------------------------------------

def fwht(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform along `dim` (size 2^m): the
    radix-2 butterfly with the reference's exact add/sub DAG (each stage
    maps pairs (i, i+h) to (a+b, a-b)), so f32 results are bit-identical
    to rsq_tpu.core.hadamard.fwht and to the CUDA decode_prep butterfly."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    assert is_pow2(n), f"fwht needs a power-of-2 size, got {n}"
    shape = x.shape
    h = 1
    while h < n:
        x = x.reshape(*shape[:-1], n // (2 * h), 2, h)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.cat([a + b, a - b], dim=-1)
        h *= 2
    return x.reshape(shape).movedim(-1, dim)


@functools.lru_cache(maxsize=None)
def _hadK_tensor(n: int, dtype: torch.dtype, device: torch.device):
    """get_hadK(n)'s block on `device`, uploaded once."""
    return torch.as_tensor(get_hadK(n)[1], dtype=dtype, device=device)


def matmul_hadU(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Orthonormal Hadamard H_n/sqrt(n) along the last axis, n = K * 2^m:
    butterfly over the 2^m part, then one (K, K) block product (exact for
    the +-1 entries up to f32 summation order)."""
    n = x.shape[-1]
    K, _ = get_hadK(n)
    compute_dtype = dtype or (torch.float32 if x.dtype != torch.float64
                              else x.dtype)
    xf = x.to(compute_dtype)
    if K == 1:
        out = fwht(xf)
    else:
        xf = fwht(xf.reshape(*x.shape[:-1], K, n // K))
        hk = _hadK_tensor(n, compute_dtype, x.device)
        out = torch.einsum("kl,...lj->...kj", hk, xf).reshape(x.shape)
    return div_const(out, math.sqrt(n)).to(x.dtype)


def hadamard_transform_last(x: torch.Tensor, block: int | None = None,
                            dtype=None) -> torch.Tensor:
    """Orthonormal Hadamard over the last axis, optionally per `block`."""
    if block is None:
        return matmul_hadU(x, dtype=dtype)
    n = x.shape[-1]
    assert n % block == 0
    xs = x.reshape(*x.shape[:-1], n // block, block)
    return matmul_hadU(xs, dtype=dtype).reshape(x.shape)


def head_mixing_hadamard(x: torch.Tensor, head_dim: int,
                         dtype=None) -> torch.Tensor:
    """H_{heads}/sqrt(heads) across heads for each within-head coordinate
    (the o_proj input's online partial Hadamard). x: (..., heads*head_dim)."""
    n = x.shape[-1]
    heads = n // head_dim
    xs = x.reshape(*x.shape[:-1], heads, head_dim).transpose(-1, -2)
    xs = matmul_hadU(xs, dtype=dtype).transpose(-1, -2)
    return xs.reshape(x.shape)


# ---------------------------------------------------------------------------
# The rotation's half: float64 weight-side transforms and the random
# orthogonal generators.  The reference folds weights in numpy float64 on
# the host; these run in torch float64 on whatever device the tensor is on
# (the card, one tensor at a time, in rotate_model).  The generators stay
# numpy, so a seed gives the reference's Q exactly.
# ---------------------------------------------------------------------------

def hadU_supported(n: int) -> bool:
    """Whether a fast Hadamard exists for n (falcon-7b's 4544 and 18176,
    odd part 71, have none: H_n needs n in {1, 2} or n % 4 == 0)."""
    try:
        get_hadK(n)
        return True
    except Exception:
        return False


def matmul_hadU_f64(x: torch.Tensor) -> torch.Tensor:
    """x @ M^T / sqrt(n) along the last axis in float64 (the reference's
    host matmul_hadU_np, whose butterfly fwht shares): the weight-side
    exact Hadamard of the rotation, with a true division by sqrt(n)."""
    n = x.shape[-1]
    K, hadK = get_hadK(n)
    xf = x.to(torch.float64)
    if K == 1:
        out = fwht(xf)
    else:
        xs = fwht(xf.reshape(*x.shape[:-1], K, n // K))
        hk = torch.as_tensor(hadK, dtype=torch.float64, device=x.device)
        out = torch.einsum("kl,...lj->...kj", hk, xs).reshape(x.shape)
    return out / torch.tensor(math.sqrt(n), dtype=torch.float64,
                              device=x.device)


def random_hadamard_matrix(n: int, seed: int = 0) -> np.ndarray:
    """Randomized orthonormal Hadamard H_n diag(+-1) / sqrt(n), float64."""
    rng = np.random.default_rng(seed)
    signs = rng.integers(0, 2, size=n).astype(np.float64) * 2 - 1
    H = hadamard_matrix(n, dtype=np.float64)
    return (H * signs[None, :]) / math.sqrt(n)


def random_orthogonal_matrix(n: int, seed: int = 0) -> np.ndarray:
    """QR-based random orthogonal matrix, float64, sign-fixed (Haar)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    q, r = np.linalg.qr(A)
    q *= np.sign(np.diag(r))[None, :]
    return q


def get_orthogonal_matrix(n: int, mode: str = "hadamard",
                          seed: int = 0) -> np.ndarray:
    if mode == "hadamard":
        return random_hadamard_matrix(n, seed)
    if mode == "random":
        return random_orthogonal_matrix(n, seed)
    raise ValueError(f"unknown rotation mode {mode!r}")
