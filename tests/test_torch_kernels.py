"""rsq_tpu_torch kernels' plain versions (what a wrapper runs on CPU
tensors) against rsq_tpu's Pallas kernels in interpret mode, on the same
numpy inputs.  The CUDA kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.core import hadamard as JH
from rsq_tpu.kernels import kv_cache as JKV
from rsq_tpu.kernels import matmul_w4 as JMW
from rsq_tpu.kernels import paged_kv as JPKV
from rsq_tpu.kernels.hadamard_mxu import hadamard_transform as j_had_mxu
from rsq_tpu.models import llama as JM
from rsq_tpu_torch.core import hadamard as TH
from rsq_tpu_torch.kernels import kv_cache as TKV
from rsq_tpu_torch.kernels import matmul_w4 as TMW
from rsq_tpu_torch.kernels import paged_kv as TPKV
from rsq_tpu_torch.kernels.hadamard_mxu import hadamard_transform as t_had_mxu
from rsq_tpu_torch.models import llama as TM

BF16_EPS = 2.0 ** -8     # bf16 rounding unit (half an ulp at 1.0)


def f32(x):
    """jax or torch array -> f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def both(a, dtype="float32"):
    """One numpy array as (jax array, torch tensor) of `dtype`."""
    return jnp.asarray(a, getattr(jnp, dtype)), \
        torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# Hadamard transforms and prefill attention (plain torch in both packages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 112, 128])
def test_hadamard_transforms_match(n):
    """fwht is bit-equal (same add DAG).  matmul_hadU / hadamard_transform
    sum the K=28 block in another order: f32 within 1e-6 relative, and the
    bf16 fast path within one bf16 rounding."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, 5, n)).astype(np.float32)
    xj, xt = both(x)
    np.testing.assert_array_equal(TH.dense_hadamard(n), JH.dense_hadamard(n))
    if JH.is_pow2(n):
        np.testing.assert_array_equal(f32(JH.fwht(xj)), f32(TH.fwht(xt)))
    np.testing.assert_allclose(f32(TH.matmul_hadU(xt)), f32(JH.matmul_hadU(xj)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(f32(t_had_mxu(xt)), f32(j_had_mxu(xj)),
                               rtol=1e-6, atol=1e-6)
    xj, xt = both(x, "bfloat16")
    got, want = f32(t_had_mxu(xt)), f32(j_had_mxu(xj))
    np.testing.assert_allclose(got, want, rtol=2 * BF16_EPS, atol=1e-6)
    np.testing.assert_allclose(
        f32(TH.head_mixing_hadamard(xt, head_dim=n // 4 if n % 4 == 0 else n)),
        f32(JH.head_mixing_hadamard(xj, head_dim=n // 4 if n % 4 == 0 else n)),
        rtol=2 * BF16_EPS, atol=1e-6)


@pytest.mark.parametrize("chunked", [False, True])
def test_prefill_attention_matches(chunked):
    """f32 scores and softmax; only summation order and exp differ, so the
    bf16 outputs agree within one bf16 rounding."""
    rng = np.random.default_rng(7)
    b, s, h, d = 1, 40, 4, 16
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    (qj, qt), (kj, kt), (vj, vt) = (both(a, "bfloat16") for a in (q, k, v))
    if chunked:
        got = TM.attention_chunked(qt, kt, vt, q_chunk=16, k_chunk=8)
        want = JM.attention_chunked(qj, kj, vj, q_chunk=16, k_chunk=8)
    else:
        got = TM.attention(qt, kt, vt)
        want = JM.attention(qj, kj, vj)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2 * BF16_EPS,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# W4A4 and W8 matmuls
# ---------------------------------------------------------------------------

def _stacked_w4(rng, L, K, Nh):
    wp = rng.integers(0, 256, size=(L, K, Nh), dtype=np.uint8)
    s2 = (rng.uniform(0.5, 1.5, size=(2, Nh)) / (7 * np.sqrt(K))
          ).astype(np.float32)
    return wp, s2


@pytest.mark.parametrize("M", [3, 8, 130])
@pytest.mark.parametrize("K,Nh", [(64, 64), (112, 32)])
def test_w4a4_stacked_plain_bit_equal(M, K, Nh):
    """Integer accumulation and the same epilogue order: bit-equal."""
    rng = np.random.default_rng(M + K)
    wp, s2 = _stacked_w4(rng, 2, K, Nh)
    x = (rng.standard_normal((M, K)) * 2).astype(np.float32)
    x[0] = 0.0                                      # absmax == 0 row
    xj, xt = both(x, "bfloat16")
    want = JMW.w4a4_matmul_paired_stacked(xj, jnp.asarray(wp),
                                          jnp.asarray(s2), 1)
    got = TMW.w4a4_matmul_paired_stacked(xt, torch.from_numpy(wp),
                                         torch.from_numpy(s2), 1)
    assert got.shape == (M, 2, Nh) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("M", [1, 8])
def test_w8_matmul_plain_matches(M):
    """f32 accumulation in another order, then one bf16 rounding: within
    one bf16 rounding of the reference."""
    rng = np.random.default_rng(M)
    K, N = 64, 256
    x = rng.standard_normal((M, K)).astype(np.float32)
    w8 = rng.integers(-127, 128, size=(K, N), dtype=np.int8)
    sc = (rng.uniform(0.5, 1.5, N) / (127 * np.sqrt(K))).astype(np.float32)
    xj, xt = both(x, "bfloat16")
    want = JMW.w8_matmul(xj, jnp.asarray(w8), jnp.asarray(sc))
    got = TMW.w8_matmul(xt, torch.from_numpy(w8), torch.from_numpy(sc))
    np.testing.assert_allclose(f32(got), f32(want), rtol=2 * BF16_EPS,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# decode_prep
# ---------------------------------------------------------------------------

def _prep_inputs(rng, B=3, Hq=8, Hkv=2, D=16):
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    pos = rng.integers(0, 4096, size=B)
    inv = 1.0 / (500000.0 ** (np.arange(0, D, 2) / D))
    ang = (pos[:, None] * inv[None, :]).astype(np.float32)
    emb = np.concatenate([ang, ang], axis=-1)
    return q, k, v, np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


@pytest.mark.parametrize("kv_had", [True, False])
def test_decode_prep_plain_matches(kv_had):
    """v's codes and params are bit-equal.  XLA on the CPU contracts the
    reference's x*cos + rot*sin and u*scale - zero into FMAs, which the
    port (like the kernel as written) does not: the f32 results differ by
    at most 1 ulp, so a bf16-rounded q/k differs by one bf16 step in rare
    elements, and a k code flips by one step only where that moved it
    across a rounding boundary (bounded to 2% of codes here).  The CUDA
    kernel is held bit-equal to the plain version on the card."""
    rng = np.random.default_rng(11)
    q, k, v, cos, sin = _prep_inputs(rng, B=16, Hq=8, Hkv=4, D=32)
    jout = JKV.decode_prep(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                           jnp.asarray(cos), jnp.asarray(sin), kv_had=kv_had)
    tout = TKV.decode_prep(*(torch.from_numpy(a).to(torch.bfloat16)
                             for a in (q, k, v)),
                           torch.from_numpy(cos), torch.from_numpy(sin),
                           kv_had=kv_had)
    qh, ks, vs, nkq, nkp, nvq, nvp = jout
    # the reference broadcasts codes/params over 128 lanes; lane 0 suffices
    nkq, nkp, nvq, nvp = (np.asarray(a)[..., 0] for a in (nkq, nkp, nvq, nvp))
    np.testing.assert_array_equal(tout[5].numpy(), nvq)
    np.testing.assert_array_equal(tout[6].numpy(), nvp)
    # the FMA skips one rounding of u*scale (<= 2^-24 |u*scale| < 1e-6 here)
    np.testing.assert_allclose(f32(tout[2]), f32(vs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(f32(tout[0]), f32(qh), rtol=2 * BF16_EPS,
                               atol=0)
    assert (f32(tout[0]) != f32(qh)).mean() <= 0.01
    tk = torch.from_numpy(np.array(nkq))
    codes_t = torch.cat([tout[3] & 15, tout[3] >> 4], -1).int().numpy()
    codes_j = torch.cat([tk & 15, tk >> 4], -1).int().numpy()
    assert np.abs(codes_t - codes_j).max() <= 1
    assert (codes_t != codes_j).mean() <= 0.02
    np.testing.assert_allclose(tout[4].numpy(), nkp, rtol=2 * BF16_EPS)
    same = (codes_t == codes_j).all(-1) & (tout[4].numpy() == nkp).all(-1)
    np.testing.assert_allclose(f32(tout[1])[same], f32(ks)[same], rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Paged attention with self fold and in-place append
# ---------------------------------------------------------------------------

def _random_pool(rng, L, P, H, D, page):
    def params():
        return np.stack([rng.uniform(0.01, 0.2, size=(L, P, H, page)),
                         rng.uniform(-0.5, 0.5, size=(L, P, H, page))],
                        axis=3).astype(np.float32)
    return (rng.integers(0, 256, size=(L, P, H, D // 2, page), dtype=np.uint8),
            params(),
            rng.integers(0, 256, size=(L, P, H, D // 2, page), dtype=np.uint8),
            params())


def _paged_case(seed, Hkv=2, G=4, D=16, page=128):
    rng = np.random.default_rng(seed)
    L, P, B = 2, 10, 3
    pool = _random_pool(rng, L, P, Hkv, D, page)
    ptab = np.array([[0, 2, 5], [3, 1, 6], [4, 7, 8]], np.int32)
    # mid-page, page-boundary (fresh page), empty-row lengths
    lengths = np.array([page + 7, page, 0], np.int32)
    q = (rng.standard_normal((B, Hkv * G, D)) * 2).astype(np.float32)
    knew = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    vnew = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    return pool, ptab, lengths, q, knew, vnew


@pytest.mark.parametrize("int8_qk", [False, True])
@pytest.mark.parametrize("flat", [False, True])
def test_paged_self_append_plain_matches(flat, int8_qk):
    """Output within 2 bf16 roundings of the reference (f32 sums in another
    order, then one bf16 rounding); the pools bit-equal: the new column
    written, everything else unchanged."""
    pool, ptab, lengths, q, knew, vnew = _paged_case(17 + int8_qk)
    nkq, nkp = JKV.asym_quant_pack_head(jnp.asarray(knew))
    nvq, nvp = JKV.asym_quant_pack_head(jnp.asarray(vnew))
    ks, vs = JKV.unpack_dequant_head(nkq, nkp), JKV.unpack_dequant_head(nvq, nvp)
    layer = 1
    jres = JPKV.int4_paged_decode_attention_self_append(
        jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, pool), layer,
        jnp.asarray(ptab), jnp.asarray(lengths), ks, vs, nkq[..., None],
        nkp[..., None], nvq[..., None], nvp[..., None], flat=flat,
        int8_qk=int8_qk)
    tpool = [torch.from_numpy(a.copy()) for a in pool]
    tout = TPKV.int4_paged_decode_attention_self_append(
        torch.from_numpy(q).to(torch.bfloat16), *tpool, layer,
        torch.from_numpy(ptab), torch.from_numpy(lengths),
        torch.from_numpy(np.asarray(ks)), torch.from_numpy(np.asarray(vs)),
        *(torch.from_numpy(np.asarray(a)) for a in (nkq, nkp, nvq, nvp)),
        int8_qk=int8_qk)
    np.testing.assert_allclose(f32(tout), f32(jres[0]), rtol=4 * BF16_EPS,
                               atol=2e-3)
    for got, want, name in zip(tpool, jres[1:], ("kq", "kp", "vq", "vp")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    # and the column really was written
    for b in range(3):
        pid = ptab[b, lengths[b] // 128]
        np.testing.assert_array_equal(
            tpool[0][layer, pid, :, :, lengths[b] % 128].numpy(),
            np.asarray(nkq)[b])


def test_paged_self_append_rejects_small_pages():
    pool, ptab, lengths, q, knew, vnew = _paged_case(3, page=128)
    small = [torch.from_numpy(a[..., :64].copy()) for a in pool]
    B, Hkv, D = 3, 2, 16
    with pytest.raises(ValueError, match="page size 64|page 64"):
        TPKV.int4_paged_decode_attention_self_append(
            torch.zeros((B, 8, D), dtype=torch.bfloat16), *small, 0,
            torch.from_numpy(ptab), torch.from_numpy(lengths),
            torch.zeros((B, Hkv, D)), torch.zeros((B, Hkv, D)),
            torch.zeros((B, Hkv, D // 2), dtype=torch.uint8),
            torch.zeros((B, Hkv, 2)),
            torch.zeros((B, Hkv, D // 2), dtype=torch.uint8),
            torch.zeros((B, Hkv, 2)))
