"""The last three kernel-table rows of rsq_tpu_torch against rsq_tpu, at
small size (L <= 3, B <= 4, Hkv 2, G 2-4, D 64-128, S <= 384, pages 16 and
128): the contiguous append (row 7), the read-only contiguous attention
with the new token folded in (row 3) and its paged twin (row 18), as plain
versions against the Pallas kernels in interpret mode; then, in the port
alone, the fused self-appending kernels (rows 4 and 19) against the
self fold followed by the append.

Tolerances: the append is bit-equal (integer stages and copied floats);
attention out within 2 bf16 roundings + 2e-3, the tolerance row 2 is held
to in test_torch_layers.py (p rounds to bf16 against another running
maximum: the reference tiles by `chunk` or a page group, the plain version
takes the whole cache); a row of length 0 attends to its own token alone,
so its output is v_self, exactly.  On the CPU the port's fused function
is defined as the same plain steps as the pair, so the last two tests only
guard that refactor (out within 1e-5, caches bit-equal); the real check of
the composition is test_torch_cuda.py's, which holds the fused kernels
against the separate ones on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.kernels import kv_cache as JKV
from rsq_tpu.kernels import paged_kv as JPKV
from rsq_tpu_torch.kernels import kv_cache as TKV
from rsq_tpu_torch.kernels import paged_kv as TPKV
from test_torch_contiguous import BF16_EPS, _int4_cache, f32
from test_torch_packing import np_of
from test_torch_small_pages import _pool


def _new_token(rng, B, Hkv, D):
    """The new token's k and v: (k_self, v_self) (B, Hkv, D) f32 dequantized,
    and (nkq, nkp, nvq, nvp) (B, Hkv, D/2) u8 / (B, Hkv, 2) f32, as numpy."""
    selfs, new = [], []
    for _ in range(2):
        q, p = TKV.asym_quant_pack_head(torch.from_numpy(
            rng.standard_normal((B, Hkv, D)).astype(np.float32)))
        selfs.append(TKV.unpack_dequant_head(q, p).numpy())
        new += [q.numpy(), p.numpy()]
    return selfs, new


def _close_attention(got, want):
    np.testing.assert_allclose(f32(got), f32(want), rtol=4 * BF16_EPS,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# Row 7: the contiguous append
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [64, 128])
def test_kv_append_stacked_bit_equal(D):
    """Positions 0, 127, 128 and S - 1 (both sides of the reference's
    128-lane window): all four caches bit-equal to the reference's, which
    rewrites the window around each column with the same values."""
    rng = np.random.default_rng(D)
    L, B, H, S = 3, 4, 2, 384
    cache = _int4_cache(rng, L, B, H, D, S)
    pos = np.array([0, 127, 128, S - 1], np.int32)
    _, new = _new_token(rng, B, H, D)
    lane = [a[..., None] for a in new]                  # (B, H, x, 1)
    want = JKV.kv_append_stacked(*map(jnp.asarray, cache), 1,
                                 jnp.asarray(pos), *map(jnp.asarray, lane))
    tcache = [torch.from_numpy(a.copy()) for a in cache]
    got = TKV.kv_append_stacked(*tcache, 1, torch.from_numpy(pos),
                                *map(torch.from_numpy, lane))
    for g, t, w in zip(got, tcache, want):
        assert g is t                                   # written in place
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="max_seq"):
        TKV.kv_append_stacked(*tcache, 1, torch.tensor([0, 1, 2, S]),
                              *map(torch.from_numpy, lane))


# ---------------------------------------------------------------------------
# Row 3: read-only contiguous attention with the self fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths", ["ends", "empty_row"])
@pytest.mark.parametrize("int8_qk", [False, True])
def test_decode_attention_stacked_self_matches(int8_qk, lengths):
    """Lengths [100, 1, S-1, 77] as the reference's own test, and a batch
    with a row of length 0, against the reference at chunk 128; the cache
    is not written."""
    rng = np.random.default_rng(7 + int8_qk + 2 * (lengths == "ends"))
    L, B, Hkv, G, D, S = 3, 4, 2, 4, 128, 256
    cache = _int4_cache(rng, L, B, Hkv, D, S)
    lens = np.array([100, 1, S - 1, 77] if lengths == "ends"
                    else [0, 130, 5, 0], np.int32)
    q = (rng.standard_normal((B, Hkv * G, D)) * 2).astype(np.float32)
    (k_self, v_self), _ = _new_token(rng, B, Hkv, D)
    want = JKV.int4_decode_attention_stacked_self(
        jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, cache), 1,
        jnp.asarray(lens), jnp.asarray(k_self, jnp.float32),
        jnp.asarray(v_self, jnp.float32), chunk=128, int8_qk=int8_qk)
    tcache = [torch.from_numpy(a.copy()) for a in cache]
    got = TKV.int4_decode_attention_stacked_self(
        torch.from_numpy(q).to(torch.bfloat16), *tcache, 1,
        torch.from_numpy(lens), torch.from_numpy(k_self),
        torch.from_numpy(v_self), chunk=128, int8_qk=int8_qk)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close_attention(got, want)
    for t, a in zip(tcache, cache):
        np.testing.assert_array_equal(t.numpy(), a)


def test_decode_attention_stacked_self_empty_cache():
    """Every row of length 0: the output is v_self repeated over the G
    query rows of its kv head, exactly (one bf16 rounding), in both."""
    rng = np.random.default_rng(9)
    L, B, Hkv, G, D, S = 1, 2, 2, 2, 64, 128
    cache = _int4_cache(rng, L, B, Hkv, D, S)
    lens = np.zeros(B, np.int32)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    k_self, v_self = (rng.standard_normal((B, Hkv, D)).astype(np.float32)
                      for _ in range(2))
    got = TKV.int4_decode_attention_stacked_self(
        torch.from_numpy(q).to(torch.bfloat16),
        *map(torch.from_numpy, cache), 0, torch.from_numpy(lens),
        torch.from_numpy(k_self), torch.from_numpy(v_self))
    want = JKV.int4_decode_attention_stacked_self(
        jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, cache), 0,
        jnp.asarray(lens), jnp.asarray(k_self), jnp.asarray(v_self),
        chunk=128)
    expect = torch.from_numpy(np.repeat(v_self, G, axis=1)).to(torch.bfloat16)
    np.testing.assert_array_equal(np_of(got), np_of(expect))
    np.testing.assert_array_equal(np_of(want), np_of(expect))


# ---------------------------------------------------------------------------
# Row 18: the paged twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page,int8_qk", [(16, False), (16, True),
                                          (128, False), (128, True)])
def test_paged_attention_stacked_self_matches(page, int8_qk):
    """Page tables in no pool order, rows that end mid-page, on a page
    boundary, after one token, and a row of length 0; the pool is not
    written."""
    rng = np.random.default_rng(page + 10 * int8_qk)
    L, B, Hkv, G, D = 2, 4, 2, 2, 64
    NP = -(-384 // page)
    P = B * NP + 1
    pool = _pool(rng, L, P, Hkv, D, page)
    ptab = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    lens = np.array([NP * page - page // 2 - 1, (NP // 2) * page, 1, 0],
                    np.int32)
    q = (rng.standard_normal((B, Hkv * G, D)) * 2).astype(np.float32)
    (k_self, v_self), _ = _new_token(rng, B, Hkv, D)
    want = JPKV.int4_paged_decode_attention_stacked_self(
        jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, pool), 1,
        jnp.asarray(ptab), jnp.asarray(lens),
        jnp.asarray(k_self, jnp.float32), jnp.asarray(v_self, jnp.float32),
        int8_qk=int8_qk)
    tpool = [torch.from_numpy(a.copy()) for a in pool]
    got = TPKV.int4_paged_decode_attention_stacked_self(
        torch.from_numpy(q).to(torch.bfloat16), *tpool, 1,
        torch.from_numpy(ptab), torch.from_numpy(lens),
        torch.from_numpy(k_self), torch.from_numpy(v_self), int8_qk=int8_qk)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close_attention(got, want)
    for t, a in zip(tpool, pool):
        np.testing.assert_array_equal(t.numpy(), a)


# ---------------------------------------------------------------------------
# In the port: the fused kernels equal the self fold followed by the append
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8_qk", [False, True])
def test_self_append_equals_fold_then_append(int8_qk):
    """Row 4 == row 3 then row 7 on the slot cache, at a chunk's last
    token, a chunk boundary and an empty slot.  The plain row 4 is row 3's
    plain version then the append, so this guards only that definition;
    test_self_append_kernel_equals_fold_then_append holds the kernels."""
    rng = np.random.default_rng(23 + int8_qk)
    L, B, Hkv, G, D, S = 2, 3, 2, 2, 64, 256
    cache = _int4_cache(rng, L, B, Hkv, D, S)
    lens = torch.tensor([127, 128, 0], dtype=torch.int32)
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2)
                         .astype(np.float32)).to(torch.bfloat16)
    (k_self, v_self), new = _new_token(rng, B, Hkv, D)
    selfs = [torch.from_numpy(k_self), torch.from_numpy(v_self)]
    new = [torch.from_numpy(a) for a in new]
    fused = [torch.from_numpy(a.copy()) for a in cache]
    pair = [torch.from_numpy(a.copy()) for a in cache]
    out_f = TKV.int4_decode_attention_self_append(q, *fused, 1, lens, *selfs,
                                                  *new, int8_qk=int8_qk)
    out_s = TKV.int4_decode_attention_stacked_self(q, *pair, 1, lens, *selfs,
                                                   int8_qk=int8_qk)
    TKV.kv_append_stacked(*pair, 1, lens, *(a[..., None] for a in new))
    np.testing.assert_allclose(f32(out_f), f32(out_s), rtol=1e-5, atol=1e-5)
    for a, b in zip(fused, pair):
        assert torch.equal(a, b)


@pytest.mark.parametrize("int8_qk", [False, True])
def test_paged_self_append_equals_fold_then_append(int8_qk):
    """Row 19 == row 18 then row 21 on the pool, page 128, two rows
    appending into one shared page at different lanes.  As above, on the
    CPU this guards only the plain definition of row 19."""
    rng = np.random.default_rng(31 + int8_qk)
    L, B, Hkv, G, D, page = 2, 3, 2, 2, 64, 128
    P = 8
    pool = _pool(rng, L, P, Hkv, D, page)
    ptab = torch.tensor([[3, 5], [5, 6], [1, 2]], dtype=torch.int32)
    lens = torch.tensor([page + 2, 7, page - 1], dtype=torch.int32)
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2)
                         .astype(np.float32)).to(torch.bfloat16)
    (k_self, v_self), new = _new_token(rng, B, Hkv, D)
    selfs = [torch.from_numpy(k_self), torch.from_numpy(v_self)]
    new = [torch.from_numpy(a) for a in new]
    fused = [torch.from_numpy(a.copy()) for a in pool]
    pair = [torch.from_numpy(a.copy()) for a in pool]
    out_f = TPKV.int4_paged_decode_attention_self_append(
        q, *fused, 1, ptab, lens, *selfs, *new, int8_qk=int8_qk)
    out_s = TPKV.int4_paged_decode_attention_stacked_self(
        q, *pair, 1, ptab, lens, *selfs, int8_qk=int8_qk)
    TPKV.paged_append_pool(*pair, 1, ptab, lens, *new)
    np.testing.assert_allclose(f32(out_f), f32(out_s), rtol=1e-5, atol=1e-5)
    for a, b in zip(fused, pair):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# A NaN in one query head under int8_qk (rows 3 and 18)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_int8_qk_nan_query_head(paged):
    """q[0, 1, 5] = NaN with int8_qk: the reference's max |q| is NaN, so
    that head's scale, logits and output are NaN; the plain version gives
    the same NaN pattern (that head alone) and the other heads within the
    file's tolerance (rows 3 and 18 at page 16)."""
    rng = np.random.default_rng(61 + paged)
    L, B, Hkv, G, D = 2, 2, 2, 2, 128
    q = (rng.standard_normal((B, Hkv * G, D)) * 2).astype(np.float32)
    q[0, 1, 5] = np.nan
    (k_self, v_self), _ = _new_token(rng, B, Hkv, D)
    lens = np.array([100, 37], np.int32)
    jq = jnp.asarray(q, jnp.bfloat16)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    selfs = (k_self, v_self)
    if paged:
        page, NP = 16, 8
        P = B * NP + 1
        cache = _pool(rng, L, P, Hkv, D, page)
        ptab = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
        want = JPKV.int4_paged_decode_attention_stacked_self(
            jq, *map(jnp.asarray, cache), 1, jnp.asarray(ptab),
            jnp.asarray(lens), *(jnp.asarray(a, jnp.float32) for a in selfs),
            int8_qk=True)
        got = TPKV.int4_paged_decode_attention_stacked_self(
            tq, *map(torch.from_numpy, cache), 1, torch.from_numpy(ptab),
            torch.from_numpy(lens), *map(torch.from_numpy, selfs),
            int8_qk=True)
    else:
        cache = _int4_cache(rng, L, B, Hkv, D, 128)
        want = JKV.int4_decode_attention_stacked_self(
            jq, *map(jnp.asarray, cache), 1, jnp.asarray(lens),
            *(jnp.asarray(a, jnp.float32) for a in selfs), chunk=128,
            int8_qk=True)
        got = TKV.int4_decode_attention_stacked_self(
            tq, *map(torch.from_numpy, cache), 1, torch.from_numpy(lens),
            *map(torch.from_numpy, selfs), int8_qk=True)
    g, w = f32(got), f32(want)
    head = np.zeros(g.shape, bool)
    head[0, 1] = True
    np.testing.assert_array_equal(np.isnan(w), head)
    np.testing.assert_array_equal(np.isnan(g), head)
    np.testing.assert_allclose(g[~head], w[~head], rtol=4 * BF16_EPS,
                               atol=2e-3)
