"""How the port's Hopper kernels split their work, held on the CPU: the
INT4 decode attention's split of each row over a thread-block cluster
(rsq_tpu_torch/csrc/int4_attention.cuh, mirrored by
kv_cache.int4_attention_chunks) and the weight-only matmul's K split and
shape rule (csrc/w4_matmul.cu, sized by matmul_w4.w4_split).

The merge test rebuilds what the kernel's cluster computes, from the
port's plain read-only attention on each block's share of a row, and holds
it against rsq_tpu's Pallas kernels in interpret mode at the kernels'
stated tolerance (4 bf16 roundings + 2e-3: each share's output is rounded
to bf16 before the merge)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.kernels import kv_cache as JKV
from rsq_tpu.kernels import paged_kv as JPKV
from rsq_tpu_torch.kernels import kv_cache as TKV
from rsq_tpu_torch.kernels import matmul_w4 as TMW
from rsq_tpu_torch.kernels import paged_kv as TPKV

BF16_EPS = 2.0 ** -8


# ---------------------------------------------------------------------------
# The attention split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [16, 64, 100, 256, 704, 1024, 4096])
def test_int4_split_covers_each_row(cap):
    """For rows of up to `cap` tokens, the planner's cluster (1-8 blocks,
    at most 4 tiles each for the longest row unless 8 are not enough) and
    every other cluster size split every length 0..cap (and past it,
    clamped) into rank-ordered, disjoint ranges of whole 64-token tiles
    that cover [0, length) exactly."""
    cl = TKV.int4_attention_cluster(cap)
    assert 1 <= cl <= 8
    assert -(-cap // 64) <= 4 * cl or cl == 8
    for size in range(1, 9):
        for n in range(cap + 2):
            chunks = TKV.int4_attention_chunks(n, cap, size)
            assert len(chunks) == size
            pos = 0
            for a, b in chunks:
                assert a == pos and a <= b <= min(n, cap)
                assert a % 64 == 0 and (b % 64 == 0 or b == min(n, cap))
                pos = b
            assert pos == min(n, cap)


@pytest.mark.parametrize("run,codes,params,width", [
    (1024, 16, 16, 16), (512, 16, 16, 16), (16, 16, 16, 16), (8, 16, 16, 4),
    (20, 16, 16, 4), (320, 4, 16, 4), (320, 16, 4, 1), (6, 16, 16, 1),
    (2, 16, 16, 1)])
def test_int4_copy_width(run, codes, params, width):
    """The staged copies are as wide as the runs of contiguous tokens (S,
    or a page) and the code arrays' alignment allow, 16 tokens or 4, with
    the parameters in 16-byte copies beside them; else one token (byte
    loads)."""
    class Buf:
        def __init__(self, p):
            self.p = p

        def data_ptr(self):
            return self.p

    caches = [Buf(4096 + codes), Buf(4096 + params)] * 2
    assert TKV.int4_copy_width(run, caches) == width


def _cache(rng, L, R, H, D, S):
    def params():
        return np.stack([rng.uniform(0.01, 0.2, (L, R, H, S)),
                         rng.uniform(-0.5, 0.5, (L, R, H, S))], 3
                        ).astype(np.float32)
    return [rng.integers(0, 256, (L, R, H, D // 2, S), dtype=np.uint8),
            params(),
            rng.integers(0, 256, (L, R, H, D // 2, S), dtype=np.uint8),
            params()]


def _merge(parts):
    """The cluster's merge of per-share (out, m, l) states, in rank order:
    acc_r = out_r * l_r weighed by exp(m_r - max m), an empty share (l = 0)
    weighing 0; a row with no token keeps 0/0, -inf, 0."""
    m = np.full(parts[0][1].shape, -np.inf, np.float32)
    for _, mr, lr in parts:
        m = np.where(lr > 0, np.maximum(m, mr), m)
    acc = np.zeros(parts[0][0].shape, np.float32)
    l = np.zeros(m.shape, np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        for o, mr, lr in parts:
            wl = np.where(lr > 0, np.exp(mr - m) * lr, 0.0).astype(np.float32)
            acc = acc + np.where(wl[..., None] > 0,
                                 np.nan_to_num(o) * wl[..., None], 0.0)
            l = l + wl
        return acc / l[..., None], m, l


def _check_merge(got, want, lengths, G):
    out, m, l = got
    B, Hkv = m.shape[:2]
    out = out.reshape(B, Hkv * G, -1)
    live = lengths > 0
    np.testing.assert_allclose(out[live], want[live], rtol=4 * BF16_EPS,
                               atol=2e-3)
    assert np.isnan(out[~live]).all() and np.isnan(want[~live]).all()
    assert (m[~live] == -np.inf).all() and (l[~live] == 0).all()


@pytest.mark.parametrize("cl", [1, 3, 4, 8])
@pytest.mark.parametrize("int8_qk", [False, True])
def test_int4_merge_matches_reference_contiguous(cl, int8_qk):
    """Row 2's split: each block's share of a contiguous row (empty shares
    and a zero-length row included), through the port's plain read-only
    attention on that share alone, merged as the cluster merges, against
    rsq_tpu.kernels.kv_cache.int4_decode_attention_stacked (interpret
    mode)."""
    rng = np.random.default_rng(10 * cl + int8_qk)
    L, Hkv, G, D, S = 2, 2, 2, 64, 512
    lengths = np.array([0, 1, 65, 200, 511], np.int32)
    B = len(lengths)
    cache = _cache(rng, L, B, Hkv, D, S)
    q = (rng.standard_normal((B, Hkv * G, D)) * 2).astype(np.float32)
    want, _, _ = JKV.int4_decode_attention_stacked(
        jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, cache), 1,
        jnp.asarray(lengths), int8_qk=int8_qk)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    parts = []
    for r in range(cl):
        # block r's share of each row as a cache of its own: the share's
        # tokens first, then zeros past its length
        spans = [TKV.int4_attention_chunks(int(n), S, cl)[r] for n in lengths]
        width = max(1, max(e - a for a, e in spans))
        sub = [np.zeros(c.shape[:-1] + (width,), c.dtype) for c in cache]
        for i, (a, e) in enumerate(spans):
            for c, full in zip(sub, cache):
                c[:, i, ..., :e - a] = full[:, i, ..., a:e]
        n = torch.tensor([e - a for a, e in spans], dtype=torch.int32)
        o, m, l = TKV.decode_attention_plain(
            qt, *map(torch.from_numpy, sub), 1, n, int8_qk=int8_qk)
        parts.append((o.float().numpy().reshape(B, Hkv, G, D), m.numpy(),
                      l.numpy()))
    _check_merge(_merge(parts), np.asarray(want, np.float32), lengths, G)


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("int8_qk", [False, True])
def test_int4_merge_matches_reference_paged(page, int8_qk):
    """Row 17's split at pages of 16 (a 64-token tile spans 4 pages) and
    64: each block's share of each row, read through a page table cut to
    the share's pages, merged as the cluster merges, against
    rsq_tpu.kernels.paged_kv.int4_paged_decode_attention_stacked
    (interpret mode), with empty shares and a zero-length row."""
    rng = np.random.default_rng(page + 5 * int8_qk)
    L, Hkv, G, D = 2, 2, 2, 64
    lengths = np.array([0, 17, 130, 300], np.int32)
    B = len(lengths)
    NP = -(-320 // page)
    P = B * NP + 1
    pool = _cache(rng, L, P, Hkv, D, page)
    ptab = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    q = (rng.standard_normal((B, Hkv * G, D)) * 2).astype(np.float32)
    want = JPKV.int4_paged_decode_attention_stacked(
        jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, pool), 1,
        jnp.asarray(ptab), jnp.asarray(lengths), int8_qk=int8_qk)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    tpool = [torch.from_numpy(a) for a in pool]
    cl = TKV.int4_attention_cluster(NP * page)
    assert cl > 1
    parts = []
    for r in range(cl):
        spans = [TKV.int4_attention_chunks(int(n), NP * page, cl)[r]
                 for n in lengths]
        w = max(1, max(-(-(b - a) // page) for a, b in spans))
        sub = np.zeros((B, w), np.int32)
        n = np.zeros(B, np.int32)
        for i, (a, b) in enumerate(spans):
            if b > a:                         # whole 64-token tiles: pages
                pages = ptab[i, a // page:-(-b // page)]
                sub[i, :len(pages)] = pages
                n[i] = b - a
        qg, state = TPKV._paged_state(qt, *tpool, 1, torch.from_numpy(sub),
                                      torch.from_numpy(n), None, int8_qk)
        o, m, l = TKV.finalize_read(qt, state)
        parts.append((o.float().numpy().reshape(B, Hkv, G, D), m.numpy(),
                      l.numpy()))
    _check_merge(_merge(parts), np.asarray(want, np.float32), lengths, G)


# ---------------------------------------------------------------------------
# The weight-only matmul's K split and shape rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 8, 9, 16, 17, 128, 1024, 4096])
@pytest.mark.parametrize("K", [64, 112, 512, 4096, 14336])
def test_w4_split_sizing(M, K):
    """Both paths' K splits: at most 8 slices (one portable cluster), each
    a multiple of 64 rows (the stream's stages and the TMA path's k steps),
    none empty, covering K; the TMA path splits only where its tiles leave
    SMs idle and never past one wave."""
    for Nh in (32, 500, 512, 1040, 2048, 3072, 7168, 14336):
        for tma in (False, True):
            nsplit, kchunk = TMW.w4_split(M, K, Nh, tma)
            assert 1 <= nsplit <= 8 and kchunk % 64 == 0
            assert (nsplit - 1) * kchunk < K <= nsplit * kchunk
            if tma:
                rows = TMW.w4_tma_rows(M, Nh)
                assert rows in (64, 128)
                tiles = -(-M // rows) * -(-Nh // 128)
                assert nsplit == 1 or tiles * nsplit <= 132


def test_w4_shape_rule():
    """TMA and wgmma only beyond M = 16, where the maps can address the
    weights: Nh a multiple of 16 and a 16-byte aligned stacked base."""
    assert TMW.w4_uses_tma(17, 1024, 4096)
    assert not TMW.w4_uses_tma(16, 1024, 4096)
    assert not TMW.w4_uses_tma(1024, 500, 4096)
    assert not TMW.w4_uses_tma(1024, 1024, 4097)
