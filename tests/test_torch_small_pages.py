"""Paged serving at pages under 128 tokens, rsq_tpu_torch against rsq_tpu:
the read-only paged attention (kernel table row 17) and the pool append
(row 21) as plain versions against the Pallas kernels in interpret mode
at pages 8, 16 and 64; the per-layer oracles prefill_paged and
decode_step_paged on unstacked params; and the page-16 engine step by
step against the reference's engine (tiny model of test_torch_paged.py:
2 layers, hidden 64, heads 4/2, head_dim 16, max_seq 256).

Tolerances: the append is bit-equal (integer stages); attention out
within 2 bf16 roundings (f32 sums in another order over other tiles), as
the earlier attention checks; model logits and pools within the
reference's own jit-vs-eager spread (LOGIT_MAX, LOGIT_RMS, CODE_FRAC,
PARAM_FRAC of test_torch_paged.py).  No new tolerance.

Mirrored from the reference: at pages under 128 the engine's decode step
ignores attn_int8_qk (the reference's sub-128 branch passes none,
serving/paged.py:398).  Not copied: the reference's append kernel
rewrites its whole window (a sub-128 page), so two rows appending into one
page in one step lose a write; the port writes one column, and its plain
version equals the reference's dynamic_update_slice oracle there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.kernels import paged_kv as JPKV
from rsq_tpu.serving import model as JS
from rsq_tpu.serving import paged as JPG
from rsq_tpu.serving import params as JP
from rsq_tpu_torch.kernels import paged_kv as TPKV
from rsq_tpu_torch.kernels.kv_cache import asym_quant_pack_head
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.serving import model as TS
from rsq_tpu_torch.serving import paged as TPG
from rsq_tpu_torch.serving import params as TP
from test_torch_packing import dense_model, jax_config, np_of
from test_torch_paged import (NAMES, assert_logits_close, assert_pools_close,
                              configs, reference_steps_copy_inputs)  # noqa: F401

BF16_EPS = 2.0 ** -8
PAGE = 16


def _pool(rng, L, P, H, D, page):
    def params():
        return np.stack([rng.uniform(0.01, 0.2, (L, P, H, page)),
                         rng.uniform(-0.5, 0.5, (L, P, H, page))],
                        axis=3).astype(np.float32)
    return [rng.integers(0, 256, (L, P, H, D // 2, page), dtype=np.uint8),
            params(),
            rng.integers(0, 256, (L, P, H, D // 2, page), dtype=np.uint8),
            params()]


# ---------------------------------------------------------------------------
# Row 17: read-only paged attention at any page size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page,int8_qk", [(8, False), (16, False), (16, True),
                                          (64, True)])
def test_paged_read_only_matches(page, int8_qk):
    """Rows that end mid-page and on a page boundary, over page tables in
    no pool order (a 128-token tile of the port spans 128 / page pages),
    and a row of one token.  The L = 1 view gives the stacked out."""
    rng = np.random.default_rng(page + 100 * int8_qk)
    L, B, Hkv, G, D = 2, 3, 2, 2, 64
    NP = -(-160 // page)
    P = B * NP + 1
    pool = _pool(rng, L, P, Hkv, D, page)
    ptab = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    lengths = np.array([NP * page - page // 2 - 1, (NP // 2) * page, 1],
                       np.int32)
    q = (rng.standard_normal((B, Hkv * G, D)) * 2).astype(np.float32)
    want = JPKV.int4_paged_decode_attention_stacked(
        jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, pool), 1,
        jnp.asarray(ptab), jnp.asarray(lengths), int8_qk=int8_qk)
    tpool = [torch.from_numpy(a) for a in pool]
    qt = torch.from_numpy(q).to(torch.bfloat16)
    got = TPKV.int4_paged_decode_attention_stacked(
        qt, *tpool, 1, torch.from_numpy(ptab), torch.from_numpy(lengths),
        int8_qk=int8_qk)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=4 * BF16_EPS, atol=2e-3)
    if not int8_qk:
        one = TPKV.int4_paged_decode_attention(
            qt, *(t[1] for t in tpool), torch.from_numpy(ptab),
            torch.from_numpy(lengths))
        np.testing.assert_array_equal(np_of(one), np_of(got))


# ---------------------------------------------------------------------------
# Row 21: the pool append
# ---------------------------------------------------------------------------

def _new_tokens(rng, B, H, D):
    """One token's lane-major (B, H, D/2, 1) codes and (B, H, 2, 1) params
    for k and v, as numpy."""
    out = []
    for _ in range(2):
        q, p = asym_quant_pack_head(torch.from_numpy(
            rng.standard_normal((B, H, D)).astype(np.float32)))
        out += [q.numpy()[..., None], p.numpy()[..., None]]
    return out


def _append_both(pool, ptab, positions, new, layer):
    """The port's paged_append_pool on a copy of pool, and the reference's
    kernel and its dynamic_update_slice oracle: three numpy pools."""
    tpool = [torch.from_numpy(a.copy()) for a in pool]
    TPKV.paged_append_pool(*tpool, layer, torch.from_numpy(ptab),
                           torch.from_numpy(positions),
                           *(torch.from_numpy(a[..., 0]) for a in new))
    jpool = [jnp.asarray(a) for a in pool]
    jk = JPKV.paged_append_pool(*jpool, layer, jnp.asarray(ptab),
                                jnp.asarray(positions),
                                *map(jnp.asarray, new))
    jo = JPG._pool_append_token(dict(zip(NAMES, jpool)), layer,
                                jnp.asarray(ptab), jnp.asarray(positions),
                                *map(jnp.asarray, new))
    return ([t.numpy() for t in tpool], [np.asarray(a) for a in jk],
            [np.asarray(jo[n]) for n in NAMES])


@pytest.mark.parametrize("page", [8, 16, 64])
def test_paged_append_bit_equal(page):
    """Rows on their second and third pages, mid-page and at lane 0 and the
    last lane, and an idle row on the null page 0: bit-equal to the
    reference's kernel and to its oracle; only the appended columns move."""
    rng = np.random.default_rng(page)
    L, P, H, D, B = 2, 10, 2, 32, 4
    pool = _pool(rng, L, P, H, D, page)
    ptab = np.array([[1, 4, 2], [5, 6, 3], [7, 8, 9], [0, 0, 0]], np.int32)
    positions = np.array([page + 1, 2 * page + page - 1, page, 0], np.int32)
    new = _new_tokens(rng, B, H, D)
    got, kern, oracle = _append_both(pool, ptab, positions, new, 1)
    for g, k, o, before in zip(got, kern, oracle, pool):
        np.testing.assert_array_equal(g, k)
        np.testing.assert_array_equal(g, o)
        moved = np.argwhere((g != before).any(axis=(2, 3)))
        cols = {(1, int(ptab[b, positions[b] // page]), int(positions[b] % page))
                for b in range(B)}
        assert {tuple(map(int, m)) for m in moved} <= cols


def test_paged_append_cross_page_and_shared_page():
    """The reference's own cross-boundary case (tests/test_paged_kv.py:224:
    page 8, positions 9 and 17 through tables [[1, 4, 2], [5, 2, 3]]):
    bit-equal to its kernel.  Then two live rows appending into one shared
    page at different lanes in one step: both writes land, equal to the
    reference's dynamic_update_slice oracle (its window kernel keeps only
    one of them)."""
    rng = np.random.default_rng(13)
    L, P, H, D, page, B = 1, 6, 2, 64, 8, 2
    pool = _pool(rng, L, P, H, D, page)
    new = _new_tokens(rng, B, H, D)
    ptab = np.array([[1, 4, 2], [5, 2, 3]], np.int32)
    got, kern, oracle = _append_both(pool, ptab, np.array([9, 17], np.int32),
                                     new, 0)
    for g, k, o in zip(got, kern, oracle):
        np.testing.assert_array_equal(g, k)
        np.testing.assert_array_equal(g, o)
    shared = np.array([[1, 4, 2], [4, 5, 3]], np.int32)   # page 4 in both
    got, _, oracle = _append_both(pool, shared, np.array([10, 3], np.int32),
                                  new, 0)
    for g, o, n in zip(got, oracle, new):
        np.testing.assert_array_equal(g, o)
        np.testing.assert_array_equal(g[0, 4, ..., 2], n[0, ..., 0])
        np.testing.assert_array_equal(g[0, 4, ..., 3], n[1, ..., 0])


def test_append_refuses_unaligned_large_page():
    """Mirrored: pages of 128 tokens or more must be multiples of 128."""
    kq = torch.zeros((1, 2, 2, 8, 192), dtype=torch.uint8)
    kp = torch.zeros((1, 2, 2, 2, 192))
    with pytest.raises(ValueError, match="multiples of 128"):
        TPKV.paged_append_pool(kq, kp, kq.clone(), kp.clone(), 0,
                               torch.zeros((1, 2), dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32),
                               torch.zeros((1, 2, 8), dtype=torch.uint8),
                               torch.zeros((1, 2, 2)),
                               torch.zeros((1, 2, 8), dtype=torch.uint8),
                               torch.zeros((1, 2, 2)))


# ---------------------------------------------------------------------------
# The per-layer oracles and the page-16 engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """W4A4 fused params, unstacked (the oracles) and stacked (the engine),
    in both packages."""
    cfg = ModelConfig.tiny()
    jcfg = jax_config(cfg)
    params, quant = dense_model(cfg, seed=1)
    jl = JS.quantize_lm_head(JP.fuse_for_decode(
        JP.to_serving_params(params, quant, jcfg)))
    tl = TS.quantize_lm_head(TP.fuse_for_decode(
        TP.to_serving_params(params, quant, cfg, device="cpu")))
    return cfg, jcfg, jl, tl


def _empty_pool(cfg, num_pages):
    pool = JPKV.init_pool(cfg.num_layers, num_pages, cfg.num_key_value_heads,
                          cfg.head_dim_, PAGE)
    return {n: np.asarray(pool[n]) for n in NAMES}


def _np(pool):
    return {n: np.asarray(pool[n]) for n in NAMES}


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=n)


def _oracle_prefill(cfg, jcfg, jp, tp, pool, row, prompt, prefix_pages):
    jsc, tsc = configs(cfg, jcfg)
    prefix_len = prefix_pages * PAGE
    tail = prompt[prefix_len:]
    tail_pad = np.zeros((1, -(-len(tail) // PAGE) * PAGE), np.int32)
    tail_pad[0, :len(tail)] = tail
    tl, tpool = TPG.prefill_paged(
        tp, TP.from_numpy_params(pool, device="cpu"), row,
        torch.from_numpy(tail_pad.astype(np.int64)), tsc, prefix_pages,
        prefix_len, len(prompt))
    jl, jpool = JPG.prefill_paged(
        jp, {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(row, jnp.int32), jnp.asarray(tail_pad), jsc,
        prefix_pages=prefix_pages, prefix_len=prefix_len,
        prompt_len=len(prompt))
    return tl, tpool, np.asarray(jl, np.float32), _np(jpool)


def test_oracles_match(model):
    """prefill_paged from an empty pool (request A, 45 tokens, pages
    [1, 2, 3]) and, from the reference's state, through the prefix-cache
    branch (request B shares A's first two pages, 40 tokens, pages
    [1, 2, 4]); then 2 decode_step_paged steps at lengths (45, 40) with an
    idle row on the null page 0, each from the reference's pool: logits and
    pools within the spread, only the appended columns moved."""
    cfg, jcfg, jp, tp = model
    jsc, tsc = configs(cfg, jcfg)
    pa = _prompt(0, 45, cfg.vocab_size)
    pb = np.concatenate([pa[:2 * PAGE], _prompt(1, 8, cfg.vocab_size)])
    pool = _empty_pool(cfg, 6)
    for prompt, row, prefix in ((pa, [1, 2, 3], 0), (pb, [1, 2, 4], 2)):
        tl, tpool, jl, pool = _oracle_prefill(cfg, jcfg, jp, tp, pool, row,
                                              prompt, prefix)
        assert tl.shape == (cfg.vocab_size,) and torch.isfinite(tl).all()
        assert_logits_close(tl, jl)
        assert_pools_close(tpool, pool)
    ptab = np.array([[1, 2, 3], [1, 2, 4], [0, 0, 0]], np.int32)
    lengths = np.array([45, 40, 0], np.int32)
    toks = np.array([5, 7, 0], np.int32)
    for _ in range(2):
        tl, tpool = TPG.decode_step_paged(
            tp, TP.from_numpy_params(pool, device="cpu"),
            torch.from_numpy(ptab), torch.from_numpy(lengths),
            torch.from_numpy(toks), tsc)
        jl, jpool = JPG.decode_step_paged(
            jp, {n: jnp.asarray(a) for n, a in pool.items()},
            jnp.asarray(ptab), jnp.asarray(lengths), jnp.asarray(toks), jsc)
        jl, jpool = np.asarray(jl, np.float32), _np(jpool)
        for r in range(2):
            assert_logits_close(tl[r], jl[r])
        assert_pools_close(tpool, jpool)
        moved = (tpool["kq"] != torch.from_numpy(np.array(pool["kq"]))).any(
            dim=(0, 2, 3))
        cols = {(int(ptab[r, lengths[r] // PAGE]), int(lengths[r] % PAGE))
                for r in range(3)}
        assert {tuple(map(int, m)) for m in moved.nonzero()} <= cols
        pool = jpool
        toks = np.argmax(jl, axis=-1).astype(np.int32)
        lengths = lengths + np.array([1, 1, 0], np.int32)


def test_page16_engine_matches_reference_engine(model,
                                                reference_steps_copy_inputs):
    """Three requests through two slots of each engine at page 16 (two
    share two full prompt pages), attn_int8_qk on in the config (ignored
    by both at this page size): same token counts, prefix reuse and cache
    stats; logits within the spread up to the first step where the
    trajectories pick different tokens (until then both saw the same
    tokens)."""
    cfg, jcfg, jp, tp = model
    jsc, tsc = configs(cfg, jcfg, int8_qk=True)
    shared = _prompt(2, 2 * PAGE, cfg.vocab_size)
    prompts = [_prompt(3, 21, cfg.vocab_size),
               np.concatenate([shared, _prompt(4, 9, cfg.vocab_size)]),
               np.concatenate([shared, _prompt(5, 30, cfg.vocab_size)])]
    runs, stats = [], []
    for eng in (TPG.PagedServingEngine(TS.stack_layer_params(tp), tsc,
                                       num_slots=2, page_size=PAGE,
                                       record_logits=True, device="cpu"),
                JPG.PagedServingEngine(JS.stack_layer_params(jp), jsc,
                                       num_slots=2, page_size=PAGE,
                                       record_logits=True)):
        for p in prompts:
            eng.add_request(p, max_new_tokens=4)
        runs.append({r.uid: r for r in eng.run_until_done(max_steps=50)})
        stats.append(eng.cache_stats)
    assert stats[0] == stats[1]
    t, j = runs
    assert set(t) == set(j) == {1, 2, 3}
    for uid in t:
        a, b = t[uid], j[uid]
        assert len(a.output) == len(b.output) == 4
        assert a.reused_pages == b.reused_pages
        for step, (x, y) in enumerate(zip(a.output, b.output)):
            assert_logits_close(torch.from_numpy(a.logit_trace[step]),
                                b.logit_trace[step])
            if x != y:
                break
    assert t[3].reused_pages == 2
