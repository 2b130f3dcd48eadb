"""The paged serving slice of rsq_tpu_torch against rsq_tpu, end to end at
tiny size (2 layers, hidden 64, heads 4/2, head_dim 16, intermediate 112
so the K=28 Hadamard block runs, page 128, max_seq 256): the same params
(the same bytes, checked in test_torch_packing), the same cache state.

Tolerances.  W4A4 cascades amplify 1-ulp differences into int4 code flips
at rounding ties, so the reference does not even agree with itself: the
same jitted forward run op by op under jax.disable_jit (XLA then contracts
no multiply-adds into FMAs and fuses nothing) differs on this config, on
identical inputs, by up to 0.21 std of the logits at prefill (rms 0.068
std; 3.6% of the pool's k/v codes, and 2.1% of its (scale, zero) entries
by more than 5%) and 0.11 std at decode (rms 0.025 std).  The port is held
to that spread (LOGIT_MAX, LOGIT_RMS, CODE_FRAC, PARAM_FRAC), always on
identical cache state.  A real fault (a missing rotation, a
wrong scale) moves the logits by about 1 std."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.kernels import paged_kv as JPKV
from rsq_tpu.serving import model as JS
from rsq_tpu.serving import paged as JPG
from rsq_tpu.serving.native import PyPageAllocator as JPyPageAllocator
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.serving import model as TS
from rsq_tpu_torch.serving import paged as TPG
from rsq_tpu_torch.serving.native import PyPageAllocator
from rsq_tpu_torch.serving.params import from_numpy_params
from test_torch_packing import (dense_model, jax_serving_params,
                                torch_serving_params)

PAGE, MAX_SEQ = 128, 256
NAMES = ("kq", "kp", "vq", "vp")
LOGIT_MAX, LOGIT_RMS, CODE_FRAC, PARAM_FRAC = 0.25, 0.08, 0.04, 0.03  # module doc


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig.tiny()
    params, quant = dense_model(cfg, seed=1)
    jcfg, jsp = jax_serving_params(cfg, params, quant)
    return cfg, jcfg, jsp, torch_serving_params(cfg, params, quant)


@pytest.fixture
def reference_steps_copy_inputs(monkeypatch):
    """Closes a race of the reference's paged engine on the CPU backend.
    Its step hands the host `lengths` array to the asynchronously
    dispatched decode step through jnp.asarray, which aliases a numpy
    array whose data is 64-byte aligned instead of copying it, and then
    increments that array in place before the step has run.  Whether the
    step reads the old or the new lengths (rope positions, attention
    length) depends on where numpy put the array and on timing, so two
    identical runs can disagree (ROADMAP §3).  Here the step copies its
    host inputs before the engine goes on; the computation is unchanged."""
    step = JPG.decode_step_paged_fast

    def copied(params, pool, page_tables, lengths, token_ids, sc):
        return step(params, pool, *(jnp.array(np.array(a)) for a in
                                    (page_tables, lengths, token_ids)), sc)

    monkeypatch.setattr(JPG, "decode_step_paged_fast", copied)


def configs(cfg, jcfg, int8_qk=False):
    kw = dict(a4=True, kv_int4=True, kv_hadamard=True, online_had=True,
              max_seq=MAX_SEQ, attn_int8_qk=int8_qk)
    return JS.ServingConfig(model=jcfg, **kw), TS.ServingConfig(model=cfg, **kw)


def empty_pool(cfg, num_pages=6):
    """The reference's empty pool, as numpy (the JAX steps donate theirs)."""
    pool = JPKV.init_pool(cfg.num_layers, num_pages, cfg.num_key_value_heads,
                          cfg.head_dim_, PAGE)
    return {n: np.asarray(pool[n]) for n in NAMES}


def to_jax(pool):
    return {n: jnp.array(pool[n]) for n in NAMES}


def to_torch(pool):
    return from_numpy_params(pool, device="cpu")


def assert_logits_close(t, j):
    """Within the reference's own jit-vs-eager spread (module doc)."""
    t, j = t.float().numpy(), np.asarray(j, np.float32)
    sd = float(np.std(j))
    err = np.abs(t - j)
    assert err.max() <= LOGIT_MAX * sd, (err.max() / sd, "max")
    assert np.sqrt(np.mean(err ** 2)) <= LOGIT_RMS * sd, "rms"


def code_mismatch(t, j):
    """Fraction of int4 codes that differ."""
    t, j = t.numpy(), np.asarray(j)
    ct = np.stack([t & 15, t >> 4]).astype(np.int16)
    cj = np.stack([j & 15, j >> 4]).astype(np.int16)
    return float((ct != cj).mean())


def assert_pools_close(tpool, jpool):
    """Codes and (scale, zero) within the reference's own spread."""
    for n in ("kq", "vq"):
        assert code_mismatch(tpool[n], jpool[n]) <= CODE_FRAC, n
    for n in ("kp", "vp"):
        t, j = tpool[n].numpy(), jpool[n]
        off = np.abs(t - j) > 1e-3 + 0.05 * np.abs(j)
        assert off.mean() <= PARAM_FRAC, (n, off.mean())


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=n)


def _prefill_both(cfg, jcfg, jsp, tsp, pool, row, prompt, prefix_pages):
    """Prefill `prompt` in both packages from the same numpy pool state.
    Returns (torch logits, torch pool, jax logits, numpy pool of jax)."""
    jsc, tsc = configs(cfg, jcfg)
    prefix_len = prefix_pages * PAGE
    tail = prompt[prefix_len:]
    st = -(-len(tail) // PAGE) * PAGE
    tail_pad = np.zeros((1, st), np.int32)
    tail_pad[0, :len(tail)] = tail
    tl, tpool = TPG.prefill_paged_fast(
        tsp, to_torch(pool), row, torch.from_numpy(tail_pad.astype(np.int64)),
        tsc, prefix_pages=prefix_pages, prefix_len=prefix_len,
        prompt_len=len(prompt))
    jl, jpool = JPG.prefill_paged_fast(
        jsp, to_jax(pool), jnp.asarray(row, jnp.int32), jnp.asarray(tail_pad),
        jsc, prefix_pages=prefix_pages, prefix_len=prefix_len,
        prompt_len=len(prompt))
    return tl, tpool, np.asarray(jl), {n: np.asarray(jpool[n]) for n in NAMES}


@pytest.fixture(scope="module")
def prefilled(model):
    """Request A (200 tokens, pages [1, 2]) prefilled in both packages from
    an empty pool; then, from the JAX state carried across, request B (its
    first page shared with A, 150 tokens, pages [1, 3]) through the
    prefix-cache branch."""
    cfg, jcfg, jsp, tsp = model
    pa = _prompt(0, 200, cfg.vocab_size)
    pb = np.concatenate([pa[:PAGE], _prompt(1, 22, cfg.vocab_size)])
    a = _prefill_both(cfg, jcfg, jsp, tsp, empty_pool(cfg), [1, 2], pa, 0)
    b = _prefill_both(cfg, jcfg, jsp, tsp, a[3], [1, 3], pb, 1)
    return a, b


@pytest.mark.parametrize("which", ["plain", "prefix"])
def test_prefill_matches(prefilled, which):
    tl, tpool, jl, jpool = prefilled[0 if which == "plain" else 1]
    assert tl.shape == (256,) and torch.isfinite(tl).all()
    assert_logits_close(tl, jl)
    assert_pools_close(tpool, jpool)


@pytest.mark.parametrize("int8_qk", [False, True])
def test_decode_steps_match(model, prefilled, int8_qk):
    """3 decode steps, each started from the JAX pool state: logits close,
    pool close, and the appended columns are the only ones that move."""
    cfg, jcfg, jsp, tsp = model
    jsc, tsc = configs(cfg, jcfg, int8_qk)
    pool = prefilled[1][3]
    # slots A, B and an idle row on the null page 0
    ptab = np.array([[1, 2], [1, 3], [0, 0]], np.int32)
    lengths = np.array([200, 150, 0], np.int32)
    toks = np.array([5, 7, 0], np.int32)
    for _ in range(3):
        tpool = to_torch(pool)
        tl, tpool = TPG.decode_step_paged_fast(
            tsp, tpool, torch.from_numpy(ptab), torch.from_numpy(lengths),
            torch.from_numpy(toks), tsc)
        jl, jpool = JPG.decode_step_paged_fast(
            jsp, to_jax(pool), jnp.asarray(ptab), jnp.asarray(lengths),
            jnp.asarray(toks), jsc)
        jl = np.asarray(jl)
        jpool = {n: np.asarray(jpool[n]) for n in NAMES}
        for r in range(2):
            assert_logits_close(tl[r], jl[r])
        assert_pools_close(tpool, jpool)
        changed = (tpool["kq"] != torch.from_numpy(pool["kq"])).any(
            dim=(0, 2, 3))
        cols = {(int(ptab[r, lengths[r] // PAGE]), int(lengths[r] % PAGE))
                for r in range(3)}
        assert {tuple(map(int, ix)) for ix in changed.nonzero()} <= cols
        pool = jpool
        toks = np.argmax(jl, axis=-1).astype(np.int32)
        lengths = lengths + np.array([1, 1, 0], np.int32)


def test_engine_matches_reference_engine(model, reference_steps_copy_inputs):
    """Three requests (two sharing a full prompt page) through both engines:
    same token counts and prefix reuse.  Up to and including the first step
    where the two trajectories pick different tokens, both saw the same
    tokens, so their logits must agree within the end-to-end tolerance: a
    divergence is then an argmax near-tie of the reference, never a fault."""
    cfg, jcfg, jsp, tsp = model
    jsc, tsc = configs(cfg, jcfg)
    shared = _prompt(2, PAGE, cfg.vocab_size)
    prompts = [_prompt(3, 40, cfg.vocab_size),
               np.concatenate([shared, _prompt(4, 9, cfg.vocab_size)]),
               np.concatenate([shared, _prompt(5, 30, cfg.vocab_size)])]
    engines, stats = [], []
    for eng in (TPG.PagedServingEngine(tsp, tsc, num_slots=2, page_size=PAGE,
                                       record_logits=True, device="cpu"),
                JPG.PagedServingEngine(jsp, jsc, num_slots=2, page_size=PAGE,
                                       record_logits=True)):
        for p in prompts:
            eng.add_request(p, max_new_tokens=4)
        engines.append({r.uid: r for r in eng.run_until_done(max_steps=50)})
        stats.append(eng.cache_stats)
    assert stats[0] == stats[1]
    t, j = engines
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
    assert t[3].reused_pages == 1


def test_small_pages_raise(model):
    """Pages under 128 tokens are served now (test_torch_small_pages.py;
    the test keeps its name from when they were refused): the engine
    refuses only what the reference refuses, a page of 128 tokens or more
    that is not a multiple of 128, and serves page 64."""
    cfg, jcfg, jsp, tsp = model
    _, tsc = configs(cfg, jcfg)
    with pytest.raises(ValueError, match="multiple of 128"):
        TPG.PagedServingEngine(tsp, tsc, page_size=192, device="cpu")
    assert TPG.PagedServingEngine(tsp, tsc, page_size=64,
                                  device="cpu").pool["kq"].shape[-1] == 64


def test_prefix_hashes_and_allocator_match_reference():
    ids = np.arange(300) * 7 % 256
    assert TPG.prefix_hashes(ids, 128) == JPG.prefix_hashes(ids, 128)
    ops = [("alloc", 3), ("insert", 111, 0), ("insert", 111, 1),
           ("decref", 0), ("decref", 1), ("decref", 2), ("lookup", 111),
           ("lookup", 222), ("decref", 0), ("alloc", 6)]
    seen = []
    for alloc in (PyPageAllocator(6), JPyPageAllocator(6)):
        out = []
        for op in ops:
            if op[0] == "alloc":
                out.append(alloc.alloc(op[1]))
            elif op[0] == "insert":
                out.append(alloc.prefix_insert(op[1], op[2]))
            elif op[0] == "lookup":
                out.append(alloc.prefix_lookup(op[1]))
            else:
                alloc.decref(op[1])
            out.append((alloc.free_count, alloc.cached_count, alloc.stats))
        seen.append(out)
    assert seen[0] == seen[1]
    assert [f.name for f in dataclasses.fields(TPG.PagedRequest)] == [
        f.name for f in dataclasses.fields(JPG.PagedRequest)]
