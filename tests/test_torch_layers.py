"""The per-layer serving slice of rsq_tpu_torch against rsq_tpu, at tiny
size (2 layers, hidden 64, heads 4/2, head_dim 16, intermediate 112,
max_seq 256): the unstacked matmuls (kernel table rows 9, 10, 11) and the
read-only contiguous attention (row 2) as plain versions against the
Pallas kernels in interpret mode; serving_linear and serving_linear_fused
in every layout; prefill and decode_step on unstacked params in the
configurations A, B and C of test_torch_contiguous.py on identical cache
state; prefill_stacked against prefill; and the RSQ_SCAN_DECODE=1 branch
of decode_step_stacked against decode_step and against the reference's
own scan branch.

Tolerances are the ones the earlier slices state (test_torch_paged.py,
test_torch_contiguous.py): integer stages (W4A4 accumulators, cache codes
written from bit-equal inputs) bit-equal; weight-only and affine matmuls
within 2^-7 of the largest output + 1e-5 (f32 sums in another order, then
one bf16 rounding; the reference's biased dot adds its own); attention out
within 2 bf16 roundings, m and l within 1e-5 relative + 1e-5; model logits
within the reference's own jit-vs-eager spread (LOGIT_TOL) and caches
within its spread (CODE_FRAC, PARAM_FRAC, BF16_CACHE_STD).  The
reference's per-layer decode_step is jitted, its scan branch is run
unjitted here (so that it is traced anew under RSQ_SCAN_DECODE=1): the
scan comparison is held to the same spread.  One tolerance is new: the
port's own layer-scanned forms run the same functions in the same order
as the per-layer ones on views of the same tensors, so they must be
bit-equal to them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.kernels import kv_cache as JKV
from rsq_tpu.kernels import matmul_w4 as JMW
from rsq_tpu.serving import model as JS
from rsq_tpu.serving import params as JP
from rsq_tpu_torch.kernels import kv_cache as TKV
from rsq_tpu_torch.kernels import matmul_w4 as TMW
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.serving import model as TS
from rsq_tpu_torch.serving import params as TP
from test_torch_contiguous import (BF16_CACHE_STD, BF16_EPS, CONFIGS,
                                   LOGIT_TOL, PREFILL_CODE_FRAC,
                                   PREFILL_PARAM_FRAC,
                                   _int4_cache, _positions, both, configs,
                                   f32)
from test_torch_packing import dense_model, jax_config, np_of
from test_torch_paged import CODE_FRAC, PARAM_FRAC, code_mismatch


def close_w4(t, j):
    """Weight-only and affine matmuls: within 2^-7 of the largest output."""
    t, j = f32(t), f32(j)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= 2.0 ** -7 * np.abs(j).max() + 1e-5


def _packed(rng, K, Nh, L=None):
    shape = (K, Nh) if L is None else (L, K, Nh)
    wp = rng.integers(0, 256, shape, dtype=np.uint8)
    s2 = (rng.uniform(0.5, 1.5, (2, Nh)) / (7 * np.sqrt(K))).astype(np.float32)
    return wp, s2


# ---------------------------------------------------------------------------
# Rows 9, 10, 11: the unstacked matmuls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decode", [True, False, None])
@pytest.mark.parametrize("M", [3, 40])
def test_w4a4_paired_bit_equal(decode, M):
    """Row 11: the reference's int8 (decode) and bf16 (prefill) bodies sum
    the same integers exactly; the port's one version equals both, bit for
    bit, at M <= 32 and above (decode=None picks by M), with the absmax
    scale and with an explicit token_scale."""
    rng = np.random.default_rng(M + 3 * (decode is None) + 5 * bool(decode))
    K, Nh = 112, 48
    wp, s2 = _packed(rng, K, Nh)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xj, xt = both(x, "bfloat16")
    want = JMW.w4a4_matmul_paired(xj, jnp.asarray(wp), jnp.asarray(s2),
                                  clip_ratio=0.9, decode=decode)
    got = TMW.w4a4_matmul_paired(xt, torch.from_numpy(wp),
                                 torch.from_numpy(s2), clip_ratio=0.9,
                                 decode=decode)
    assert got.shape == (M, 2, Nh) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np_of(got), np_of(want))
    ts = (np.abs(x).max(axis=1, keepdims=True) * 1.3 / 7).astype(np.float32)
    want = JMW.w4a4_matmul_paired(xj, jnp.asarray(wp), jnp.asarray(s2),
                                  jnp.asarray(ts), decode=decode)
    got = TMW.w4a4_matmul_paired(xt, torch.from_numpy(wp),
                                 torch.from_numpy(s2), torch.from_numpy(ts),
                                 decode=decode)
    np.testing.assert_array_equal(np_of(got), np_of(want))
    sc = rng.uniform(0.01, 0.1, 2 * Nh).astype(np.float32)
    np.testing.assert_array_equal(
        np_of(TMW.w4a4_matmul(xt, torch.from_numpy(wp), torch.from_numpy(sc),
                              decode=decode)),
        np_of(JMW.w4a4_matmul(xj, jnp.asarray(wp), jnp.asarray(sc),
                              decode=decode)))


def test_clipped_token_scale_bit_equal():
    """With an activation clip ratio other than 1 the jitted reference folds
    `absmax * clip / 7.0` into one constant, absmax * f32(clip * f32(1/7));
    the port rounded (absmax * clip) * f32(1/7) instead, and the stacked
    W4A4 matmul then differed by an ulp at some outputs."""
    rng = np.random.default_rng(45)
    K, Nh = 112, 48
    wp, s2 = _packed(rng, K, Nh, L=2)
    xj, xt = both(rng.standard_normal((40, K)), "bfloat16")
    for clip in (0.9, 0.85):
        np.testing.assert_array_equal(
            np_of(TMW.w4a4_matmul_paired_stacked(
                xt, torch.from_numpy(wp), torch.from_numpy(s2), 1,
                clip_ratio=clip)),
            np_of(JMW.w4a4_matmul_paired_stacked(
                xj, jnp.asarray(wp), jnp.asarray(s2), 1, clip_ratio=clip)))


@pytest.mark.parametrize("M", [3, 40])
def test_w4_paired_matches(M):
    """Row 9 (weight-only), Nh = 40: no tile multiple, no padding."""
    rng = np.random.default_rng(M)
    wp, s2 = _packed(rng, 64, 40)
    xj, xt = both(rng.standard_normal((M, 64)), "bfloat16")
    got = TMW.w4_matmul_paired(xt, torch.from_numpy(wp), torch.from_numpy(s2))
    assert got.shape == (M, 2, 40)
    close_w4(got, JMW.w4_matmul_paired(xj, jnp.asarray(wp), jnp.asarray(s2)))


@pytest.mark.parametrize("plane_major", [False, True])
def test_w4_affine_matches(plane_major):
    """Row 10: the per-tensor sh and the rank-1 +0.5 term, both un-pairings."""
    rng = np.random.default_rng(11 + plane_major)
    wp, _ = _packed(rng, 112, 24)
    sh = np.float32(0.0123)
    xj, xt = both(rng.standard_normal((5, 112)), "bfloat16")
    got = TMW.w4_affine_matmul(xt, torch.from_numpy(wp), torch.tensor(sh),
                               plane_major=plane_major)
    want = JMW.w4_affine_matmul(xj, jnp.asarray(wp), jnp.asarray(sh),
                                plane_major=plane_major)
    assert got.shape == (5, 48)
    close_w4(got, want)


# ---------------------------------------------------------------------------
# Row 2: the read-only contiguous attention, with its softmax state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8_qk", [False, True])
def test_decode_attention_stacked_matches(int8_qk):
    """out within 2 bf16 roundings (p rounds to bf16 against another
    running maximum: the reference's tiles are 128 tokens here, the plain
    version's the whole cache), m and l within 1e-5 relative + 1e-5 (a
    logit is the difference of two f32 products summed in another order,
    so near 0 its error is absolute); the row of
    length 0 gives m = -inf, l = 0 and out = 0/0 in both.  The L = 1 view
    gives the stacked function's out on that layer."""
    rng = np.random.default_rng(4 + int8_qk)
    L, B, Hkv, G, D, S = 2, 4, 2, 2, 64, 384
    cache = _int4_cache(rng, L, B, Hkv, D, S)
    lengths = np.array([300, 128, 0, 1], np.int32)
    q = (rng.standard_normal((B, Hkv * G, D)) * 2).astype(np.float32)
    qj, qt = both(q, "bfloat16")
    jo, jm, jl = JKV.int4_decode_attention_stacked(
        qj, *map(jnp.asarray, cache), 1, jnp.asarray(lengths), chunk=128,
        int8_qk=int8_qk)
    tcache = [torch.from_numpy(a) for a in cache]
    to, tm, tl = TKV.int4_decode_attention_stacked(
        qt, *tcache, 1, torch.from_numpy(lengths), int8_qk=int8_qk)
    assert to.dtype == torch.bfloat16 and tm.shape == tl.shape == (B, Hkv, G)
    live = lengths > 0
    np.testing.assert_allclose(f32(to)[live], f32(jo)[live],
                               rtol=4 * BF16_EPS, atol=2e-3)
    np.testing.assert_allclose(f32(tm)[live], f32(jm)[live], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(f32(tl)[live], f32(jl)[live], rtol=1e-5,
                               atol=1e-5)
    assert np.all(f32(tm)[~live] == -np.inf) and np.all(f32(jm)[~live] == -np.inf)
    assert np.all(f32(tl)[~live] == 0) and np.all(f32(jl)[~live] == 0)
    assert np.isnan(f32(to)[~live]).all() and np.isnan(f32(jo)[~live]).all()
    if not int8_qk:
        one = TKV.int4_decode_attention(qt, *(t[1] for t in tcache),
                                        torch.from_numpy(lengths))
        np.testing.assert_array_equal(np_of(one)[live], np_of(to)[live])


# ---------------------------------------------------------------------------
# serving_linear and serving_linear_fused, every layout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """The tiny model unstacked, per configuration: (JAX params, torch
    params) as serving_linear, prefill and decode_step take them."""
    cfg = ModelConfig.tiny()
    jcfg = jax_config(cfg)
    params, quant = dense_model(cfg, seed=1)
    fused = (JS.quantize_lm_head(JP.fuse_for_decode(
                 JP.to_serving_params(params, quant, jcfg))),
             TS.quantize_lm_head(TP.fuse_for_decode(
                 TP.to_serving_params(params, quant, cfg, device="cpu"))))
    dense = (JP.to_serving_params(params, {}, jcfg),
             TP.to_serving_params(params, {}, cfg, device="cpu"))
    packed = (JP.to_serving_params(params, quant, jcfg),
              TP.to_serving_params(params, quant, cfg, device="cpu"))
    return cfg, jcfg, {"A": fused, "B": dense, "C": dense}, packed


def test_serving_linear_every_layout(model):
    """Against the reference's serving_linear(_fused) at both phase hints:
    W4A4 in the adjacent 'wp' and plane-major 'wpm' layouts and fused:
    bit-equal; weight-only (a4=False) in the same three, and affine E8P on
    'wp' and 'wpm' with a bias: within 2^-7 of the largest output; dense
    'w': within one bf16 rounding; the legacy 'codes' bit-equal to the
    stacked path's plain product (held against the reference there).
    tp_axis is not ported and raises."""
    cfg, jcfg, P, (jpk, tpk) = model
    x = np.random.default_rng(3).standard_normal((2, 3, 64)).astype(np.float32)
    xj, xt = both(x, "bfloat16")
    (jfa, tfa), (jd, td) = P["A"], P["B"]
    for name, a4, decode in (("A", True, True), ("A", True, None),
                             ("C", False, None)):
        jsc, tsc = configs(cfg, jcfg, name)
        cmp = (lambda t, j: np.testing.assert_array_equal(np_of(t), np_of(j))) \
            if a4 else close_w4
        for jp, tp in ((jpk["layers"][1]["q"], tpk["layers"][1]["q"]),
                       (jfa["layers"][1]["o"], tfa["layers"][1]["o"])):
            got = TS.serving_linear(xt, tp, tsc, decode=decode)
            assert got.shape == (2, 3, 64)
            cmp(got, JS.serving_linear(xj, jp, jsc, decode=decode))
        segs = TS.serving_linear_fused(xt, tfa["layers"][0]["qkv"], tsc,
                                       decode=decode)
        assert [s.shape[-1] for s in segs] == [64, 32, 32]
        for t, j in zip(segs, JS.serving_linear_fused(
                xj, jfa["layers"][0]["qkv"], jsc, decode=decode)):
            cmp(t, j)
    jsc, tsc = configs(cfg, jcfg, "C")
    rng = np.random.default_rng(8)
    wp, _ = _packed(rng, 64, 16)
    sh, b = np.float32(0.021), rng.standard_normal(32).astype(np.float32)
    for key in ("wp", "wpm"):                      # affine E8P, with a bias
        jp = {key: jnp.asarray(wp), "sh": jnp.asarray(sh),
              "b": jnp.asarray(b, jnp.bfloat16)}
        tp = {key: torch.from_numpy(wp), "sh": torch.tensor(sh),
              "b": torch.from_numpy(b).to(torch.bfloat16)}
        close_w4(TS.serving_linear(xt, tp, tsc),
                 JS.serving_linear(xj, jp, jsc))
    # legacy 'codes': the plain product of _linear_fast, which
    # test_torch_contiguous holds against the reference
    codes = {"codes": torch.from_numpy(rng.integers(0, 1 << 16, (2, 32, 8))
                                       .astype(np.int32)),
             "e8p_scale": torch.tensor([0.02, 0.03]), "b": None}
    np.testing.assert_array_equal(
        np_of(TS.serving_linear(xt, {k: (v if v is None else v[1])
                                     for k, v in codes.items()}, tsc)),
        np_of(TS._linear_fast(xt.reshape(6, 64), codes, 1, tsc)
              .reshape(2, 3, 32)))
    np.testing.assert_allclose(
        f32(TS.serving_linear(xt, td["layers"][0]["up"], tsc)),
        f32(JS.serving_linear(xj, jd["layers"][0]["up"], jsc)),
        rtol=2 * BF16_EPS, atol=1e-6)
    with pytest.raises(NotImplementedError, match="item 17"):
        TS.serving_linear(xt, tpk["layers"][0]["q"], tsc, tp_axis="tp")


# ---------------------------------------------------------------------------
# prefill and decode_step against the reference, A, B and C
# ---------------------------------------------------------------------------

PROMPT_LEN, BATCH = 24, 2
LENGTHS = [24, 17]      # row 1 decodes from position 17: rows of unequal length


def _assert_logits(t, j, name):
    t, j = f32(t), np.asarray(j, np.float32)
    lmax, lrms = LOGIT_TOL[name]
    sd = float(np.std(j))
    err = np.abs(t - j)
    assert err.max() <= lmax * sd, (err.max() / sd, "max")
    assert np.sqrt(np.mean(err ** 2)) <= lrms * sd, "rms"


def _assert_cache_close(tc, jc, name, code_frac, param_frac, n):
    """Positions [0, n): INT4 codes and (scale, zero) within the given
    spread; bf16 values within BF16_CACHE_STD."""
    for k, t in tc.items():
        if k == "length":
            continue
        ax = _positions(k)
        t = torch.from_numpy(np.take(np_of(t), range(n), axis=ax))
        j = np.take(jc[k], range(n), axis=ax)
        if k in ("kq", "vq"):
            assert code_mismatch(t, j) <= code_frac, k
        elif k in ("kp", "vp"):
            off = np.abs(t.numpy() - j) > 1e-3 + 0.05 * np.abs(j)
            assert off.mean() <= param_frac, k
        else:
            t = t.view(torch.bfloat16).float().numpy()
            jv = j.astype(np.float32)
            assert np.abs(t - jv).max() <= BF16_CACHE_STD * np.abs(jv).std(), k


@pytest.fixture(scope="module")
def prefilled(model):
    """Per configuration: the same prompts (2 x 24 tokens) prefilled by both
    packages' per-layer prefill.  {name: (t logits, t cache, j logits,
    j cache as numpy)}."""
    cfg, jcfg, P, _ = model
    ids = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                            (BATCH, PROMPT_LEN))
    out = {}
    for name in CONFIGS:
        jsc, tsc = configs(cfg, jcfg, name)
        jp, tp = P[name]
        jl, jc = JS.prefill(jp, JS.init_cache(jsc, BATCH),
                            jnp.asarray(ids, jnp.int32), jsc)
        tl, tc = TS.prefill(tp, TS.init_cache(tsc, BATCH, device="cpu"),
                            torch.from_numpy(ids), tsc)
        out[name] = (tl, tc, np.asarray(jl, np.float32),
                     {k: np.asarray(v) for k, v in jc.items()})
    return ids, out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_matches(model, prefilled, name):
    cfg = model[0]
    tl, tc, jl, jc = prefilled[1][name]
    assert tl.shape == (BATCH, cfg.vocab_size) and torch.isfinite(tl).all()
    for r in range(BATCH):
        _assert_logits(tl[r], jl[r], name)
    assert tc["length"].tolist() == jc["length"].tolist() == [PROMPT_LEN] * 2
    _assert_cache_close(tc, jc, name, PREFILL_CODE_FRAC.get(name),
                        PREFILL_PARAM_FRAC.get(name), PROMPT_LEN)


def _np_cache(c):
    return {k: np.asarray(v) for k, v in c.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_steps_match(model, prefilled, name):
    """3 decode steps at lengths (24, 17), each started from the
    reference's cache state: logits within the spread, every cache position
    but the appended one untouched, the cache within the decode spread."""
    cfg, jcfg, P, _ = model
    jsc, tsc = configs(cfg, jcfg, name)
    jp, tp = P[name]
    cache = dict(prefilled[1][name][3])
    cache["length"] = np.array(LENGTHS, np.int32)
    toks = np.array([5, 7], np.int32)
    for _ in range(3):
        lengths = cache["length"].copy()
        tl, tc = TS.decode_step(tp, TP.from_numpy_params(cache, device="cpu"),
                                torch.from_numpy(toks), tsc)
        jl, jc = JS.decode_step(jp, {k: jnp.asarray(v) for k, v in
                                     cache.items()}, jnp.asarray(toks), jsc)
        jl, jc = np.asarray(jl, np.float32), _np_cache(jc)
        for r in range(BATCH):
            _assert_logits(tl[r], jl[r], name)
        assert tc["length"].tolist() == jc["length"].tolist() \
            == (lengths + 1).tolist()
        for k in tc:
            if k == "length":
                continue
            t, old, ax = np_of(tc[k]), np_of(cache[k]), _positions(k)
            for b, pos in enumerate(lengths):
                rest = [i for i in range(t.shape[ax]) if i != pos]
                np.testing.assert_array_equal(np.take(t[:, b], rest, axis=ax),
                                              np.take(old[:, b], rest, axis=ax))
        _assert_cache_close(tc, jc, name, CODE_FRAC, PARAM_FRAC,
                            int(lengths.max()) + 1)
        cache = jc
        toks = np.argmax(jl, axis=-1).astype(np.int32)


# ---------------------------------------------------------------------------
# The layer-scanned forms
# ---------------------------------------------------------------------------

def _stacked(tp):
    return TS.stack_layer_params(tp)


@pytest.mark.parametrize("name", ["A", "B"])
def test_prefill_stacked_bit_equal_to_prefill(model, prefilled, name):
    cfg, jcfg, P, _ = model
    _, tsc = configs(cfg, jcfg, name)
    ids = prefilled[0]
    tl, tc = TS.prefill_stacked(_stacked(P[name][1]),
                                TS.init_cache(tsc, BATCH, device="cpu"),
                                torch.from_numpy(ids), tsc)
    want_l, want_c = prefilled[1][name][:2]
    assert torch.equal(tl, want_l)
    for k in want_c:
        assert torch.equal(tc[k], want_c[k]), k


@pytest.mark.parametrize("name", ["A", "C"])
def test_scan_decode_matches(model, prefilled, name, monkeypatch):
    """decode_step_stacked under RSQ_SCAN_DECODE=1: bit-equal to the port's
    per-layer decode_step on the same state, and within the spread of the
    reference's scan branch, which runs unjitted here so that it is traced
    anew with the variable set (asserted: its fast path is never called
    and its per-slice body runs once per layer)."""
    cfg, jcfg, P, _ = model
    jsc, tsc = configs(cfg, jcfg, name)
    jp, tp = P[name]
    state = dict(prefilled[1][name][3])
    state["length"] = np.array(LENGTHS, np.int32)
    toks = np.array([3, 11], np.int32)
    monkeypatch.setenv("RSQ_SCAN_DECODE", "1")
    sl, sc_ = TS.decode_step_stacked(
        _stacked(tp), TP.from_numpy_params(state, device="cpu"),
        torch.from_numpy(toks), tsc)
    monkeypatch.delenv("RSQ_SCAN_DECODE")
    pl, pc = TS.decode_step(tp, TP.from_numpy_params(state, device="cpu"),
                            torch.from_numpy(toks), tsc)
    assert torch.equal(sl, pl)
    for k in pc:
        assert torch.equal(sc_[k], pc[k]), k

    calls = []

    def no_fast(*a, **k):
        raise AssertionError("the reference took its fast path")

    body = JS._decode_cache_slice

    def counted(*a, **k):
        calls.append(1)
        return body(*a, **k)

    monkeypatch.setattr(JS, "_decode_step_fast", no_fast)
    monkeypatch.setattr(JS, "_decode_cache_slice", counted)
    monkeypatch.setenv("RSQ_SCAN_DECODE", "1")
    jl, jc = JS.decode_step_stacked.__wrapped__(
        JS.stack_layer_params(jp), {k: jnp.asarray(v) for k, v in
                                    state.items()}, jnp.asarray(toks), jsc)
    assert calls, "the reference's scan body was not traced"
    jl, jc = np.asarray(jl, np.float32), _np_cache(jc)
    for r in range(BATCH):
        _assert_logits(sl[r], jl[r], name)
    _assert_cache_close(sc_, jc, name, CODE_FRAC, PARAM_FRAC, PROMPT_LEN + 1)
    assert sc_["length"].tolist() == jc["length"].tolist()


def test_unstack_layer_params_views(model):
    """unstack_layer_params inverts stack_layer_params without copying."""
    tp = model[2]["A"][1]
    st = _stacked(tp)
    back = TS.unstack_layer_params(st)
    w = st["layers_stacked"]["qkv"]["wp2"]
    for i, lp in enumerate(back["layers"]):
        assert lp["qkv"]["wp2"].data_ptr() == w[i].data_ptr()
        assert torch.equal(lp["down"]["wpm"], tp["layers"][i]["down"]["wpm"])
        assert lp["input_norm"] is None or torch.equal(
            lp["input_norm"], tp["layers"][i]["input_norm"])
