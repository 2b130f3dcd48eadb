"""The contiguous-cache serving slice of rsq_tpu_torch against rsq_tpu, at
tiny size (2 layers, hidden 64, heads 4/2, head_dim 16, intermediate 112,
max_seq 256): the kernels' plain versions against the Pallas kernels in
interpret mode, then prefill, decode steps, greedy runs and the engines
in three configurations:

- A: W4A4 weights (fused, plane-major), INT4 KV with Hadamards, int8
  lm_head -- the bench's "contiguous" serving;
- B: dense bf16 weights, bf16 KV, no Hadamards -- the bench's bf16
  baseline;
- C: dense bf16 weights with INT4 KV -- the reference's own engine tests.

Tolerances of the model-level checks are the reference's own spread: the
same prefill run op by op under jax.disable_jit differs from the jitted
one, on identical inputs, by 0.13 std of the logits in A (0.016 in B and
C); in layer 1 of its cache by 22% of A's INT4 codes and 7% of its
(scale, zero) entries by more than 5%, by 2.1% of C's codes, and by 0.036
std of B's values (measured on this model and prompt).  Layer 0 is
bit-equal in all three.  A real fault (a missing rotation, a wrong scale)
moves the logits by about 1 std."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.kernels import kv_cache as JKV
from rsq_tpu.kernels import matmul_w4 as JMW
from rsq_tpu.serving import engine as JE
from rsq_tpu.serving import model as JS
from rsq_tpu.serving import params as JP
from rsq_tpu_torch.kernels import kv_cache as TKV
from rsq_tpu_torch.kernels import matmul_w4 as TMW
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.serving import engine as TE
from rsq_tpu_torch.serving import model as TS
from rsq_tpu_torch.serving import paged as TPG
from rsq_tpu_torch.serving import params as TP
from test_torch_packing import (assert_trees_equal, dense_model, jax_config,
                                jax_serving_params, np_of,
                                torch_serving_params)
from test_torch_paged import (CODE_FRAC, LOGIT_MAX, LOGIT_RMS, PARAM_FRAC,
                              code_mismatch)

BF16_EPS = 2.0 ** -8
MAX_SEQ = 256
CONFIGS = {
    "A": dict(a4=True, kv_int4=True, kv_hadamard=True, online_had=True),
    "B": dict(a4=False, kv_int4=False, kv_hadamard=False, online_had=False),
    "C": dict(a4=False, kv_int4=True, kv_hadamard=True, online_had=False),
}
# logits: A as the paged slice (its W4A4 cascade); B and C at twice the
# reference's own jit-vs-eager spread (module doc)
LOGIT_TOL = {"A": (LOGIT_MAX, LOGIT_RMS), "B": (0.03, 0.01),
             "C": (0.03, 0.01)}
# prefill caches, all layers: the reference's own spread (module doc)
PREFILL_CODE_FRAC = {"A": 0.12, "C": 0.03}
PREFILL_PARAM_FRAC = {"A": 0.075, "C": 0.03}
BF16_CACHE_STD = 0.05
NAMES4 = ("kq", "kp", "vq", "vp")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def both(a, dtype="float32"):
    return jnp.asarray(a, getattr(jnp, dtype)), \
        torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# Kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _int4_cache(rng, L, B, H, D, S):
    def params():
        return np.stack([rng.uniform(0.01, 0.2, (L, B, H, S)),
                         rng.uniform(-0.5, 0.5, (L, B, H, S))],
                        axis=3).astype(np.float32)
    return [rng.integers(0, 256, (L, B, H, D // 2, S), dtype=np.uint8),
            params(),
            rng.integers(0, 256, (L, B, H, D // 2, S), dtype=np.uint8),
            params()]


def test_pick_chunk_matches():
    for S in (48, 256, 384, 1000, 1024, 2048):
        for target in (128, 256, 512):
            assert TKV.pick_chunk(S, target) == JKV.pick_chunk(S, target)


@pytest.mark.parametrize("int8_qk", [False, True])
@pytest.mark.parametrize("chunk", [128, 256])
def test_self_append_plain_matches(chunk, int8_qk):
    """Output within 2 bf16 roundings (f32 sums in another order and other
    tiles, one bf16 rounding), as the paged check.  Caches bit-equal,
    except the lanes the reference fills with stale content when an
    append opens a fresh chunk (positions past the new length in the
    written chunk); the port leaves those untouched."""
    rng = np.random.default_rng(23 + chunk + int8_qk)
    L, B, Hkv, G, D, S = 2, 3, 2, 2, 64, 256
    cache = _int4_cache(rng, L, B, Hkv, D, S)
    ch = JKV.pick_chunk(S, chunk)
    lengths = np.array([ch - 1, min(ch, S - 1), 0], np.int32)
    q = (rng.standard_normal((B, Hkv * G, D)) * 2).astype(np.float32)
    nkq, nkp = JKV.asym_quant_pack_head(jnp.asarray(
        rng.standard_normal((B, Hkv, D)), jnp.float32))
    nvq, nvp = JKV.asym_quant_pack_head(jnp.asarray(
        rng.standard_normal((B, Hkv, D)), jnp.float32))
    ks, vs = JKV.unpack_dequant_head(nkq, nkp), JKV.unpack_dequant_head(nvq, nvp)
    layer = 1
    jres = JKV.int4_decode_attention_self_append(
        jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, cache), layer,
        jnp.asarray(lengths), ks, vs, nkq[..., None], nkp[..., None],
        nvq[..., None], nvp[..., None], chunk=chunk, int8_qk=int8_qk)
    tcache = [torch.from_numpy(a.copy()) for a in cache]
    tout = TKV.int4_decode_attention_self_append(
        torch.from_numpy(q).to(torch.bfloat16), *tcache, layer,
        torch.from_numpy(lengths), torch.from_numpy(np.array(ks)),
        torch.from_numpy(np.array(vs)),
        *(torch.from_numpy(np.array(a)) for a in (nkq, nkp, nvq, nvp)),
        int8_qk=int8_qk)
    np.testing.assert_allclose(f32(tout), f32(jres[0]), rtol=4 * BF16_EPS,
                               atol=2e-3)
    for got, want, orig, name in zip(tcache, jres[1:], cache, NAMES4):
        g, w = got.numpy(), np.asarray(want)
        for b in range(B):
            pos = int(lengths[b])
            stale = slice(pos + 1, (pos // ch + 1) * ch)
            np.testing.assert_array_equal(g[layer, b, ..., stale],
                                          orig[layer, b, ..., stale])
            g[layer, b, ..., stale] = w[layer, b, ..., stale]
        np.testing.assert_array_equal(g, w, err_msg=name)


# (G, D, S, lengths): the first case, then the CUDA tests' edges
# (tests/test_torch_cuda.py::test_bf16_attention_edges): every length a
# 64-token tile or a cluster block can end on, S a multiple of 16 but not
# of the tile, G padded to the mma's 8 rows or not
BF16_ATTN_CASES = [(4, 64, 512, [200, 384, 0])] + [
    (G, D, 528, [0, 1, 63, 64, 65, 500, 527, 528])
    for G, D in ((1, 64), (4, 128), (8, 128), (8, 64))]


@pytest.mark.parametrize("G,D,S,lengths", BF16_ATTN_CASES)
def test_bf16_decode_attention_plain_matches(G, D, S, lengths):
    """m and l: the same maximum and f32 sums taken over other tiles, so
    within 1e-5 relative.  out where l > 0: p is rounded to bf16 against
    another running maximum, then one bf16 rounding of out; within 2 bf16
    roundings (as the INT4 kernels).  The empty row gives m = -inf, l = 0
    and out = 0/0 in both."""
    rng = np.random.default_rng(5)
    L, Hkv = 2, 2
    lengths = np.array(lengths, np.int32)
    B = len(lengths)
    q = (rng.standard_normal((B, Hkv * G, D)) * 2).astype(np.float32)
    k = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (both(a, "bfloat16") for a in (q, k, v))
    jo, jm, jl = JKV.bf16_decode_attention_stacked(qj, kj, vj, 1,
                                                   jnp.asarray(lengths),
                                                   chunk=128)
    to, tm, tl = TKV.bf16_decode_attention_stacked(qt, kt, vt, 1,
                                                   torch.from_numpy(lengths))
    assert to.dtype == torch.bfloat16 and tm.shape == (B, Hkv, G)
    live = lengths > 0
    np.testing.assert_allclose(f32(tm)[live], f32(jm)[live], rtol=1e-5)
    np.testing.assert_allclose(f32(tl)[live], f32(jl)[live], rtol=1e-5)
    np.testing.assert_allclose(f32(to)[live], f32(jo)[live],
                               rtol=4 * BF16_EPS, atol=2e-3)
    assert np.all(f32(tm)[~live] == -np.inf) and np.all(f32(jm)[~live] == -np.inf)
    assert np.all(f32(tl)[~live] == 0) and np.all(f32(jl)[~live] == 0)
    assert np.isnan(f32(to)[~live]).all() and np.isnan(f32(jo)[~live]).all()


def test_bf16_decode_attention_nan_query_row():
    """q[0, 1, 5] = NaN (batch row 0, kv head 0, query row 1): the
    reference's running maximum and sums keep the NaN, so that query row's
    out (all D values), m and l are NaN and nothing else is; the plain
    version gives the same pattern and the other rows within the
    tolerances of test_bf16_decode_attention_plain_matches.  The oracle of
    the CUDA kernel's test_bf16_attention_nan_query_row."""
    rng = np.random.default_rng(55)
    L, B, Hkv, G, D, S = 2, 2, 2, 2, 128, 256
    lengths = np.array([200, 77], np.int32)
    q = (rng.standard_normal((B, Hkv * G, D)) * 2).astype(np.float32)
    q[0, 1, 5] = np.nan
    k = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (both(a, "bfloat16") for a in (q, k, v))
    want = JKV.bf16_decode_attention_stacked(qj, kj, vj, 1,
                                             jnp.asarray(lengths), chunk=128)
    got = TKV.bf16_decode_attention_stacked(qt, kt, vt, 1,
                                            torch.from_numpy(lengths))
    row = np.zeros((B, Hkv, G), bool)
    row[0, 0, 1] = True
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = f32(g), f32(w)
        mask = row.reshape(B, Hkv * G)[..., None].repeat(D, -1) if i == 0 \
            else row
        np.testing.assert_array_equal(np.isnan(w), mask)
        np.testing.assert_array_equal(np.isnan(g), mask)
        rtol, atol = (4 * BF16_EPS, 2e-3) if i == 0 else (1e-5, 0.0)
        np.testing.assert_allclose(g[~mask], w[~mask], rtol=rtol, atol=atol)


@pytest.mark.parametrize("S", [16, 64, 128, 528, 1024, 4096])
def test_bf16_attention_split_covers_each_row(S):
    """The CUDA kernel's sequence split (mirrored by bf16_attention_chunks):
    for every length 0..S (and one past S, clamped), the cluster's blocks
    read disjoint token ranges, in rank order, that cover [0, length)
    exactly and never reach S; at most 8 blocks, each with at most 4
    64-token tiles of the longest row."""
    cl = TKV.bf16_attention_cluster(S)
    assert 1 <= cl <= 8
    assert -(-S // 64) <= 4 * cl or cl == 8
    for n in range(S + 2):
        chunks = TKV.bf16_attention_chunks(n, S, cl)
        assert len(chunks) == cl
        pos = 0
        for a, b in chunks:
            assert a == pos and a <= b <= min(n, S)
            if S <= 2048:
                assert b - a <= 4 * 64
            pos = b
        assert pos == min(n, S)


def test_bf16_append_plain_bit_equal():
    rng = np.random.default_rng(6)
    L, B, H, S, D = 2, 4, 2, 32, 16
    pos = np.array([0, 7, 8, S - 1], np.int32)
    k, v = (rng.standard_normal((L, B, H, S, D)).astype(np.float32)
            for _ in range(2))
    nk, nv = (rng.standard_normal((B, H, 1, D)).astype(np.float32)
              for _ in range(2))
    (kj, kt), (vj, vt), (nkj, nkt), (nvj, nvt) = (
        both(a, "bfloat16") for a in (k, v, nk, nv))
    jk, jv = JKV.kv_append_stacked_bf16(kj, vj, 1, jnp.asarray(pos), nkj, nvj)
    TKV.kv_append_stacked_bf16(kt, vt, 1, torch.from_numpy(pos), nkt, nvt)
    np.testing.assert_array_equal(np_of(kt), np_of(jk))
    np.testing.assert_array_equal(np_of(vt), np_of(jv))
    assert (np_of(kt) != np_of(both(k, "bfloat16")[1])).any()


def test_bf16_append_refuses_unaligned_cache():
    """Mirrored: the reference asserts max_seq % 16 == 0."""
    k = torch.zeros((1, 2, 2, 24, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        TKV.kv_append_stacked_bf16(k, k.clone(), 0,
                                   torch.zeros(2, dtype=torch.int32),
                                   torch.zeros((2, 2, 1, 16)),
                                   torch.zeros((2, 2, 1, 16)))


# M: the decode stream (1, 8, 16), one past it (17) and the wgmma tiles
@pytest.mark.parametrize("M", [3, 8, 130, 1, 16, 17, 64])
def test_w16_plain_matches(M):
    """f32 sums in another order, then one bf16 rounding: within one bf16
    rounding (f32 output: within 1e-5 relative)."""
    rng = np.random.default_rng(M)
    K, N = 112, 64
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((2, K, N)) / np.sqrt(K)).astype(np.float32)
    (xj, xt), (wj, wt) = both(x, "bfloat16"), both(w, "bfloat16")
    got = TMW.w16_matmul_stacked(xt, wt, 1)
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(JMW.w16_matmul_stacked(xj, wj, 1)),
                               rtol=2 * BF16_EPS, atol=1e-6)
    np.testing.assert_allclose(
        f32(TMW.w16_matmul_stacked(xt, wt, 1, out_dtype=torch.float32)),
        f32(JMW.w16_matmul_stacked(xj, wj, 1, out_dtype=jnp.float32)),
        rtol=1e-5, atol=1e-6)


def test_merge_self_attention_matches():
    """f32 arithmetic in another order, one bf16 rounding: within one bf16
    rounding.  Row 2 is an empty cache (m = -inf, l = 0, out = 0/0): the
    merge is then exactly v_self."""
    rng = np.random.default_rng(8)
    B, Hkv, G, D = 3, 2, 2, 16
    out = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    m = rng.standard_normal((B, Hkv, G)).astype(np.float32)
    l = rng.uniform(1, 50, (B, Hkv, G)).astype(np.float32)
    out[2], m[2], l[2] = np.nan, -np.inf, 0.0
    qs = (rng.standard_normal((B, Hkv, G, D)) * 0.25).astype(np.float32)
    ks, vs = (rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
              for _ in range(2))
    (oj, ot) = both(out, "bfloat16")
    args = (m, l, qs, ks, vs)
    want = JKV.merge_self_attention(oj, *map(jnp.asarray, args))
    got = TKV.merge_self_attention(ot, *map(torch.from_numpy, args))
    np.testing.assert_allclose(f32(got), f32(want), rtol=2 * BF16_EPS,
                               atol=1e-6)
    np.testing.assert_allclose(
        f32(got)[2], f32(torch.from_numpy(vs[2]).repeat_interleave(G, 0)
                         .reshape(Hkv * G, D).to(torch.bfloat16)))


# ---------------------------------------------------------------------------
# Params, caches, dispatch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig.tiny()
    jcfg = jax_config(cfg)
    params, quant = dense_model(cfg, seed=1)
    fused = (jax_serving_params(cfg, params, quant)[1],
             torch_serving_params(cfg, params, quant))
    dense = (JS.stack_layer_params(JP.to_serving_params(params, {}, jcfg)),
             TS.stack_layer_params(TP.to_serving_params(params, {}, cfg,
                                                        device="cpu")))
    return cfg, jcfg, {"A": fused, "B": dense, "C": dense}, (params, quant)


def configs(cfg, jcfg, name, int8_qk=False):
    kw = dict(max_seq=MAX_SEQ, attn_int8_qk=int8_qk, **CONFIGS[name])
    return JS.ServingConfig(model=jcfg, **kw), TS.ServingConfig(model=cfg, **kw)


def test_dense_params_and_caches_carry_across(model):
    """The dense chain gives the JAX chain's bytes, and from_numpy_params
    carries dense params and both cache layouts across unchanged."""
    cfg, jcfg, P, _ = model
    jd, td = P["B"]
    assert_trees_equal(jd, td)
    assert_trees_equal(jd, TP.from_numpy_params(jd, device="cpu"))
    for name in ("A", "B"):
        jsc, tsc = configs(cfg, jcfg, name)
        jc = JS.init_cache(jsc, 3)
        assert_trees_equal(jc, TS.init_cache(tsc, 3, device="cpu"))
        rng = np.random.default_rng(1)
        filled = {k: np.asarray(v) + (rng.random(v.shape) * 100).astype(
            np.asarray(v).dtype) for k, v in jc.items()}
        assert_trees_equal(filled, TP.from_numpy_params(filled, device="cpu"))


def _e8p_stacks(seed):
    """Two layers of one E8P linear (K 64, N 32, with a bias), packed and
    stacked by both packages: (legacy adjacent 'wp' + 'sh', plane-major
    'wpm' + 'sh', legacy 'codes') as (JAX, torch) pairs."""
    rng = np.random.default_rng(seed)
    lins = [({"b": rng.standard_normal(32).astype(np.float32)},
             {"codes": rng.integers(0, 1 << 16, (32, 8)).astype(np.int32),
              "scale": np.float32(sc)}) for sc in (0.02, 0.03)]
    out = []
    for pk, stack, fuse in ((JP.pack_linear_e8p, JS.stack_layer_params,
                             JP.fuse_for_decode),
                            (lambda p, q: TP.pack_linear_e8p(p, q, "cpu"),
                             TS.stack_layer_params, TP.fuse_for_decode)):
        tree = {"layers": [{"e": pk(p, q)} for p, q in lins]}
        out.append((stack(tree)["layers_stacked"]["e"],
                    stack(fuse(tree))["layers_stacked"]["e"]))
    codes = np.stack([q["codes"] for _, q in lins])
    scale = np.stack([q["scale"] for _, q in lins])
    legacy = ({"codes": jnp.asarray(codes), "e8p_scale": jnp.asarray(scale),
               "b": None},
              {"codes": torch.from_numpy(codes),
               "e8p_scale": torch.from_numpy(scale), "b": None})
    return (out[0][0], out[1][0]), (out[0][1], out[1][1]), legacy


def test_linear_fast_dispatch(model):
    """Every layout against the reference's _linear_fast.  W4A4 legacy
    adjacent 'wp' (paired scales, un-paired output): bit-equal; dense 'w':
    within one bf16 rounding.  Weight-only W4 (a4=False: fused 'wp2',
    plane-major 'wpm', legacy 'wp'), E8P affine ('wp' and 'wpm' + 'sh') and
    the legacy E8P 'codes': f32 sums in another order, then bf16 roundings
    (the reference's biased dot adds its own): within 2^-7 of the largest
    output + 1e-5."""
    cfg, jcfg, P, (params, quant) = model
    jsp = JS.stack_layer_params(JP.to_serving_params(params, quant, jcfg))
    tsp = TS.stack_layer_params(TP.to_serving_params(params, quant, cfg,
                                                     device="cpu"))
    x = np.random.default_rng(3).standard_normal((5, 64)).astype(np.float32)
    xj, xt = both(x, "bfloat16")
    jsc, tsc = configs(cfg, jcfg, "A")
    for name in ("q", "o"):
        jp, tp = jsp["layers_stacked"][name], tsp["layers_stacked"][name]
        assert "wp" in tp
        np.testing.assert_array_equal(f32(TS._linear_fast(xt, tp, 1, tsc)),
                                      f32(JS._linear_fast(xj, jp, 1, jsc)))
    jp, tp = P["B"][0]["layers_stacked"]["q"], P["B"][1]["layers_stacked"]["q"]
    np.testing.assert_allclose(f32(TS._linear_fast(xt, tp, 1, tsc)),
                               f32(JS._linear_fast(xj, jp, 1, jsc)),
                               rtol=2 * BF16_EPS, atol=1e-6)

    def close(t, j):
        t, j = f32(t), f32(j)
        assert t.shape == j.shape
        assert np.abs(t - j).max() <= 2.0 ** -7 * np.abs(j).max() + 1e-5

    jw4, w4 = configs(cfg, jcfg, "C")                       # a4=False
    jf, tf = P["A"][0]["layers_stacked"], P["A"][1]["layers_stacked"]
    segs = TS._linear_fast(xt, tf["qkv"], 0, w4)
    assert len(segs) == 3
    for t, j in zip(segs, JS._linear_fast(xj, jf["qkv"], 0, jw4)):
        close(t, j)
    close(TS._linear_fast(xt, tf["o"], 0, w4),
          JS._linear_fast(xj, jf["o"], 0, jw4))
    close(TS._linear_fast(xt, tsp["layers_stacked"]["q"], 0, w4),
          JS._linear_fast(xj, jsp["layers_stacked"]["q"], 0, jw4))
    for jp, tp in _e8p_stacks(7):
        close(TS._linear_fast(xt, tp, 1, w4), JS._linear_fast(xj, jp, 1, jw4))


def test_scan_decode_env_raises(model, monkeypatch):
    """RSQ_SCAN_DECODE=1 raised before the read-only contiguous attention
    was ported (the test keeps its name from then); it now takes the
    reference's layer-scanned branch, here on
    the bf16 cache (B): bit-equal to the per-layer decode_step on the same
    params, unstacked (test_torch_layers.py holds both against the
    reference)."""
    cfg, jcfg, P, _ = model
    _, tsc = configs(cfg, jcfg, "B")
    tp = P["B"][1]
    toks = torch.tensor([3, 9], dtype=torch.int32)
    caches = []
    for scan in (True, False):
        cache = TS.init_cache(tsc, 2, device="cpu")
        _, cache = TS.prefill_fast(tp, cache, torch.arange(2 * 11).reshape(
            2, 11) % cfg.vocab_size, tsc)
        if scan:
            monkeypatch.setenv("RSQ_SCAN_DECODE", "1")
            logits, cache = TS.decode_step_stacked(tp, cache, toks, tsc)
            monkeypatch.delenv("RSQ_SCAN_DECODE")
        else:
            logits, cache = TS.decode_step(TS.unstack_layer_params(tp), cache,
                                           toks, tsc)
        caches.append((logits, cache))
    (ls, cs), (lp, cp) = caches
    assert torch.equal(ls, lp)
    for k in cs:
        assert torch.equal(cs[k], cp[k]), k


def test_random_dense_params():
    cfg = ModelConfig.tiny(num_layers=3)
    p = TP.random_dense_params(cfg, seed=0, device="cpu")
    ls = p["layers_stacked"]
    for name, (k, n) in {"q": (64, 64), "k": (64, 32), "v": (64, 32),
                         "o": (64, 64), "up": (64, 112), "gate": (64, 112),
                         "down": (112, 64)}.items():
        w = ls[name]["w"]
        assert w.shape == (3, k, n) and w.dtype == torch.bfloat16
        assert ls[name]["b"] is None
        assert 0.07 < float(w.float().std()) * np.sqrt(k) < 0.13
    assert p["embed"].dtype == torch.bfloat16
    assert torch.equal(p["lm_head"], p["embed"].T)
    assert torch.equal(TP.random_dense_params(cfg, seed=0, device="cpu")
                       ["layers_stacked"]["down"]["w"], ls["down"]["w"])


# ---------------------------------------------------------------------------
# Prefill and decode against the reference
# ---------------------------------------------------------------------------

PROMPTS = ((100, 128), (37, 64))         # (true length, bucket) in slots 0, 1


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=n)


def assert_logits_close(t, j, name):
    t, j = f32(t), np.asarray(j, np.float32)
    lmax, lrms = LOGIT_TOL[name]
    sd = float(np.std(j))
    err = np.abs(t - j)
    assert err.max() <= lmax * sd, (err.max() / sd, "max")
    assert np.sqrt(np.mean(err ** 2)) <= lrms * sd, "rms"


def _positions(arr_name):
    """Axis of the sequence in a cache array."""
    return -1 if arr_name in NAMES4 else -2


def assert_prefill_cache_close(tc, jc, name, lens):
    """Layer 0 bit-equal at the prompt positions; all layers within the
    reference's own spread (module doc)."""
    for k in tc:
        if k == "length":
            continue
        for b, n in enumerate(lens):
            t = np.take(np_of(tc[k])[:, b], range(n), axis=_positions(k))
            j = np.take(np_of(jc[k])[:, b], range(n), axis=_positions(k))
            np.testing.assert_array_equal(t[0], j[0], err_msg=f"{k} layer 0")
            if k in ("kq", "vq"):
                assert code_mismatch(torch.from_numpy(t), j) \
                    <= PREFILL_CODE_FRAC[name], (k, b)
            elif k in ("kp", "vp"):
                off = np.abs(t - j) > 1e-3 + 0.05 * np.abs(j)
                assert off.mean() <= PREFILL_PARAM_FRAC[name], (k, b)
            else:
                t = f32(tc[k][:, b, :, :n])
                j = jc[k][:, b, :, :n].astype(np.float32)
                assert np.abs(t - j).max() <= BF16_CACHE_STD * np.abs(j).std(), k


@pytest.fixture(scope="module")
def prefilled(model):
    """Per configuration: requests of PROMPTS prefilled into slots 0 and 1
    of a 3-slot cache (slot 2 stays empty) by prefill_into_slot, in both
    packages.  Returns {name: (t logits, t cache, j logits, j cache)}."""
    cfg, jcfg, P, _ = model
    out = {}
    for name in CONFIGS:
        jsc, tsc = configs(cfg, jcfg, name)
        jp, tp = P[name]
        jc, tc = JS.init_cache(jsc, 3), TS.init_cache(tsc, 3, device="cpu")
        jls, tls = [], []
        for slot, (n, bucket) in enumerate(PROMPTS):
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :n] = _prompt(slot, n, cfg.vocab_size)
            jl, jc = JE.prefill_into_slot(jp, jc, jnp.asarray(ids, jnp.int32),
                                          jsc, slot, true_len=n)
            tl, tc = TE.prefill_into_slot(tp, tc, torch.from_numpy(ids), tsc,
                                          slot, true_len=n)
            jls.append(np.asarray(jl, np.float32))
            tls.append(tl)
        out[name] = (tls, tc, jls, {k: np.asarray(v) for k, v in jc.items()})
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_matches(model, prefilled, name):
    cfg, jcfg, P, _ = model
    tls, tc, jls, jc = prefilled[name]
    for tl, jl in zip(tls, jls):
        assert tl.shape == (cfg.vocab_size,) and torch.isfinite(tl).all()
        assert_logits_close(tl, jl, name)
    assert tc["length"].tolist() == jc["length"].tolist() == [100, 37, 0]
    assert_prefill_cache_close(tc, jc, name, [n for n, _ in PROMPTS])
    _, tsc = configs(cfg, jcfg, name)
    empty = TS.init_cache(tsc, 3, device="cpu")
    for k in tc:
        if k != "length":
            assert torch.equal(tc[k][:, 2], empty[k][:, 2]), k


@pytest.mark.parametrize("name,int8_qk", [("A", False), ("A", True),
                                          ("B", False), ("C", False)])
def test_decode_steps_match(model, prefilled, name, int8_qk):
    """3 decode steps, each started from the reference's cache state: the
    live rows' logits close; every cache position but the appended one
    bit-equal; the cache as a whole within the paged slice's spread (INT4)
    or the appended bf16 values within BF16_CACHE_STD."""
    cfg, jcfg, P, _ = model
    jsc, tsc = configs(cfg, jcfg, name, int8_qk)
    jp, tp = P[name]
    cache = prefilled[name][3]
    toks = np.array([5, 7, 0], np.int32)
    for _ in range(3):
        lengths = cache["length"].copy()
        tl, tc = TS.decode_step_stacked(
            tp, TP.from_numpy_params(cache, device="cpu"),
            torch.from_numpy(toks), tsc)
        jl, jc = JS.decode_step_stacked(
            jp, {k: jnp.asarray(v) for k, v in cache.items()},
            jnp.asarray(toks), jsc)
        jl = np.asarray(jl, np.float32)
        jc = {k: np.asarray(v) for k, v in jc.items()}
        for r in range(2):                 # row 2 is an idle slot
            assert_logits_close(tl[r], jl[r], name)
        assert tc["length"].tolist() == jc["length"].tolist() \
            == (lengths + 1).tolist()
        for k in tc:
            if k == "length":
                continue
            t, j, old = np_of(tc[k]), jc[k], np_of(cache[k])
            ax = _positions(k)
            for b, pos in enumerate(lengths):
                rest = [i for i in range(MAX_SEQ) if i != pos]
                np.testing.assert_array_equal(
                    np.take(t[:, b], rest, axis=ax),
                    np.take(old[:, b], rest, axis=ax), err_msg=k)
            if k in ("kq", "vq"):
                assert code_mismatch(torch.from_numpy(t), j) <= CODE_FRAC, k
            elif k in ("kp", "vp"):
                off = np.abs(t - j) > 1e-3 + 0.05 * np.abs(j)
                assert off.mean() <= PARAM_FRAC, k
            else:
                jv = j.astype(np.float32)
                assert np.abs(f32(tc[k]) - jv).max() \
                    <= BF16_CACHE_STD * np.abs(jv).std(), k
        cache = jc
        toks = np.argmax(jl, axis=-1).astype(np.int32)


@pytest.mark.parametrize("name", ["A", "B"])
def test_greedy_run_matches_reference(model, name):
    """Prefill, then decode_step_stacked on each step's own argmax, in both
    packages.  Up to and including the first step where the two pick
    different tokens both saw the same tokens, so their logits must agree
    within the end-to-end tolerance; a divergence is then an argmax
    near-tie of the reference, never a fault."""
    cfg, jcfg, P, _ = model
    jsc, tsc = configs(cfg, jcfg, name)
    jp, tp = P[name]
    ids = _prompt(4, 29, cfg.vocab_size)[None]
    jl, jc = JS.prefill_fast(jp, JS.init_cache(jsc, 1),
                             jnp.asarray(ids, jnp.int32), jsc)
    tl, tc = TS.prefill_fast(tp, TS.init_cache(tsc, 1, device="cpu"),
                             torch.from_numpy(ids), tsc)
    for step in range(5):
        jl = np.asarray(jl, np.float32)
        assert_logits_close(tl[0], jl[0], name)
        jt, tt = int(np.argmax(jl[0])), int(torch.argmax(tl[0]))
        if jt != tt or step == 4:
            break
        jl, jc = JS.decode_step_stacked(jp, jc, jnp.asarray([jt], jnp.int32),
                                        jsc)
        tl, tc = TS.decode_step_stacked(tp, tc, torch.tensor([tt]), tsc)


# ---------------------------------------------------------------------------
# Engines against generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["A", "C"])
def test_engine_matches_generate(model, name):
    """Three requests through two slots: each request's tokens equal the
    port's generate() on that prompt alone (mirrors the reference's
    tests/test_engine.py)."""
    cfg, jcfg, P, _ = model
    _, tsc = configs(cfg, jcfg, name)
    tp = P[name][1]
    eng = TE.ServingEngine(tp, tsc, num_slots=2, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, size=n), mnt)
            for n, mnt in [(6, 4), (19, 6), (5, 3)]]
    uids = [eng.add_request(p, max_new_tokens=mnt) for p, mnt in reqs]
    done = {r.uid: r for r in eng.run_until_done(max_steps=100)}
    assert set(done) == set(uids)
    for uid, (p, mnt) in zip(uids, reqs):
        want = TS.generate(tp, p[None], tsc, max_new_tokens=mnt)[0].tolist()
        assert done[uid].output == want, uid
    assert eng.lengths.tolist() == [0, 0]


def test_paged_engine_serves_dense_unfused(model):
    """The reference's engine-test configuration (dense unfused bf16
    weights, a4=False, INT4 KV) through the port's paged engine at page
    128: its tokens equal the port's generate() (mirrors the reference's
    tests/test_paged_engine.py)."""
    cfg, jcfg, P, _ = model
    _, tsc = configs(cfg, jcfg, "C")
    tp = P["C"][1]
    prompt = _prompt(2, 7, cfg.vocab_size)
    eng = TPG.PagedServingEngine(tp, tsc, num_slots=2, page_size=128,
                                 prefix_caching=False, device="cpu")
    eng.add_request(prompt, max_new_tokens=5)
    done = eng.run_until_done(max_steps=50)
    want = TS.generate(tp, prompt[None], tsc, max_new_tokens=5)[0].tolist()
    assert done[0].output == want
