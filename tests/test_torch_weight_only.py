"""The weight-only serving slice of rsq_tpu_torch against rsq_tpu, at tiny
size (2 layers, hidden 64, heads 4/2, head_dim 16, intermediate 112,
max_seq 256): the E8P codebook and its lossless int4 re-encoding, E8P
packing and fusing, the int4 lm_head, the plain versions of the three
weight-only kernels against the Pallas kernels in interpret mode, the
legacy E8P "codes" layout, and then the slice as a whole in two
configurations, both with INT4 KV and the online Hadamards:

- W4: W4A16 (a4=False) fused plane-major weights, int4 lm_head;
- E8P: every projection E8P (random codes), re-encoded to affine int4 and
  served unfused, int8 lm_head.

Tolerances.  Integer-exact stages (codebook, packing, scales) are
bit-equal.  A kernel's plain version against the reference: f32 sums in
another order (the reference's biased dot, dot(x, q+8) - 8 sum(x), adds
its own rounding), one rounding to bf16 each: within 2^-7 of the largest
output plus 1e-5.  Model logits, by the earlier slices' rule: twice the
reference's own spread.  The same prefill and three greedy decode steps
run op by op under jax.disable_jit differ from the jitted run, on
identical inputs, by up to 0.022 std of the logits (rms 0.0068) in W4 and
0.031 std (rms 0.010) in E8P (measured on these models and prompts).  A
real fault (a dropped +0.5 offset, a wrong scale) moves the logits by
about 1 std."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.kernels import matmul_w4 as JMW
from rsq_tpu.quantize import ldlq as JL
from rsq_tpu.serving import model as JS
from rsq_tpu.serving import paged as JPG
from rsq_tpu.serving import params as JP
from rsq_tpu_torch.kernels import matmul_w4 as TMW
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.quantize import ldlq as TL
from rsq_tpu_torch.serving import engine as TE
from rsq_tpu_torch.serving import model as TS
from rsq_tpu_torch.serving import paged as TPG
from rsq_tpu_torch.serving import params as TP
from test_torch_contiguous import both, f32
from test_torch_packing import (LINEARS, assert_trees_equal, dense_model,
                                jax_config, np_of)
from test_torch_paged import reference_steps_copy_inputs  # noqa: F401 (fixture)

MAX_SEQ, PAGE = 256, 128
FLAGS = dict(a4=False, kv_int4=True, kv_hadamard=True, online_had=True,
             max_seq=MAX_SEQ)
LOGIT_MAX, LOGIT_RMS = 0.06, 0.02          # module doc


def assert_kernel_close(got, want):
    """2^-7 of the largest output + 1e-5 (module doc)."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 2.0 ** -7 * np.abs(want).max() + 1e-5, err


def assert_logits_close(t, j):
    t, j = f32(t), np.asarray(j, np.float32)
    sd = float(np.std(j))
    err = np.abs(t - j)
    assert err.max() <= LOGIT_MAX * sd, (err.max() / sd, "max")
    assert np.sqrt(np.mean(err ** 2)) <= LOGIT_RMS * sd, "rms"


def random_codes(rng, n, k):
    return rng.integers(0, 1 << 16, size=(n, k // 8)).astype(np.int32)


def e8p_quantizers(cfg, seed):
    """Random E8P quantizer entries (codes (N, K/8), per-tensor scale) for
    every projection of every layer, scaled to weights of std ~1/sqrt(K)."""
    rng = np.random.default_rng(seed)
    d, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {"q": (d, cfg.q_dim), "k": (d, cfg.kv_dim), "v": (d, cfg.kv_dim),
              "o": (cfg.q_dim, d), "up": (d, f), "gate": (d, f),
              "down": (f, d)}
    return {f"layers.{i}.{n}": {
        "codes": random_codes(rng, nout, k),
        "scale": np.float32(rng.uniform(0.6, 1.0) / np.sqrt(k))}
        for i in range(cfg.num_layers) for n, (k, nout) in shapes.items()}


# ---------------------------------------------------------------------------
# E8P codebook, re-encoding and packing: bit-equal
# ---------------------------------------------------------------------------

def test_e8p_codebook_bit_equal():
    np.testing.assert_array_equal(TL.abs_grid(), JL.abs_grid())
    np.testing.assert_array_equal(TL.e8p_grid(), JL.e8p_grid())
    np.testing.assert_array_equal(TL._affine_int4_table(),
                                  JL._affine_int4_table())


def _ldlq_linear():
    """One linear (out 32, in 16) quantized by the reference's LDLQ, as
    tests/test_serving.py does."""
    rng = np.random.default_rng(13)
    W = (rng.standard_normal((16, 32)) * 0.1).astype(np.float32)
    A = rng.standard_normal((64, 16)).astype(np.float32)
    H = (2.0 / 64) * A.T @ A + 0.05 * np.eye(16, dtype=np.float32)
    _, info = JL.ldlq_quantize(jnp.asarray(W.T), jnp.asarray(H),
                               quip_tune_iters=0)
    return {"w": W, "b": None}, {"codes": info["codes"], "scale": info["scale"]}


@pytest.mark.parametrize("source", ["random", "ldlq"])
def test_e8p_reencode_and_pack_bit_equal(source):
    """e8p_codes_to_int4 and pack_linear_e8p's bytes and sh bit-equal; the
    lossless invariant: e8p_dequantize == (unpack + 0.5) * sh exactly."""
    if source == "random":
        rng = np.random.default_rng(4)
        p = {"w": None, "b": rng.standard_normal(48).astype(np.float32)}
        qinfo = {"codes": random_codes(rng, 48, 64),
                 "scale": np.float32(0.731)}
    else:
        p, qinfo = _ldlq_linear()
    codes = qinfo["codes"]
    np.testing.assert_array_equal(np_of(TL.e8p_codes_to_int4(codes)),
                                  JL.e8p_codes_to_int4(codes))
    jsp = JP.pack_linear_e8p(p, qinfo)
    tsp = TP.pack_linear_e8p(p, qinfo, "cpu")
    assert_trees_equal(jsp, tsp)
    deq = TL.e8p_dequantize(codes, float(qinfo["scale"]))
    np.testing.assert_array_equal(
        np_of(deq), np.asarray(JL.e8p_dequantize(jnp.asarray(codes),
                                                 qinfo["scale"])))
    implied = (TMW.unpack_w4_planar(tsp["wp"]).float() + 0.5) * tsp["sh"]
    np.testing.assert_array_equal(np_of(implied.T), np_of(deq))


def test_fuse_for_decode_e8p_bit_equal():
    """to_serving_params (E8P codes) -> fuse_for_decode (not fused: 'wpm' +
    'sh') -> stack_layer_params (sh stacked to (L,)) gives the same bytes
    in both packages."""
    cfg = ModelConfig.tiny()
    params, _ = dense_model(cfg, seed=2)
    quant = e8p_quantizers(cfg, seed=3)
    jsp = JS.stack_layer_params(JP.fuse_for_decode(
        JP.to_serving_params(params, quant, jax_config(cfg))))
    tsp = TS.stack_layer_params(TP.fuse_for_decode(
        TP.to_serving_params(params, quant, cfg, device="cpu")))
    assert_trees_equal(jsp, tsp)
    ls = tsp["layers_stacked"]
    assert "qkv" not in ls and "upgate" not in ls
    for n in LINEARS:
        assert set(ls[n]) == {"wpm", "sh", "b"} and ls[n]["sh"].shape == (2,)


def test_quantize_lm_head_int4_bit_equal():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    w[:, 5] = 0.0                                   # the absmax == 0 branch
    jw, tw = both(w, "bfloat16")
    j = JS.quantize_lm_head({"lm_head": jw}, bits=4)
    t = TS.quantize_lm_head({"lm_head": tw}, bits=4)
    assert_trees_equal(j, t)
    with pytest.raises(ValueError, match="8 or 4"):
        TS.quantize_lm_head({"lm_head": tw}, bits=3)


def test_unpack_linear_matches():
    cfg = ModelConfig.tiny()
    params, quant = dense_model(cfg, seed=1)
    jp = JP.to_serving_params(params, quant, jax_config(cfg))["layers"][0]
    tp = TP.to_serving_params(params, quant, cfg, device="cpu")["layers"][0]
    for n in ("q", "down"):
        np.testing.assert_array_equal(np_of(TP.unpack_linear(tp[n])),
                                      np.asarray(JP.unpack_linear(jp[n])))
        np.testing.assert_array_equal(np_of(TP.unpack_linear(tp[n])),
                                      params["layers"][0][n]["w"])


# ---------------------------------------------------------------------------
# Kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer", [0, 2])
def test_w4_paired_stacked_plain_matches(layer):
    """Row 13 at two layers of a stack, Nh not a multiple of 128."""
    rng = np.random.default_rng(20 + layer)
    L, M, K, Nh = 3, 5, 96, 80
    wp = rng.integers(0, 256, (L, K, Nh), dtype=np.uint8)
    s2 = (rng.uniform(0.5, 1.5, (2, Nh)) / (7 * np.sqrt(K))).astype(np.float32)
    xj, xt = both(rng.standard_normal((M, K)), "bfloat16")
    want = JMW.w4_matmul_paired_stacked(xj, jnp.asarray(wp), jnp.asarray(s2),
                                        layer)
    got = TMW.w4_matmul_paired_stacked(xt, torch.from_numpy(wp),
                                       torch.from_numpy(s2), layer)
    assert got.dtype == torch.bfloat16
    assert_kernel_close(got, want)


@pytest.mark.parametrize("K", [64, 66])             # the biased dot and not
@pytest.mark.parametrize("plane_major", [False, True])
def test_w4_affine_stacked_plain_matches(plane_major, K):
    """Row 14 with both un-pairings; also against the dense product of the
    affine weights (x @ ((q + 0.5) * sh))."""
    rng = np.random.default_rng(K + plane_major)
    L, M, Nh = 2, 6, 48
    wp = rng.integers(0, 256, (L, K, Nh), dtype=np.uint8)
    sh = rng.uniform(0.01, 0.05, L).astype(np.float32)
    xj, xt = both(rng.standard_normal((M, K)), "bfloat16")
    want = JMW.w4_affine_matmul_stacked(xj, jnp.asarray(wp), jnp.asarray(sh),
                                        1, plane_major=plane_major)
    twp = torch.from_numpy(wp)
    got = TMW.w4_affine_matmul_stacked(xt, twp, torch.from_numpy(sh), 1,
                                       plane_major=plane_major)
    assert got.shape == (M, 2 * Nh) and got.dtype == torch.bfloat16
    assert_kernel_close(got, want)
    q = TMW.unpack_w4_planar(twp[1]).float()
    if plane_major:       # byte j holds natural outputs j and j + Nh
        u = twp[1].to(torch.int32)
        q = torch.cat([(u << 28) >> 28, (u << 24) >> 28], dim=1).float()
    assert_kernel_close(got, xt.float() @ ((q + 0.5) * float(sh[1])))


def test_w4_matmul_plain_matches():
    """Row 8, the int4 lm_head, at N = 320 (Nh = 160, not a multiple of
    128: the reference pads, the port does not)."""
    rng = np.random.default_rng(8)
    M, K, N = 5, 64, 320
    wq = rng.integers(-8, 8, (K, N)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, N).astype(np.float32)
    wpj = JMW.pack_w4_planar(jnp.asarray(wq))
    xj, xt = both(rng.standard_normal((M, K)), "bfloat16")
    want = JMW.w4_matmul(xj, wpj, jnp.asarray(scale))
    got = TMW.w4_matmul(xt, torch.from_numpy(np.array(wpj)),
                        torch.from_numpy(scale))
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    assert_kernel_close(got, want)
    assert_kernel_close(got, xt.float() @ (torch.from_numpy(wq).float()
                                           * torch.from_numpy(scale)))


def test_linear_fast_codes_matches():
    """The legacy E8P 'codes' layout against the reference's _linear_fast:
    the same dequantized weights (bit-equal, test above), a bf16 product
    and a bf16 bias add on each side: within 4 bf16 roundings."""
    cfg = ModelConfig.tiny()
    rng = np.random.default_rng(9)
    L, K, N = 2, 64, 32
    codes = np.stack([random_codes(rng, N, K) for _ in range(L)])
    scale = rng.uniform(0.05, 0.1, L).astype(np.float32)
    b = rng.standard_normal((L, N)).astype(np.float32)
    xj, xt = both(rng.standard_normal((4, K)), "bfloat16")
    bj, bt = both(b, "bfloat16")
    jsc = JS.ServingConfig(model=jax_config(cfg), **FLAGS)
    tsc = TS.ServingConfig(model=cfg, **FLAGS)
    want = JS._linear_fast(xj, {"codes": jnp.asarray(codes),
                                "e8p_scale": jnp.asarray(scale), "b": bj},
                           1, jsc)
    got = TS._linear_fast(xt, {"codes": torch.from_numpy(codes),
                               "e8p_scale": torch.from_numpy(scale), "b": bt},
                          1, tsc)
    np.testing.assert_allclose(f32(got), f32(want), rtol=4 * 2.0 ** -8,
                               atol=1e-5 * np.abs(f32(want)).max())


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """Per configuration: (JAX params, the port's params carried across with
    from_numpy_params).  The port's own conversion chain is checked
    bit-equal to the reference's on the way."""
    cfg = ModelConfig.tiny()
    jcfg = jax_config(cfg)
    params, w4_quant = dense_model(cfg, seed=1)
    out = {}
    for name, quant, bits in (("W4", w4_quant, 4),
                              ("E8P", e8p_quantizers(cfg, seed=5), 8)):
        jsp = JS.quantize_lm_head(JS.stack_layer_params(JP.fuse_for_decode(
            JP.to_serving_params(params, quant, jcfg))), bits=bits)
        tsp = TS.quantize_lm_head(TS.stack_layer_params(TP.fuse_for_decode(
            TP.to_serving_params(params, quant, cfg, device="cpu"))), bits=bits)
        assert_trees_equal(jsp, tsp)
        out[name] = (jsp, TP.from_numpy_params(jsp, device="cpu"))
    assert "qkv" in out["W4"][1]["layers_stacked"]
    assert "lm_head_wp" in out["W4"][1]
    assert "sh" in out["E8P"][1]["layers_stacked"]["q"]
    return cfg, jcfg, out


def configs(cfg, jcfg):
    return JS.ServingConfig(model=jcfg, **FLAGS), TS.ServingConfig(model=cfg,
                                                                  **FLAGS)


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=n)


@pytest.mark.parametrize("name", ["W4", "E8P"])
def test_prefill_decode_match(model, name):
    """prefill_fast, then 3 decode_step_stacked steps each started from the
    reference's cache state: logits within tolerance."""
    cfg, jcfg, P = model
    jsc, tsc = configs(cfg, jcfg)
    jp, tp = P[name]
    ids = np.stack([_prompt(s, 24, cfg.vocab_size) for s in (1, 2)])
    jl, jc = JS.prefill_fast(jp, JS.init_cache(jsc, 2),
                             jnp.asarray(ids, jnp.int32), jsc)
    tl, _ = TS.prefill_fast(tp, TS.init_cache(tsc, 2, device="cpu"),
                            torch.from_numpy(ids), tsc)
    for step in range(4):
        jl = np.asarray(jl, np.float32)
        for r in range(2):
            assert torch.isfinite(tl[r]).all()
            assert_logits_close(tl[r], jl[r])
        if step == 3:
            break
        toks = np.argmax(jl, axis=-1).astype(np.int32)
        cache = {k: np.asarray(v) for k, v in jc.items()}
        tl, _ = TS.decode_step_stacked(
            tp, TP.from_numpy_params(cache, device="cpu"),
            torch.from_numpy(toks), tsc)
        jl, jc = JS.decode_step_stacked(
            jp, {k: jnp.asarray(v) for k, v in cache.items()},
            jnp.asarray(toks), jsc)


def assert_trace_matches_reference(jp, jsc, prompt, req):
    """A finished request's recorded logits against the reference's
    prefill_fast and decode_step_stacked fed the same prompt and the same
    tokens."""
    assert len(req.output) == len(req.logit_trace) == req.max_new_tokens
    jl, jc = JS.prefill_fast(jp, JS.init_cache(jsc, 1),
                             jnp.asarray(np.asarray(prompt)[None], jnp.int32),
                             jsc)
    for step, lt in enumerate(req.logit_trace):
        assert_logits_close(torch.from_numpy(lt), np.asarray(jl)[0])
        if step + 1 < len(req.logit_trace):
            jl, jc = JS.decode_step_stacked(
                jp, jc, jnp.asarray([req.output[step]], jnp.int32), jsc)


@pytest.mark.parametrize("name", ["W4", "E8P"])
def test_paged_engine_matches_reference(model, name,
                                        reference_steps_copy_inputs):
    """Three requests (two sharing a full prompt page) through the port's
    paged engine and the reference's at page 128: the same prefix reuse
    and cache statistics, the same tokens, and logits within tolerance at
    every step; every request's logits also match the reference's
    prefill_fast and decode_step_stacked on its own tokens."""
    cfg, jcfg, P = model
    jsc, tsc = configs(cfg, jcfg)
    jp, tp = P[name]
    shared = _prompt(2, PAGE, cfg.vocab_size)
    prompts = [_prompt(3, 40, cfg.vocab_size),
               np.concatenate([shared, _prompt(4, 9, cfg.vocab_size)]),
               np.concatenate([shared, _prompt(5, 30, cfg.vocab_size)])]
    runs, stats = [], []
    for eng in (TPG.PagedServingEngine(tp, tsc, num_slots=2, page_size=PAGE,
                                       record_logits=True, device="cpu"),
                JPG.PagedServingEngine(jp, jsc, num_slots=2, page_size=PAGE,
                                       record_logits=True)):
        uids = [eng.add_request(p, max_new_tokens=4) for p in prompts]
        done = {r.uid: r for r in eng.run_until_done(max_steps=50)}
        assert set(done) == set(uids)
        runs.append([done[u] for u in uids])
        stats.append(eng.cache_stats)
    assert stats[0] == stats[1]
    assert [r.reused_pages for r in runs[0]] == [0, 0, 1]
    for t, j, prompt in zip(*runs, prompts):
        assert t.reused_pages == j.reused_pages
        assert t.output == j.output
        for lt, lj in zip(t.logit_trace, j.logit_trace):
            assert_logits_close(torch.from_numpy(lt), lj)
        assert_trace_matches_reference(jp, jsc, prompt, t)


@pytest.mark.parametrize("name", ["W4", "E8P"])
def test_serving_engine_matches_reference(model, name):
    """Three requests through two slots of the port's ServingEngine, each
    request's logits against the reference on its own tokens."""
    cfg, jcfg, P = model
    jsc, tsc = configs(cfg, jcfg)
    jp, tp = P[name]
    eng = TE.ServingEngine(tp, tsc, num_slots=2, record_logits=True,
                           device="cpu")
    reqs = [(_prompt(6 + i, n, cfg.vocab_size), mnt)
            for i, (n, mnt) in enumerate([(6, 3), (19, 4), (11, 3)])]
    uids = [eng.add_request(p, max_new_tokens=mnt) for p, mnt in reqs]
    done = {r.uid: r for r in eng.run_until_done(max_steps=50)}
    assert set(done) == set(uids)
    for uid, (prompt, _) in zip(uids, reqs):
        assert_trace_matches_reference(jp, jsc, prompt, done[uid])
