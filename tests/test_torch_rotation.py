"""Rotation and token weighting of rsq_tpu_torch against rsq_tpu on the
CPU, at tiny size (2 layers, hidden 64), inputs from numpy seeds:

- get_orthogonal_matrix: the same Q for the same seed, both modes;
- rotate_model, fuse_norms + rotate and post_rotate_after_load in float64:
  within 1e-12 of each array's largest entry (the reference folds with
  numpy on the host, the port with torch; products in another order); in
  float32 within one f32 rounding (both round the same float64 values);
- the eight weighting methods, the post-processing options and the five
  calibration masks: within 1e-5 relative."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.core import hadamard as JH
from rsq_tpu.models.config import ModelConfig as JConfig
from rsq_tpu.models.policy import FP16 as JFP16
from rsq_tpu.quantize import rotation as JR
from rsq_tpu.quantize import weighting as JW
from rsq_tpu_torch.core import hadamard as TH
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.models.policy import FP16
from rsq_tpu_torch.quantize import rotation as TR
from rsq_tpu_torch.quantize import weighting as TW


def np_params(cfg: ModelConfig, seed: int, scale: float = 0.05,
              dtype=np.float32):
    """A Llama-family param tree in numpy: N(0, scale^2) weights, norms in
    [0.8, 1.2], q/k/v biases when the config has them."""
    rng = np.random.default_rng(seed)
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def w(*shape):
        return (rng.standard_normal(shape) * scale).astype(dtype)

    def lin(i, o, bias=False):
        return {"w": w(i, o), "b": w(o) if bias else None}

    def norm():
        return rng.uniform(0.8, 1.2, d).astype(dtype)

    b = cfg.attention_bias
    layers = [{"input_norm": norm(), "post_norm": norm(),
               "q": lin(d, cfg.q_dim, b), "k": lin(d, cfg.kv_dim, b),
               "v": lin(d, cfg.kv_dim, b), "o": lin(cfg.q_dim, d),
               "up": lin(d, f), "gate": lin(d, f), "down": lin(f, d)}
              for _ in range(cfg.num_layers)]
    return {"embed": w(v, d), "layers": layers, "final_norm": norm(),
            "lm_head": w(d, v)}


def tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, x) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, x) for x in tree]
    return fn(tree)


def jtree(tree):
    return tree_map(jnp.asarray, tree)


def ttree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def leaves(tree, prefix=""):
    """{path: numpy array} of a param tree (None leaves skipped)."""
    out = {}
    if isinstance(tree, dict):
        for k, x in tree.items():
            out.update(leaves(x, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            out.update(leaves(x, f"{prefix}{i}."))
    elif tree is not None:
        a = tree.numpy() if isinstance(tree, torch.Tensor) else \
            np.asarray(tree)
        out[prefix[:-1]] = a
    return out


def assert_trees_close(got, want, rel, ulps=False):
    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        if ulps:
            np.testing.assert_allclose(g[k], w[k], rtol=rel, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=0,
                                       atol=rel * np.abs(w[k]).max(),
                                       err_msg=k)


def tiny(**kw):
    return ModelConfig.tiny(**kw), JConfig.tiny(**kw)


@pytest.mark.parametrize("mode", ["hadamard", "random"])
@pytest.mark.parametrize("n", [64, 112])
def test_orthogonal_matrix_same_for_seed(mode, n):
    if mode == "hadamard" and not TH.hadU_supported(n):
        pytest.skip("no Hadamard of this order")
    np.testing.assert_array_equal(TH.get_orthogonal_matrix(n, mode, seed=3),
                                  JH.get_orthogonal_matrix(n, mode, seed=3))
    assert TH.hadU_supported(n) == JH.hadU_supported(n)


@pytest.mark.parametrize("n", [64, 112, 28])
def test_matmul_hadU_f64(n):
    x = np.random.default_rng(n).standard_normal((3, 5, n))
    np.testing.assert_allclose(TH.matmul_hadU_f64(torch.from_numpy(x)).numpy(),
                               JH.matmul_hadU_np(x), rtol=0, atol=1e-14)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("mode", ["hadamard", "random"])
def test_rotate_model_f64(mode, bias):
    """rotate_model in float64: embedding, lm_head and every linear (and
    bias) within 1e-12 of its largest entry; norms fused to None."""
    cfg, jcfg = tiny(attention_bias=bias)
    p = np_params(cfg, seed=7, dtype=np.float64)
    want, wQ = JR.rotate_model(jtree(p), jcfg, mode=mode, seed=5)
    got, gQ = TR.rotate_model(ttree(p), cfg, mode=mode, seed=5, device="cpu")
    np.testing.assert_array_equal(gQ, wQ)
    assert got["final_norm"] is None and got["layers"][1]["input_norm"] is None
    assert_trees_close(got, want, 1e-12)


def test_fuse_then_rotate_and_post_rotate_f64():
    cfg, jcfg = tiny()
    p = np_params(cfg, seed=8, dtype=np.float64)
    Q = JH.get_orthogonal_matrix(cfg.hidden_size, "hadamard", seed=1)
    wf = JR.fuse_norms(jtree(p), jcfg)
    gf = TR.fuse_norms(ttree(p), cfg, device="cpu")
    assert_trees_close(gf, wf, 1e-12)
    assert_trees_close(TR.rotate(gf, cfg, Q, device="cpu"),
                       JR.rotate(wf, jcfg, Q), 1e-12)
    assert_trees_close(TR.post_rotate_after_load(ttree(p), cfg, device="cpu"),
                       JR.post_rotate_after_load(jtree(p), jcfg), 1e-12)


def test_rotate_model_f32_one_rounding():
    """In float32 both packages round the same float64 folds after every
    transform: equal within one f32 rounding."""
    cfg, jcfg = tiny()
    p = np_params(cfg, seed=9)
    want, _ = JR.rotate_model(jtree(p), jcfg, seed=2)
    got, _ = TR.rotate_model(ttree(p), cfg, seed=2, device="cpu")
    assert_trees_close(got, want, 2.0 ** -23, ulps=True)


# ---------------------------------------------------------------------------
# Weighting
# ---------------------------------------------------------------------------

L_CAL = 32


def _layer_case(seed=11):
    """One layer's params, two calibration samples (input and output) and
    token frequencies, in numpy."""
    cfg, jcfg = tiny(num_layers=1)
    lp = np_params(cfg, seed)["layers"][0]
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, L_CAL, cfg.hidden_size)).astype(np.float32)
    out = x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    tf = rng.integers(1, 50, (2, L_CAL)).astype(np.int32)
    return cfg, jcfg, lp, x, out, tf


def _both_weights(wcfg_kw):
    cfg, jcfg, lp, x, out, tf = _layer_case()
    want = np.stack([np.asarray(JW.compute_sample_weight(
        jtree(lp), jnp.asarray(x[s]), jnp.asarray(out[s]),
        jnp.asarray(tf[s]), jcfg, JFP16, JW.WeightingConfig(**wcfg_kw)))
        for s in range(2)])
    got = TW.compute_sample_weight(
        ttree(lp), torch.from_numpy(x), torch.from_numpy(out),
        torch.from_numpy(tf), cfg, FP16, TW.WeightingConfig(**wcfg_kw))
    assert got.shape == (2, L_CAL)
    return got.numpy(), want


METHODS = [dict(method="attncon", min_value=0.005, max_value=1.0),
           dict(method="heuristic", method_type="first_half"),
           dict(method="heuristic", method_type="1_3_8"),
           dict(method="actnorm"),
           dict(method="actnorm", input_or_output="output"),
           dict(method="actdiff"), dict(method="tokenfreq"),
           dict(method="tokensim"), dict(method="cluster", n_clusters=8),
           dict(method="dot", input_or_output="output")]
POSTPROCESS = [dict(normalize="linear"), dict(normalize="sqrt", scale="square"),
               dict(normalize=None, scale="sqrt"), dict(reverse=True),
               dict(quantile_value=0.1), dict(masking=0.25),
               dict(truncate=0.5), dict(num_bins=4)]
MASKS = [dict(custom_attn_type=t, attn_length=8)
         for t in ("block", "window", "sink", "ss", "topk")]


@pytest.mark.parametrize("kw", METHODS + [dict(method="actnorm", **p)
                                          for p in POSTPROCESS]
                         + [dict(method="attncon", **m) for m in MASKS],
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_sample_weights_match_reference(kw):
    got, want = _both_weights(kw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kw", MASKS, ids=lambda kw: kw["custom_attn_type"])
def test_calibration_masks_equal(kw):
    wcfg = TW.WeightingConfig(**kw)
    got = TW.calibration_mask(wcfg, 24, 4)
    want = JW.calibration_mask(JW.WeightingConfig(**kw), 24, 4)
    if kw["custom_attn_type"] == "topk":
        assert got == want == "topk"
        logits = np.random.default_rng(0).standard_normal((3, 24, 24)).astype(
            np.float32)
        got = TW.apply_topk_to_logits(torch.from_numpy(logits), 8)
        want = JW.apply_topk_to_logits(jnp.asarray(logits), 8)
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want, np.float32))


def test_token_frequencies_and_kmeans():
    ids = np.random.default_rng(3).integers(0, 40, (4, 32))
    np.testing.assert_array_equal(TW.token_frequencies(ids).numpy(),
                                  np.asarray(JW.token_frequencies(ids)))
    x = np.random.default_rng(4).standard_normal((50, 16)).astype(np.float32)
    ga, gc = TW.kmeans(torch.from_numpy(x), 6)
    wa, wc = JW.kmeans(jnp.asarray(x), 6)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-5,
                               atol=1e-6)


def test_weighting_applies_to():
    for kw in (dict(), dict(apply_module="q|down")):
        t, j = TW.WeightingConfig(**kw), JW.WeightingConfig(**kw)
        for g in (("q", "k", "v"), ("o",), ("down",)):
            assert t.applies_to(g) == j.applies_to(g)
    assert dataclasses.asdict(TW.WeightingConfig()) == dataclasses.asdict(
        JW.WeightingConfig())


def test_batch_weighting_matches_reference():
    """compute_batch_weighting, one sample at a time, as the reference's."""
    cfg, jcfg, lp, x, out, tf = _layer_case(12)
    wcfg = dict(method="actdiff", normalize="linear")
    want = JW.compute_batch_weighting(jtree(lp), x, out, tf, jcfg, JFP16,
                                      JW.WeightingConfig(**wcfg))
    got = TW.compute_batch_weighting(ttree(lp), torch.from_numpy(x),
                                     torch.from_numpy(out),
                                     torch.from_numpy(tf), cfg, FP16,
                                     TW.WeightingConfig(**wcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
