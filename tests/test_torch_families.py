"""The OPT, Gemma-2 and Falcon families of rsq_tpu_torch against rsq_tpu
on the CPU, at tiny size (2 layers, hidden 64; Falcon in falcon-7b's
shared-norm MQA layout and in the two-norm GQA one), on the same params
made from numpy seeds (norms off their constant init, OPT's biases and
positions random):

- the forward's logits under FP16 and W4A4KV4 fake quantization within
  1e-5 of the largest |logit|;
- fuse_norms, rotate, rotate_model and post_rotate_after_load in float64
  within 1e-12 of each array's largest entry (the reference folds with
  numpy, the port with torch), in float32 within one f32 rounding; the
  rotated model's logits equal the original's; falcon-7b-like dims (an
  intermediate size with no Hadamard) skip the fc2 pair; Gemma-2 refused;
- Gemma-2's chunked attention against its dense one and the reference's,
  and its sliding window changes the result;
- attncon's attention received, per family and layer, within 1e-5;
- quantize_model call by call (tests/test_torch_pipeline.py's rules);
- a checkpoint saved by either package loads in the other;
- ppl_fullmodel and ppl_streamed within 1e-5 relative;
- `cli quantize --eval` and `eval --load` give the reference CLI's PPL
  within 1e-5 relative on the same params; `cli serve` refuses them.
The transformers forward and the HF ingest of these families are held in
tests/test_torch_hf.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu import cli as jcli
from rsq_tpu.core import hadamard as JH
from rsq_tpu.eval import ppl as JPPL
from rsq_tpu.models import family as JF
from rsq_tpu.models import gemma2 as JG
from rsq_tpu.models import policy as JPOL
from rsq_tpu.models.config import ModelConfig as JConfig
from rsq_tpu.quantize import checkpoint as JCK
from rsq_tpu.quantize import data as JD
from rsq_tpu.quantize import pipeline as JP
from rsq_tpu.quantize import rotation as JR
from rsq_tpu.quantize import weighting as JW
from rsq_tpu_torch import cli
from rsq_tpu_torch.core.hadamard import hadU_supported
from rsq_tpu_torch.eval import ppl as TPPL
from rsq_tpu_torch.models import family as TF
from rsq_tpu_torch.models import gemma2 as TG
from rsq_tpu_torch.models import policy as TPOL
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.quantize import checkpoint as TCK
from rsq_tpu_torch.quantize import data as TD
from rsq_tpu_torch.quantize import pipeline as TP
from rsq_tpu_torch.quantize import rotation as TR
from rsq_tpu_torch.quantize import weighting as TW
from test_torch_pipeline import _rsq_configs, _same_checkpoint, \
    hold_quantize_model
from test_torch_rotation import assert_trees_close, jtree, leaves, ttree

CONFIGS = {
    "opt": ("tiny_opt", {}),
    "gemma2": ("tiny_gemma2", {}),
    "falcon": ("tiny_falcon", {}),
    "falcon_two_norms": ("tiny_falcon", dict(falcon_two_norms=True,
                                             num_key_value_heads=2)),
    # falcon-7b's odd part 71 in the intermediate size: no fc2 Hadamard
    "falcon7b_dims": ("tiny_falcon", dict(intermediate_size=142)),
}
FAMILIES = ["opt", "gemma2", "falcon", "falcon_two_norms"]
ROTATABLE = ["opt", "falcon", "falcon_two_norms", "falcon7b_dims"]


def configs(name, **kw):
    ctor, base = CONFIGS[name]
    return (getattr(ModelConfig, ctor)(**base, **kw),
            getattr(JConfig, ctor)(**base, **kw))


def np_family_params(cfg: ModelConfig, seed: int, scale: float = 0.05,
                     dtype=np.float32):
    """A family's param tree in numpy: N(0, scale^2) weights; LayerNorms
    with weights in [0.8, 1.2] and N(0, 0.05^2) biases; Gemma-2's (1 + w)
    norms with w in [-0.2, 0.2]; OPT's biases and learned positions
    random; the lm_head the embedding's transpose (all three are tied)."""
    rng = np.random.default_rng(seed)
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def w(*shape):
        return (rng.standard_normal(shape) * scale).astype(dtype)

    def ln():
        return {"w": rng.uniform(0.8, 1.2, d).astype(dtype),
                "b": (0.05 * rng.standard_normal(d)).astype(dtype)}

    def lin(i, o, bias):
        return {"w": w(i, o), "b": w(o) if bias else None}

    bias = cfg.family == "opt"
    layers = []
    for _ in range(cfg.num_layers):
        lp = {"q": lin(d, cfg.q_dim, bias), "k": lin(d, cfg.kv_dim, bias),
              "v": lin(d, cfg.kv_dim, bias), "o": lin(cfg.q_dim, d, bias)}
        if cfg.family == "gemma2":
            lp.update({n: rng.uniform(-0.2, 0.2, d).astype(dtype)
                       for n in TG.NORMS})
            lp.update(up=lin(d, f, False), gate=lin(d, f, False),
                      down=lin(f, d, False))
        else:
            two = cfg.family == "opt" or cfg.falcon_two_norms
            lp.update(input_norm=ln(), post_norm=ln() if two else None,
                      fc1=lin(d, f, bias), fc2=lin(f, d, bias))
        layers.append(lp)
    out = {"embed": w(v, d), "layers": layers,
           "final_norm": rng.uniform(-0.2, 0.2, d).astype(dtype)
           if cfg.family == "gemma2" else ln()}
    if cfg.family == "opt":
        out["embed_pos"] = w(cfg.max_position_embeddings + 2, d)
    out["lm_head"] = out["embed"].T.copy()
    return out


def _ids(cfg, seed, shape=(2, 24)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _logits(tparams, jparams, cfg, jcfg, ids, tpol, jpol):
    got = TF.forward(tparams, torch.from_numpy(ids), cfg, tpol).numpy()
    want = np.asarray(JF.forward(jparams, jnp.asarray(ids), jcfg, jpol))
    return got, want


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fp16", "w4a4kv4"])
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_reference(name, policy):
    """Logits within rtol 1e-5 and 1e-5 of the largest |logit|, under FP16
    and the W4A4KV4 fake-quant policy (4-bit activations, V and K, the
    online Hadamards)."""
    cfg, jcfg = configs(name)
    p = np_family_params(cfg, seed=1)
    tpol, jpol = ((TPOL.FP16, JPOL.FP16) if policy == "fp16"
                  else (TPOL.w4a4kv4(), JPOL.w4a4kv4()))
    got, want = _logits(ttree(p), jtree(p), cfg, jcfg, _ids(cfg, 2), tpol,
                        jpol)
    assert got.shape == (2, 24, cfg.vocab_size) and np.isfinite(got).all()
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# Rotation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ROTATABLE)
def test_rotation_f64_matches_reference(name):
    """fuse_norms, rotate (a random Hadamard) and post_rotate_after_load,
    then rotate_model, in float64: every array within 1e-12 of its largest
    entry, lm_head_bias and the norms as the reference leaves them; the
    rotated model (fused norms, the online Hadamard before fc2 where the
    intermediate size has one) gives the original's logits."""
    cfg, jcfg = configs(name)
    p = np_family_params(cfg, seed=3, dtype=np.float64)
    Q = JH.get_orthogonal_matrix(cfg.hidden_size, "hadamard", seed=1)
    wf = JR.fuse_norms(jtree(p), jcfg)
    gf = TR.fuse_norms(ttree(p), cfg, device="cpu")
    assert_trees_close(gf, wf, 1e-12)
    assert gf["lm_head_bias"] is not None and gf["final_norm"] is None
    assert_trees_close(TR.rotate(gf, cfg, Q, device="cpu"),
                       JR.rotate(wf, jcfg, Q), 1e-12)
    assert_trees_close(TR.post_rotate_after_load(ttree(p), cfg, device="cpu"),
                       JR.post_rotate_after_load(jtree(p), jcfg), 1e-12)
    want, wQ = JR.rotate_model(jtree(p), jcfg, seed=4)
    got, gQ = TR.rotate_model(ttree(p), cfg, seed=4, device="cpu")
    np.testing.assert_array_equal(gQ, wQ)
    assert_trees_close(got, want, 1e-12)
    ids = torch.from_numpy(_ids(cfg, 5))
    pol = TPOL.QuantPolicy(norms_fused=True, online_had_o=True,
                           online_had_down=hadU_supported(
                               cfg.intermediate_size))
    base = TF.forward(ttree(p), ids, cfg, TPOL.FP16).numpy()
    _close(TF.forward(got, ids, cfg, pol).numpy(), base, 1e-5)


@pytest.mark.parametrize("name", ["opt", "falcon_two_norms"])
def test_rotate_model_f32_one_rounding(name):
    """In float32 both packages round the same float64 folds after every
    transform: equal within one f32 rounding."""
    cfg, jcfg = configs(name)
    p = np_family_params(cfg, seed=6)
    want, _ = JR.rotate_model(jtree(p), jcfg, seed=2)
    got, _ = TR.rotate_model(ttree(p), cfg, seed=2, device="cpu")
    assert_trees_close(got, want, 2.0 ** -23, ulps=True)


def test_gemma2_rotation_refused():
    cfg, jcfg = configs("gemma2")
    p = np_family_params(cfg, seed=7)
    with pytest.raises(NotImplementedError, match="Gemma-2"):
        JR.rotate_model(jtree(p), jcfg)
    for fn in (lambda: TR.rotate_model(ttree(p), cfg, device="cpu"),
               lambda: TR.fuse_norms(ttree(p), cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match="Gemma-2"):
            fn()


# ---------------------------------------------------------------------------
# Gemma-2's attention
# ---------------------------------------------------------------------------

def _qkv(cfg, seed, s):
    rng = np.random.default_rng(seed)
    shape = (2, s, cfg.num_attention_heads, cfg.head_dim_)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("layer", [0, 1])
def test_gemma2_attention_chunked_matches_dense(layer):
    """The chunked path (query chunks of 16, key chunks of 16, at 40 tokens
    with a window of 8 on even layers) against the dense path at a lowered
    threshold and against the reference's chunked path, within 2e-6."""
    cfg, jcfg = configs("gemma2")
    q, k, v = _qkv(cfg, 8, 40)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TG.attention_chunked(tq, tk, tv, cfg, layer, q_chunk=16,
                               k_chunk=16).numpy()
    dense = TG.attention(tq, tk, tv, cfg, layer,
                         chunk_threshold=10 ** 6).numpy()
    chunked = TG.attention(tq, tk, tv, cfg, layer, chunk_threshold=40)
    want = np.asarray(JG.attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jcfg, layer,
                                           q_chunk=16, k_chunk=16))
    np.testing.assert_allclose(got, dense, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(
        dense, np.asarray(JG.attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jcfg, layer)),
        rtol=2e-6, atol=2e-6)
    assert torch.equal(chunked, TG.attention_chunked(tq, tk, tv, cfg, layer))


def test_gemma2_sliding_window_changes_result():
    """Layer 0 (windowed, 8 tokens) and layer 1 (full causal) agree on the
    first 8 queries and differ after them; so do the models' logits."""
    cfg, _ = configs("gemma2")
    q, k, v = (torch.from_numpy(a) for a in _qkv(cfg, 9, 24))
    even = TG.attention(q, k, v, cfg, 0)
    odd = TG.attention(q, k, v, cfg, 1)
    torch.testing.assert_close(even[:, :8], odd[:, :8], rtol=0, atol=0)
    assert (even[:, 8:] - odd[:, 8:]).abs().amax() > 1e-2
    p = ttree(np_family_params(cfg, seed=10))
    ids = torch.from_numpy(_ids(cfg, 11))
    wide = dataclasses.replace(cfg, sliding_window=None)
    a = TF.forward(p, ids, cfg, TPOL.FP16)
    b = TF.forward(p, ids, wide, TPOL.FP16)
    torch.testing.assert_close(a[:, :8], b[:, :8], rtol=0, atol=0)
    assert (a[:, 8:] - b[:, 8:]).abs().amax() > 1e-4


# ---------------------------------------------------------------------------
# Weighting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("name", FAMILIES)
def test_attention_received_matches_reference(name, layer):
    """attncon (0.005-1) of two samples of 32 tokens on each layer's own
    attention, within 1e-5 relative; on Gemma-2 the layer's window."""
    cfg, jcfg = configs(name)
    lp = np_family_params(cfg, seed=12)["layers"][layer]
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 32, cfg.hidden_size)).astype(np.float32)
    tf = np.ones((2, 32), np.int32)
    kw = dict(method="attncon", min_value=0.005, max_value=1.0)
    want = np.stack([np.asarray(JW.compute_sample_weight(
        jtree(lp), jnp.asarray(x[s]), jnp.asarray(x[s]), jnp.asarray(tf[s]),
        jcfg, JPOL.FP16, JW.WeightingConfig(**kw), layer=layer))
        for s in range(2)])
    got = TW.compute_sample_weight(
        ttree(lp), torch.from_numpy(x), torch.from_numpy(x),
        torch.from_numpy(tf), cfg, TPOL.FP16, TW.WeightingConfig(**kw),
        layer=layer).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    raw = TW._attention_received(ttree(lp), torch.from_numpy(x), cfg,
                                 TW.WeightingConfig(**kw), layer)
    # each query's probabilities sum to 1: heads x tokens in all
    torch.testing.assert_close(raw.sum(-1), torch.full(
        (2,), 32.0 * cfg.num_attention_heads), rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# The pipeline, checkpoints, PPL
# ---------------------------------------------------------------------------

def _family_rsq(name, rtn=False):
    """run_rsq.sh's configuration (rotate, attncon 0.005-1, W4 MSE clip,
    add_until_fail), without rotation on Gemma-2; RTN for the checkpoint
    tests."""
    trsq, jrsq = _rsq_configs("run_rsq")
    kw = dict(nsamples=4, w_rtn=rtn, rotate=name != "gemma2")
    return dataclasses.replace(trsq, **kw), dataclasses.replace(jrsq, **kw)


def _calib(cfg):
    return JD.get_loaders("synthetic", nsamples=4, seqlen=24,
                          vocab_size=cfg.vocab_size)


@pytest.mark.parametrize("name", FAMILIES)
def test_quantize_model_matches_reference(name, monkeypatch):
    """Each GPTQ call held against the reference's at the same place: the
    port's W within 1e-6 and H within 1e-5 of the reference's largest
    entries; then GPTQ on the reference's W and H, Q within rtol 1e-4,
    atol 1e-5 but for ties one step off; then the same quantizers and
    weights (test_torch_pipeline.hold_quantize_model).  GPTQ runs on the
    reference's state because OPT's layer-0 o is chaotic in the reference
    itself: a 1e-7 relative change of H moves 8 of its entries by up to 2
    steps; the port on the same W and H moves none."""
    cfg, jcfg = configs(name)
    p = np_family_params(cfg, seed=14)
    got, gq, _, _ = hold_quantize_model(p, cfg, jcfg, _calib(cfg),
                                        *_family_rsq(name), monkeypatch,
                                        on_reference_state=True)
    assert set(gq) == {f"layers.{i}.{n}" for i in range(cfg.num_layers)
                       for n in TF.linear_names(cfg)}
    if name != "gemma2":
        assert got["layers"][0]["input_norm"] is None
        assert got["lm_head_bias"] is not None


@pytest.mark.parametrize("name", FAMILIES)
def test_checkpoint_interchange(name, tmp_path):
    """RTN (rotated but on Gemma-2) saved by rsq_tpu loads in the port and
    the reverse, bit for bit: OPT's embed_pos, the fused lm_head_bias,
    Falcon's fc1/fc2.  The port also saves Gemma-2's post_attn_norm,
    pre_ff_norm and post_ff_norm, which the reference neither saves nor
    reads (ROADMAP section 3): the port's own round trip keeps them."""
    cfg, jcfg = configs(name)
    p = np_family_params(cfg, seed=15)
    calib = _calib(cfg)
    trsq, jrsq = _family_rsq(name, rtn=True)
    jq = JP.quantize_model(jtree(p), jcfg, jrsq, calib)
    tq = TP.quantize_model(ttree(p), cfg, trsq, calib, device="cpu")
    meta = {"rotate": trsq.rotate, "w_bits": 4}
    JCK.save_quantized(str(tmp_path / "j"), *jq, jcfg, meta=meta)
    TCK.save_quantized(str(tmp_path / "t"), *tq, cfg, meta=meta)
    _same_checkpoint(TCK.load_quantized(str(tmp_path / "j")),
                     JCK.load_quantized(str(tmp_path / "j")))
    mine = TCK.load_quantized(str(tmp_path / "t"))
    saved = leaves(tq[0])
    if name == "gemma2":
        extra = {k for k in saved if k.split(".")[-1] in TG.NORMS[1:]}
        assert len(extra) == 3 * cfg.num_layers
        for k in extra:
            np.testing.assert_array_equal(leaves(mine[0])[k], saved[k])
        for lp in mine[0]["layers"]:
            for n in TG.NORMS[1:]:
                lp[n] = None
    else:
        assert {"embed_pos", "lm_head_bias"} & set(leaves(mine[0]))
    _same_checkpoint(JCK.load_quantized(str(tmp_path / "t")), mine)


@pytest.mark.parametrize("name", FAMILIES)
def test_ppl_matches_reference(name):
    """ppl_fullmodel and ppl_streamed (FP16; 1024 tokens at val_seqlen 32,
    a ragged last batch of 2) within 1e-5 relative of the reference's."""
    cfg, jcfg = configs(name)
    p = np_family_params(cfg, seed=16)
    stream = JD.get_loaders("synthetic", eval_mode=True,
                            vocab_size=cfg.vocab_size)[:1024]
    want = JPPL.ppl_fullmodel(jtree(p), jcfg, JPOL.FP16, stream, 32, bsz=6)
    got = TPPL.ppl_fullmodel(ttree(p), cfg, TPOL.FP16, stream, 32, bsz=6,
                             device="cpu")
    assert got == pytest.approx(want, rel=1e-5)
    want_s = JPPL.ppl_streamed(jtree(p), jcfg, JPOL.FP16, stream, 32, bsz=6)
    got_s = TPPL.ppl_streamed(ttree(p), cfg, TPOL.FP16, stream, 32, bsz=6,
                              device="cpu")
    assert got_s == pytest.approx(want_s, rel=1e-5)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

CLI_ARGS = ["--cal-dataset", "synthetic", "--nsamples", "4",
            "--train-seqlen", "24", "--w-bits", "4", "--w-clip",
            "--weighting", "attncon", "--min-value", "0.005", "--max-value",
            "1", "--add-until-fail", "--eval", "--eval-dataset",
            "synthetic", "--val-seqlen", "128", "--bsz", "128"]


@pytest.mark.parametrize("model", ["tiny-opt", "tiny-gemma2",
                                   "tiny-falcon"])
def test_cli_quantize_eval_matches_reference(model, tmp_path, monkeypatch):
    """`quantize --model tiny-<family> [--rotate] --eval --save`, then
    `eval --load`, on the CPU: both packages' CLIs given the same params
    (their random inits differ: a jax.random key and a torch.Generator)
    and the same eval stream, its first 4096 tokens (32 rows of 128, one
    ragged batch), the port's PPL within 1e-5 relative of the
    reference's, eval's of quantize's.  --rotate on tiny-gemma2 raises in
    both; `serve` refuses the checkpoint (rsq_tpu serves the Llama family
    only)."""
    cfg = getattr(ModelConfig, model.replace("-", "_"))()
    p = np_family_params(cfg, seed=17)
    monkeypatch.setattr(JF, "init_params", lambda *a, **k: jtree(p))
    monkeypatch.setattr(TF, "init_params", lambda *a, **k: ttree(p))
    for data in (JD, TD):
        def short(*a, _load=data.get_loaders, **k):
            out = _load(*a, **k)
            return out[:4096] if k.get("eval_mode") else out
        monkeypatch.setattr(data, "get_loaders", short)
    rot = [] if model == "tiny-gemma2" else ["--rotate"]
    args = ["quantize", "--model", model, *rot, *CLI_ARGS]
    want = jcli.main(args)["ppl"]
    ck = str(tmp_path / "ck")
    got = cli.main(args + ["--device", "cpu", "--save", ck])
    assert np.isfinite(got["ppl"]) and got["ppl"] == pytest.approx(
        want, rel=1e-5)
    ev = cli.main(["eval", "--load", ck, "--device", "cpu", "--eval-dataset",
                   "synthetic", "--val-seqlen", "128", "--bsz", "128"])
    assert ev["ppl"] == pytest.approx(got["ppl"], rel=1e-5)
    with pytest.raises(NotImplementedError, match="Llama family"):
        cli.main(["serve", "--load", ck, "--device", "cpu"])
    if model == "tiny-gemma2":
        for main in (jcli.main, lambda a: cli.main(a + ["--device", "cpu"])):
            with pytest.raises(NotImplementedError, match="Gemma-2"):
                main(["quantize", "--model", model, "--rotate",
                      *CLI_ARGS])
