"""The RSQ pipeline of rsq_tpu_torch against rsq_tpu on the CPU, at tiny
size (2 layers, hidden 64), on the same params carried across from numpy
and the same calibration data:

- quantize_model under the run_rsq.sh config (rotate, attncon weighting
  0.005-1, W4 sym with MSE clip, add_until_fail), plain GPTQ, RTN, the
  "ss" calibration attention (half the heads block, half shifted-block,
  kept for the Hessian passes), and layers_dont_quantize with
  int8_down_proj, each quantizer call held
  against the reference's on the same state (its W, its Hessian, its
  weights within rtol 1e-4, atol 1e-5 -- tests/test_gptq.py's bound --
  but for rounding ties one step off in at most 0.1% of the entries); the
  same quantizer keys and bits, scales within 1e-5 relative;
- ppl_fullmodel and ppl_streamed within 1e-4 relative (FP16), 2e-3 under
  W4A4KV4, whose 4-bit activation ties give the reference itself that
  spread;
- a checkpoint saved by either package loads in the other, bit for bit;
- the data loaders (synthetic, retrieval) equal;
- `python -m rsq_tpu_torch.cli quantize --device cpu --save`, then `eval`
  and `serve` on the checkpoint, end to end."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rsq_tpu.core.quant import WeightQuantConfig as JWQ
from rsq_tpu.eval import ppl as JPPL
from rsq_tpu.models.config import ModelConfig as JConfig
from rsq_tpu.models import policy as JPOL
from rsq_tpu.quantize import checkpoint as JCK
from rsq_tpu.quantize import data as JD
from rsq_tpu.quantize import pipeline as JP
from rsq_tpu.quantize.weighting import WeightingConfig as JWC
from rsq_tpu_torch import cli
from rsq_tpu_torch.core.quant import WeightQuantConfig as TWQ
from rsq_tpu_torch.eval import ppl as TPPL
from rsq_tpu_torch.models import policy as TPOL
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.quantize import checkpoint as TCK
from rsq_tpu_torch.quantize import data as TD
from rsq_tpu_torch.quantize import pipeline as TP
from rsq_tpu_torch.quantize.weighting import WeightingConfig as TWC
from test_torch_rotation import jtree, leaves, np_params, ttree

CFG, JCFG = ModelConfig.tiny(num_layers=2), JConfig.tiny(num_layers=2)


@pytest.fixture(scope="module")
def model():
    params = np_params(CFG, seed=21)
    calib = JD.get_loaders("synthetic", nsamples=8, seqlen=32,
                           vocab_size=CFG.vocab_size)
    stream = JD.get_loaders("synthetic", eval_mode=True,
                            vocab_size=CFG.vocab_size)[:1024]
    return params, calib, stream


def _rsq_configs(name):
    """(port RSQConfig, reference RSQConfig) of a named configuration."""
    def both(**kw):
        w = kw.pop("w", {})
        wt = kw.pop("weighting", None)
        g = kw.pop("gptq", {})
        t = TP.RSQConfig(w=TWQ(**w), weighting=wt and TWC(**wt),
                         gptq=dataclasses.replace(TP.RSQConfig().gptq, **g),
                         **kw)
        j = JP.RSQConfig(w=JWQ(**w), weighting=wt and JWC(**wt),
                         gptq=dataclasses.replace(JP.RSQConfig().gptq, **g),
                         **kw)
        return t, j

    return {
        "run_rsq": lambda: both(
            w=dict(bits=4, sym=True, mse=True), rotate=True,
            weighting=dict(method="attncon", min_value=0.005, max_value=1.0),
            nsamples=8, gptq=dict(add_until_fail=True)),
        "gptq": lambda: both(w=dict(bits=4, sym=True), nsamples=8),
        "rtn": lambda: both(w=dict(bits=4, sym=True), nsamples=4,
                            w_rtn=True),
        "ss_mask": lambda: both(
            w=dict(bits=4, sym=True), nsamples=4,
            weighting=dict(method="attncon", custom_attn_type="ss",
                           attn_length=8)),
        "skip_int8_down": lambda: both(
            w=dict(bits=4, sym=True), nsamples=4, layers_dont_quantize=(0,),
            int8_down_proj=True,
            weighting=dict(method="actnorm", apply_module="down")),
    }[name]()


def _one_step_flips(got, want, step):
    """Entries of got outside rtol 1e-4, atol 1e-5 of want: each must be
    one quantization step (the row's scale) off, a rounding tie decided the
    other way.  Returns their count."""
    got, want = np.asarray(got), np.asarray(want)
    off = ~np.isclose(got, want, rtol=1e-4, atol=1e-5)
    rows = np.nonzero(off)[0]
    step = np.asarray(step).reshape(-1)[rows]
    np.testing.assert_allclose(np.abs(got - want)[off], step, rtol=1e-4)
    return int(off.sum())


def hold_quantize_model(params, cfg, jcfg, calib, trsq, jrsq, monkeypatch,
                        on_reference_state=False):
    """quantize_model of both packages on the same numpy params, each of
    the port's quantizer calls held against the reference's at the same
    place (test_quantize_model_matches_reference's rules); returns (the
    port's params, its quantizers, the reference's params, quantizers).
    on_reference_state: the port's quantizer runs on the reference's W and
    H (its own held to them first), for a call whose result the reference
    itself moves by more than one step under a 1e-7 change of H."""
    ref = []

    def recorder(fn):
        def run(W, *args):
            Q, info = fn(W, *args)
            H = args[0] if len(args) == 3 else None
            ref.append((np.asarray(W), None if H is None else np.asarray(H),
                        np.asarray(Q), np.asarray(info["scale"])))
            return Q, info
        return run

    monkeypatch.setattr(JP, "gptq_quantize", recorder(JP.gptq_quantize))
    monkeypatch.setattr(JP, "rtn_quantize", recorder(JP.rtn_quantize))
    want, wq = JP.quantize_model(jtree(params), jcfg, jrsq, calib)
    calls, flips, entries = iter(ref), [0], [0]

    def forced(fn):
        def run(W, *args, device):
            rW, rH, rQ, rs = next(calls)
            np.testing.assert_allclose(W.numpy(), rW, rtol=0,
                                       atol=1e-6 * np.abs(rW).max())
            if rH is not None:
                H = args[0].numpy()
                np.testing.assert_allclose(H, rH, rtol=0,
                                           atol=1e-5 * np.abs(rH).max())
            if on_reference_state:
                W = torch.from_numpy(rW)
                args = (torch.from_numpy(rH),) + args[1:] \
                    if rH is not None else args
            Q, info = fn(W, *args, device=device)
            flips[0] += _one_step_flips(Q.numpy(), rQ, rs)
            entries[0] += rQ.size
            return torch.from_numpy(rQ).to(Q.dtype), info
        return run

    monkeypatch.setattr(TP, "gptq_quantize", forced(TP.gptq_quantize))
    monkeypatch.setattr(TP, "rtn_quantize", forced(TP.rtn_quantize))
    got, gq = TP.quantize_model(ttree(params), cfg, trsq, calib,
                                device="cpu")
    assert next(calls, None) is None
    assert flips[0] <= 1e-3 * entries[0], (flips[0], entries[0])
    assert gq.keys() == wq.keys()
    for k in wq:
        assert gq[k]["bits"] == wq[k]["bits"], k
        np.testing.assert_allclose(gq[k]["scale"].numpy().reshape(-1),
                                   np.asarray(wq[k]["scale"]).reshape(-1),
                                   rtol=1e-5, err_msg=k)
    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    return got, gq, want, wq


@pytest.mark.parametrize("name", ["run_rsq", "gptq", "rtn", "ss_mask",
                                  "skip_int8_down"])
def test_quantize_model_matches_reference(model, name, monkeypatch):
    """Each quantizer call of the port's pipeline is held against the
    reference's call at the same place, on the same state: the port's W
    within 1e-6 and its Hessian within 1e-5 of their largest entries, its
    own quantized weights within rtol 1e-4, atol 1e-5 but for at most 0.1%
    of all entries that sit one step off (a rounding tie: the reference
    itself flips one in layer 1's o under a 1e-7 change of H).  The
    reference's weights then go on, as the ROADMAP holds end-to-end logits
    on identical cache state: a flipped tie moves the next groups'
    Hessians by 1e-4 to 1e-3, and their ties cascade.  Then the same
    quantizer keys, bits and scales (1e-5 relative), and the same
    weights."""
    params, calib, _ = model
    trsq, jrsq = _rsq_configs(name)
    got, gq, _, _ = hold_quantize_model(params, CFG, JCFG, calib, trsq, jrsq,
                                        monkeypatch)
    g = leaves(got)
    if name == "skip_int8_down":
        assert "layers.0.q" not in gq and gq["layers.1.down"]["bits"] == 8
        np.testing.assert_array_equal(g["layers.0.q.w"],
                                      params["layers"][0]["q"]["w"])


@pytest.mark.parametrize("policy", ["fp16", "w4a4kv4"])
def test_ppl_matches_reference(model, policy):
    """FP16: within 1e-4 relative.  W4A4KV4: within 2e-3, twice the
    reference's own spread -- its PPL of these params moves by 1.5e-4 to
    8.6e-4 relative when a third of the weights move by one f32 rounding
    (numpy seeds 0-2), since 4-bit activation codes at a rounding tie
    flip.  The port's streamed and full-model PPL within 1e-4 of each
    other either way."""
    params, _, stream = model
    rel = 1e-4 if policy == "fp16" else 2e-3
    tp, jp = ((TPOL.FP16, JPOL.FP16) if policy == "fp16"
              else (TPOL.w4a4kv4(), JPOL.w4a4kv4()))
    # 1024 tokens at val_seqlen 32: 32 rows, a ragged last batch of 2
    want = JPPL.ppl_fullmodel(jtree(params), JCFG, jp, stream, 32, bsz=6)
    got = TPPL.ppl_fullmodel(ttree(params), CFG, tp, stream, 32, bsz=6,
                             device="cpu")
    assert got == pytest.approx(want, rel=rel)
    want = JPPL.ppl_streamed(jtree(params), JCFG, jp, stream, 32, bsz=6)
    got_s = TPPL.ppl_streamed(ttree(params), CFG, tp, stream, 32, bsz=6,
                              device="cpu")
    assert got_s == pytest.approx(want, rel=rel)
    assert got_s == pytest.approx(got, rel=1e-4)


def _same_checkpoint(got, want):
    (gp, gq, gcfg, gm), (wp, wq, wcfg, wm) = got, want
    assert dataclasses.asdict(gcfg) == dataclasses.asdict(wcfg)
    assert gm == wm
    g, w = leaves(gp), leaves(wp)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k
    assert gq.keys() == wq.keys()
    for k in wq:
        for f in ("scale", "zero"):
            np.testing.assert_array_equal(np.asarray(gq[k][f]),
                                          np.asarray(wq[k][f]))
        assert gq[k]["bits"] == wq[k]["bits"]


def test_checkpoint_interchange(model, tmp_path):
    """Saved by rsq_tpu, loaded by the port, and the reverse: the same
    arrays bit for bit, the same config, manifest and quantizers."""
    params, calib, _ = model
    trsq, jrsq = _rsq_configs("rtn")
    jparams = JP.quantize_model(jtree(params), JCFG, jrsq, calib)
    tparams = TP.quantize_model(ttree(params), CFG, trsq, calib,
                                device="cpu")
    meta = {"rotate": False, "w_bits": 4}
    JCK.save_quantized(str(tmp_path / "j"), *jparams, JCFG, meta=meta)
    TCK.save_quantized(str(tmp_path / "t"), *tparams, CFG, meta=meta)
    _same_checkpoint(TCK.load_quantized(str(tmp_path / "j")),
                     JCK.load_quantized(str(tmp_path / "j")))
    _same_checkpoint(JCK.load_quantized(str(tmp_path / "t")),
                     TCK.load_quantized(str(tmp_path / "t")))
    # the port's save of what it loaded from the reference: the same bytes
    TCK.save_quantized(str(tmp_path / "jt"),
                       *TCK.load_quantized(str(tmp_path / "j"))[:3],
                       meta=meta)
    _same_checkpoint(JCK.load_quantized(str(tmp_path / "jt")),
                     JCK.load_quantized(str(tmp_path / "j")))


@pytest.mark.parametrize("name,kw", [
    ("synthetic", dict(nsamples=4, seqlen=64, vocab_size=300)),
    ("synthetic", dict(eval_mode=True, vocab_size=300)),
    ("retrieval", dict(nsamples=3, seqlen=48, vocab_size=500, seed=2))])
def test_data_loaders_equal(name, kw):
    np.testing.assert_array_equal(TD.get_loaders(name, **kw),
                                  JD.get_loaders(name, **kw))


def test_cli_quantize_eval_serve_on_cpu(tmp_path, capsys):
    """The three commands end to end on the CPU, the run_rsq.sh config on
    the tiny model: quantize saves a rotated W4 checkpoint and reports a
    finite PPL; eval reloads it and gives the same PPL; serve answers
    every request on it through the paged engine."""
    ck = str(tmp_path / "ck")
    res = cli.main(["quantize", "--model", "tiny", "--device", "cpu",
                    "--cal-dataset", "synthetic", "--nsamples", "4",
                    "--train-seqlen", "32", "--w-bits", "4", "--w-clip",
                    "--rotate", "--weighting", "attncon", "--min-value",
                    "0.005", "--max-value", "1", "--add-until-fail",
                    "--eval", "--eval-dataset", "synthetic", "--val-seqlen",
                    "128", "--bsz", "128", "--save", ck])
    assert np.isfinite(res["ppl"]) and res["device"] == "cpu"
    ev = cli.main(["eval", "--load", ck, "--device", "cpu", "--eval-dataset",
                   "synthetic", "--val-seqlen", "128", "--bsz", "128"])
    assert ev["ppl"] == pytest.approx(res["ppl"], rel=1e-5)
    out = cli.main(["serve", "--load", ck, "--device", "cpu", "--requests",
                    "3", "--num-slots", "2", "--page-size", "128",
                    "--max-seq", "256", "--prompt-len", "20",
                    "--max-new-tokens", "4", "--attn-int8-qk"])
    assert out["requests"] == 3 and out["new_tokens"] == 12
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [set(x) >= {"ppl"} for x in lines[:2]] == [True, True]


def test_two_dimensional_calibration_mask_gets_causality():
    """block / window / sink: the reference adds its (L, L) mask to None
    and raises TypeError; the port adds the causal mask, as it does to the
    per-head "ss" masks (ROADMAP section 3)."""
    from rsq_tpu_torch.models.llama import causal_mask
    rsq, _ = _rsq_configs("gptq")
    rsq = dataclasses.replace(rsq, weighting=TWC(
        method="attncon", custom_attn_type="block", attn_length=4))
    got = TP._calibration_attn_mask(rsq, CFG, 12, torch.device("cpu"))
    block = (torch.arange(12)[:, None] // 4 == torch.arange(12)[None, :] // 4)
    causal = causal_mask(12, "cpu") == 0
    assert torch.equal(got == 0, block & causal)
    assert float(got.min()) == torch.finfo(torch.float32).min
