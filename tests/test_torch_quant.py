"""The quantizer primitives and GPTQ of rsq_tpu_torch against rsq_tpu on
the CPU, inputs from numpy seeds: core.quant and core.nf (integer codes bit
for bit, scales within 1e-6 relative), hessian_from_inputs (within 1e-6
of its largest entry), and gptq_quantize / rtn_quantize on identical
Hessians (within rtol 1e-4, atol 1e-5: the bound of tests/test_gptq.py),
act-order, groups,
dead columns and add_until_fail on a singular H included."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.core import nf as JNF
from rsq_tpu.core import quant as JQ
from rsq_tpu.quantize import gptq as JG
from rsq_tpu_torch.core import nf as TNF
from rsq_tpu_torch.core import quant as TQ
from rsq_tpu_torch.quantize import gptq as TG


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=0)


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(a, jnp.float32)


ACT_CFGS = [TQ.ActQuantConfig(bits=4), TQ.ActQuantConfig(bits=4, sym=False),
            TQ.ActQuantConfig(bits=4, groupsize=16),
            TQ.ActQuantConfig(bits=8, sym=False, groupsize=16,
                              clip_ratio=0.9),
            TQ.ActQuantConfig(bits=4, clip_ratio=0.85)]


@pytest.mark.parametrize("i", range(len(ACT_CFGS)))
def test_act_fake_quant_bit_equal(i):
    """Per-token and per-group activation quantization, as the reference
    runs it (inside a jitted forward): bit for bit, zero rows included."""
    cfg = ACT_CFGS[i]
    jcfg = JQ.ActQuantConfig(**cfg.__dict__)
    x = np.random.default_rng(i).standard_normal((3, 5, 64)).astype(
        np.float32) * 3
    x[0, 1] = 0.0
    want = jax.jit(functools.partial(JQ.act_fake_quant, cfg=jcfg))(j(x))
    got = TQ.act_fake_quant(t(x), cfg)
    np.testing.assert_array_equal(np_of(got), np.asarray(want))
    ws, wz = jax.jit(functools.partial(JQ.act_quant_params, cfg=jcfg))(j(x))
    gs, gz = TQ.act_quant_params(t(x), cfg)
    np.testing.assert_array_equal(np_of(gs), np.asarray(ws))
    np.testing.assert_array_equal(np_of(gz), np.asarray(wz))


W_CFGS = [dict(bits=4), dict(bits=4, sym=False), dict(bits=4, mse=True),
          dict(bits=3, sym=False, mse=True), dict(bits=4, nf=True),
          dict(bits=4, nf=True, mse=True), dict(bits=8, perchannel=False),
          dict(bits=2, mse=True, grid=50, maxshrink=0.5)]


@pytest.mark.parametrize("i", range(len(W_CFGS)))
def test_weight_quant_params_and_codes(i):
    """Per-row (scale, zero) within 1e-6 relative (the MSE search scores
    with f32 sums in another order); each package's codes from its own
    params bit for bit; the fake-quant weights within one f32 rounding."""
    rng = np.random.default_rng(10 + i)
    W = (rng.standard_normal((24, 80)) * 0.05).astype(np.float32)
    W[3] = 0.0
    cfg = TQ.WeightQuantConfig(**W_CFGS[i])
    jcfg = JQ.WeightQuantConfig(**W_CFGS[i])
    js, jz = JQ.weight_quant_params(j(W), jcfg)
    ts, tz = TQ.weight_quant_params(t(W), cfg)
    assert ts.shape == (24, 1) and tz.shape == (24, 1)
    close(ts, js, 1e-6)
    close(tz, jz, 1e-6)
    if cfg.nf:
        want = JNF.nf_quant(j(W), cfg.bits, js)
        got = TNF.nf_quant(t(W), cfg.bits, ts)
    else:
        want = JQ.weight_quantize_store(j(W), js, jz, jcfg)
        got = TQ.weight_quantize_store(t(W), ts, tz, cfg)
    np.testing.assert_array_equal(np_of(got), np.asarray(want))
    close(TQ.weight_fake_quant(t(W), ts, tz, cfg),
          JQ.weight_fake_quant(j(W), js, jz, jcfg), 1e-6)


def test_pack_int4_round_trip():
    q = np.random.default_rng(3).integers(-8, 8, (5, 34)).astype(np.int8)
    got = TQ.pack_int4(t(q))
    np.testing.assert_array_equal(np_of(got), np.asarray(JQ.pack_int4(
        jnp.asarray(q))))
    np.testing.assert_array_equal(np_of(TQ.unpack_int4(got)), q)


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_nf_codebook_and_scale(bits):
    np.testing.assert_array_equal(TNF.nf_codebook(bits),
                                  JNF.nf_codebook(bits))
    assert TNF.grid_max(bits) == JNF.grid_max(bits)
    W = (np.random.default_rng(bits).standard_normal((16, 40)) * 0.1).astype(
        np.float32)
    close(TNF.nf_find_scale(t(W), bits), JNF.nf_find_scale(j(W), bits), 1e-6)
    s = JNF.nf_find_scale(j(W), bits)
    np.testing.assert_array_equal(
        np_of(TNF.nf_quant(t(W), bits, t(np.asarray(s)))),
        np.asarray(JNF.nf_quant(j(W), bits, s)))


@pytest.mark.parametrize("weighted", [False, True])
def test_hessian_from_inputs(weighted):
    rng = np.random.default_rng(20 + weighted)
    xs = rng.standard_normal((5, 12, 48)).astype(np.float32)
    w = rng.uniform(0.01, 1.0, (5, 12)).astype(np.float32) if weighted \
        else None
    want = np.asarray(JG.hessian_from_inputs(j(xs),
                                             None if w is None else j(w)))
    got = np_of(TG.hessian_from_inputs(t(xs), None if w is None else t(w)))
    # f32 sums in another order: within 1e-6 of the largest entry (entries
    # near 0 are differences of large terms)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _problem(seed, rows=16, cols=72, nsamples=200):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((rows, cols)) * 0.1).astype(np.float32)
    A = rng.standard_normal((cols, cols)).astype(np.float32)
    X = rng.standard_normal((nsamples, cols)).astype(np.float32) @ A
    return W, ((2.0 / nsamples) * X.T @ X).astype(np.float32)


# (name, WeightQuantConfig kwargs, GPTQConfig kwargs); blocksize 16 puts
# several blocks (and a padded last one) in a 72-column problem
GPTQ_CASES = [
    ("plain", dict(bits=4), dict(blocksize=16)),
    ("mse_clip", dict(bits=4, mse=True), dict(blocksize=16)),
    ("asym", dict(bits=3, sym=False), dict(blocksize=16)),
    ("actorder", dict(bits=4), dict(blocksize=16, actorder=True)),
    ("groups4", dict(bits=4), dict(blocksize=16, groupsize=4)),
    ("groups8_actorder", dict(bits=4, sym=False),
     dict(blocksize=16, groupsize=8, actorder=True)),
    ("nf", dict(bits=4, nf=True), dict(blocksize=16)),
    ("default_block", dict(bits=4, mse=True), dict()),
]


@pytest.mark.parametrize("name,wkw,gkw", GPTQ_CASES,
                         ids=[c[0] for c in GPTQ_CASES])
def test_gptq_matches_reference(name, wkw, gkw):
    W, H = _problem(30 + len(name))
    if name == "actorder":
        H[5, :] = H[:, 5] = 0.0           # a dead column, reordered last
    want, winfo = JG.gptq_quantize(j(W), j(H), JQ.WeightQuantConfig(**wkw),
                                   JG.GPTQConfig(**gkw))
    got, ginfo = TG.gptq_quantize(t(W), t(H), TQ.WeightQuantConfig(**wkw),
                                  TG.GPTQConfig(**gkw), device="cpu")
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    close(ginfo["scale"], winfo["scale"], 1e-5)
    np.testing.assert_allclose(np_of(ginfo["losses"]),
                               np.asarray(winfo["losses"]), rtol=1e-3,
                               atol=1e-9)
    assert TG.quant_error(t(W), got, t(H)) == pytest.approx(
        JG.quant_error(j(W), want, j(H)), rel=1e-4)


def test_gptq_dead_columns_zeroed():
    W, H = _problem(41)
    H[[2, 9], :] = 0.0
    H[:, [2, 9]] = 0.0
    wq = dict(bits=4)
    want, _ = JG.gptq_quantize(j(W), j(H), JQ.WeightQuantConfig(**wq),
                               JG.GPTQConfig(blocksize=16))
    got, _ = TG.gptq_quantize(t(W), t(H), TQ.WeightQuantConfig(**wq),
                              TG.GPTQConfig(blocksize=16), device="cpu")
    assert np.all(np_of(got)[:, [2, 9]] == 0)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_gptq_add_until_fail_on_singular_hessian():
    """A rank-6 Hessian (48 columns) shifted by -1.5% of its mean diagonal:
    the first damping (1% of the mean diagonal) leaves it indefinite, so
    both packages refuse it, and with add_until_fail both find the factor
    at the second damping."""
    rng = np.random.default_rng(42)
    W = (rng.standard_normal((8, 48)) * 0.1).astype(np.float32)
    X = rng.standard_normal((6, 48)).astype(np.float32)
    H = (X.T @ X).astype(np.float32)
    H -= np.float32(0.015 * np.diag(H).mean()) * np.eye(48, dtype=np.float32)
    wq, cfg = dict(bits=4), dict(blocksize=16)
    with pytest.raises(FloatingPointError):
        TG.gptq_quantize(t(W), t(H), TQ.WeightQuantConfig(**wq),
                         TG.GPTQConfig(**cfg), device="cpu")
    with pytest.raises(FloatingPointError):
        JG.gptq_quantize(j(W), j(H), JQ.WeightQuantConfig(**wq),
                         JG.GPTQConfig(**cfg))
    cfg["add_until_fail"] = True
    want, _ = JG.gptq_quantize(j(W), j(H), JQ.WeightQuantConfig(**wq),
                               JG.GPTQConfig(**cfg))
    got, _ = TG.gptq_quantize(t(W), t(H), TQ.WeightQuantConfig(**wq),
                              TG.GPTQConfig(**cfg), device="cpu")
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("mse", [False, True])
def test_rtn_matches_reference(mse):
    W, _ = _problem(50 + mse)
    wq = dict(bits=4, mse=mse)
    want, winfo = JG.rtn_quantize(j(W), JQ.WeightQuantConfig(**wq))
    got, ginfo = TG.rtn_quantize(t(W), TQ.WeightQuantConfig(**wq),
                                 device="cpu")
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    close(ginfo["scale"], winfo["scale"], 1e-6)
