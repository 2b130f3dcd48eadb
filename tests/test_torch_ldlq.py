"""The LDLQ+E8P half of rsq_tpu_torch.quantize.ldlq, and the E8P route from
quantize_model to the served weights, against rsq_tpu on the CPU, on the
same seeded numpy inputs (float32 given explicitly: tests/conftest.py runs
JAX with x64 on):

- search_grids equal to the reference's array for array (values and
  dtypes); quantize_e8p values and codes bit-equal;
- block_ldl's L and D within 1e-5 of their largest entry; e8p_scale
  within 1e-6 relative (the norm's reduction order differs: 1-3 f32
  units in the last place);
- ldlq_quantize at (16, 64) and (32, 128), quip_tune_iters 0, 2 and 10:
  codes bit-equal, Q within 1e-6 relative, the Hessian-weighted error
  tr(E H E^T) within 1e-4 relative.  No rounding tie flipped a block on
  these seeds (0-2);
- the tiny pipeline (rotate, attncon, add_until_fail, e8p) call by call:
  each ldlq_quantize of the port runs on the reference's W and H of the
  same call (the port's own within 1e-6 / 1e-5 of their largest entries)
  and gives the reference's codes bit for bit, and the reference's
  weights go on, as the GPTQ pipeline test holds it -- but for layer 0's
  q, k and v, whose Hessian has a near-dead column (chip_smoke.CHAOTIC_REL):
  there the first pass is bit-equal and the refined result within the
  reference's own spread;
- the port's checkpoint with codes loads in rsq_tpu's load_quantized
  (which ignores the codes) with the same scales and zeros, the reverse
  loads without codes, and the port reads its own codes back;
- to_serving_params' affine-int4 weight, dequantized, equals the
  pipeline's Q bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.core.quant import WeightQuantConfig as JWQ
from rsq_tpu.models.config import ModelConfig as JConfig
from rsq_tpu.quantize import checkpoint as JCK
from rsq_tpu.quantize import data as JD
from rsq_tpu.quantize import ldlq as JL
from rsq_tpu.quantize import pipeline as JP
from rsq_tpu.quantize.weighting import WeightingConfig as JWC
from rsq_tpu_torch.core.quant import WeightQuantConfig as TWQ
from rsq_tpu_torch.kernels.matmul_w4 import unpack_w4_planar
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.quantize import checkpoint as TCK
from rsq_tpu_torch.quantize import ldlq as TL
from rsq_tpu_torch.quantize import pipeline as TP
from rsq_tpu_torch.quantize.weighting import WeightingConfig as TWC
from rsq_tpu_torch.serving import params as TSP
from chip_smoke import CHAOTIC_REL, near_dead
from test_torch_rotation import jtree, leaves, np_params, ttree

CFG, JCFG = ModelConfig.tiny(num_layers=2), JConfig.tiny(num_layers=2)


def problem(rows, cols, seed):
    """W (rows, cols) at 0.05 and H = (2/256) A^T A of a correlated A, f32."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((rows, cols)) * 0.05).astype(np.float32)
    A = (rng.standard_normal((256, cols))
         @ (np.eye(cols) + 0.3 * rng.standard_normal((cols, cols)))
         ).astype(np.float32)
    return W, ((2.0 / 256) * A.T @ A).astype(np.float32)


def test_search_grids_equal():
    want, got = JL.search_grids(), TL.search_grids()
    assert got[0].shape == (1366, 8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_e8p_bit_equal(seed):
    X = (np.random.default_rng(seed).standard_normal((256, 8)) * (1 + seed)
         ).astype(np.float32)
    jv, jc = JL.quantize_e8p(jnp.asarray(X))
    tv, tc = TL.quantize_e8p(torch.from_numpy(X))
    assert tv.dtype == torch.float32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # the code decodes to the value, as serving reads it
    np.testing.assert_array_equal(TL.e8p_grid()[tc.numpy()], tv.numpy())


@pytest.mark.parametrize("percdamp,aof", [(0.0, False), (0.01, True)])
def test_block_ldl_close(percdamp, aof):
    _, H = problem(8, 64, 5)
    jLm, jD = JL.block_ldl(jnp.asarray(H), 8, percdamp, aof)
    tLm, tD = TL.block_ldl(torch.from_numpy(H), 8, percdamp, aof)
    for t, j in ((tLm, jLm), (tD, jD)):
        j = np.asarray(j)
        assert t.shape == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max())
    # unit block diagonal, H + damping = L D L^T
    for i in range(8):
        np.testing.assert_allclose(tLm[8 * i:8 * i + 8, 8 * i:8 * i + 8],
                                   np.eye(8), atol=1e-5)


def test_block_ldl_add_until_fail_retries():
    """An indefinite H: one try fails, repeated damping makes it factor."""
    H = np.eye(16, dtype=np.float32)
    H[0, 0] = -0.5
    with pytest.raises(FloatingPointError):
        TL.block_ldl(torch.from_numpy(H), 8, 0.5, add_until_fail=False)
    Lm, _ = TL.block_ldl(torch.from_numpy(H), 8, 0.5, add_until_fail=True)
    assert torch.isfinite(Lm).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_e8p_scale_close(seed):
    W, _ = problem(32, 128, seed)
    for override in (0.9, 0.0):
        want = float(JL.e8p_scale(jnp.asarray(W), override))
        got = TL.e8p_scale(torch.from_numpy(W), override)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(want, rel=1e-6)


def hessian_error(Q, W, H):
    E = np.asarray(Q, np.float64) - W
    return float(np.einsum("rc,cd,rd->", E, H.astype(np.float64), E))


@pytest.mark.parametrize("iters", [0, 2, 10])
@pytest.mark.parametrize("rows,cols,seed", [(16, 64, 0), (16, 64, 1),
                                            (32, 128, 2)])
def test_ldlq_quantize_matches_reference(rows, cols, seed, iters):
    W, H = problem(rows, cols, seed)
    H[3, :] = H[:, 3] = 0.0                    # a dead input column
    jQ, ji = JL.ldlq_quantize(jnp.asarray(W), jnp.asarray(H),
                              quip_tune_iters=iters)
    tQ, ti = TL.ldlq_quantize(torch.from_numpy(W), torch.from_numpy(H),
                              quip_tune_iters=iters, device="cpu")
    jQ = np.asarray(jQ)
    assert ti["codes"].dtype == torch.int32
    np.testing.assert_array_equal(ti["codes"].numpy(), np.asarray(ji["codes"]))
    np.testing.assert_allclose(tQ.numpy(), jQ, rtol=1e-6, atol=0)
    assert float(ti["scale"]) == pytest.approx(float(ji["scale"]), rel=1e-6)
    assert float(ti["zero"]) == 0.0
    assert hessian_error(tQ.numpy(), W, H) == pytest.approx(
        hessian_error(jQ, W, H), rel=1e-4)
    # Q is the codes' grid values times the scale, bit for bit
    np.testing.assert_array_equal(
        TL.e8p_dequantize(ti["codes"], ti["scale"]).numpy(), tQ.numpy())


def test_ldlq_beats_blockwise_rounding():
    """Hessian-weighted error at most that of rounding each block alone
    at the same scale (tests/test_ldlq.py's property, on the port)."""
    W, H = problem(16, 64, 4)
    Q, info = TL.ldlq_quantize(torch.from_numpy(W), torch.from_numpy(H),
                               quip_tune_iters=4, device="cpu")
    s = info["scale"]
    naive = torch.cat([TL.quantize_e8p(torch.from_numpy(W[:, c:c + 8]) / s)[0]
                       for c in range(0, 64, 8)], dim=1) * s
    assert hessian_error(Q, W, H) <= hessian_error(naive, W, H) * 1.001


# ---------------------------------------------------------------------------
# The pipeline, the checkpoint and the served weights
# ---------------------------------------------------------------------------

def rsq_configs():
    """rsq_e8p of the reference's sweep (run_rsq_e8p.sh): 2 bits recorded,
    rotate, add_until_fail, E8P, attncon 0.005-1."""
    kw = dict(rotate=True, e8p=True, nsamples=8)
    w = dict(bits=2, sym=True)
    wt = dict(method="attncon", min_value=0.005, max_value=1.0)
    t = TP.RSQConfig(w=TWQ(**w), weighting=TWC(**wt), **kw,
                     gptq=dataclasses.replace(TP.RSQConfig().gptq,
                                              add_until_fail=True))
    j = JP.RSQConfig(w=JWQ(**w), weighting=JWC(**wt), **kw,
                     gptq=dataclasses.replace(JP.RSQConfig().gptq,
                                              add_until_fail=True))
    return t, j


# Layer 0's q/k/v Hessian has a near-dead column (chip_smoke.near_dead:
# the embedding is mean-centred before the rotation, so the rotated input
# has, up to rounding, no component along the Hadamard's first column;
# H[0, 0] is 3e-13 against a mean diagonal of 45, not 0, so not caught as
# dead).  The damped LDL is sound, but the refinement multiplies by the
# inverse of the undamped 8x8 block H[0:8, 0:8] (entries ~1e12) and turns
# f32 rounding into different codes: the reference itself moves 6-21
# codes of these calls and its Hessian-weighted error by up to 1.4e-2
# under a 1e-7 relative change of H.  The port differs from it there by up
# to 3.5e-2, within chip_smoke.CHAOTIC_REL (5e-2).


@pytest.fixture(scope="module")
def pipeline_run():
    """Both pipelines on the tiny model, the port's held call by call
    (module doc).  Returns (the port's result, the reference's, the
    reference's recorded calls)."""
    params = np_params(CFG, seed=21)
    calib = JD.get_loaders("synthetic", nsamples=8, seqlen=32,
                           vocab_size=CFG.vocab_size)
    trsq, jrsq = rsq_configs()
    ref = []
    fn = JL.ldlq_quantize

    def recorder(W, H, **kw):
        Q, info = fn(W, H, **kw)
        ref.append((np.array(W), np.array(H), np.array(Q), info))
        return Q, info

    mp = pytest.MonkeyPatch()
    mp.setattr(JL, "ldlq_quantize", recorder)
    try:
        want = JP.quantize_model(jtree(params), JCFG, jrsq, calib)
    finally:
        mp.undo()
    calls = iter(ref)
    port_fn = TP.ldlq_quantize
    chaotic, chaotic_seen = [], []

    def hold_chaotic(W, H, Q, rQ, add_until_fail):
        """First pass bit-equal; after the ten refinement passes the
        Hessian-weighted error within CHAOTIC_REL of the reference's."""
        _, j0 = fn(jnp.asarray(W), jnp.asarray(H), quip_tune_iters=0,
                   add_until_fail=add_until_fail)
        _, t0 = port_fn(torch.from_numpy(W), torch.from_numpy(H),
                        quip_tune_iters=0, add_until_fail=add_until_fail,
                        device="cpu")
        np.testing.assert_array_equal(t0["codes"].numpy(),
                                      np.asarray(j0["codes"]))
        assert hessian_error(Q, W, H) == pytest.approx(
            hessian_error(rQ, W, H), rel=CHAOTIC_REL)

    def forced(W, H, *, add_until_fail, device):
        rW, rH, rQ, rinfo = next(calls)
        np.testing.assert_allclose(W.numpy(), rW, rtol=0,
                                   atol=1e-6 * np.abs(rW).max())
        np.testing.assert_allclose(H.numpy(), rH, rtol=0,
                                   atol=1e-5 * np.abs(rH).max())
        Q, info = port_fn(torch.from_numpy(rW), torch.from_numpy(rH),
                          add_until_fail=add_until_fail, device=device)
        assert float(info["scale"]) == pytest.approx(
            float(rinfo["scale"]), rel=1e-6)
        if near_dead(torch.from_numpy(rH)):
            chaotic.append(len(chaotic_seen))
            hold_chaotic(rW, rH, Q.numpy(), rQ, add_until_fail)
        else:
            np.testing.assert_array_equal(info["codes"].numpy(),
                                          np.asarray(rinfo["codes"]))
            np.testing.assert_allclose(Q.numpy(), rQ, rtol=1e-6, atol=0)
        chaotic_seen.append(None)
        return torch.from_numpy(rQ), dict(
            info, scale=torch.as_tensor(np.asarray(rinfo["scale"])),
            codes=torch.from_numpy(np.asarray(rinfo["codes"])))

    mp = pytest.MonkeyPatch()
    mp.setattr(TP, "ldlq_quantize", forced)
    try:
        got = TP.quantize_model(ttree(params), CFG, trsq, calib,
                                device="cpu")
    finally:
        mp.undo()
    assert next(calls, None) is None and len(ref) == 14
    assert chaotic == [0, 1, 2]                 # layer 0's q, k and v
    return got, want, ref


def test_e8p_pipeline_matches_reference(pipeline_run):
    (gp, gq), (wp, wq), ref = pipeline_run
    assert gq.keys() == wq.keys()
    for (k, w), (_, _, _, rinfo) in zip(wq.items(), ref):
        assert gq[k]["bits"] == w["bits"] == 2
        np.testing.assert_array_equal(gq[k]["scale"].numpy(),
                                      np.asarray(w["scale"]))
        assert float(gq[k]["zero"]) == float(w["zero"]) == 0.0
        assert "codes" not in w                    # the reference drops them
        np.testing.assert_array_equal(gq[k]["codes"].numpy(),
                                      np.asarray(rinfo["codes"]))
    g, w = leaves(gp), leaves(wp)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_e8p_checkpoint_interchange(pipeline_run, tmp_path):
    (gp, gq), (wp, wq), _ = pipeline_run
    meta = {"rotate": True, "w_bits": 2}
    TCK.save_quantized(str(tmp_path / "t"), gp, gq, CFG, meta=meta)
    with np.load(tmp_path / "t" / "arrays.npz") as z:
        assert z["quant.layers.1.down.codes"].shape == (CFG.hidden_size,
                                                       CFG.intermediate_size
                                                       // 8)
    jp_, jq, _, jm = JCK.load_quantized(str(tmp_path / "t"))
    tp_, tq, _, tm = TCK.load_quantized(str(tmp_path / "t"))
    assert jm == tm
    assert jq.keys() == tq.keys() == gq.keys()
    for k in gq:
        for f in ("scale", "zero"):
            np.testing.assert_array_equal(np.asarray(jq[k][f]),
                                          tq[k][f].numpy())
            np.testing.assert_array_equal(tq[k][f].numpy(),
                                          gq[k][f].numpy())
        assert "codes" not in jq[k]
        assert torch.equal(tq[k]["codes"], gq[k]["codes"])
    jl, tl = leaves(jp_), leaves(tp_)
    for k in tl:
        assert np.asarray(jl[k]).tobytes() == tl[k].tobytes(), k
    # the reference's save of its own result: no codes for the port to read
    JCK.save_quantized(str(tmp_path / "j"), wp, wq, JCFG, meta=meta)
    _, jq2, _, _ = TCK.load_quantized(str(tmp_path / "j"))
    assert jq2.keys() == gq.keys()
    assert not any("codes" in q for q in jq2.values())


def test_served_e8p_weight_equals_q(pipeline_run, tmp_path):
    """Through a checkpoint, to_serving_params re-encodes each projection
    to affine int4: (q + 0.5) * sh equals the pipeline's Q bit for bit."""
    (gp, gq), _, _ = pipeline_run
    TCK.save_quantized(str(tmp_path), gp, gq, CFG)
    params, quants, cfg, _ = TCK.load_quantized(str(tmp_path))
    sp = TSP.to_serving_params(params, quants, cfg, device="cpu")
    for i, lp in enumerate(sp["layers"]):
        for name in TSP.QUANT_NAMES:
            e = lp[name]
            assert set(e) == {"wp", "sh", "b"}, (i, name)
            deq = (unpack_w4_planar(e["wp"]).float() + 0.5) * e["sh"]
            assert torch.equal(deq, gp["layers"][i][name]["w"]), (i, name)
