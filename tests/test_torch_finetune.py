"""rsq_tpu_torch.quantize.finetune and .schedulers against rsq_tpu on the
CPU, on the same seeded numpy inputs (float32 given explicitly):

- round_ste, clamp_ste and qat_fake_quant: forward bit-equal, gradients
  equal (the STEs' identity gradients exactly; the scale's gradient through
  the dequantizing product within 1e-6 relative);
- finetune_layer on a tiny 1-layer model (hidden 64) for 2 epochs of 6
  training and 2 validation samples, from GPTQ W3 weights whose quantizer
  scales are perturbed by 1.4x (after tests/test_finetune.py), under the
  plain MSE, the attention KL and logit losses and the self-similarity
  loss, weights trained or frozen: the best validation loss within 1e-4
  relative of the reference's, every quantized weight and every bias and
  norm within 1e-4 of the largest entry of its tensor.  Adam's first
  steps move a parameter by about the learning rate whatever the size of
  its gradient, so where a gradient is near 0 the two packages' f32
  gradients can point apart: parameters are held to the tensor's scale;
- the three schedulers and make_scheduler equal to the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.core.quant import WeightQuantConfig as JWQ
from rsq_tpu.models import llama as JM
from rsq_tpu.models.config import ModelConfig as JConfig
from rsq_tpu.models.policy import FP16 as JFP16
from rsq_tpu.quantize import data as JD
from rsq_tpu.quantize import finetune as JF
from rsq_tpu.quantize import pipeline as JP
from rsq_tpu.quantize import schedulers as JS
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.models.policy import FP16
from rsq_tpu_torch.quantize import finetune as TF
from rsq_tpu_torch.quantize import schedulers as TS
from test_torch_rotation import jtree, leaves, np_params

REL = 1e-4


@pytest.mark.parametrize("sym", [True, False])
def test_qat_fake_quant_forward_and_gradients(sym):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((16, 32)) * 0.1).astype(np.float32)
    # half-integer ratios land on rounding ties in both packages
    w[0, :8] = np.arange(8, dtype=np.float32) * 0.05 + 0.025
    scale = rng.uniform(0.02, 0.05, (16, 1)).astype(np.float32)
    scale[0] = 0.05
    zero = (np.full((16, 1), 4.0, np.float32) if not sym
            else np.zeros((16, 1), np.float32))
    up = rng.standard_normal((16, 32)).astype(np.float32)

    def jloss(w_, s_, z_):
        return jnp.sum(JF.qat_fake_quant(w_, s_, z_, 3, sym) * up)

    jf = JF.qat_fake_quant(jnp.asarray(w), jnp.asarray(scale),
                           jnp.asarray(zero), 3, sym)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(w), jnp.asarray(scale),
                                            jnp.asarray(zero))
    tw, ts, tz = (torch.tensor(a, requires_grad=True) for a in (w, scale,
                                                                 zero))
    tf = TF.qat_fake_quant(tw, ts, tz, 3, sym)
    np.testing.assert_array_equal(tf.detach().numpy(), np.asarray(jf))
    (tf * torch.from_numpy(up)).sum().backward()
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(jg[0]))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg[1]), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(jg[1])).max())
    if not sym:
        np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg[2]),
                                   rtol=1e-6)


def test_ste_forward_bit_equal_and_identity_gradient():
    x = np.array([-3.5, -2.5, -0.5, 0.5, 1.5, 2.49, 7.0], np.float32)
    t = torch.tensor(x, requires_grad=True)
    np.testing.assert_array_equal(TF.round_ste(t).detach().numpy(),
                                  np.asarray(JF.round_ste(jnp.asarray(x))))
    np.testing.assert_array_equal(
        TF.clamp_ste(t, -2.0, 2.0).detach().numpy(),
        np.asarray(JF.clamp_ste(jnp.asarray(x), -2.0, 2.0)))
    (TF.round_ste(t) * 2.0 + TF.clamp_ste(t, -1.0, 1.0)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(JF.round_ste(v) * 2.0
                                    + JF.clamp_ste(v, -1.0, 1.0)))(
        jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    assert (t.grad == 3.0).all()


@pytest.fixture(scope="module")
def layer():
    """A GPTQ W3 tiny layer whose quantizer scales are perturbed 1.4x (its
    weights stay on the GPTQ grid, so w / scale sits between integers and
    the scales' gradients are well defined); 8 calibration inputs
    (embeddings) and the original layer's outputs as targets (numpy)."""
    cfg = ModelConfig.tiny(num_layers=1)
    jcfg = JConfig.tiny(num_layers=1)
    params = jtree(np_params(cfg, seed=7))
    calib = JD.get_loaders("synthetic", nsamples=8, seqlen=16,
                           vocab_size=cfg.vocab_size)
    inps = np.asarray(JM.embed(params, jnp.asarray(calib)), np.float32)
    cos, sin = JM.rope_tables(jcfg, jnp.arange(16))
    mask = JM.causal_mask(16)
    targets = np.asarray(JM.layer_forward(params["layers"][0],
                                          jnp.asarray(inps), cos, sin, jcfg,
                                          JFP16, mask), np.float32)
    rsq = JP.RSQConfig(w=JWQ(bits=3, sym=True), nsamples=8)
    qparams, quantizers = JP.quantize_model(params, jcfg, rsq, calib)
    bad = {k: dict(v, scale=(np.asarray(v["scale"]) * 1.4).astype(
        np.float32), zero=np.asarray(v["zero"], np.float32))
        for k, v in quantizers.items()}
    lp = {k: ({kk: None if vv is None else np.asarray(vv, np.float32)
               for kk, vv in v.items()} if isinstance(v, dict)
              else np.asarray(v, np.float32))
          for k, v in qparams["layers"][0].items()}
    return cfg, jcfg, lp, bad, inps, targets


FT = {"mse": dict(),
      "frozen_weights": dict(train_weights=False),
      "attn_kl": dict(attn_loss=True, attn_loss_on_prob=True,
                      attn_loss_weight=0.5),
      "attn_logits": dict(attn_loss=True, attn_loss_on_prob=False),
      "self_similarity": dict(self_similarity_loss=True)}


@pytest.mark.parametrize("name", list(FT))
def test_finetune_layer_matches_reference(layer, name):
    cfg, jcfg, lp, quant, inps, targets = layer
    kw = dict(max_epochs=2, early_stop=3, quant_lr=1e-3, weight_lr=1e-4,
              **FT[name])
    jlp, jinfo = JF.finetune_layer(jtree(lp), quant, 0, inps, targets, jcfg,
                                   JFP16, JF.FinetuneConfig(**kw))
    tlp, tinfo = TF.finetune_layer(
        {k: (None if v is None else
             {kk: None if vv is None else torch.tensor(vv)
              for kk, vv in v.items()} if isinstance(v, dict)
             else torch.tensor(v)) for k, v in lp.items()},
        quant, 0, inps, targets, cfg, FP16, TF.FinetuneConfig(**kw),
        device="cpu")
    assert tinfo["val_loss"] == pytest.approx(jinfo["val_loss"], rel=REL)
    g, w = leaves(tlp), leaves(jlp)
    assert g.keys() == w.keys()
    for k in w:
        want = np.asarray(w[k])
        assert g[k].dtype == want.dtype, k
        np.testing.assert_allclose(g[k], want, rtol=0,
                                   atol=REL * np.abs(want).max(), err_msg=k)
    # the finetune moved the weights
    assert not np.array_equal(g["down.w"], lp["down"]["w"])


def test_finetune_skips_a_layer_without_quantizers(layer):
    cfg, _, lp, _, inps, targets = layer
    tlp = {k: {kk: None if vv is None else torch.from_numpy(vv)
               for kk, vv in v.items()} if isinstance(v, dict)
           else torch.from_numpy(v) for k, v in lp.items()}
    _, info = TF.finetune_layer(tlp, {}, 0, inps, targets, cfg, FP16,
                                device="cpu")
    assert info == {"skipped": True}


@pytest.mark.parametrize("name,kw,n", [
    ("linear", dict(start_value=1.0, end_value=3.0), 64),
    ("linear", dict(start_value=3.0, end_value=0.5), 10),
    ("endpoints_peak", dict(min_value=0.5, max_value=2.0), 64),
    ("endpoints_peak", dict(min_value=0.0, max_value=1.0, factor=2), 11),
    ("start_peak", dict(min_value=0.5, max_value=2.0), 64),
    ("start_peak", dict(min_value=0.0, max_value=1.0, factor=3), 10)])
def test_schedulers_equal(name, kw, n):
    got = TS.make_scheduler(name, **kw)
    want = JS.make_scheduler(name, **kw)
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(got.get_ratio(n), want.get_ratio(n))


def test_normalize_with_quantile_equal():
    w = np.random.default_rng(0).standard_normal(100)
    np.testing.assert_array_equal(TS._normalize(w, 0.2, 3.0, 0.9),
                                  JS._normalize(w, 0.2, 3.0, 0.9))
