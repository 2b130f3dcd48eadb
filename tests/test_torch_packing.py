"""rsq_tpu_torch packing and parameter conversion against rsq_tpu: the same
numpy inputs through both packages; every packed byte and scale must be
bit-equal (integer-exact stages)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.kernels import kv_cache as JKV
from rsq_tpu.kernels import matmul_w4 as JMW
from rsq_tpu.models.config import ModelConfig as JConfig
from rsq_tpu.serving import model as JS
from rsq_tpu.serving import params as JP
from rsq_tpu_torch.kernels import kv_cache as TKV
from rsq_tpu_torch.kernels import matmul_w4 as TMW
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.serving import model as TS
from rsq_tpu_torch.serving import params as TP

LINEARS = ("q", "k", "v", "o", "up", "gate", "down")


def np_of(x):
    """torch or jax array -> numpy with the same bits (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_trees_equal(j, t, path="params"):
    """Every leaf of the JAX tree equals the torch tree's, bit for bit."""
    if j is None or t is None:
        assert j is None and t is None, path
    elif isinstance(j, dict):
        assert set(j) == set(t), (path, set(j) ^ set(t))
        for k in j:
            assert_trees_equal(j[k], t[k], f"{path}.{k}")
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            assert_trees_equal(a, b, f"{path}[{i}]")
    else:
        a, b = np_of(j), np_of(t)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def dense_model(cfg, seed=0):
    """A fake-quant dense tiny model in numpy (weights = codes * scale, so
    packing is exact) plus its 4-bit quantizer table."""
    rng = np.random.default_rng(seed)
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {"q": (d, cfg.q_dim), "k": (d, cfg.kv_dim), "v": (d, cfg.kv_dim),
              "o": (cfg.q_dim, d), "up": (d, f), "gate": (d, f),
              "down": (f, d)}
    layers, quant = [], {}
    for i in range(cfg.num_layers):
        lp = {"input_norm": rng.uniform(0.8, 1.2, d).astype(np.float32),
              "post_norm": rng.uniform(0.8, 1.2, d).astype(np.float32)}
        for name, (k, n) in shapes.items():
            codes = rng.integers(-8, 8, size=(k, n)).astype(np.float32)
            scale = (rng.uniform(0.5, 1.5, n) / (7 * np.sqrt(k))
                     ).astype(np.float32)
            lp[name] = {"w": codes * scale[None, :], "b": None}
            quant[f"layers.{i}.{name}"] = {"bits": 4, "scale": scale}
        layers.append(lp)
    params = {"embed": rng.standard_normal((v, d)).astype(np.float32),
              "final_norm": rng.uniform(0.8, 1.2, d).astype(np.float32),
              "lm_head": (rng.standard_normal((d, v)) / np.sqrt(d)
                          ).astype(np.float32),
              "layers": layers}
    return params, quant


def jax_config(cfg):
    """The reference's ModelConfig with the port config's field values."""
    return JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


def jax_serving_params(cfg, params, quant):
    jcfg = jax_config(cfg)
    sp = JP.to_serving_params(params, quant, jcfg)
    return jcfg, JS.quantize_lm_head(JS.stack_layer_params(
        JP.fuse_for_decode(sp)))


def torch_serving_params(cfg, params, quant):
    sp = TP.to_serving_params(params, quant, cfg, device="cpu")
    return TS.quantize_lm_head(TS.stack_layer_params(TP.fuse_for_decode(sp)))


@pytest.mark.parametrize("K,N", [(16, 32), (8, 6), (3, 224)])
def test_planar_pack_unpack_pair_bit_equal(K, N):
    rng = np.random.default_rng(K * N)
    wq = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    jp, tp = JMW.pack_w4_planar(jnp.asarray(wq)), TMW.pack_w4_planar(
        torch.from_numpy(wq))
    np.testing.assert_array_equal(np_of(jp), np_of(tp))
    np.testing.assert_array_equal(np_of(TMW.unpack_w4_planar(tp)), wq)
    np.testing.assert_array_equal(np_of(JP.repack_plane_major(jp)),
                                  np_of(TP.repack_plane_major(tp)))
    s = rng.uniform(0.1, 1.0, N).astype(np.float32)
    np.testing.assert_array_equal(np_of(JMW.pair_scales(jnp.asarray(s))),
                                  np_of(TMW.pair_scales(torch.from_numpy(s))))
    y3 = rng.standard_normal((5, 2, N // 2)).astype(np.float32)
    np.testing.assert_array_equal(
        np_of(JMW.unpair_outputs(jnp.asarray(y3))),
        np_of(TMW.unpair_outputs(torch.from_numpy(y3))))


def test_w8_quantize_bit_equal():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    w[:, 5] = 0.0                                   # the absmax == 0 branch
    wb = torch.from_numpy(w).to(torch.bfloat16)
    jw8, js = JMW.w8_quantize(jnp.asarray(w, jnp.bfloat16))
    tw8, ts = TMW.w8_quantize(wb)
    np.testing.assert_array_equal(np_of(jw8), np_of(tw8))
    np.testing.assert_array_equal(np_of(js), np_of(ts))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_asym_quant_pack_head_bit_equal(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 7, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.25                               # constant row: 1e-5 floor
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x, getattr(jnp, dtype))
    # jitted, as on the serving path (XLA folds `/ 15.0` into a multiply)
    jq, jpar = jax.jit(JKV.asym_quant_pack_head)(xj)
    tq, tpar = TKV.asym_quant_pack_head(xt)
    np.testing.assert_array_equal(np_of(jq), np_of(tq))
    np.testing.assert_array_equal(np_of(jpar), np_of(tpar))
    np.testing.assert_array_equal(
        np_of(JKV.unpack_dequant_head(jq, jpar)),
        np_of(TKV.unpack_dequant_head(tq, tpar)))


def test_serving_param_chain_bit_equal():
    """to_serving_params -> fuse_for_decode -> stack_layer_params ->
    quantize_lm_head produces the same bytes in both packages, and the JAX
    result carries across with from_numpy_params unchanged."""
    cfg = ModelConfig.tiny()
    params, quant = dense_model(cfg)
    _, jsp = jax_serving_params(cfg, params, quant)
    tsp = torch_serving_params(cfg, params, quant)
    assert_trees_equal(jsp, tsp)
    carried = TP.from_numpy_params(jsp, device="cpu")
    assert_trees_equal(jsp, carried)
