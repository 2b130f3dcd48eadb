"""Hugging Face ingest of rsq_tpu_torch.models.hf against rsq_tpu.models.hf
and against transformers itself, on tiny LlamaForCausalLM,
Qwen2ForCausalLM, MistralForCausalLM, OPTForCausalLM, Gemma2ForCausalLM
and FalconForCausalLM models built in this process from config objects
(seeded torch init; nothing is downloaded):

- config_from_hf field-equal to the reference's (Llama with and without
  tied embeddings and llama3 rope scaling, Qwen2 with its q/k/v biases,
  Mistral with an explicit head_dim, OPT, Gemma-2, and Falcon in its three
  query_key_value layouts: falcon-7b's multi-query, MHA interleaved per
  head, and the new decoder architecture's grouped one with two norms);
- params_from_state_dict bit-equal to the reference's, from torch tensors
  and from numpy arrays;
- the port's f32 forward logits within 1e-4 of the HF model's (eager
  attention);
- load_hf of a checkpoint saved to a local directory equals from_hf_model,
  and `cli quantize --model <dir>` quantizes it;
- an unknown model name that is no directory raises."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import transformers

from rsq_tpu.models import hf as JHF
from rsq_tpu_torch import cli
from rsq_tpu_torch.models import family
from rsq_tpu_torch.models import hf as THF
from rsq_tpu_torch.models.policy import FP16
from test_torch_rotation import leaves

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=112,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, rms_norm_eps=1e-5)
LOGIT_ATOL = 1e-4
FALCON = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, parallel_attn=True, bias=False,
              alibi=False)

MODELS = {
    "llama": lambda: transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **TINY, rope_theta=500000.0)),
    "llama_tied_rope_scaled": lambda: transformers.LlamaForCausalLM(
        transformers.LlamaConfig(
            **TINY, tie_word_embeddings=True,
            rope_scaling={"rope_type": "llama3", "factor": 8.0,
                          "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                          "original_max_position_embeddings": 32})),
    "qwen2": lambda: transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        **TINY, rope_theta=1000000.0)),
    "mistral": lambda: transformers.MistralForCausalLM(
        transformers.MistralConfig(**TINY, head_dim=32)),
    "opt": lambda: transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=256, hidden_size=64, ffn_dim=112, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128,
        do_layer_norm_before=True, word_embed_proj_dim=64)),
    "gemma2": lambda: transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        **TINY, head_dim=16, query_pre_attn_scalar=24,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        sliding_window=8, attn_implementation="eager")),
    "falcon": lambda: transformers.FalconForCausalLM(transformers.FalconConfig(
        **FALCON, multi_query=True, new_decoder_architecture=False)),
    "falcon_mha": lambda: transformers.FalconForCausalLM(
        transformers.FalconConfig(**FALCON, multi_query=False,
                                  new_decoder_architecture=False)),
    "falcon_new_arch": lambda: transformers.FalconForCausalLM(
        transformers.FalconConfig(**FALCON, num_kv_heads=2, multi_query=False,
                                  new_decoder_architecture=True)),
}
FAMILY = {"llama_tied_rope_scaled": "llama", "falcon_mha": "falcon",
          "falcon_new_arch": "falcon"}


def build(name):
    """A tiny HF model with seeded weights, norms and biases perturbed off
    their constant init, eager attention, f32."""
    torch.manual_seed(0)
    model = MODELS[name]()
    model.config._attn_implementation = "eager"
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if "norm" in pname:
                p.copy_(0.8 + 0.4 * torch.rand(p.shape, generator=g))
            elif pname.endswith(".bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model.eval()


@pytest.fixture(scope="module", params=list(MODELS))
def hf_model(request):
    return request.param, build(request.param)


def test_config_from_hf_field_equal(hf_model):
    name, model = hf_model
    got = THF.config_from_hf(model.config)
    want = JHF.config_from_hf(model.config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.family == FAMILY.get(name, name)
    if name == "qwen2":
        assert got.attention_bias
    if name == "mistral":
        assert got.head_dim_ == 32 and got.q_dim == 128
    if name == "llama_tied_rope_scaled":
        assert got.rope_scaling is not None and got.tie_word_embeddings
    if name.startswith("falcon"):
        assert (got.num_key_value_heads, got.falcon_two_norms) == {
            "falcon": (1, False), "falcon_mha": (4, False),
            "falcon_new_arch": (2, True)}[name]
    if name == "gemma2":
        assert (got.query_pre_attn_scalar, got.sliding_window) == (24.0, 8)


@pytest.mark.parametrize("source", ["torch", "numpy"])
def test_params_from_state_dict_bit_equal(hf_model, source):
    _, model = hf_model
    sd = model.state_dict()
    if source == "numpy":
        sd = {k: v.numpy() for k, v in sd.items()}
    cfg = THF.config_from_hf(model.config)
    got = leaves(THF.params_from_state_dict(sd, cfg))
    want = leaves(JHF.params_from_state_dict(sd, JHF.config_from_hf(
        model.config)))
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype == np.float32, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    if cfg.family == "qwen2":
        assert "layers.0.q.b" in got and "layers.0.o.b" not in got
    if cfg.family == "opt":
        assert "embed_pos" in got and "layers.0.o.b" in got


def test_forward_logits_match_transformers(hf_model):
    _, model = hf_model
    cfg, params = THF.from_hf_model(model)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    with torch.no_grad():
        want = model(ids).logits
        got = family.forward(params, ids, cfg, FP16)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_ATOL)


def test_load_hf_and_cli_from_a_local_directory(tmp_path):
    model = build("qwen2")
    path = tmp_path / "qwen2"
    model.save_pretrained(path)
    cfg, params = THF.load_hf(str(path))
    rcfg, rparams = THF.from_hf_model(model)
    assert cfg == rcfg
    got, want = leaves(params), leaves(rparams)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    res = cli.main(["quantize", "--model", str(path), "--device", "cpu",
                    "--cal-dataset", "synthetic", "--nsamples", "2",
                    "--train-seqlen", "16", "--w-bits", "4", "--save",
                    str(tmp_path / "ck")])
    assert res["device"] == "cpu"
    assert (tmp_path / "ck" / "arrays.npz").exists()


def test_config_object_without_transformers():
    """A plain object with a config's attributes will do (an environment
    without transformers); an unknown model_type reads as llama."""
    conf = SimpleNamespace(model_type="custom", rope_scaling=None, **TINY)
    cfg = THF.config_from_hf(conf)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JHF.config_from_hf(conf))
    assert cfg.family == "llama"


def test_cli_unknown_name_raises():
    with pytest.raises(NotImplementedError, match="not a named model"):
        cli.main(["quantize", "--model", "no-such-model", "--device", "cpu"])
