"""Typed model configuration (the port's copy of rsq_tpu.models.config):
the reference's fields in its order with its defaults, so a checkpoint
manifest written by either package loads in the other, and its
constructors: the Llama family (Qwen2.5 is attention_bias=True,
Mistral-Nemo has an explicit head_dim), OPT, Falcon and Gemma-2, each of
the last three with a tiny_* config for tests."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1-style rope frequency scaling."""
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int | None = None
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling | None = None
    rms_norm_eps: float = 1e-5
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 8192
    family: str = "llama"         # llama | qwen2 | mistral | opt | gemma2 | falcon
    # Falcon's "new decoder architecture" (40B): separate parallel ln_attn
    # and ln_mlp; False is falcon-7b's one shared LayerNorm
    falcon_two_norms: bool = False
    # Gemma-2 only, None elsewhere
    query_pre_attn_scalar: float | None = None   # attention scale = this**-0.5
    attn_logit_softcap: float | None = None      # tanh(x/c)*c on attention logits
    final_logit_softcap: float | None = None     # tanh(x/c)*c on the lm logits
    sliding_window: int | None = None            # on even layers (HF layout)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim_

    @staticmethod
    def tiny(vocab_size=256, hidden_size=64, intermediate_size=112,
             num_layers=2, num_attention_heads=4, num_key_value_heads=2,
             **kw) -> "ModelConfig":
        """A small config for tests; intermediate 112 = 7 * 16 exercises the
        non-pow2 Hadamard path (K=28 base)."""
        return ModelConfig(
            vocab_size=vocab_size, hidden_size=hidden_size,
            intermediate_size=intermediate_size, num_layers=num_layers,
            num_attention_heads=num_attention_heads,
            num_key_value_heads=num_key_value_heads, **kw)

    @staticmethod
    def llama3_8b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_attention_heads=32, num_key_value_heads=8,
            rope_theta=500000.0, rms_norm_eps=1e-5,
            max_position_embeddings=8192, family="llama")

    @staticmethod
    def llama2_7b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=32000, hidden_size=4096, intermediate_size=11008,
            num_layers=32, num_attention_heads=32, num_key_value_heads=32,
            rope_theta=10000.0, rms_norm_eps=1e-5,
            max_position_embeddings=4096, family="llama")

    @staticmethod
    def qwen25_7b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_attention_heads=28, num_key_value_heads=4,
            rope_theta=1000000.0, rms_norm_eps=1e-6, attention_bias=True,
            max_position_embeddings=32768, family="qwen2")

    @staticmethod
    def llama3_70b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=128256, hidden_size=8192, intermediate_size=28672,
            num_layers=80, num_attention_heads=64, num_key_value_heads=8,
            rope_theta=500000.0, rms_norm_eps=1e-5,
            max_position_embeddings=8192, family="llama")

    @staticmethod
    def llama2_13b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=32000, hidden_size=5120, intermediate_size=13824,
            num_layers=40, num_attention_heads=40, num_key_value_heads=40,
            rope_theta=10000.0, rms_norm_eps=1e-5,
            max_position_embeddings=4096, family="llama")

    @staticmethod
    def llama2_70b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=32000, hidden_size=8192, intermediate_size=28672,
            num_layers=80, num_attention_heads=64, num_key_value_heads=8,
            rope_theta=10000.0, rms_norm_eps=1e-5,
            max_position_embeddings=4096, family="llama")

    @staticmethod
    def qwen25_14b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=152064, hidden_size=5120, intermediate_size=13824,
            num_layers=48, num_attention_heads=40, num_key_value_heads=8,
            rope_theta=1000000.0, rms_norm_eps=1e-6, attention_bias=True,
            max_position_embeddings=32768, family="qwen2")

    @staticmethod
    def qwen25_32b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=152064, hidden_size=5120, intermediate_size=27648,
            num_layers=64, num_attention_heads=40, num_key_value_heads=8,
            rope_theta=1000000.0, rms_norm_eps=1e-6, attention_bias=True,
            max_position_embeddings=32768, family="qwen2")

    @staticmethod
    def opt_125m() -> "ModelConfig":
        """The reference's debug model (fake_quant/utils.py:279-280). OPT:
        learned positions, LayerNorm with bias, biased q/k/v/o, ReLU
        fc1/fc2 MLP, MHA (no GQA), tied embeddings."""
        return ModelConfig(
            vocab_size=50272, hidden_size=768, intermediate_size=3072,
            num_layers=12, num_attention_heads=12, num_key_value_heads=12,
            rms_norm_eps=1e-5, attention_bias=True, tie_word_embeddings=True,
            max_position_embeddings=2048, family="opt")

    @staticmethod
    def opt_1_3b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=50272, hidden_size=2048, intermediate_size=8192,
            num_layers=24, num_attention_heads=32, num_key_value_heads=32,
            rms_norm_eps=1e-5, attention_bias=True, tie_word_embeddings=True,
            max_position_embeddings=2048, family="opt")

    @staticmethod
    def tiny_opt(vocab_size=256, hidden_size=64, intermediate_size=112,
                 num_layers=2, num_attention_heads=4, **kw) -> "ModelConfig":
        return ModelConfig(
            vocab_size=vocab_size, hidden_size=hidden_size,
            intermediate_size=intermediate_size, num_layers=num_layers,
            num_attention_heads=num_attention_heads,
            num_key_value_heads=num_attention_heads, attention_bias=True,
            max_position_embeddings=512, family="opt", **kw)

    @staticmethod
    def falcon_7b() -> "ModelConfig":
        """tiiuae/falcon-7b: MQA (1 kv head), shared parallel LayerNorm."""
        return ModelConfig(
            vocab_size=65024, hidden_size=4544, intermediate_size=18176,
            num_layers=32, num_attention_heads=71, num_key_value_heads=1,
            head_dim=64, rope_theta=10000.0, rms_norm_eps=1e-5,
            tie_word_embeddings=True, max_position_embeddings=2048,
            family="falcon")

    @staticmethod
    def falcon_40b() -> "ModelConfig":
        """tiiuae/falcon-40b: GQA (8 kv heads), two parallel norms."""
        return ModelConfig(
            vocab_size=65024, hidden_size=8192, intermediate_size=32768,
            num_layers=60, num_attention_heads=128, num_key_value_heads=8,
            head_dim=64, rope_theta=10000.0, rms_norm_eps=1e-5,
            tie_word_embeddings=True, max_position_embeddings=2048,
            family="falcon", falcon_two_norms=True)

    @staticmethod
    def tiny_falcon(vocab_size=256, hidden_size=64, intermediate_size=112,
                    num_layers=2, num_attention_heads=4,
                    num_key_value_heads=1, **kw) -> "ModelConfig":
        return ModelConfig(
            vocab_size=vocab_size, hidden_size=hidden_size,
            intermediate_size=intermediate_size, num_layers=num_layers,
            num_attention_heads=num_attention_heads,
            num_key_value_heads=num_key_value_heads,
            tie_word_embeddings=True, max_position_embeddings=512,
            family="falcon", **kw)

    @staticmethod
    def gemma2_9b() -> "ModelConfig":
        """google/gemma-2-9b-it (reference supported list, utils.py:22)."""
        return ModelConfig(
            vocab_size=256000, hidden_size=3584, intermediate_size=14336,
            num_layers=42, num_attention_heads=16, num_key_value_heads=8,
            head_dim=256, rope_theta=10000.0, rms_norm_eps=1e-6,
            tie_word_embeddings=True, max_position_embeddings=8192,
            family="gemma2", query_pre_attn_scalar=256.0,
            attn_logit_softcap=50.0, final_logit_softcap=30.0,
            sliding_window=4096)

    @staticmethod
    def gemma2_27b() -> "ModelConfig":
        """google/gemma-2-27b-it (reference supported list, utils.py:23)."""
        return ModelConfig(
            vocab_size=256000, hidden_size=4608, intermediate_size=36864,
            num_layers=46, num_attention_heads=32, num_key_value_heads=16,
            head_dim=128, rope_theta=10000.0, rms_norm_eps=1e-6,
            tie_word_embeddings=True, max_position_embeddings=8192,
            family="gemma2", query_pre_attn_scalar=144.0,
            attn_logit_softcap=50.0, final_logit_softcap=30.0,
            sliding_window=4096)

    @staticmethod
    def tiny_gemma2(vocab_size=256, hidden_size=64, intermediate_size=112,
                    num_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, **kw) -> "ModelConfig":
        return ModelConfig(
            vocab_size=vocab_size, hidden_size=hidden_size,
            intermediate_size=intermediate_size, num_layers=num_layers,
            num_attention_heads=num_attention_heads,
            num_key_value_heads=num_key_value_heads, rms_norm_eps=1e-6,
            tie_word_embeddings=True, max_position_embeddings=512,
            family="gemma2", query_pre_attn_scalar=float(
                kw.pop("query_pre_attn_scalar", 24.0)),
            attn_logit_softcap=50.0, final_logit_softcap=30.0,
            sliding_window=kw.pop("sliding_window", 8), **kw)

    @staticmethod
    def mistral_7b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=32768, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_attention_heads=32, num_key_value_heads=8,
            rope_theta=1000000.0, rms_norm_eps=1e-5,
            max_position_embeddings=32768, family="mistral")

    @staticmethod
    def mistral_nemo() -> "ModelConfig":
        return ModelConfig(
            vocab_size=131072, hidden_size=5120, intermediate_size=14336,
            num_layers=40, num_attention_heads=32, num_key_value_heads=8,
            head_dim=128, rope_theta=1000000.0, rms_norm_eps=1e-5,
            max_position_embeddings=128000, family="mistral")
