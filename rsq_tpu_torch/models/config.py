"""Typed model configuration (the port's copy of rsq_tpu.models.config):
every field of the reference's dataclass, so a checkpoint manifest written
by either package loads in the other, and the Llama-family constructors
(`cli` names llama3-8b, llama2-7b, qwen25-7b, mistral-nemo and tiny).
Qwen2.5 is attention_bias=True; Mistral-Nemo has an explicit head_dim."""

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
    family: str = "llama"         # llama | qwen2 | mistral (opt, gemma2, falcon: ROADMAP item 15)
    # the other families' fields, kept for manifest interchange
    falcon_two_norms: bool = False
    query_pre_attn_scalar: float | None = None
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    sliding_window: int | None = None

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
    def mistral_nemo() -> "ModelConfig":
        return ModelConfig(
            vocab_size=131072, hidden_size=5120, intermediate_size=14336,
            num_layers=40, num_attention_heads=32, num_key_value_heads=8,
            head_dim=128, rope_theta=1000000.0, rms_norm_eps=1e-5,
            max_position_embeddings=128000, family="mistral")
