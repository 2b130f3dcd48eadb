"""Quantization policy: how activations and the KV cache are treated inside
the fake-quant forward (the port of rsq_tpu.models.policy).  One frozen
dataclass threaded through the forward."""

from __future__ import annotations

import dataclasses

from rsq_tpu_torch.core.quant import ActQuantConfig


@dataclasses.dataclass(frozen=True)
class KVQuantConfig:
    """K-cache quantization after RoPE and the post-RoPE Hadamard;
    groupsize -1 is per token across all heads, groupsize == head_dim per
    head."""
    bits: int = 16
    groupsize: int = -1
    sym: bool = True
    clip_ratio: float = 1.0

    @property
    def enabled(self) -> bool:
        return self.bits < 16


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Static per-forward quantization behaviour."""
    a: ActQuantConfig = ActQuantConfig()         # every linear's input
    a_down: ActQuantConfig | None = None         # down_proj input override
    v: ActQuantConfig = ActQuantConfig()         # v_proj output
    k: KVQuantConfig = KVQuantConfig()           # K cache (+ q/k Hadamard)
    online_had_down: bool = False                # full Hadamard before down
    online_had_o: bool = False                   # head-mixing before o
    fp32_had: bool = False                       # online transforms in f32
    norms_fused: bool = False                    # weightless RMSNorm

    @property
    def a_down_(self) -> ActQuantConfig:
        return self.a_down if self.a_down is not None else self.a


FP16 = QuantPolicy()


def w4a4kv4(groupsize: int = -1, a_clip: float = 1.0, v_clip: float = 1.0,
            k_clip: float = 1.0) -> QuantPolicy:
    """The headline joint-quantization policy (run_rsq_w4a4kv4.sh)."""
    return QuantPolicy(
        a=ActQuantConfig(bits=4, sym=True, groupsize=groupsize,
                         clip_ratio=a_clip),
        v=ActQuantConfig(bits=4, sym=True, groupsize=groupsize,
                         clip_ratio=v_clip),
        k=KVQuantConfig(bits=4, groupsize=groupsize, sym=True,
                        clip_ratio=k_clip),
        online_had_down=True, online_had_o=True, norms_fused=True)
