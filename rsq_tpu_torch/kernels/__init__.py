"""Kernel wrappers.  Each wrapper takes its plain PyTorch version for CPU
tensors and launches its hand-written CUDA kernel for CUDA tensors (or
raises); `LAUNCHES[name]` counts kernel launches, and only those."""

from __future__ import annotations

import collections
import ctypes

import torch

KERNELS = ("w4a4_matmul_paired_stacked", "w8_matmul", "decode_prep",
           "int4_paged_decode_attention_self_append",
           "int4_decode_attention_self_append",
           "bf16_decode_attention_stacked", "kv_append_stacked_bf16",
           "w16_matmul_stacked", "w4_matmul_paired_stacked",
           "w4_affine_matmul_stacked", "w4_matmul", "w4a4_matmul_paired",
           "w4_matmul_paired", "w4_affine_matmul",
           "int4_decode_attention_stacked",
           "int4_paged_decode_attention_stacked", "paged_append_pool",
           "int4_decode_attention_stacked_self", "kv_append_stacked",
           "int4_paged_decode_attention_stacked_self")

LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def on_cuda(tensors) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; anything else is an error."""
    devs = {t.device for t in tensors}
    require(len(devs) == 1, f"tensors on several devices: {devs}")
    dev = devs.pop()
    require(dev.type in ("cuda", "cpu"), f"unsupported device {dev}")
    return dev.type == "cuda"


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
