"""PyTorch/CUDA port of rsq_tpu's INT4 serving path, for NVIDIA Hopper.

The JAX package `rsq_tpu` is the reference this package is tested against;
nothing here imports it (or JAX).  Layout mirrors it: `core/`, `models/`,
`quantize/` (the RSQ pipeline), `eval/` (perplexity), `cli.py`, `kernels/`
(wrappers + plain PyTorch versions), `serving/`, and `csrc/` (hand-written
CUDA for sm_90a, built by nvcc on first use).

Device rule: entry points default to device="cuda" and raise when CUDA is
not available; only an explicit device="cpu" runs the plain PyTorch
versions on the CPU (the tests do that).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`, refusing a CUDA request without CUDA
    (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def tree_to(tree, device):
    """A param tree (dicts, lists, None leaves) with every tensor moved to
    `device`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)
