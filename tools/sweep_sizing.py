"""Sweep the launch sizing of two kernels on an NVIDIA GPU and print the
device time of each choice (chip_smoke.py's device_ms: calls queued behind
a sleep kernel, so host gaps are out):

- bf16_decode_attention_stacked: blocks per (b, kv head) row (the cluster
  size), 1, 2, 4 and 8, at chip_smoke's unit (one Llama-3-8B layer, B=8,
  S=1024) for three length patterns;
- w16_matmul_stacked at decode (M=8): the K split's target of blocks per
  SM, 1 to 4, for the four Llama-3-8B projection shapes and one decode
  layer's seven products.

Each choice is first held against the plain version at chip_smoke's
tolerances.  The wrappers' planners are replaced for the sweep only.

    python3 tools/sweep_sizing.py
"""

import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from rsq_tpu_torch.kernels import kv_cache as KV  # noqa: E402
from rsq_tpu_torch.kernels import matmul_w4 as MW  # noqa: E402

LENGTHS = {"smoke": cs.CONTIG_LENGTHS, "all 512": [512] * 8,
           "all 1023": [1023] * 8}
W16_SHAPES = {"q|o": (4096, 4096, 2), "k|v": (4096, 1024, 2),
              "up|gate": (4096, 14336, 2), "down": (14336, 4096, 1)}


def sweep_attention(dev, g):
    B, Hkv, G, D, S, NL = 8, 8, 4, 128, 1024, cs.TIMING_LAYERS
    k, v = cs._bf16_cache(dev, g, NL, B, Hkv, S, D)
    q = (torch.randn((B, Hkv * G, D), generator=g, device=dev) * 2).to(
        torch.bfloat16)
    planner = KV.bf16_attention_cluster
    try:
        for name, lens in LENGTHS.items():
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            want = KV.bf16_decode_attention_plain(q, k, v, 1, lengths)
            for cl in (1, 2, 4, 8):
                KV.bf16_attention_cluster = lambda S, cl=cl: cl
                got = KV.bf16_decode_attention_stacked(q, k, v, 1, lengths)
                cs._bf16_attn_err(got, want, lengths, f"cluster {cl}")
                t = cs.device_ms(cs.rotating(
                    lambda j: KV.bf16_decode_attention_stacked(
                        q, k, v, j, lengths), NL))
                print(f"bf16 attention, lengths {name}, {cl} blocks a row: "
                      f"{t:.5f} ms", flush=True)
    finally:
        KV.bf16_attention_cluster = planner


def sweep_w16(dev, g):
    split = MW._split_k
    try:
        for per_sm in (1, 2, 3, 4):
            MW._split_k = lambda blocks, K, p=per_sm, **kw: split(
                blocks, K, per_sm=p, most=kw.get("most", 1 << 30))
            layer = 0.0
            for name, (K, N, uses) in W16_SHAPES.items():
                copies = max(2, -(-128 * 2**20 // (K * N * 2)))
                w = torch.randn((copies, K, N), generator=g, device=dev).to(
                    torch.bfloat16) * (1.0 / math.sqrt(K))
                x = torch.randn((8, K), generator=g, device=dev).to(
                    torch.bfloat16)
                cs.matmul_err(MW.w16_matmul_stacked(x, w, 1),
                              MW.w16_matmul_stacked_plain(
                                  x, w, 1, torch.bfloat16), name)
                t = cs.device_ms(cs.rotating(
                    lambda j: MW.w16_matmul_stacked(x, w, j), copies))
                layer += t * uses
                print(f"w16 M=8 {name}, {per_sm} blocks an SM: {t:.5f} ms",
                      flush=True)
                del w
            print(f"w16 M=8 decode layer, {per_sm} blocks an SM: "
                  f"{layer:.5f} ms", flush=True)
    finally:
        MW._split_k = split


def main():
    if not torch.cuda.is_available():
        sys.exit("sweep_sizing: no CUDA device")
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sweep_attention(dev, g)
    torch.cuda.empty_cache()
    sweep_w16(dev, g)


if __name__ == "__main__":
    main()
