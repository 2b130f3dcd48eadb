"""Sweep the launch sizing of four kernels on an NVIDIA GPU and print the
device time of each choice (chip_smoke.py's device_ms: calls queued behind
a sleep kernel, so host gaps are out):

- bf16_decode_attention_stacked: blocks per (b, kv head) row (the cluster
  size), 1, 2, 4 and 8, at chip_smoke's unit (one Llama-3-8B layer, B=8,
  S=1024) for three length patterns;
- w16_matmul_stacked at decode (M=8): the K split's target of blocks per
  SM, 1 to 4, for the four Llama-3-8B projection shapes and one decode
  layer's seven products;
- the INT4 decode attention (rows 2 and 4, contiguous, S=1024; rows 17 and
  19, paged at pages 16 and 512): blocks per row 1, 2, 4 and 8 (the tiles
  a block takes of the longest row, 16 down to 2), for the same length
  patterns;
- the weight-only W4 matmul at decode (M=8, rows 13 and 14): the stream's
  K split (1, 2, 4, 5, 8 slices and the planner's choice) for each of one
  decode layer's shapes (the fused ones of row 13, the unfused ones of row
  14), and the layer at the planner's choices.

Each choice is first held against the plain version at chip_smoke's
tolerances.  The wrappers' planners are replaced for the sweep only.

    python3 tools/sweep_sizing.py [bf16] [w16] [int4] [w4]   # default: all
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


def _int4_case(dev, g, row, lens, NL):
    """Row `row`'s wrapper on NL layers of a cache holding rows of 1024
    tokens, and its arguments past the layer, for lengths `lens`."""
    from rsq_tpu_torch.kernels import paged_kv as PKV
    B, Hkv, G, D = 8, 8, 4, 128
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = (torch.randn((B, Hkv * G, D), generator=g, device=dev) * 2).to(
        torch.bfloat16)
    kself = cs._self_token(KV, dev, g, B, Hkv, D)
    new = []
    for t in kself:
        new += list(KV.asym_quant_pack_head(t))
    if row in (2, 4):
        cache = cs._int4_cache(dev, g, NL, B, Hkv, D, 1024)
        table = ()
    else:
        page = 16 if row == 17 else 512
        cache, ptab = cs._paged_pool(dev, g, NL, Hkv, D, page, [1024] * B)
        table = (ptab,)
    fn = {2: KV.int4_decode_attention_stacked,
          4: KV.int4_decode_attention_self_append,
          17: PKV.int4_paged_decode_attention_stacked,
          19: PKV.int4_paged_decode_attention_self_append}[row]
    rest = (*table, lengths) + ((*kself, *new) if row in (4, 19) else ())
    return fn, cache, rest, q


def sweep_int4_attention(dev, g):
    NL = cs.TIMING_LAYERS
    per_block = KV.INT4_TILES_PER_BLOCK
    try:
        for row in (2, 4, 17, 19):
            for name, lens in LENGTHS.items():
                fn, cache, rest, q = _int4_case(dev, g, row, lens, NL)
                int8_qk = row in (4, 19)
                for tpb in (16, 8, 4, 2):
                    KV.INT4_TILES_PER_BLOCK = tpb
                    t = cs.device_ms(cs.rotating(
                        lambda j: fn(q, *cache, j, *rest, int8_qk=int8_qk),
                        NL))
                    print(f"int4 attention row {row}, lengths {name}, "
                          f"{KV.int4_attention_cluster(1024)} blocks a row: "
                          f"{t:.5f} ms", flush=True)
                del cache
    finally:
        KV.INT4_TILES_PER_BLOCK = per_block


W4_SHAPES = {13: {"qkv": (4096, 3072, 1), "o": (4096, 2048, 1),
                  "upgate": (4096, 14336, 1), "down": (14336, 2048, 1)},
             14: {"q|o": (4096, 2048, 2), "k|v": (4096, 512, 2),
                  "up|gate": (4096, 7168, 2), "down": (14336, 2048, 1)}}


def sweep_w4(dev, g):
    planner = MW.w4_split
    try:
        for row, shapes in W4_SHAPES.items():
            layer = 0.0
            for name, (K, Nh, uses) in shapes.items():
                copies = max(2, -(-128 * 2**20 // (K * Nh)))
                wp = torch.randint(0, 256, (copies, K, Nh), dtype=torch.uint8,
                                   generator=g, device=dev)
                x = torch.randn((8, K), generator=g, device=dev).to(
                    torch.bfloat16)
                if row == 13:
                    s = torch.rand((2, Nh), generator=g, device=dev) / K
                    run = lambda j: MW.w4_matmul_paired_stacked(  # noqa
                        x, wp, s, j)
                    want = MW.w4_matmul_paired_stacked_plain(x, wp, s, 1)
                else:
                    s = torch.rand((copies,), generator=g, device=dev) / K
                    run = lambda j: MW.w4_affine_matmul_stacked(  # noqa
                        x, wp, s, j, plane_major=True)
                    want = MW.w4_affine_matmul_stacked_plain(
                        x, wp, s, 1).reshape(8, -1)
                chosen = planner(8, K, Nh, False)[0]
                for ns in sorted({1, 2, 4, 5, 8, chosen}):
                    kc = -(-(-(-K // ns)) // 128) * 128
                    MW.w4_split = lambda *a, kc=kc: (-(-a[1] // kc), kc)
                    cs.matmul_err(run(1), want, name)
                    t = cs.device_ms(cs.rotating(run, copies))
                    if ns == chosen:
                        layer += t * uses
                    print(f"w4 row {row} M=8 {name}, K split {-(-K // kc)}"
                          f"{' (planner)' if ns == chosen else ''}: "
                          f"{t:.5f} ms", flush=True)
                MW.w4_split = planner
                del wp
            print(f"w4 row {row} M=8 decode layer at the planner's splits: "
                  f"{layer:.5f} ms", flush=True)
    finally:
        MW.w4_split = planner


def main():
    if not torch.cuda.is_available():
        sys.exit("sweep_sizing: no CUDA device")
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    which = set(sys.argv[1:]) or {"bf16", "w16", "int4", "w4"}
    for name, sweep in (("bf16", sweep_attention), ("w16", sweep_w16),
                        ("int4", sweep_int4_attention), ("w4", sweep_w4)):
        if name in which:
            sweep(dev, g)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
