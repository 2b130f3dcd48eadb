"""Run chip_smoke.py's kernel checks against the rsq_tpu_torch of another
checkout (an unpacked parent commit, say) and print one JSON line per
check: its device, events, plain and library times and, per case, the
same.  The checks come from this checkout's chip_smoke.py; the package
they call, and the kernels built, from ROOT.  Compare two checkouts in
one call on one card, in turns (parent, change, change, parent).

    python3 tools/compare_kernels.py ROOT [CHECK ...]

CHECK names a chip_smoke.py function (default: the weight-only and INT4
attention checks), `same_operands`: rows 1, 5, 6, 7 and 21 timed on
operands that every version of the package takes, beside the launch floor
where ROOT has it, or a phase run as the smoke runs it: `serve_bf16` (the
bf16 baseline (B), with the profile of one decode step: its wall, queue
and device-busy ms) or `quantize_phase` (ROOT must hold the quantization
pipeline), in the order given.
"""

import ctypes
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
CHECKS = ("check_w4", "check_w4_affine", "check_w4_head", "check_w4_paired",
          "check_w4_affine_unstacked", "check_paged_attention",
          "check_contiguous_attention", "check_decode_attention",
          "check_paged_read_only")
PHASES = ("serve_bf16", "quantize_phase")


def same_operands(cs, dev, g, cfg):
    """decode_prep on contiguous (B, H, D) q, k, v, the bf16 decode
    attention as the smoke times it (lengths CONTIG_LENGTHS, S = 1024,
    cycling over TIMING_LAYERS layers), the bf16 append on
    contiguous (B, H, 1, D) nk, nv, and the INT4 appends as the smoke
    checks them (the contiguous one at positions CONTIG_LENGTHS, S = 1024;
    the pool's at page 16, positions PAGED_LENGTHS), at the Llama-3-8B
    decode shapes, B = 8 (S = 1024): device ms per call, five readings of
    200 calls each."""
    from rsq_tpu_torch.kernels import cuda_build
    from rsq_tpu_torch.kernels import kv_cache as KV
    from rsq_tpu_torch.kernels import paged_kv as PKV
    from rsq_tpu_torch.models import llama as LM
    B, Hq, Hkv, D = 8, cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim_

    def bf16(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = bf16(B, Hq, D), bf16(B, Hkv, D), bf16(B, Hkv, D)
    cos, sin = LM.rope_tables(cfg, torch.randint(100, 1000, (B,), generator=g,
                                                 device=dev))
    kc, vc = bf16(2, B, Hkv, 1024, D), bf16(2, B, Hkv, 1024, D)
    pos = torch.randint(0, 1024, (B,), generator=g, device=dev).int()
    nk, nv = bf16(B, Hkv, 1, D), bf16(B, Hkv, 1, D)
    new = (*KV.asym_quant_pack_head(bf16(B, Hkv, D)),
           *KV.asym_quant_pack_head(bf16(B, Hkv, D)))
    lane = [t[..., None] for t in new]          # row 7 takes (B, H, ., 1)
    cache = cs._int4_cache(dev, g, 2, B, Hkv, D, 1024)
    cpos = torch.tensor(cs.CONTIG_LENGTHS, dtype=torch.int32, device=dev)
    pool, ptab = cs._paged_pool(dev, g, 2, Hkv, D, 16, cs.PAGED_LENGTHS)
    ppos = torch.tensor(cs.PAGED_LENGTHS, dtype=torch.int32, device=dev)
    kb, vb = cs._bf16_cache(dev, g, cs.TIMING_LAYERS, B, Hkv, 1024, D)
    qb = bf16(B, Hq, D)
    runs = {"decode_prep": lambda i=0: KV.decode_prep(q, k, v, cos, sin),
            "bf16_decode_attention_stacked": cs.rotating(
                lambda j: KV.bf16_decode_attention_stacked(qb, kb, vb, j,
                                                           cpos),
                cs.TIMING_LAYERS),
            "kv_append_stacked_bf16": lambda i=0: KV.kv_append_stacked_bf16(
                kc, vc, 1, pos, nk, nv),
            "kv_append_stacked": lambda i=0: KV.kv_append_stacked(
                *cache, 1, cpos, *lane),
            "paged_append_pool": lambda i=0: PKV.paged_append_pool(
                *pool, 1, ptab, ppos, *new)}
    if "launch_floor" in cuda_build.SOURCES:
        fn = cuda_build.function("launch_floor", "empty_launch",
                                 [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        runs["launch_floor"] = lambda i=0: fn(64, 192, st)
    return {"check": "same_operands",
            "device_ms": {n: [cs.device_ms(f, iters=200) for _ in range(5)]
                          for n, f in runs.items()}}


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("compare_kernels: no CUDA device")
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from rsq_tpu_torch.kernels import cuda_build
    from rsq_tpu_torch.models.config import ModelConfig
    ensure_root = Path(cuda_build.__file__).resolve().parents[2]
    cs.ensure(ensure_root == root, f"rsq_tpu_torch found at {ensure_root}")
    print(json.dumps({"root": str(root), "card": cs.nvidia_smi(),
                      "build_s": cuda_build.build()}), flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig.llama3_8b()
    g = torch.Generator(device=dev).manual_seed(0)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")
    for name in argv[1:] or CHECKS:
        if name == "same_operands":
            print(json.dumps(same_operands(cs, dev, g, cfg)), flush=True)
            continue
        if name in PHASES:
            t0 = time.perf_counter()
            prompts = cs.serve_prompts(cfg)
            rec = (cs.serve_bf16(dev, cfg, prompts, True)
                   if name == "serve_bf16"
                   else cs.quantize_phase(dev, prompts, {}))[0]
            rec = {k: {f: v for f, v in r.items() if not isinstance(v, list)}
                   for k, r in rec.items()}
            print(json.dumps({"phase": name, **rec,
                              "s": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
            continue
        r = getattr(cs, name)(dev, g, cfg)
        out = {"check": name, "kernel": r["name"],
               **{k: r.get(k) for k in keys}}
        if "cases" in r:
            out["cases"] = [{k: v for k, v in c.items()
                             if k in keys + ("proj", "M", "page",
                                             "vs_library")}
                            for c in r["cases"]]
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
