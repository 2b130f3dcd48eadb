#!/usr/bin/env python3
"""Smoke run of rsq_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--profile]

Phases (any failure raises and exits nonzero; nothing is caught):
  1. device  -- require CUDA; print the card's name and power limit.
  2. build   -- nvcc the CUDA sources of rsq_tpu_torch/csrc, in parallel.
  3. kernels -- each of the twenty kernels against its plain PyTorch
                version on the card at the Llama-3-8B serving shapes, with
                the tolerance stated beside each check; kernel, plain and
                library-call times (CUDA events) and the least time the
                card could take; first the launch floor, an empty
                kernel's time (launch_floor_ms).  The attention kernels
                also run on a copy of their cache with every byte they
                must not read poisoned (0xFF codes, NaN parameters).
                decode_prep also runs on the plane-major views of a fused
                qkv output and on NaN rows, the bf16 append on strided new
                values, the self-appending INT4 attention on a query with
                a NaN head under int8_qk.  Three kernels (rows 3, 7, 18
                of PERF.md's table) lie on no serving path, as their TPU
                kernels lie on none of the reference's: they must launch 0
                times in phases 5 and 6.
  4. small   -- tiny models served on the GPU (kernels) and on the CPU
                (plain versions) by the paged engine at pages 128 and 16,
                the contiguous engine, the per-layer prefill/decode_step
                and the per-layer paged oracles at page 16, in three
                configurations (W4A4, W4A16 with an int4 lm_head, E8P): the
                logits must agree.  The RSQ pipeline (run_rsq.sh config,
                then rsq_e8p's LDLQ+E8P) on a tiny model on the card
                against the CPU, call by call; then the CLI's quantize,
                eval and serve on the card, and quantize --e8p then serve;
                the C++ page allocator against its Python twin.  The OPT,
                Gemma-2 and Falcon (shared-norm MQA and two-norm GQA) tiny
                models through the same pipeline on the card against the
                CPU, call by call; the CLI's quantize --eval and eval on
                tiny-falcon, and serve refusing it.  Every engine of
                phases 5 and 6 must run on the C++ allocator or scheduler.
  5. quantize -- the RSQ pipeline at Llama-3-8B width on QUANT_LAYERS of
                its 32 layers, seeded params read through the Hugging
                Face ingest (models/hf.py, from a state dict), 32 synthetic
                calibration samples of 2048 tokens: seconds per stage,
                peak memory, quant_error, PPL; the result served by
                PagedServingEngine (page 512), its prefill logits held
                against the fake-quant forward: W4A16 corr > 0.98; W4A4
                within A4_MARGIN of the 4-bit-activation forward's
                agreement with itself on bf16-rounded weights, a bound the
                W4A16 prefill must miss.
     quantize_e8p -- the same params and calibration on E8P_LAYERS
                layers through LDLQ+E8P: seconds per stage and per
                projection, peak memory; every served weight equal to the
                pipeline's Q bit for bit, then ServingEngine serves it
                weight-only on the affine-W4 kernel: prefill logits corr
                > 0.98 with the 16-bit fake-quant forward.
     quantize_families -- falcon-7b, gemma-2-9b and opt-125m at their
                published widths on 1, 1 and 2 layers, seeded params read
                through each family's Hugging Face ingest (bit for bit);
                the rotated model's logits against the original's (OPT,
                Falcon) or rotate_model refused (Gemma-2); the pipeline
                on 32 samples of 2048 tokens: seconds per stage and
                projection, the full depth reckoned, peak memory,
                quant_error; the card's fake-quant logits against the
                CPU's; a finite PPL.  No kernel: these families are
                quantized and evaluated, not served (rsq_tpu serves the
                Llama family only).
  6. serve   -- ten paths at full Llama-3-8B width and depth (32 layers),
                32 new tokens per request; each path's kernel launch counts
                start at 0 just before it and must rise:
                serve            PagedServingEngine, W4A4 INT4-KV, page 512
                serve_contiguous ServingEngine, the same W4A4 weights (A)
                serve_layers     prefill + decode_step on the same weights
                                 unstacked, 8 prompts of 512 tokens (E)
                scan             prefill_stacked + decode_step_stacked under
                                 RSQ_SCAN_DECODE=1 on them, held against (E)
                serve_page16     PagedServingEngine, W4A4, page 16 (F)
                serve_w4         PagedServingEngine, the same weights served
                                 weight-only (a4=False), int4 lm_head (C)
                serve_layers_w4  (E) on (C)'s weights and head
                serve_e8p        ServingEngine, E8P weights as affine int4,
                                 INT4-KV (D)
                serve_layers_e8p (E) on (D)'s weights
                serve_bf16       ServingEngine, dense bf16 weights and cache
                                 (the bf16 baseline, B)
                The paged and contiguous engines serve 8 requests of
                100-700 prompt tokens (two sharing a 600-token prefix).
                One set of weights is live at a time.
Then one JSON line per phase result, the kernels line, the nvidia-smi line,
and as the last line {"ok": true, "device": {...}}.  --profile adds, after
each serve phase but scan, a torch.profiler table of one decode step and a
"profile" line: the step's wall and queueing time, the card's busy time,
and the step's stream syncs, copies and launches.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: bytes/s of HBM3 and peak operations/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
BF16_EPS = 2.0 ** -8
# end-to-end logit tolerance of the tiny GPU-vs-CPU check, in std of the
# logits: the reference's own jit-vs-eager spread (tests/test_torch_paged.py)
LOGIT_MAX, LOGIT_RMS = 0.25, 0.08


def log(*a):
    print(*a, flush=True)


def ensure(cond, what="check failed"):
    """A failed check ends the run (explicit, so it also holds under -O)."""
    if not cond:
        raise AssertionError(what)


def bound_ms(nbytes: float, ops: float, kind: str):
    """Least time for the work: bytes at the HBM rate or operations at the
    peak rate of their type, whichever is longer."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time per fn() call without the host's gaps between launches:
    the calls are queued behind a sleep kernel that lasts longer than the
    host takes to queue them, so they run back to back on the card."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    while True:
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        host_ms = (time.perf_counter() - t0) * 1e3
        e2.record()
        torch.cuda.synchronize()
        if host_ms < e0.elapsed_time(e1):
            return e1.elapsed_time(e2) / iters
        ensure(cycles < 2_000_000_000, "host cannot queue ahead of the card")
        cycles *= 4


def rotating(fn, n):
    """fn(j) for call i with j = i % n: cycles through n weight copies so a
    timed loop reads from device memory, as the serving step does, rather
    than from the 50 MB L2."""
    return lambda i=0: fn(i % n)


def timings(kernel, plain, library=None):
    """The kernel wrapper's time per call (ms: CUDA events over back-to-back
    calls, host gaps included; device_ms: device busy time), the plain
    version's, and the library call's (None where there is none)."""
    return {"ms": time_ms(kernel), "device_ms": device_ms(kernel),
            "plain_ms": time_ms(plain, iters=5),
            "library_ms": None if library is None else time_ms(library)}


def matmul_err(got, want, what) -> float:
    """The matmul kernels' check: f32 sums in another order, then one bf16
    rounding each, so within two bf16 rounding units of the plain version,
    plus 1e-5 of its largest output for cancelling sums.  Returns the max
    error; raises beyond the tolerance."""
    e = (got.float() - want.float()).abs()
    w = want.float().abs()
    if not bool((e <= 2 * BF16_EPS * w + 1e-5 * float(w.max())).all()):
        raise AssertionError(f"{what}: max err {float(e.max())}")
    return float(e.max())


def launch_floor():
    """The launch floor: one launch of an empty kernel <<<64, 192>>> (the
    grid of decode_prep at Llama-3-8B widths and B = 8), timed as the
    kernel rows are."""
    import ctypes
    from rsq_tpu_torch.kernels import cuda_build
    fn = cuda_build.function("launch_floor", "empty_launch",
                             [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run(i=0):
        cuda_build.check(fn(64, 192, st), "empty kernel")

    return {"launch_floor_ms": device_ms(run), "launch_floor_events_ms":
            time_ms(run), "launch": "<<<64, 192>>>"}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

W4A4_SHAPES = {"qkv": (4096, 3072), "o": (4096, 2048),
               "upgate": (4096, 14336), "down": (14336, 2048)}
# M of the matmul checks: decode (batch 8) and the engines' largest prefill
# bucket; the per-layer path's kernels also at its prefill, whose 8 prompts
# of 512 tokens serving_linear flattens into one call
ENGINE_MS = (8, 1024)
# M of the W4A4 checks held bit-equal but not timed: one row, and one past
# a tile of 8 (2 tiles of 8 rows per block)
CHECK_MS = (1, 9)


def layer_ms():
    return ENGINE_MS + (BATCH * LAYER_PROMPT_LEN,)


def _w4a4_cases(dev, g, run, plain, decodes=(None,), ms=ENGINE_MS):
    """A W4A4 matmul at the four fused Llama-3-8B projection shapes and
    each M of `ms`: run(x, wp, s2, j, decode) against plain(x, wp, s2, j)
    on weight copy j, bit-equal for every phase hint in `decodes`, then
    timed with torch._int_mm on pre-unpacked int8 weights as the library
    yardstick.  Returns (cases, max error, the decode layer's totals)."""
    copies = 4
    cases, err = [], 0.0
    for name, (K, Nh) in W4A4_SHAPES.items():
        wp = torch.randint(0, 256, (copies, K, Nh), dtype=torch.uint8,
                           generator=g, device=dev)
        s2 = (torch.rand((2, Nh), generator=g, device=dev) + 0.5) / (
            7 * math.sqrt(K))
        # the library yardstick: the same product on pre-unpacked int8
        # weights (column-major, as torch._int_mm wants them)
        w = wp.to(torch.int32)
        w_i8 = torch.cat([(w << 28) >> 28, (w << 24) >> 28], dim=2).to(
            torch.int8)
        w_i8 = w_i8.transpose(1, 2).contiguous().transpose(1, 2)
        del w
        for M in CHECK_MS + ms:
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            want = plain(x, wp, s2, 1)
            for decode in decodes:
                got = run(x, wp, s2, 1, decode)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                err = max(err, float(diff.max()))
                # integer accumulation and the same epilogue order: bit-equal
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"w4a4 {name} M={M} decode={decode}: not bit-equal, "
                        f"{int((diff > 0).sum())} differ, max {float(diff.max())}")
            if M in CHECK_MS:
                continue                          # held, not timed
            mp = max(32, -(-M // 8) * 8)          # _int_mm wants M > 16
            xq = torch.randint(-8, 8, (mp, K), dtype=torch.int8,
                               generator=g, device=dev)
            t = timings(
                rotating(lambda j: run(x, wp, s2, j, decodes[0]), copies),
                rotating(lambda j: plain(x, wp, s2, j), copies),
                rotating(lambda j: torch._int_mm(xq, w_i8[j]), copies))
            nbytes = M * K * 2 + K * Nh + 2 * Nh * 4 + M * 2 * Nh * 2
            b, by = bound_ms(nbytes, 2.0 * M * K * 2 * Nh, "int8")
            cases.append({"proj": name, "M": M, "K": K, "Nh": Nh, **t,
                          "bound_ms": b, "bound_by": by})
        del wp, w_i8
    dec = [c for c in cases if c["M"] == 8]
    total = {k: sum(c[k] for c in dec)
             for k in ("ms", "device_ms", "plain_ms", "library_ms",
                       "bound_ms")}
    return cases, err, {**total, "bound_by": "bytes" if all(
        c["bound_by"] == "bytes" for c in dec) else "operations"}


def check_w4a4(dev, g):
    from rsq_tpu_torch.kernels import matmul_w4 as MW
    cases, err, total = _w4a4_cases(
        dev, g, lambda x, wp, s2, j, _: MW.w4a4_matmul_paired_stacked(
            x, wp, s2, j),
        lambda x, wp, s2, j: MW.w4a4_matmul_paired_stacked_plain(
            x, wp, s2, j, MW.token_scales(x)))
    return {"name": "w4a4_matmul_paired_stacked", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/w4a4_matmul.cu",
            "replaces": "rsq_tpu/kernels/matmul_w4.py:559",
            "max_abs_err": err, **total,
            "unit": "one decode layer: qkv, o, upgate, down at M=8",
            "check": "bit-equal to the plain version, M in (1, 9, 8, 1024)",
            "cases": cases}


def check_w4a4_paired(dev, g):
    """Row 11, the unstacked W4A4 matmul of the per-layer path (row 12's
    kernel on the L = 1 view of one weight copy), with the reference's
    decode and prefill hints: the TPU kernel has an int8 and a bf16 body,
    the port one kernel that must equal the plain version under both."""
    from rsq_tpu_torch.kernels import matmul_w4 as MW
    cases, err, total = _w4a4_cases(
        dev, g, lambda x, wp, s2, j, decode: MW.w4a4_matmul_paired(
            x, wp[j], s2, decode=decode),
        lambda x, wp, s2, j: MW.w4a4_matmul_paired_plain(
            x, wp[j], s2, MW.token_scales(x)), decodes=(True, False),
        ms=layer_ms())
    return {"name": "w4a4_matmul_paired", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/w4a4_matmul.cu",
            "replaces": "rsq_tpu/kernels/matmul_w4.py:458",
            "max_abs_err": err, **total,
            "unit": "one decode layer: qkv, o, upgate, down at M=8",
            "check": "bit-equal to the plain version with decode=True and "
                     f"decode=False, M in {CHECK_MS + layer_ms()}",
            "cases": cases}


def _head_cases(dev, g, K, N, run, plain, w_deq, weight_bytes):
    """An lm_head kernel at both of its main-path shapes, M=8 at decode and
    M=1 for the last prompt token, against its plain version (matmul_err)
    and timed, with torch.matmul of x and the bf16 weights w_deq as the
    library yardstick.  Returns (cases, max error); the caller's top-level
    times are M=8's."""
    cases, err = [], 0.0
    for M in (8, 1):
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        got, want = run(x), plain(x)
        torch.cuda.synchronize()
        err = max(err, matmul_err(got, want, f"lm_head M={M}"))
        t = timings(lambda i=0: run(x), lambda i=0: plain(x),
                    lambda i=0: torch.matmul(x, w_deq))
        b, by = bound_ms(M * K * 2 + weight_bytes + N * 4 + M * N * 2,
                         2.0 * M * K * N, "bf16")
        cases.append({"M": M, **t, "bound_ms": b, "bound_by": by})
    return cases, err


def _head_entry(cases):
    return {k: cases[0][k] for k in ("ms", "device_ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by")}


def check_w8(dev, g):
    """The int8 lm_head (8, 4096) x (4096, 128256), at M=8 and M=1."""
    from rsq_tpu_torch.kernels import matmul_w4 as MW
    K, N = 4096, 128256
    w8 = torch.randint(-127, 128, (K, N), dtype=torch.int8, generator=g,
                       device=dev)
    scale = (torch.rand((N,), generator=g, device=dev) + 0.5) / (
        127 * math.sqrt(K))
    w_deq = (w8.float() * scale).to(torch.bfloat16)
    cases, err = _head_cases(dev, g, K, N,
                             lambda x: MW.w8_matmul(x, w8, scale),
                             lambda x: MW.w8_matmul_plain(x, w8, scale),
                             w_deq, K * N)
    del w_deq
    return {"name": "w8_matmul", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/w8_matmul.cu",
            "replaces": "rsq_tpu/kernels/matmul_w4.py:899",
            "max_abs_err": err, **_head_entry(cases),
            "unit": "lm_head (8, 4096) x (4096, 128256)",
            "check": "|err| <= 2^-7 |plain| + 1e-5 max|plain|, M in (8, 1)",
            "cases": cases}


def same_bits(a, b) -> bool:
    """Bit-equal, a NaN matching a NaN (the kernel and the plain version
    may give NaNs different payloads)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(bits(a.masked_fill(na, 0)),
                                               bits(b.masked_fill(nb, 0)))


def _prep_same(got, want, what, skip_codes=None):
    """decode_prep's seven outputs bit-equal (same_bits); skip_codes: (B,
    Hkv) rows of k and of v whose codes are left out (a NaN row's codes
    are undefined in the reference too).  Returns the max abs error."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if skip_codes is not None and i in (3, 5):
            keep = ~skip_codes[int(i == 5)]
            a, b = a[keep], b[keep]
        if not same_bits(a, b):
            raise AssertionError(f"decode_prep {what}: output {i} not "
                                 "bit-equal")
        d = (a.float() - b.float()).abs()
        d = d[~d.isnan()]
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def check_decode_prep(dev, g, cfg):
    """Row 1 at the decode step's shapes: B = 8, the Llama-3-8B heads, on
    (B, H, D) operands, then on the plane-major segment views of a fused
    (B, 2, N) qkv output (what the decode branches hand it), then with a
    NaN in one k row and one v row; timed on the views."""
    from rsq_tpu_torch.kernels import kv_cache as KV
    from rsq_tpu_torch.models import llama as LM
    B, Hq, Hkv, D = 8, cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim_
    q = torch.randn((B, Hq, D), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
    pos = torch.randint(100, 1000, (B,), generator=g, device=dev)
    cos, sin = LM.rope_tables(cfg, pos)
    # same rounding points, no FMA contraction on either side: bit-equal
    err = _prep_same(KV.decode_prep(q, k, v, cos, sin),
                     KV.decode_prep_plain(q, k, v, cos, sin), "(B, H, D)")
    widths = ((Hq * D) // 2, (Hkv * D) // 2, (Hkv * D) // 2)
    y3 = torch.randn((B, 2, sum(widths)), generator=g, device=dev).to(
        torch.bfloat16)
    segs = [y3[:, :, o:o + w] for o, w in
            zip((0, widths[0], widths[0] + widths[1]), widths)]
    got = KV.decode_prep(*segs, cos, sin)
    err = max(err, _prep_same(got, KV.decode_prep_plain(*segs, cos, sin),
                              "plane-major"))
    flat = [t.reshape(B, -1, D) for t in segs]          # copies
    ensure(all(same_bits(a, b) for a, b in zip(
        got, KV.decode_prep(*flat, cos, sin))),
        "decode_prep: plane-major views and their copies differ")
    kn, vn = flat[1].clone(), flat[2].clone()
    kn[3, 2, 5] = float("nan")
    vn[5, 1, 7] = float("nan")
    got = KV.decode_prep(flat[0], kn, vn, cos, sin)
    want = KV.decode_prep_plain(flat[0], kn, vn, cos, sin)
    nan_rows = torch.zeros((2, B, Hkv), dtype=torch.bool, device=dev)
    nan_rows[0, 3, 2] = nan_rows[1, 5, 1] = True
    err = max(err, _prep_same(got, want, "NaN rows", skip_codes=nan_rows))
    ensure(bool(got[4][3, 2].isnan().all() and got[6][5, 1].isnan().all()
                and got[1][3, 2].isnan().all()
                and got[2][5, 1].isnan().all()),
           "decode_prep: a NaN row did not give NaN scale, zero and self")
    t = timings(lambda i=0: KV.decode_prep(*segs, cos, sin),
                lambda i=0: KV.decode_prep_plain(*segs, cos, sin))
    nbytes = (B * (Hq + 2 * Hkv) * D * 2 + 2 * B * D * 4      # q, k, v, cos, sin
              + B * Hq * D * 2 + 2 * B * Hkv * D * 4           # qh, k/v self
              + 2 * B * Hkv * (D // 2 + 8))                    # codes, params
    # rope 3 + butterfly log2(D) + scale 1 per q/k element; quant ~6 per k/v
    ops = B * (Hq + Hkv) * D * (4 + math.log2(D)) + 2 * B * Hkv * D * 6
    b, by = bound_ms(nbytes, ops, "f32")
    return {"name": "decode_prep", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/decode_prep.cu",
            "replaces": "rsq_tpu/kernels/kv_cache.py:180",
            "max_abs_err": err, **t, "bound_ms": b, "bound_by": by,
            "unit": "one decode layer, B=8, the plane-major segment views "
                    "of the fused qkv output",
            "check": "all seven outputs bit-equal to the plain version on "
                     "(B, H, D) operands and on plane-major views (the same "
                     "bits as on their copies); with a NaN in a k and a v "
                     "row, NaN scale, zero and self there and every other "
                     "code bit-equal"}


def _int4_cache(dev, g, L, B, H, D, S):
    """Random INT4 cache (L, B, H, ., S): codes, and (scale, zero) params."""
    cache = {n: torch.randint(0, 256, (L, B, H, D // 2, S), dtype=torch.uint8,
                              generator=g, device=dev) for n in ("kq", "vq")}
    for n in ("kp", "vp"):
        sc = torch.rand((L, B, H, 1, S), generator=g, device=dev) * 0.2
        zp = torch.rand((L, B, H, 1, S), generator=g, device=dev) - 0.5
        cache[n] = torch.cat([sc + 0.01, zp], dim=3).contiguous()
    return [cache[n] for n in ("kq", "kp", "vq", "vp")]


# The poisoned-cache checks (rsq_tpu_torch/kernels/poison.py): every byte
# a kernel must not read is 0xFF or NaN, so a stray read shows as NaN.

def bits(t):
    """A tensor's bits, so that equal NaNs compare equal."""
    if not t.is_floating_point():
        return t
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def check_paged_attention(dev, g, cfg):
    from rsq_tpu_torch.kernels import kv_cache as KV
    from rsq_tpu_torch.kernels import paged_kv as PKV
    from rsq_tpu_torch.kernels.poison import pages_live, poisoned
    L, Hkv, D = cfg.num_layers, cfg.num_key_value_heads, cfg.head_dim_
    Hq, page, B, NP = cfg.num_attention_heads, 512, 8, 2
    P = B * NP + 1
    pool = dict(zip(("kq", "kp", "vq", "vp"),
                    _int4_cache(dev, g, L, P, Hkv, D, page)))
    # fill averaging 512 tokens: mid-page, page-boundary and second-page rows
    lengths = torch.tensor([300, 400, 480, 511, 512, 600, 700, 595],
                           dtype=torch.int32, device=dev)
    ptab = (1 + torch.arange(B * NP, dtype=torch.int32, device=dev)
            ).reshape(B, NP)
    q = (torch.randn((B, Hq, D), generator=g, device=dev) * 2).to(
        torch.bfloat16)
    nk, nv = (torch.randn((B, Hkv, D), generator=g, device=dev)
              for _ in range(2))
    nkq, nkp = KV.asym_quant_pack_head(nk)
    nvq, nvp = KV.asym_quant_pack_head(nv)
    rest = (ptab, lengths, KV.unpack_dequant_head(nkq, nkp),
            KV.unpack_dequant_head(nvq, nvp), nkq, nkp, nvq, nvp)
    names = ("kq", "kp", "vq", "vp")
    live = pages_live(ptab, lengths, P, page, keep=1)
    err = 0.0
    for int8_qk in (True, False):
        pk = [pool[n].clone() for n in names]
        pp = [pool[n].clone() for n in names]
        px = poisoned([pool[n] for n in names], live)
        got = PKV.int4_paged_decode_attention_self_append(
            q, *pk, L - 1, *rest, int8_qk=int8_qk)
        bad = PKV.int4_paged_decode_attention_self_append(
            q, *px, L - 1, *rest, int8_qk=int8_qk)
        want = PKV.paged_self_append_plain(q, *pp, L - 1, *rest,
                                           int8_qk=int8_qk)
        torch.cuda.synchronize()
        # f32 sums in another order over a tiled online softmax, then one
        # bf16 rounding: within 4 bf16 rounding units + 2e-3; the same on
        # the poisoned pool
        err = max(err, _attn_err(got, want, f"paged attention int8_qk="
                                            f"{int8_qk}"),
                  _attn_err(bad, want, f"paged attention int8_qk={int8_qk}"
                                       ", poisoned pool"))
        # the in-place append: pools bit-equal (written column + the rest)
        for n, a, b, x, y in zip(names, pk, pp, px, poisoned(pp, live)):
            if not torch.equal(a, b):
                raise AssertionError(f"paged attention pool {n} differs")
            if not torch.equal(bits(x), bits(y)):
                raise AssertionError(f"paged attention poisoned pool {n}")
        del pk, pp, px
    qn, head = _nan_head(q)
    pk = [pool[n].clone() for n in names]
    pp = [pool[n].clone() for n in names]
    got = PKV.int4_paged_decode_attention_self_append(qn, *pk, L - 1, *rest,
                                                      int8_qk=True)
    want = PKV.paged_self_append_plain(qn, *pp, L - 1, *rest, int8_qk=True)
    err = max(err, _nan_head_err(got, want, head,
                                 "paged attention, NaN query head"))
    ensure(all(torch.equal(a, b) for a, b in zip(pk, pp)),
           "paged attention, NaN query head: pools differ")
    del pk, pp
    pl = [pool[n] for n in names]
    t = timings(rotating(lambda j: PKV.int4_paged_decode_attention_self_append(
                    q, *pl, j, *rest, int8_qk=True), L),
                rotating(lambda j: PKV.paged_self_append_plain(
                    q, *pl, j, *rest, int8_qk=True), L))
    tokens = int(lengths.sum())
    nbytes = (tokens * Hkv * 2 * (D // 2 + 8)                   # cached k, v
              + 2 * B * Hq * D * 2                              # q, out
              + 2 * B * Hkv * D * 4 + 2 * B * Hkv * (D // 2 + 8)  # new token
              + 2 * B * Hkv * (D // 2 + 8) + B * (NP + 1) * 4)  # append, tables
    b, by = bound_ms(nbytes, 2.0 * 2 * tokens * Hq * D, "int8")
    return {"name": "int4_paged_decode_attention_self_append",
            "route": "cuda", "source": "rsq_tpu_torch/csrc/paged_attention.cu",
            "replaces": "rsq_tpu/kernels/paged_kv.py:463",
            "also_replaces": "rsq_tpu/kernels/paged_kv.py:706",
            "max_abs_err": err, **t, "bound_ms": b, "bound_by": by,
            "unit": "one decode layer, B=8, page 512, lengths "
                    + ",".join(str(int(x)) for x in lengths) + ", int8_qk",
            "check": "out within 4*2^-8 rel + 2e-3 of the plain version, "
                     "int8_qk on and off, also on a poisoned pool; pools "
                     "bit-equal after the append; a query with a NaN head "
                     "under int8_qk: NaN in that head alone"}


# one decode layer of the contiguous phases: 8 slots of 1024 tokens, fill
# 300-700 plus the edges (empty slot, chunk ends, the last position)
CONTIG_LENGTHS = [300, 450, 600, 700, 0, 511, 512, 1023]
TIMING_LAYERS = 8          # > the 50 MB L2, as the serving step reads it


def check_contiguous_attention(dev, g, cfg):
    from rsq_tpu_torch.kernels import kv_cache as KV
    from rsq_tpu_torch.kernels.poison import poisoned, slots_live
    Hkv, D, Hq = cfg.num_key_value_heads, cfg.head_dim_, cfg.num_attention_heads
    L, B, S = 2, len(CONTIG_LENGTHS), 1024
    cache = _int4_cache(dev, g, L, B, Hkv, D, S)
    lengths = torch.tensor(CONTIG_LENGTHS, dtype=torch.int32, device=dev)
    q = (torch.randn((B, Hq, D), generator=g, device=dev) * 2).to(
        torch.bfloat16)
    nk, nv = (torch.randn((B, Hkv, D), generator=g, device=dev)
              for _ in range(2))
    nkq, nkp = KV.asym_quant_pack_head(nk)
    nvq, nvp = KV.asym_quant_pack_head(nv)
    rest = (lengths, KV.unpack_dequant_head(nkq, nkp),
            KV.unpack_dequant_head(nvq, nvp), nkq, nkp, nvq, nvp)
    live = slots_live(lengths, S, keep=1)
    err = 0.0
    for int8_qk in (True, False):
        ck = [t.clone() for t in cache]
        cp = [t.clone() for t in cache]
        cx = poisoned(cache, live)
        got = KV.int4_decode_attention_self_append(q, *ck, L - 1, *rest,
                                                   int8_qk=int8_qk)
        bad = KV.int4_decode_attention_self_append(q, *cx, L - 1, *rest,
                                                   int8_qk=int8_qk)
        want = KV.self_append_plain(q, *cp, L - 1, *rest, int8_qk=int8_qk)
        torch.cuda.synchronize()
        # as the paged kernel (the same device body): 4 bf16 units + 2e-3
        err = max(err, _attn_err(got, want, f"contiguous attention int8_qk="
                                            f"{int8_qk}"),
                  _attn_err(bad, want, f"contiguous attention int8_qk="
                                       f"{int8_qk}, poisoned cache"))
        for n, a, b, x, y in zip(("kq", "kp", "vq", "vp"), ck, cp, cx,
                                 poisoned(cp, live)):
            if not torch.equal(a, b):
                raise AssertionError(f"contiguous attention cache {n} differs")
            if not torch.equal(bits(x), bits(y)):
                raise AssertionError(f"contiguous attention poisoned {n}")
        del ck, cp, cx
    qn, head = _nan_head(q)
    ck = [t.clone() for t in cache]
    cp = [t.clone() for t in cache]
    got = KV.int4_decode_attention_self_append(qn, *ck, L - 1, *rest,
                                               int8_qk=True)
    want = KV.self_append_plain(qn, *cp, L - 1, *rest, int8_qk=True)
    err = max(err, _nan_head_err(got, want, head,
                                 "contiguous attention, NaN query head"))
    ensure(all(torch.equal(a, b) for a, b in zip(ck, cp)),
           "contiguous attention, NaN query head: caches differ")
    del ck, cp
    big = _int4_cache(dev, g, TIMING_LAYERS, B, Hkv, D, S)
    t = timings(rotating(lambda j: KV.int4_decode_attention_self_append(
                    q, *big, j, *rest, int8_qk=True), TIMING_LAYERS),
                rotating(lambda j: KV.self_append_plain(
                    q, *big, j, *rest, int8_qk=True), TIMING_LAYERS))
    del big
    tokens = sum(CONTIG_LENGTHS)
    nbytes = (tokens * Hkv * 2 * (D // 2 + 8)                   # cached k, v
              + 2 * B * Hq * D * 2                              # q, out
              + 2 * B * Hkv * D * 4 + 2 * B * Hkv * (D // 2 + 8)  # new token
              + 2 * B * Hkv * (D // 2 + 8) + B * 4)             # append, lengths
    b, by = bound_ms(nbytes, 2.0 * 2 * tokens * Hq * D, "int8")
    return {"name": "int4_decode_attention_self_append", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/contiguous_attention.cu",
            "replaces": "rsq_tpu/kernels/kv_cache.py:695",
            "max_abs_err": err, **t, "bound_ms": b, "bound_by": by,
            "unit": "one decode layer, B=8, S=1024, lengths "
                    + ",".join(map(str, CONTIG_LENGTHS)) + ", int8_qk",
            "check": "out within 4*2^-8 rel + 2e-3 of the plain version, "
                     "int8_qk on and off, also on a poisoned cache; caches "
                     "bit-equal after the append; a query with a NaN head "
                     "under int8_qk: NaN in that head alone"}


def _bf16_cache(dev, g, L, B, H, S, D):
    return [torch.randn((L, B, H, S, D), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2)]


def _bf16_attn_err(got, want, lengths, what):
    """out within 4 bf16 units + 2e-3 where l > 0 (bf16(p) against another
    running maximum, one bf16 rounding of out); m and l within 1e-5 rel
    (f32 sums in another order); a length-0 row -inf, 0 and 0/0.  Returns
    out's max error."""
    live = lengths > 0
    err = 0.0
    for i, (a, w, rtol, atol) in enumerate(zip(
            got, want, (4 * BF16_EPS, 1e-5, 1e-5), (2e-3, 0.0, 0.0))):
        a, w = a.float()[live], w.float()[live]
        e = (a - w).abs()
        if not bool((e <= rtol * w.abs() + atol).all()):
            raise AssertionError(f"bf16 attention {what} output {i}: max err "
                                 f"{float(e.max())}")
        err = max(err, float(e.max())) if i == 0 else err
    ensure(bool(torch.isnan(got[0][~live]).all())
           and bool((got[1][~live] == -math.inf).all())
           and bool((got[2][~live] == 0).all()),
           f"bf16 attention {what}: empty row")
    return err


def check_bf16_attention(dev, g, cfg):
    from rsq_tpu_torch.kernels import kv_cache as KV
    from rsq_tpu_torch.kernels.poison import poisoned, slots_live
    Hkv, D, Hq = cfg.num_key_value_heads, cfg.head_dim_, cfg.num_attention_heads
    L, B, S = 2, len(CONTIG_LENGTHS), 1024
    G = Hq // Hkv
    k, v = _bf16_cache(dev, g, L, B, Hkv, S, D)
    q = (torch.randn((B, Hq, D), generator=g, device=dev) * 2).to(
        torch.bfloat16)
    lengths = torch.tensor(CONTIG_LENGTHS, dtype=torch.int32, device=dev)
    got = KV.bf16_decode_attention_stacked(q, k, v, L - 1, lengths)
    want = KV.bf16_decode_attention_plain(q, k, v, L - 1, lengths)
    torch.cuda.synchronize()
    err = _bf16_attn_err(got, want, lengths, "")
    # every cache value at or past a row's length NaN: the same bits as on
    # the clean cache (nothing there is read)
    live = slots_live(lengths, S).transpose(-1, -2)       # (1, B, 1, S, 1)
    kb, vb = poisoned([k, v], live)
    bad = KV.bf16_decode_attention_stacked(q, kb, vb, L - 1, lengths)
    torch.cuda.synchronize()
    for a, b in zip(got, bad):
        ensure(torch.equal(bits(a), bits(b)),
               "bf16 attention: poisoned cache changes the output")
    del kb, vb
    # every row at S - 1: each block of the cluster full
    full = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    err = max(err, _bf16_attn_err(
        KV.bf16_decode_attention_stacked(q, k, v, L - 1, full),
        KV.bf16_decode_attention_plain(q, k, v, L - 1, full), full,
        "at lengths S - 1"))
    # a query row with a NaN: NaN in its out, m and l alone, as in the
    # plain version (the empty row's out is 0/0 in both)
    qn, head = _nan_head(q)
    got_n = KV.bf16_decode_attention_stacked(qn, k, v, L - 1, lengths)
    want_n = KV.bf16_decode_attention_plain(qn, k, v, L - 1, lengths)
    row = head[:, :, 0].reshape(B, Hkv, G)
    empty = (lengths == 0)[:, None, None].expand(head.shape)
    for i, (a, w, nan) in enumerate(zip(got_n, want_n, (head, row, row))):
        ensure(torch.equal(torch.isnan(w), nan | empty if i == 0 else nan)
               and torch.equal(torch.isnan(a), torch.isnan(w)),
               f"bf16 attention output {i}: NaN pattern differs from the "
               "query's NaN row")
    err = max(err, _bf16_attn_err(
        *[[torch.where(nan, 0.0, t.float()) for t, nan in zip(
            res, (head, row, row))] for res in (got_n, want_n)],
        lengths, "with a NaN query row"))
    del k, v
    kb, vb = _bf16_cache(dev, g, TIMING_LAYERS, B, Hkv, S, D)
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]   # (B,1,1,S)
    q4 = q[:, :, None, :]                                         # (B,Hq,1,D)
    t = timings(
        rotating(lambda j: KV.bf16_decode_attention_stacked(
            q, kb, vb, j, lengths), TIMING_LAYERS),
        rotating(lambda j: KV.bf16_decode_attention_plain(
            q, kb, vb, j, lengths), TIMING_LAYERS),
        rotating(lambda j: torch.nn.functional.scaled_dot_product_attention(
            q4, kb[j], vb[j], attn_mask=mask, enable_gqa=True),
            TIMING_LAYERS))
    del kb, vb
    tokens = sum(CONTIG_LENGTHS)
    nbytes = (tokens * Hkv * D * 2 * 2 + 2 * B * Hq * D * 2
              + 2 * B * Hkv * G * 4 + B * 4)
    b, by = bound_ms(nbytes, 2.0 * 2 * tokens * Hq * D, "bf16")
    return {"name": "bf16_decode_attention_stacked", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/bf16_attention.cu",
            "replaces": "rsq_tpu/kernels/kv_cache.py:849",
            "max_abs_err": err, **t, "bound_ms": b, "bound_by": by,
            "library": "scaled_dot_product_attention (GQA, length mask)",
            "unit": "one decode layer, B=8, S=1024, lengths "
                    + ",".join(map(str, CONTIG_LENGTHS)),
            "cluster": KV.bf16_attention_cluster(S),
            "check": "out within 4*2^-8 rel + 2e-3 where l > 0, m and l "
                     "within 1e-5 rel; length-0 row -inf, 0, 0/0; also at "
                     "lengths all S - 1; bit-equal on a cache poisoned at "
                     "and past each length; a query row with a NaN gives "
                     "NaN in its out, m and l alone"}


def check_bf16_append(dev, g, cfg):
    from rsq_tpu_torch.kernels import kv_cache as KV
    H, D = cfg.num_key_value_heads, cfg.head_dim_
    L, B, S = 2, len(CONTIG_LENGTHS), 1024
    k, v = _bf16_cache(dev, g, L, B, H, S, D)
    pos = torch.tensor(CONTIG_LENGTHS, dtype=torch.int32, device=dev)
    # contiguous nk/nv, then the decode step's strided ones: the roped key
    # qk[:, :, Hq:].transpose(1, 2) of (B, 1, Hq + H, D), and v's view
    Hq = cfg.num_attention_heads
    qk = torch.randn((B, 1, Hq + H, D), generator=g, device=dev).to(
        torch.bfloat16)
    vb = torch.randn((B, 1, H * D), generator=g, device=dev).to(
        torch.bfloat16).reshape(B, 1, H, D).transpose(1, 2)
    err = 0.0
    for nk, nv in ((qk[:, :, Hq:].transpose(1, 2).contiguous(),
                    vb.contiguous()), (qk[:, :, Hq:].transpose(1, 2), vb)):
        kp, vp = k.clone(), v.clone()
        KV.kv_append_stacked_bf16(k, v, L - 1, pos, nk, nv)
        KV.kv_append_bf16_plain(kp, vp, L - 1, pos, nk, nv)
        torch.cuda.synchronize()
        ensure(torch.equal(k, kp) and torch.equal(v, vp),
               "bf16 append: caches differ from the plain version")
        err = max([err] + [float((a.float() - b.float()).abs().max())
                           for a, b in ((k, kp), (v, vp))])
        del kp, vp
    ensure(not nk.is_contiguous(), "bf16 append: nk should be strided")
    rows, p64 = torch.arange(B, device=dev), pos.long()

    def library(i=0):
        k[L - 1, rows, :, p64] = nk[:, :, 0]
        v[L - 1, rows, :, p64] = nv[:, :, 0]

    t = timings(lambda i=0: KV.kv_append_stacked_bf16(k, v, L - 1, pos, nk, nv),
                lambda i=0: KV.kv_append_bf16_plain(k, v, L - 1, pos, nk, nv),
                library)
    b, by = bound_ms(4 * B * H * D * 2 + B * 4, 0.0, "bf16")
    return {"name": "kv_append_stacked_bf16", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/bf16_attention.cu",
            "replaces": "rsq_tpu/kernels/kv_cache.py:937",
            "max_abs_err": err, **t, "bound_ms": b, "bound_by": by,
            "library": "indexed assignment k[layer, b_idx, :, pos] = ...",
            "unit": "one decode layer, B=8, S=1024, the decode step's "
                    "strided nk",
            "check": "whole caches bit-equal to the plain version, with "
                     "contiguous and with strided nk/nv"}


# M of the dense bf16 checks: decode (batch 8), the engine's prefill
# buckets and the per-layer prefill (8 prompts of 512)
W16_MS = (8, 128, 512, 1024, 4096)
# M of the stacked weight-only checks (rows 13, 14): the same
W4_MS = W16_MS


def check_w16(dev, g, cfg):
    """The unfused Llama-3-8B products at decode (M=8) and at prefill (M =
    128, 512, 1024 -- the engine's buckets -- and 4096, the per-layer
    prefill), each beside torch.matmul.  The top-level times are one
    decode layer's seven products: q, k, v, o, up, gate, down."""
    from rsq_tpu_torch.kernels import matmul_w4 as MW
    d, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {"q|o": (d, cfg.q_dim, 2), "k|v": (d, cfg.kv_dim, 2),
              "up|gate": (d, f, 2), "down": (f, d, 1)}
    cases, err = [], 0.0
    for name, (K, N, uses) in shapes.items():
        copies = max(2, -(-128 * 2**20 // (K * N * 2)))   # > the L2 per loop
        w = torch.randn((copies, K, N), generator=g, device=dev).to(
            torch.bfloat16) * (1.0 / math.sqrt(K))
        for M in W16_MS:
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            got = MW.w16_matmul_stacked(x, w, 1)
            want = MW.w16_matmul_stacked_plain(x, w, 1, torch.bfloat16)
            torch.cuda.synchronize()
            err = max(err, matmul_err(got, want, f"w16 {name} M={M}"))
            again = MW.w16_matmul_stacked(x, w, 1)
            ensure(torch.equal(bits(got), bits(again)),
                   f"w16 {name} M={M}: two calls differ")
            del got, want, again
            t = timings(
                rotating(lambda j: MW.w16_matmul_stacked(x, w, j), copies),
                rotating(lambda j: MW.w16_matmul_stacked_plain(
                    x, w, j, torch.bfloat16), copies),
                rotating(lambda j: torch.matmul(x, w[j]), copies))
            b, by = bound_ms(M * K * 2 + K * N * 2 + M * N * 2,
                             2.0 * M * K * N, "bf16")
            cases.append({"proj": name, "M": M, "K": K, "N": N,
                          "per_layer": uses, **t, "bound_ms": b,
                          "bound_by": by,
                          "vs_library": t["device_ms"] / t["library_ms"]})
            del x
        del w
    dec = [c for c in cases if c["M"] == 8]
    total = {k: sum(c[k] * c["per_layer"] for c in dec)
             for k in ("ms", "device_ms", "plain_ms", "library_ms",
                       "bound_ms")}
    return {"name": "w16_matmul_stacked", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/w16_matmul.cu",
            "replaces": "rsq_tpu/kernels/matmul_w4.py:822",
            "max_abs_err": err, **total,
            "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in dec)
            else "operations",
            "library": "torch.matmul(x, w_all[i])",
            "unit": "one decode layer: q, k, v, o, up, gate, down at M=8",
            "check": "|err| <= 2^-7 |plain| + 1e-5 max|plain|, M in "
                     + ", ".join(map(str, W16_MS)) + "; two calls bit-equal",
            "cases": cases}


def _planes(wp):
    """Packed bytes (..., K, Nh) -> the two nibble planes as f32 (..., K, 2Nh)."""
    w = wp.to(torch.int32)
    return torch.cat([(w << 28) >> 28, (w << 24) >> 28], dim=-1).float()


def _w4_cases(dev, g, shapes, run, plain, scales, scale_bytes, ms=ENGINE_MS):
    """The weight-only kernels at each M of `ms` on each (K, Nh, calls per
    layer) shape, against the plain version (matmul_err) and timed,
    with torch.matmul of x and the bf16 dequantized weights as the library
    yardstick.  run/plain(x, wp, s, j) call the
    wrapper and its plain version on layer j; scales(L, K, Nh) returns the
    scale operand s and deq(planes, s, j), layer j's dense weights;
    scale_bytes(M, Nh) is what the function reads besides x and the
    weights.  Returns (cases, max error)."""
    cases, err = [], 0.0
    for name, (K, Nh, uses) in shapes.items():
        copies = max(2, -(-128 * 2**20 // (K * Nh)))      # > the L2 per loop
        wp = torch.randint(0, 256, (copies, K, Nh), dtype=torch.uint8,
                           generator=g, device=dev)
        s, deq = scales(copies, K, Nh)
        lib_copies = max(2, -(-128 * 2**20 // (K * Nh * 4)))
        w_deq = [deq(_planes(wp[j]), s, j).to(torch.bfloat16)
                 for j in range(lib_copies)]
        for M in ms:
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            got, want = run(x, wp, s, 1), plain(x, wp, s, 1)
            torch.cuda.synchronize()
            err = max(err, matmul_err(got, want, f"{name} M={M}"))
            again = run(x, wp, s, 1)
            ensure(torch.equal(bits(got), bits(again)),
                   f"{name} M={M}: two calls differ")
            del got, want, again
            t = timings(rotating(lambda j: run(x, wp, s, j), copies),
                        rotating(lambda j: plain(x, wp, s, j), copies),
                        rotating(lambda j: torch.matmul(x, w_deq[j]),
                                 lib_copies))
            nbytes = M * K * 2 + K * Nh + scale_bytes(M, Nh) + M * 2 * Nh * 2
            b, by = bound_ms(nbytes, 2.0 * M * K * 2 * Nh, "bf16")
            cases.append({"proj": name, "M": M, "K": K, "Nh": Nh,
                          "per_layer": uses, **t, "bound_ms": b,
                          "bound_by": by,
                          "vs_library": t["device_ms"] / t["library_ms"]})
        del wp, w_deq
    return cases, err


def _layer_total(cases):
    dec = [c for c in cases if c["M"] == 8]
    return {**{k: sum(c[k] * c["per_layer"] for c in dec)
               for k in ("ms", "device_ms", "plain_ms", "library_ms",
                         "bound_ms")},
            "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in dec)
            else "operations"}


def check_w4(dev, g, cfg):
    """Row 13 on the fused plane-major projections of configuration (C),
    at decode (M=8) and the largest prefill bucket (M=1024).  The
    top-level times are one decode layer's four calls."""
    from rsq_tpu_torch.kernels import matmul_w4 as MW
    d, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {"qkv": (d, (cfg.q_dim + 2 * cfg.kv_dim) // 2, 1),
              "o": (cfg.q_dim, d // 2, 1), "upgate": (d, f, 1),
              "down": (f, d // 2, 1)}

    def scales(L, K, Nh):
        s2 = (torch.rand((L, 2, Nh), generator=g, device=dev) + 0.5) / (
            7 * math.sqrt(K))
        return s2, lambda planes, s, j: planes * s[j].reshape(1, 2 * Nh)

    cases, err = _w4_cases(
        dev, g, shapes,
        lambda x, wp, s, j: MW.w4_matmul_paired_stacked(x, wp, s[j], j),
        lambda x, wp, s, j: MW.w4_matmul_paired_stacked_plain(x, wp, s[j], j),
        scales, lambda M, Nh: 2 * Nh * 4,            # the paired scales
        ms=W4_MS)
    return {"name": "w4_matmul_paired_stacked", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/w4_matmul.cu",
            "replaces": "rsq_tpu/kernels/matmul_w4.py:665",
            "max_abs_err": err, **_layer_total(cases),
            "library": "torch.matmul(x, bf16 dequantized weights)",
            "unit": "one decode layer: qkv, o, upgate, down at M=8",
            "check": "|err| <= 2^-7 |plain| + 1e-5 max|plain|, M in "
                     + ", ".join(map(str, W4_MS)) + "; two calls bit-equal",
            "cases": cases}


def check_w4_affine(dev, g, cfg):
    """Row 14 on the seven unfused projections of configuration (D) (four
    shapes), at M=8 and M=1024.  The top-level times are one decode
    layer's seven calls."""
    from rsq_tpu_torch.kernels import matmul_w4 as MW
    d, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {"q|o": (d, cfg.q_dim // 2, 2), "k|v": (d, cfg.kv_dim // 2, 2),
              "up|gate": (d, f // 2, 2), "down": (f, d // 2, 1)}

    def scales(L, K, Nh):
        sh = (torch.rand((L,), generator=g, device=dev) * 0.4 + 0.6) / (
            2 * math.sqrt(K))
        return sh, lambda planes, s, j: (planes + 0.5) * s[j]

    cases, err = _w4_cases(
        dev, g, shapes,
        lambda x, wp, s, j: MW.w4_affine_matmul_stacked(x, wp, s, j,
                                                        plane_major=True),
        lambda x, wp, s, j: MW.w4_affine_matmul_stacked_plain(
            x, wp, s, j).reshape(x.shape[0], -1),
        scales, lambda M, Nh: 4 + M * 4,             # sh and the row sums
        ms=W4_MS)
    return {"name": "w4_affine_matmul_stacked", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/w4_matmul.cu",
            "replaces": "rsq_tpu/kernels/matmul_w4.py:747",
            "max_abs_err": err, **_layer_total(cases),
            "library": "torch.matmul(x, bf16 dequantized weights)",
            "unit": "one decode layer: q, k, v, o, up, gate, down at M=8",
            "check": "|err| <= 2^-7 |plain| + 1e-5 max|plain|, M in "
                     + ", ".join(map(str, W4_MS)) + "; two calls bit-equal",
            "cases": cases}


def check_w4_head(dev, g, cfg):
    """Row 8, the int4 lm_head, at M=8 and M=1 (the kernel of row 13 on an
    L = 1 view)."""
    from rsq_tpu_torch.kernels import matmul_w4 as MW
    K, N = cfg.hidden_size, cfg.vocab_size
    wp = torch.randint(0, 256, (K, N // 2), dtype=torch.uint8, generator=g,
                       device=dev)
    scale = (torch.rand((N,), generator=g, device=dev) + 0.5) / (
        7 * math.sqrt(K))
    w_deq = (MW.unpack_w4_planar(wp).float() * scale).to(torch.bfloat16)
    cases, err = _head_cases(dev, g, K, N,
                             lambda x: MW.w4_matmul(x, wp, scale),
                             lambda x: MW.w4_matmul_plain(x, wp, scale),
                             w_deq, K * N // 2)
    del w_deq
    return {"name": "w4_matmul", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/w4_matmul.cu",
            "replaces": "rsq_tpu/kernels/matmul_w4.py:143",
            "max_abs_err": err, **_head_entry(cases),
            "library": "torch.matmul(x, bf16 dequantized weights)",
            "unit": f"int4 lm_head (8, {K}) x ({K}, {N})",
            "check": "|err| <= 2^-7 |plain| + 1e-5 max|plain|, M in (8, 1)",
            "cases": cases}


def check_w4_paired(dev, g, cfg):
    """Row 9, the unstacked weight-only matmul of the per-layer W4 path (row
    13's kernel on the L = 1 view), on the same fused shapes."""
    from rsq_tpu_torch.kernels import matmul_w4 as MW
    d, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {"qkv": (d, (cfg.q_dim + 2 * cfg.kv_dim) // 2, 1),
              "o": (cfg.q_dim, d // 2, 1), "upgate": (d, f, 1),
              "down": (f, d // 2, 1)}

    def scales(L, K, Nh):
        s2 = (torch.rand((L, 2, Nh), generator=g, device=dev) + 0.5) / (
            7 * math.sqrt(K))
        return s2, lambda planes, s, j: planes * s[j].reshape(1, 2 * Nh)

    cases, err = _w4_cases(
        dev, g, shapes,
        lambda x, wp, s, j: MW.w4_matmul_paired(x, wp[j], s[j]),
        lambda x, wp, s, j: MW.w4_matmul_paired_plain(x, wp[j], s[j]),
        scales, lambda M, Nh: 2 * Nh * 4,            # the paired scales
        ms=layer_ms())
    return {"name": "w4_matmul_paired", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/w4_matmul.cu",
            "replaces": "rsq_tpu/kernels/matmul_w4.py:190",
            "max_abs_err": err, **_layer_total(cases),
            "library": "torch.matmul(x, bf16 dequantized weights)",
            "unit": "one decode layer: qkv, o, upgate, down at M=8",
            "check": "|err| <= 2^-7 |plain| + 1e-5 max|plain|, "
                     f"M in {layer_ms()}; two calls bit-equal",
            "cases": cases}


def check_w4_affine_unstacked(dev, g, cfg):
    """Row 10, the unstacked affine matmul of the per-layer E8P path (row
    14's kernel on the L = 1 view, sh a 0-d tensor on the card)."""
    from rsq_tpu_torch.kernels import matmul_w4 as MW
    d, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {"q|o": (d, cfg.q_dim // 2, 2), "k|v": (d, cfg.kv_dim // 2, 2),
              "up|gate": (d, f // 2, 2), "down": (f, d // 2, 1)}

    def scales(L, K, Nh):
        sh = (torch.rand((L,), generator=g, device=dev) * 0.4 + 0.6) / (
            2 * math.sqrt(K))
        return sh, lambda planes, s, j: (planes + 0.5) * s[j]

    cases, err = _w4_cases(
        dev, g, shapes,
        lambda x, wp, s, j: MW.w4_affine_matmul(x, wp[j], s[j],
                                                plane_major=True),
        lambda x, wp, s, j: MW.w4_affine_matmul_plain(
            x, wp[j], s[j]).reshape(x.shape[0], -1),
        scales, lambda M, Nh: 4 + M * 4,             # sh and the row sums
        ms=layer_ms())
    return {"name": "w4_affine_matmul", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/w4_matmul.cu",
            "replaces": "rsq_tpu/kernels/matmul_w4.py:269",
            "max_abs_err": err, **_layer_total(cases),
            "library": "torch.matmul(x, bf16 dequantized weights)",
            "unit": "one decode layer: q, k, v, o, up, gate, down at M=8",
            "check": "|err| <= 2^-7 |plain| + 1e-5 max|plain|, "
                     f"M in {layer_ms()}; two calls bit-equal",
            "cases": cases}


def _attn_err(got, want, what):
    """The attention kernels' check: f32 sums in another order over a tiled
    online softmax, then one bf16 rounding: within 4 bf16 rounding units +
    2e-3 of the plain version.  Returns the max error."""
    e = (got.float() - want.float()).abs()
    if not bool((e <= 4 * BF16_EPS * want.float().abs() + 2e-3).all()):
        raise AssertionError(f"{what}: max err {float(e.max())}")
    return float(e.max())


def _nan_head(q):
    """q with a NaN at (0, 5, 17) (at Llama-3-8B widths kv head 1, query
    row 1), and the mask of that query head."""
    h, d = min(5, q.shape[1] - 1), min(17, q.shape[2] - 1)
    qn = q.clone()
    qn[0, h, d] = math.nan
    head = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    head[0, h] = True
    return qn, head


def _nan_head_err(got, want, head, what):
    """A query with a NaN head under int8_qk: NaN in that head alone, in
    the kernel's output as in the plain version's; the other heads by
    _attn_err.  Returns their max error."""
    ensure(torch.equal(torch.isnan(want), head)
           and torch.equal(torch.isnan(got), head),
           f"{what}: NaN pattern differs from the query's NaN head")
    return _attn_err(got[~head], want[~head], what)


def _self_token(KV, dev, g, B, Hkv, D):
    """The new token's dequantized (k_self, v_self), (B, Hkv, D) f32."""
    return tuple(KV.unpack_dequant_head(*KV.asym_quant_pack_head(
        torch.randn((B, Hkv, D), generator=g, device=dev))) for _ in range(2))


def check_decode_attention(dev, g, cfg, fold=False):
    """Row 2 (fold False), the read-only contiguous attention of the
    per-layer path, or row 3 (fold True), the same with the new token
    folded in, which no serving path runs (none of the reference's does):
    at row 4's shapes (B=8, S=1024, CONTIG_LENGTHS, the length-0 row
    included), default QK as the path runs it, and int8_qk, against the
    plain version, and bit-equal on a poisoned cache; row 2 also m and l.
    The cache is only read."""
    from rsq_tpu_torch.kernels import kv_cache as KV
    from rsq_tpu_torch.kernels.poison import poisoned, slots_live
    Hkv, D, Hq = cfg.num_key_value_heads, cfg.head_dim_, cfg.num_attention_heads
    G = Hq // Hkv
    L, B, S = 2, len(CONTIG_LENGTHS), 1024
    cache = _int4_cache(dev, g, L, B, Hkv, D, S)
    before = [t.clone() for t in cache]
    lengths = torch.tensor(CONTIG_LENGTHS, dtype=torch.int32, device=dev)
    live = lengths > 0
    q = (torch.randn((B, Hq, D), generator=g, device=dev) * 2).to(
        torch.bfloat16)
    selfs = _self_token(KV, dev, g, B, Hkv, D) if fold else ()
    kernel = (KV.int4_decode_attention_stacked_self if fold
              else KV.int4_decode_attention_stacked)
    plain = KV.decode_attention_self_plain if fold else KV.decode_attention_plain
    what = "decode attention" + (" self" if fold else "")
    bad_cache = poisoned(cache, slots_live(lengths, S))
    err = 0.0
    for int8_qk in (False, True):
        got, bad, want = (
            [r] if fold else list(r)
            for r in (kernel(q, *cache, L - 1, lengths, *selfs, int8_qk=int8_qk),
                      kernel(q, *bad_cache, L - 1, lengths, *selfs,
                             int8_qk=int8_qk),
                      plain(q, *cache, L - 1, lengths, *selfs, int8_qk=int8_qk)))
        torch.cuda.synchronize()
        # row 3's length-0 row is v_self; row 2's is checked below
        rows = slice(None) if fold else live
        err = max(err, _attn_err(got[0][rows], want[0][rows],
                                 f"{what} int8_qk={int8_qk}"))
        ensure(all(torch.equal(bits(a), bits(b)) for a, b in zip(bad, got)),
               f"{what} on the poisoned cache differs")
        if fold:
            continue
        # m, l: f32 sums in another order; a logit is a difference of two
        # products, so 1e-5 relative + 1e-5
        for a, w in zip(got[1:], want[1:]):
            e = (a[live] - w[live]).abs()
            ensure(bool((e <= 1e-5 * w[live].abs() + 1e-5).all()),
                   f"decode attention m/l: max err {float(e.max())}")
        ensure(bool(torch.isnan(got[0][~live]).all())
               and bool((got[1][~live] == -math.inf).all())
               and bool((got[2][~live] == 0).all()),
               "decode attention length-0 row")
    # a query with a NaN head under int8_qk: NaN in that head alone (rows
    # of length 0 aside); row 2's m and l NaN in that head's entry alone
    qn, head = _nan_head(q)
    got, want = ([r] if fold else list(r)
                 for r in (kernel(qn, *cache, L - 1, lengths, *selfs,
                                  int8_qk=True),
                           plain(qn, *cache, L - 1, lengths, *selfs,
                                 int8_qk=True)))
    rows = slice(None) if fold else live
    err = max(err, _nan_head_err(got[0][rows], want[0][rows], head[rows],
                                 f"{what}, NaN query head"))
    ml = head.any(-1).reshape(B, Hkv, G)[live]
    for a, w in zip(got[1:], want[1:]):
        ensure(torch.equal(torch.isnan(a[live]), ml)
               and torch.equal(torch.isnan(w[live]), ml),
               "decode attention m/l, NaN query head: NaN pattern differs")
        e = (a[live][~ml] - w[live][~ml]).abs()
        ensure(bool((e <= 1e-5 * w[live][~ml].abs() + 1e-5).all()),
               f"decode attention m/l, NaN query head: max err "
               f"{float(e.max())}")
    ensure(all(torch.equal(a, b) for a, b in zip(cache, before)),
           f"{what} wrote the cache")
    del cache, before, bad_cache
    big = _int4_cache(dev, g, TIMING_LAYERS, B, Hkv, D, S)
    t = timings(rotating(lambda j: kernel(q, *big, j, lengths, *selfs),
                         TIMING_LAYERS),
                rotating(lambda j: plain(q, *big, j, lengths, *selfs),
                         TIMING_LAYERS))
    del big
    tokens = sum(CONTIG_LENGTHS)
    nbytes = (tokens * Hkv * 2 * (D // 2 + 8)                   # cached k, v
              + 2 * B * Hq * D * 2 + B * 4                      # q, out, lengths
              + (2 * B * Hkv * D * 4 if fold                    # k_self, v_self
                 else 2 * B * Hkv * G * 4))                     # m, l
    b, by = bound_ms(nbytes, 2.0 * 2 * tokens * Hq * D, "bf16")
    common = {"max_abs_err": err, **t, "bound_ms": b, "bound_by": by,
              "unit": "one decode layer, B=8, S=1024, lengths "
                      + ",".join(map(str, CONTIG_LENGTHS)) + ", bf16 QK"}
    if fold:
        return {"name": "int4_decode_attention_stacked_self", "route": "cuda",
                "source": "rsq_tpu_torch/csrc/contiguous_attention.cu",
                "replaces": "rsq_tpu/kernels/kv_cache.py:580", **common,
                "path": "none: no serving path of rsq_tpu runs it",
                "check": "out within 4*2^-8 rel + 2e-3 of the plain version "
                         "(the length-0 row: v_self), int8_qk off and on; "
                         "cache unchanged; on a poisoned cache out bit-equal "
                         "to the clean run; a query with a NaN head under "
                         "int8_qk: NaN in that head alone"}
    return {"name": "int4_decode_attention_stacked", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/contiguous_attention.cu",
            "replaces": "rsq_tpu/kernels/kv_cache.py:497", **common,
            "check": "out within 4*2^-8 rel + 2e-3 where the length is not "
                     "0, m and l within 1e-5 rel + 1e-5, int8_qk off and "
                     "on; length-0 row NaN, -inf, 0; cache unchanged; on a "
                     "poisoned cache out, m, l bit-equal to the clean run; "
                     "a query with a NaN head under int8_qk: NaN in that "
                     "head's out, m and l alone"}


# one decode layer of the paged phases: 8 rows of 300-700 tokens
PAGED_LENGTHS = [300, 400, 480, 511, 512, 600, 700, 595]


def _paged_pool(dev, g, L, Hkv, D, page, lengths):
    """A pool holding each row's pages in no pool order: (pool list,
    page table (B, NP))."""
    B = len(lengths)
    NP = -(-max(lengths) // page)
    P = B * NP + 1
    pool = _int4_cache(dev, g, L, P, Hkv, D, page)
    perm = torch.randperm(P - 1, generator=g, device=dev).to(torch.int32) + 1
    return pool, perm.reshape(B, NP)


def check_paged_read_only(dev, g, cfg, fold=False):
    """Row 17 (fold False), the read-only paged attention of the page-16
    path, at pages 16 (the main path: a 128-token tile spans 8 pages) and
    64; or row 18 (fold True), the same with the new token folded in, which
    no serving path runs, at pages 16 and 512.  Over tables in no pool
    order, default QK and int8_qk, on a clean and a poisoned pool; the
    top-level times are page 16's."""
    from rsq_tpu_torch.kernels import kv_cache as KV
    from rsq_tpu_torch.kernels import paged_kv as PKV
    from rsq_tpu_torch.kernels.poison import pages_live, poisoned
    Hkv, D, Hq = cfg.num_key_value_heads, cfg.head_dim_, cfg.num_attention_heads
    B = len(PAGED_LENGTHS)
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    q = (torch.randn((B, Hq, D), generator=g, device=dev) * 2).to(
        torch.bfloat16)
    selfs = _self_token(KV, dev, g, B, Hkv, D) if fold else ()
    kernel = (PKV.int4_paged_decode_attention_stacked_self if fold
              else PKV.int4_paged_decode_attention_stacked)
    plain = PKV.paged_read_self_plain if fold else PKV.paged_read_plain
    what = "paged read" + (" self" if fold else "")
    tokens = sum(PAGED_LENGTHS)
    cases, err = [], 0.0
    for page in (16, 512) if fold else (16, 64):
        pool, ptab = _paged_pool(dev, g, TIMING_LAYERS, Hkv, D, page,
                                 PAGED_LENGTHS)
        before = [t.clone() for t in pool]
        bad_pool = poisoned(pool, pages_live(ptab, lengths, pool[0].shape[1],
                                             page))
        for int8_qk in (False, True):
            got = kernel(q, *pool, 1, ptab, lengths, *selfs, int8_qk=int8_qk)
            bad = kernel(q, *bad_pool, 1, ptab, lengths, *selfs,
                         int8_qk=int8_qk)
            want = plain(q, *pool, 1, ptab, lengths, *selfs, int8_qk=int8_qk)
            torch.cuda.synchronize()
            err = max(err, _attn_err(got, want, f"{what} page {page} "
                                                f"int8_qk={int8_qk}"),
                      _attn_err(bad, want, f"{what} page {page} "
                                           f"int8_qk={int8_qk}, poisoned"))
        qn, head = _nan_head(q)
        err = max(err, _nan_head_err(
            kernel(qn, *pool, 1, ptab, lengths, *selfs, int8_qk=True),
            plain(qn, *pool, 1, ptab, lengths, *selfs, int8_qk=True), head,
            f"{what} page {page}, NaN query head"))
        ensure(all(torch.equal(a, b) for a, b in zip(pool, before)),
               f"{what} wrote the pool")
        del before, bad_pool
        t = timings(rotating(lambda j: kernel(q, *pool, j, ptab, lengths,
                                              *selfs), TIMING_LAYERS),
                    rotating(lambda j: plain(q, *pool, j, ptab, lengths,
                                             *selfs), TIMING_LAYERS))
        nbytes = (tokens * Hkv * 2 * (D // 2 + 8) + 2 * B * Hq * D * 2
                  + (2 * B * Hkv * D * 4 if fold else 0)        # k/v_self
                  + ptab.numel() * 4 + B * 4)
        b, by = bound_ms(nbytes, 2.0 * 2 * tokens * Hq * D, "bf16")
        cases.append({"page": page, **t, "bound_ms": b, "bound_by": by})
        del pool
    common = {"max_abs_err": err,
              **{k: cases[0][k] for k in ("ms", "device_ms", "plain_ms",
                                          "bound_ms", "bound_by")},
              "library_ms": None,
              "unit": "one decode layer, B=8, page 16, lengths "
                      + ",".join(map(str, PAGED_LENGTHS)) + ", bf16 QK",
              "check": "out within 4*2^-8 rel + 2e-3, pages "
                       + " and ".join(str(c["page"]) for c in cases)
                       + ", int8_qk off and on, also on a poisoned pool; "
                         "pool unchanged; a query with a NaN head under "
                         "int8_qk: NaN in that head alone",
              "cases": cases}
    if fold:
        return {"name": "int4_paged_decode_attention_stacked_self",
                "route": "cuda", "source": "rsq_tpu_torch/csrc/paged_attention.cu",
                "replaces": "rsq_tpu/kernels/paged_kv.py:324", **common,
                "path": "none: no serving path of rsq_tpu runs it"}
    return {"name": "int4_paged_decode_attention_stacked", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/paged_attention.cu",
            "replaces": "rsq_tpu/kernels/paged_kv.py:283", **common}


def check_kv_append(dev, g, cfg):
    """Row 7, the contiguous INT4 append, at row 4's shapes (B=8, S=1024,
    positions CONTIG_LENGTHS: 0 and S - 1 included): caches bit-equal to
    the plain version's; timed with indexed assignment as the library
    call.  No serving path runs it."""
    from rsq_tpu_torch.kernels import kv_cache as KV
    H, D = cfg.num_key_value_heads, cfg.head_dim_
    L, B, S = 2, len(CONTIG_LENGTHS), 1024
    cache = _int4_cache(dev, g, L, B, H, D, S)
    pos = torch.tensor(CONTIG_LENGTHS, dtype=torch.int32, device=dev)
    new = []
    for _ in range(2):
        c, p = KV.asym_quant_pack_head(torch.randn((B, H, D), generator=g,
                                                   device=dev))
        new += [c[..., None], p[..., None]]              # lane-major (., 1)
    plain = [t.clone() for t in cache]
    KV.kv_append_stacked(*cache, L - 1, pos, *new)
    KV.kv_append_stacked_plain(*plain, L - 1, pos, *new)
    torch.cuda.synchronize()
    ensure(all(torch.equal(a, b) for a, b in zip(cache, plain)),
           "kv append: caches differ from the plain version")
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(cache, plain))
    del plain
    rows, p64 = torch.arange(B, device=dev), pos.long()

    def library(i=0):
        for arr, val in zip(cache, new):
            arr[L - 1, rows, :, :, p64] = val[..., 0]

    t = timings(lambda i=0: KV.kv_append_stacked(*cache, L - 1, pos, *new),
                lambda i=0: KV.kv_append_stacked_plain(*cache, L - 1, pos,
                                                       *new),
                library)
    b, by = bound_ms(2 * 2 * B * H * (D // 2 + 8) + B * 4, 0.0, "bf16")
    return {"name": "kv_append_stacked", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/contiguous_attention.cu",
            "replaces": "rsq_tpu/kernels/kv_cache.py:1005",
            "max_abs_err": err, **t, "bound_ms": b, "bound_by": by,
            "path": "none: no serving path of rsq_tpu runs it",
            "library": "indexed assignment cache[layer, b_idx, :, :, pos] = ...",
            "unit": "one decode layer, B=8, S=1024",
            "check": "whole caches bit-equal to the plain version"}


def check_paged_append(dev, g, cfg):
    """Row 21, the pool append of the page-16 path, at pages 16, 24 (not a
    power of two) and 512 (rows 0 and 1 share a page at different lanes):
    pools bit-equal to the plain version's; timed with indexed assignment
    as the library call.  The top-level times are page 16's."""
    from rsq_tpu_torch.kernels import kv_cache as KV
    from rsq_tpu_torch.kernels import paged_kv as PKV
    H, D = cfg.num_key_value_heads, cfg.head_dim_
    B, L = len(PAGED_LENGTHS), 2
    pos = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    nk, nv = (torch.randn((B, H, D), generator=g, device=dev)
              for _ in range(2))
    new = (*KV.asym_quant_pack_head(nk), *KV.asym_quant_pack_head(nv))
    cases, err = [], 0.0
    for page in (16, 24, 512):
        pool, ptab = _paged_pool(dev, g, L, H, D, page, PAGED_LENGTHS)
        # row 1 appends into row 0's page, at another lane
        ptab[1, PAGED_LENGTHS[1] // page] = ptab[0, PAGED_LENGTHS[0] // page]
        ensure(PAGED_LENGTHS[0] % page != PAGED_LENGTHS[1] % page)
        plain = [t.clone() for t in pool]
        PKV.paged_append_pool(*pool, L - 1, ptab, pos, *new)
        PKV.paged_append_plain(*plain, L - 1, ptab, pos, *new)
        torch.cuda.synchronize()
        ensure(all(torch.equal(a, b) for a, b in zip(pool, plain)),
               f"paged append page {page}: pools differ from the plain version")
        err = max(err, max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(pool, plain)))
        del plain
        slot = (pos.long() // page).clamp(max=ptab.shape[1] - 1)
        pid = ptab.long()[torch.arange(B, device=dev), slot]
        col = pos.long() % page

        def library(i=0):
            for arr, val in zip(pool, new):
                arr[L - 1, pid, :, :, col] = val

        t = timings(lambda i=0: PKV.paged_append_pool(*pool, L - 1, ptab, pos,
                                                      *new),
                    lambda i=0: PKV.paged_append_plain(*pool, L - 1, ptab,
                                                       pos, *new),
                    library)
        b, by = bound_ms(2 * 2 * B * H * (D // 2 + 8) + 2 * B * 4, 0.0, "bf16")
        cases.append({"page": page, **t, "bound_ms": b, "bound_by": by})
        del pool
    return {"name": "paged_append_pool", "route": "cuda",
            "source": "rsq_tpu_torch/csrc/paged_attention.cu",
            "replaces": "rsq_tpu/kernels/paged_kv.py:801",
            "max_abs_err": err,
            **{k: cases[0][k] for k in ("ms", "device_ms", "plain_ms",
                                        "library_ms", "bound_ms",
                                        "bound_by")},
            "library": "indexed assignment pool[layer, pid, :, :, col] = ...",
            "unit": "one decode layer, B=8, page 16",
            "check": "whole pools bit-equal to the plain version, pages 16, "
                     "24 and 512, two rows appending into one page",
            "cases": cases}


# ---------------------------------------------------------------------------
# Phase 4: a tiny model on the GPU against the same model on the CPU
# ---------------------------------------------------------------------------

def tiny_dense_model(cfg, seed=0):
    """Fake-quant tiny model in numpy (weights = int4 codes * scale)."""
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


def _compare_runs(gpu, cpu, uids, new_tokens, lmax, lrms):
    """Logits of each request's steps on the GPU and the CPU, up to and
    including the first step where the two pick different tokens (until
    then both saw the same tokens), within lmax (max) and lrms (rms) std of
    the logits.  Returns (steps compared, worst max error over the std)."""
    worst, compared = 0.0, 0
    for uid in uids:
        a, b = gpu[uid], cpu[uid]
        ensure(len(a.output) == len(b.output) == new_tokens, uid)
        for x, y, la, lb in zip(a.output, b.output, a.logit_trace,
                                b.logit_trace):
            sd = float(np.std(lb))
            e = np.abs(la - lb)
            ensure(np.isfinite(la).all())
            ensure(e.max() <= lmax * sd, (uid, e.max() / sd))
            ensure(np.sqrt(np.mean(e ** 2)) <= lrms * sd, uid)
            worst = max(worst, float(e.max() / sd))
            compared += 1
            if x != y:
                break
    return compared, worst


def tiny_e8p_quant(cfg, seed=0):
    """Random E8P quantizer entries for every projection of the tiny model:
    codes (N, K/8) and a per-tensor scale."""
    rng = np.random.default_rng(seed)
    d, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {"q": (d, cfg.q_dim), "k": (d, cfg.kv_dim), "v": (d, cfg.kv_dim),
              "o": (cfg.q_dim, d), "up": (d, f), "gate": (d, f),
              "down": (f, d)}
    return {f"layers.{i}.{n}": {
        "codes": rng.integers(0, 1 << 16, (nout, k // 8)).astype(np.int32),
        "scale": np.float32(rng.uniform(0.6, 1.0) / np.sqrt(k))}
        for i in range(cfg.num_layers) for n, (k, nout) in shapes.items()}


# the tiny configurations: (quantizers, lm_head bits, ServingConfig flags,
# logit tolerance in std of the logits); W4A4's is the reference's own
# jit-vs-eager spread (tests/test_torch_paged.py), the weight-only ones
# twice theirs (tests/test_torch_weight_only.py)
SMALL = {"W4A4": ("w4", 8, dict(a4=True), (LOGIT_MAX, LOGIT_RMS)),
         "W4A16": ("w4", 4, dict(a4=False), (0.06, 0.02)),
         "E8P": ("e8p", 8, dict(a4=False), (0.06, 0.02))}


def small_check(dev):
    """Three requests through two slots of each engine, on the GPU (kernels)
    and on the CPU (plain versions), in three configurations: W4A4 (A),
    W4A16 with an int4 head (C) and E8P (D), all INT4 KV with the online
    Hadamards: the paged engine (two requests share a full page) and the
    contiguous ServingEngine.  Until the first step where the two pick
    different tokens both saw the same tokens, so their logits must agree
    within the configuration's tolerance."""
    from rsq_tpu_torch import tree_to
    from rsq_tpu_torch.models.config import ModelConfig
    from rsq_tpu_torch.serving import model as S
    from rsq_tpu_torch.serving import params as SP
    from rsq_tpu_torch.serving.engine import ServingEngine
    from rsq_tpu_torch.serving.paged import PagedServingEngine
    cfg = ModelConfig.tiny()
    dense, quant = tiny_dense_model(cfg, seed=1)
    quants = {"w4": quant, "e8p": tiny_e8p_quant(cfg, seed=3)}
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.vocab_size, 128)
    prompts = [rng.integers(0, cfg.vocab_size, 40),
               np.concatenate([shared, rng.integers(0, cfg.vocab_size, 9)]),
               np.concatenate([shared, rng.integers(0, cfg.vocab_size, 30)])]
    out = {}
    for conf, (qname, bits, flags, (lmax, lrms)) in SMALL.items():
        sp = S.quantize_lm_head(S.stack_layer_params(SP.fuse_for_decode(
            SP.to_serving_params(dense, quants[qname], cfg, device="cpu"))),
            bits=bits)
        sc = S.ServingConfig(model=cfg, max_seq=256, attn_int8_qk=True,
                             **flags)
        for kind in ("paged", "paged16", "contiguous"):
            runs = []
            for d in ("cuda", "cpu"):
                if kind != "contiguous":
                    page = 128 if kind == "paged" else 16
                    eng = PagedServingEngine(tree_to(sp, d), sc, num_slots=2,
                                             page_size=page,
                                             record_logits=True, device=d)
                else:
                    eng = ServingEngine(tree_to(sp, d), sc, num_slots=2,
                                        record_logits=True, device=d)
                for p in prompts:
                    eng.add_request(p, max_new_tokens=4)
                runs.append({r.uid: r for r in eng.run_until_done(max_steps=50)})
            compared, worst = _compare_runs(*runs, (1, 2, 3), 4, lmax, lrms)
            if kind != "contiguous":
                ensure(runs[0][3].reused_pages == 128 // page)
                ensure(all(runs[0][u].reused_pages == runs[1][u].reused_pages
                           for u in (1, 2, 3)))
            out[f"{conf}_{kind}"] = {"logit_steps_compared": compared,
                                     "max_err_over_std": worst,
                                     "tolerance_over_std": lmax}
        # the per-layer entry points on unstacked params: prefill and
        # decode_step, and the paged oracles at page 16
        layers = S.unstack_layer_params(sp)
        for kind, run in (("layers", _greedy_layers),
                          ("paged16_oracles", _greedy_paged_oracles)):
            runs = [{1: run(tree_to(layers, d), sc, prompts[1], d)}
                    for d in ("cuda", "cpu")]
            compared, worst = _compare_runs(*runs, (1,), 4, lmax, lrms)
            out[f"{conf}_{kind}"] = {"logit_steps_compared": compared,
                                     "max_err_over_std": worst,
                                     "tolerance_over_std": lmax}
    return {"small": {"config": "tiny (2 layers, hidden 64, heads 4/2, "
                                "intermediate 112), INT4-KV; paged at pages "
                                "128 and 16, contiguous at max_seq 256, the "
                                "per-layer prefill/decode_step and the paged "
                                "oracles (page 16) on unstacked params; W4A4 "
                                "and E8P with an int8 lm_head, W4A16 int4",
                      **out}}


def _greedy_layers(params, sc, prompt, d):
    """prefill then 3 decode_steps of one request on unstacked params:
    its 4 tokens and the logits that chose them."""
    from rsq_tpu_torch.serving import model as S
    cache = S.init_cache(sc, 1, device=d)
    logits, cache = S.prefill(params, cache,
                              torch.as_tensor(prompt[None], device=d), sc)
    out = SimpleNamespace(output=[], logit_trace=[])
    for _ in range(4):
        out.logit_trace.append(logits[0].float().cpu().numpy())
        tok = torch.argmax(logits, dim=-1)
        out.output.append(int(tok[0]))
        logits, cache = S.decode_step(params, cache, tok, sc)
    return out


def _greedy_paged_oracles(params, sc, prompt, d, page=16):
    """prefill_paged then 3 decode_step_paged of one request at page 16."""
    from rsq_tpu_torch.kernels import paged_kv as PKV
    from rsq_tpu_torch.serving import paged as SPG
    cfg = sc.cfg
    npages = -(-(len(prompt) + 4) // page)
    pool = PKV.init_pool(cfg.num_layers, npages + 1, cfg.num_key_value_heads,
                         cfg.head_dim_, page, device=d)
    row = torch.arange(1, npages + 1, dtype=torch.int32)
    tail = np.zeros((1, -(-len(prompt) // page) * page), np.int64)
    tail[0, :len(prompt)] = prompt
    logits, pool = SPG.prefill_paged(params, pool, row.tolist(),
                                     torch.as_tensor(tail, device=d), sc, 0,
                                     0, len(prompt))
    logits = logits[None]
    ptab, lengths = row[None].to(d), torch.tensor([len(prompt)], device=d)
    out = SimpleNamespace(output=[], logit_trace=[])
    for _ in range(4):
        out.logit_trace.append(logits[0].float().cpu().numpy())
        tok = torch.argmax(logits, dim=-1)
        out.output.append(int(tok[0]))
        logits, pool = SPG.decode_step_paged(params, pool, ptab, lengths, tok,
                                             sc)
        lengths = lengths + 1
    return out


# ---------------------------------------------------------------------------
# The RSQ pipeline: on the card against the CPU (phase 4), at Llama-3-8B
# width (phase quantize)
# ---------------------------------------------------------------------------

def run_rsq_config(nsamples: int):
    """The run_rsq.sh configuration (tests/test_pipeline.py): rotate,
    attncon weighting with min 0.005 and max 1, GPTQ W4 sym with the MSE
    clip search, add_until_fail."""
    from rsq_tpu_torch.core.quant import WeightQuantConfig
    from rsq_tpu_torch.quantize.gptq import GPTQConfig
    from rsq_tpu_torch.quantize.pipeline import RSQConfig
    from rsq_tpu_torch.quantize.weighting import WeightingConfig
    return RSQConfig(w=WeightQuantConfig(bits=4, sym=True, mse=True),
                     rotate=True, nsamples=nsamples,
                     weighting=WeightingConfig(method="attncon",
                                               min_value=0.005, max_value=1.0),
                     gptq=GPTQConfig(add_until_fail=True))


def one_step_off(got, want, step) -> int:
    """Entries of got outside rtol 1e-4, atol 1e-5 of want (the bound of
    tests/test_gptq.py); each must be exactly one quantization step (its
    row's scale) off, a rounding tie decided the other way.  Returns their
    count."""
    off = ~torch.isclose(got, want, rtol=1e-4, atol=1e-5)
    rows = torch.nonzero(off)[:, 0]
    d = (got - want).abs()[off]
    ensure(bool(torch.isclose(d, step.reshape(-1)[rows], rtol=1e-4).all()),
           "a quantized weight off by more than a rounding tie")
    return int(off.sum())


def quantize_vs_cpu(dev, cfg, params, calib, rsq, on_cpu_state=False):
    """quantize_model on the CPU (plain versions), each GPTQ call recorded;
    then on the card, each call held against the CPU's at the same place on
    the same state: W within 1e-6 and H within 1e-5 of their largest
    entries, the card's own weights within rtol 1e-4, atol 1e-5 at >= 99.9%
    of all entries, every other entry exactly one step off.  The CPU's
    weights then go on, so a flipped tie does not move the next groups'
    Hessians (the ROADMAP holds logits on identical state for the same
    reason).  Then the same quantizer keys and bits, scales within 1e-5
    relative.  on_cpu_state: GPTQ on the card runs on the CPU's W and H
    (the other families: a call can be chaotic, as OPT's layer-0 o is in
    the reference, whose entries move by up to 2 steps under a 1e-7
    change of H; tests/test_torch_families.py).  Returns the counts."""
    from rsq_tpu_torch.quantize import pipeline as P
    ref = []

    def record(fn):
        def run(W, H, wq, cfg_, device):
            Q, info = fn(W, H, wq, cfg_, device=device)
            ref.append((W.clone(), H.clone(), Q, info["scale"]))
            return Q, info
        return run

    with mock.patch.object(P, "gptq_quantize", record(P.gptq_quantize)):
        _, want = P.quantize_model(params, cfg, rsq, calib, device="cpu")
    calls = iter(ref)
    n = {"calls": len(ref), "entries": 0, "one_step_off": 0,
         "max_h_err_over_max": 0.0}

    def forced(fn):
        def run(W, H, wq, cfg_, device):
            rW, rH, rQ, rs = next(calls)
            scale = float(rW.abs().max())
            ensure(float((W.cpu() - rW).abs().max()) <= 1e-6 * scale,
                   "quantize: the card's W differs from the CPU's")
            e = float((H.cpu() - rH).abs().max() / rH.abs().max())
            ensure(e <= 1e-5, f"quantize: Hessian differs by {e}")
            n["max_h_err_over_max"] = max(n["max_h_err_over_max"], e)
            if on_cpu_state:
                W, H = rW.to(device), rH.to(device)
            Q, info = fn(W, H, wq, cfg_, device=device)
            ensure(Q.device.type == "cuda", "GPTQ did not run on the card")
            n["one_step_off"] += one_step_off(Q.cpu(), rQ, rs)
            n["entries"] += rQ.numel()
            return rQ.to(Q.device), info
        return run

    with mock.patch.object(P, "gptq_quantize", forced(P.gptq_quantize)):
        _, got = P.quantize_model(params, cfg, rsq, calib, device=dev)
    ensure(next(calls, None) is None and got.keys() == want.keys()
           and all(got[k]["bits"] == want[k]["bits"] for k in want))
    for k in want:
        ensure(bool(torch.isclose(got[k]["scale"], want[k]["scale"],
                                  rtol=1e-5, atol=0).all()), f"scale of {k}")
    n["share_one_step_off"] = n["one_step_off"] / n["entries"]
    ensure(n["share_one_step_off"] <= 1e-3, n)
    return n


def run_e8p_config(nsamples: int):
    """rsq_e8p of the reference's sweep (run_rsq_e8p.sh): 2 bits recorded,
    rotate, attncon weighting 0.005-1, LDLQ+E8P with add_until_fail."""
    import dataclasses
    from rsq_tpu_torch.core.quant import WeightQuantConfig
    return dataclasses.replace(run_rsq_config(nsamples), e8p=True,
                               w=WeightQuantConfig(bits=2, sym=True))


# A Hessian with a near-dead column (diag > 0 but below 1e-9 of the mean:
# the first layer's q/k/v input after rotating a mean-centred embedding
# has no component along the Hadamard's first column) makes LDLQ's
# refinement multiply by the inverse of an almost singular 8x8 block: f32
# rounding then moves codes, and the Hessian-weighted error moves within
# this share (the reference itself moves it by 1.4e-2 under a 1e-7 change
# of H; tests/test_torch_ldlq.py).  Other calls: codes differ in at most
# E8P_ROWS_OFF of the rows (a rounding tie the card's sums decide the other
# way, which the refinement carries along its row) and the error within
# E8P_ERR_REL.
CHAOTIC_REL, E8P_ROWS_OFF, E8P_ERR_REL = 5e-2, 1e-2, 1e-3


def near_dead(H: torch.Tensor) -> bool:
    """A diagonal entry above 0 but below 1e-9 of the mean."""
    d = H.diagonal()
    return bool(((d != 0) & (d < 1e-9 * d.mean())).any())


def e8p_vs_cpu(dev, cfg, params, calib, rsq):
    """quantize_model under LDLQ+E8P on the CPU, each ldlq_quantize call
    recorded; then on the card, each call held against the CPU's at the
    same place: the card's W within 1e-6 and H within 1e-5 of their largest
    entries, then ldlq_quantize on the card on the CPU's W and H: scale
    within 1e-6 relative, codes equal but for the rows and error shares
    above (CHAOTIC_REL on a near-dead Hessian).  The CPU's weights and
    codes then go on.  Returns the counts."""
    from rsq_tpu_torch.quantize import pipeline as P
    from rsq_tpu_torch.quantize.gptq import quant_error
    ref = []

    def record(fn):
        def run(W, H, *, add_until_fail, device):
            Q, info = fn(W, H, add_until_fail=add_until_fail, device=device)
            ref.append((W.clone(), H.clone(), Q, info))
            return Q, info
        return run

    with mock.patch.object(P, "ldlq_quantize", record(P.ldlq_quantize)):
        _, want = P.quantize_model(params, cfg, rsq, calib, device="cpu")
    calls = iter(ref)
    n = {"calls": len(ref), "rows": 0, "rows_off": 0, "calls_off": 0,
         "near_dead_calls": 0, "max_err_rel": 0.0, "max_err_rel_near_dead":
         0.0, "max_h_err_over_max": 0.0}

    def forced(fn):
        def run(W, H, *, add_until_fail, device):
            rW, rH, rQ, rinfo = next(calls)
            ensure(float((W.cpu() - rW).abs().max())
                   <= 1e-6 * float(rW.abs().max()),
                   "e8p: the card's W differs from the CPU's")
            e = float((H.cpu() - rH).abs().max() / rH.abs().max())
            ensure(e <= 1e-5, f"e8p: Hessian differs by {e}")
            n["max_h_err_over_max"] = max(n["max_h_err_over_max"], e)
            Q, info = fn(rW.to(device), rH.to(device),
                         add_until_fail=add_until_fail, device=device)
            ensure(Q.device.type == "cuda", "LDLQ did not run on the card")
            ensure(abs(float(info["scale"]) - float(rinfo["scale"]))
                   <= 1e-6 * float(rinfo["scale"]), "e8p scale")
            off = int((info["codes"].cpu() != rinfo["codes"]).any(1).sum())
            err = abs(quant_error(rW, Q.cpu(), rH) - quant_error(rW, rQ, rH)
                      ) / quant_error(rW, rQ, rH)
            n["rows"] += rW.shape[0]
            n["rows_off"] += off
            n["calls_off"] += off > 0
            if near_dead(rH):
                n["near_dead_calls"] += 1
                n["max_err_rel_near_dead"] = max(n["max_err_rel_near_dead"],
                                                 err)
                ensure(err <= CHAOTIC_REL, f"e8p near-dead call: {err}")
            else:
                n["max_err_rel"] = max(n["max_err_rel"], err)
                ensure(off <= E8P_ROWS_OFF * rW.shape[0]
                       and err <= E8P_ERR_REL,
                       f"e8p: {off} rows off, error {err}")
            return rQ.to(Q.device), dict(info, codes=rinfo["codes"],
                                         scale=rinfo["scale"])
        return run

    with mock.patch.object(P, "ldlq_quantize", forced(P.ldlq_quantize)):
        _, got = P.quantize_model(params, cfg, rsq, calib, device=dev)
    ensure(next(calls, None) is None and got.keys() == want.keys()
           and all("codes" in got[k] for k in want))
    return n


def allocator_trace(alloc, seed: int = 0, steps: int = 2000):
    """A seeded sequence of the calls a paged engine makes on its page
    allocator (alloc, incref and decref of held pages, prefix insert and
    lookup of known and unknown hashes, eviction under pressure); the
    record of every result and of the counts after each call."""
    rng = np.random.default_rng(seed)
    held, hashes, out = [], [], []
    for _ in range(steps):
        op = rng.choice(["alloc", "incref", "decref", "insert", "lookup"],
                        p=[0.25, 0.1, 0.3, 0.15, 0.2])
        if op == "alloc":
            got = alloc.alloc(int(rng.integers(1, 4)))
            held += got or []
            out.append(("alloc", got))
        elif op in ("incref", "decref", "insert") and held:
            pid = held[int(rng.integers(len(held)))]
            if op == "incref":
                alloc.incref(pid)
                held.append(pid)
            elif op == "decref":
                alloc.decref(pid)
                held.remove(pid)
            else:
                # hashes as the engine makes them: 64-bit, some repeated
                h = (int(rng.integers(0, 2**62)) if not hashes
                     or rng.random() < 0.7
                     else hashes[int(rng.integers(len(hashes)))])
                hashes.append(h)
                out.append(("insert", alloc.prefix_insert(h, pid)))
        elif op == "lookup":
            h = (hashes[int(rng.integers(len(hashes)))]
                 if hashes and rng.random() < 0.8 else 2**62 + 1)
            pid = alloc.prefix_lookup(h)
            if pid >= 0:
                held.append(pid)
            out.append(("lookup", pid))
        out.append((alloc.free_count, alloc.cached_count, alloc.stats))
    return out


def native_check():
    """The C++ page allocator against PyPageAllocator on one seeded call
    sequence (allocator_trace): every result and count equal; the C++
    scheduler's accounting on a fixed sequence against the counts worked
    out by hand."""
    from rsq_tpu_torch.serving import native as N
    t0 = time.perf_counter()
    native = allocator_trace(N.NativePageAllocator(24))
    ensure(native == allocator_trace(N.PyPageAllocator(24)),
           "native page allocator differs from PyPageAllocator")
    stats = native[-1][2]
    ensure(min(stats.values()) > 0, stats)
    s = N.NativeScheduler(2, 512, 128)
    s.enqueue(7, 200, 100)
    s.enqueue(8, 500, 100)
    ensure(s.admit(7, 1) and not s.admit(8, 1) and s.admit(8, 0))
    ensure((s.free_slots, s.pages_free, s.queue_len) == (0, 1, 0))
    s.release(7)
    ensure((s.free_slots, s.pages_free, s.slot_of(8)) == (1, 4, 0))
    return {"allocator_calls": len(native), "allocator_stats": stats,
            "seconds": time.perf_counter() - t0}


def small_quantize_check(dev):
    """The tiny model quantized on the card and on the CPU, held call by
    call (quantize_vs_cpu); then the CLI on the card in this process:
    quantize (--eval) saves a checkpoint, eval and serve load it."""
    import tempfile

    from rsq_tpu_torch import cli
    from rsq_tpu_torch.models.config import ModelConfig
    from rsq_tpu_torch.models.llama import init_params
    from rsq_tpu_torch.quantize.data import get_loaders
    cfg = ModelConfig.tiny(num_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), scale=0.05)
    calib = get_loaders("synthetic", nsamples=8, seqlen=64,
                        vocab_size=cfg.vocab_size)
    out = {"rsq_tiny_vs_cpu": quantize_vs_cpu(dev, cfg, params, calib,
                                              run_rsq_config(8)),
           "e8p_tiny_vs_cpu": e8p_vs_cpu(dev, cfg, params, calib,
                                         run_e8p_config(8))}
    with tempfile.TemporaryDirectory() as ck:
        q = cli.main(["quantize", "--model", "tiny", "--cal-dataset",
                      "synthetic", "--nsamples", "8", "--train-seqlen", "64",
                      "--w-bits", "4", "--w-clip", "--rotate", "--weighting",
                      "attncon", "--min-value", "0.005", "--max-value", "1",
                      "--add-until-fail", "--eval", "--eval-dataset",
                      "synthetic", "--val-seqlen", "512", "--bsz", "64",
                      "--save", ck])
        e = cli.main(["eval", "--load", ck, "--eval-dataset", "synthetic",
                      "--val-seqlen", "512", "--bsz", "64"])
        sv = cli.main(["serve", "--load", ck, "--requests", "4",
                       "--num-slots", "2", "--page-size", "128", "--max-seq",
                       "512", "--prompt-len", "100", "--max-new-tokens", "8",
                       "--attn-int8-qk"])
    ensure(q["device"] == e["device"] == sv["device"] == "cuda")
    ensure(math.isfinite(q["ppl"]) and math.isfinite(e["ppl"])
           and abs(q["ppl"] - e["ppl"]) <= 1e-5 * q["ppl"],
           f"cli PPL {q['ppl']} / {e['ppl']}")
    ensure(sv["requests"] == 4 and sv["new_tokens"] == 32, sv)
    out["cli"] = {"quantize_ppl": q["ppl"], "eval_ppl": e["ppl"],
                  "serve": sv}
    # the 2-bit route: quantize --e8p saves the codes, serve runs them
    # weight-only on the affine-W4 kernel (row 14)
    from rsq_tpu_torch.kernels import LAUNCHES
    with tempfile.TemporaryDirectory() as ck:
        q = cli.main(["quantize", "--model", "tiny", "--cal-dataset",
                      "synthetic", "--nsamples", "8", "--train-seqlen", "64",
                      "--w-bits", "2", "--rotate", "--add-until-fail",
                      "--e8p", "--weighting", "attncon", "--min-value",
                      "0.005", "--max-value", "1", "--eval",
                      "--eval-dataset", "synthetic", "--val-seqlen", "512",
                      "--bsz", "64", "--save", ck])
        before = LAUNCHES["w4_affine_matmul_stacked"]
        sv = cli.main(["serve", "--load", ck, "--requests", "4",
                       "--num-slots", "2", "--page-size", "128", "--max-seq",
                       "512", "--prompt-len", "100", "--max-new-tokens", "8",
                       "--attn-int8-qk"])
        affine = LAUNCHES["w4_affine_matmul_stacked"] - before
    ensure(q["device"] == sv["device"] == "cuda" and math.isfinite(q["ppl"]))
    ensure(sv["e8p"] and not sv["a4"] and sv["requests"] == 4
           and sv["new_tokens"] == 32, sv)
    ensure(affine > 0, "cli serve of an E8P checkpoint skipped row 14")
    out["cli_e8p"] = {"quantize_ppl": q["ppl"], "serve": sv,
                      "w4_affine_matmul_stacked_launches": affine}
    out["native"] = native_check()
    out.update(small_families_check(dev))
    return out


def small_families_check(dev):
    """The OPT, Gemma-2 and Falcon (shared-norm MQA and two-norm GQA) tiny
    models through quantize_model (run_rsq.sh's configuration, rotated but
    on Gemma-2) on the card and on the CPU, held call by call
    (quantize_vs_cpu on the CPU's state); then the CLI on the card:
    quantize --model tiny-falcon --rotate --eval --save, eval --load (the
    same PPL), and serve refusing the checkpoint (rsq_tpu serves the Llama
    family only)."""
    import dataclasses
    import tempfile

    from rsq_tpu_torch import cli
    from rsq_tpu_torch.models import family
    from rsq_tpu_torch.models.config import ModelConfig
    from rsq_tpu_torch.quantize.data import get_loaders
    out = {}
    for name, cfg in (("opt", ModelConfig.tiny_opt()),
                      ("gemma2", ModelConfig.tiny_gemma2()),
                      ("falcon", ModelConfig.tiny_falcon()),
                      ("falcon_two_norms", ModelConfig.tiny_falcon(
                          falcon_two_norms=True, num_key_value_heads=2))):
        params = family.init_params(cfg, torch.Generator().manual_seed(0),
                                    scale=0.05)
        calib = get_loaders("synthetic", nsamples=8, seqlen=64,
                            vocab_size=cfg.vocab_size)
        rsq = dataclasses.replace(run_rsq_config(8),
                                  rotate=cfg.family != "gemma2")
        t0 = time.perf_counter()
        out[f"rsq_tiny_{name}_vs_cpu"] = quantize_vs_cpu(
            dev, cfg, params, calib, rsq, on_cpu_state=True)
        out[f"rsq_tiny_{name}_vs_cpu"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ck:
        q = cli.main(["quantize", "--model", "tiny-falcon", "--cal-dataset",
                      "synthetic", "--nsamples", "8", "--train-seqlen", "64",
                      "--w-bits", "4", "--w-clip", "--rotate", "--weighting",
                      "attncon", "--min-value", "0.005", "--max-value", "1",
                      "--add-until-fail", "--eval", "--eval-dataset",
                      "synthetic", "--val-seqlen", "512", "--bsz", "64",
                      "--save", ck])
        e = cli.main(["eval", "--load", ck, "--eval-dataset", "synthetic",
                      "--val-seqlen", "512", "--bsz", "64"])
        refused = False
        try:
            cli.main(["serve", "--load", ck])
        except NotImplementedError:
            refused = True
    ensure(q["device"] == e["device"] == "cuda")
    ensure(math.isfinite(q["ppl"]) and abs(q["ppl"] - e["ppl"])
           <= 1e-5 * q["ppl"], f"cli tiny-falcon PPL {q['ppl']} / {e['ppl']}")
    ensure(refused, "cli serve took a Falcon checkpoint")
    out["cli_falcon"] = {"quantize_ppl": q["ppl"], "eval_ppl": e["ppl"],
                         "serve_refused": refused,
                         "seconds": time.perf_counter() - t0}
    return out


# 1 of Llama-3-8B's 32 layers: with 2 (and phase quantize_families) the
# smoke after the device check took 226.8 s on an H100, over its 180 s
# budget (PERF.md section 6)
QUANT_LAYERS, QUANT_SAMPLES, QUANT_SEQLEN = 1, 32, 2048
EVAL_SEQS, EVAL_BSZ = 4, 2
# mean prefill-logit corr of the W4A4 path with the 4-bit-activation
# forward, below that forward's with itself on bf16-rounded weights: -0.003
# measured, and -0.083 for the weight-only prefill (PERF.md)
A4_MARGIN = 0.04


def hf_ingested_params(dev, cfg):
    """Seeded random f32 params (made on the card, parked on the host) as a
    Hugging Face Llama state dict ((out, in) weights as transposed views,
    no host copy; untied lm_head) with
    a config object whose model_type is "llama", read back through
    models/hf.config_from_hf and params_from_state_dict: the ingest at full
    width.  The config must come back as `cfg` and every tensor bit for
    bit."""
    import dataclasses

    from rsq_tpu_torch import tree_to
    from rsq_tpu_torch.models import llama as M
    from rsq_tpu_torch.models.hf import config_from_hf, params_from_state_dict
    params = tree_to(M.init_params(cfg, torch.Generator(device=dev)
                                   .manual_seed(0)), "cpu")
    hf_names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
                "v": "self_attn.v_proj", "o": "self_attn.o_proj",
                "up": "mlp.up_proj", "gate": "mlp.gate_proj",
                "down": "mlp.down_proj"}
    sd = {"model.embed_tokens.weight": params["embed"],
          "model.norm.weight": params["final_norm"],
          "lm_head.weight": params["lm_head"].T}
    for i, lp in enumerate(params["layers"]):
        base = f"model.layers.{i}."
        sd[base + "input_layernorm.weight"] = lp["input_norm"]
        sd[base + "post_attention_layernorm.weight"] = lp["post_norm"]
        for name, hf in hf_names.items():
            sd[f"{base}{hf}.weight"] = lp[name]["w"].T
    hf_config = SimpleNamespace(
        model_type="llama", vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        rope_theta=cfg.rope_theta, rope_scaling=None,
        rms_norm_eps=cfg.rms_norm_eps, attention_bias=False,
        tie_word_embeddings=False,
        max_position_embeddings=cfg.max_position_embeddings)
    got_cfg = config_from_hf(hf_config)
    ensure(dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg),
           f"config_from_hf: {got_cfg}")
    got = params_from_state_dict(sd, got_cfg)
    del sd
    ensure(torch.equal(got["embed"], params["embed"])
           and torch.equal(got["lm_head"], params["lm_head"])
           and all(torch.equal(g[n]["w"], p[n]["w"])
                   and torch.equal(g["input_norm"], p["input_norm"])
                   for g, p in zip(got["layers"], params["layers"])
                   for n in hf_names), "params_from_state_dict")
    return got_cfg, got


def quantize_phase(dev, prompts, held):
    """The RSQ pipeline at Llama-3-8B width on QUANT_LAYERS of its 32
    layers: seeded random f32 params read through the Hugging Face ingest
    (hf_ingested_params; kept in `held` for the E8P run),
    QUANT_SAMPLES synthetic calibration samples of QUANT_SEQLEN
    tokens, the run_rsq.sh configuration.  Seconds of the rotation and per
    layer of the weighting, the Hessians and GPTQ (per projection), peak
    memory, the largest quant_error; PPL of the base model (FP16) and of
    the quantized one under W4A4KV4 on a synthetic eval stream.  Then the
    result served by PagedServingEngine (page 512, INT4 KV, online
    Hadamards, int8 QK, int8 lm_head; no prefix cache, so every prefill
    attends to its own prompt's 16-bit K/V) on the serve prompts, the
    prefill logits of each request's last prompt token held against the
    fake-quant forward on the card under the policy that prefill runs:
    - weight-only (a4=False) against the forward with 16-bit activations:
      corr > 0.98 (the bound of tests/test_serving.py);
    - the W4A4 main path (rows 1, 12, 16, 19 must launch) against the
      forward with 4-bit activations: its mean corr over the prompts no
      more than A4_MARGIN below that forward's mean corr with itself on its
      weights rounded to bf16.  A chain of 4-bit quantizers turns a
      one-rounding difference into new rounding noise within a few links,
      so that self-agreement is what a second evaluation can reach.  The
      weight-only prefill against the same forward must miss the bound:
      the check tells W4A4 from W4A16.
    """
    import dataclasses

    from rsq_tpu_torch import tree_to
    from rsq_tpu_torch.eval.ppl import ppl_fullmodel
    from rsq_tpu_torch.models import llama as M
    from rsq_tpu_torch.models.config import ModelConfig
    from rsq_tpu_torch.models.policy import FP16, QuantPolicy, w4a4kv4
    from rsq_tpu_torch.quantize import pipeline as P
    from rsq_tpu_torch.quantize.data import get_loaders
    from rsq_tpu_torch.quantize.gptq import quant_error
    from rsq_tpu_torch.serving import model as S
    from rsq_tpu_torch.serving.paged import PagedServingEngine
    from rsq_tpu_torch.serving.params import to_serving_params

    cfg = dataclasses.replace(ModelConfig.llama3_8b(), num_layers=QUANT_LAYERS)
    t0 = time.perf_counter()
    cfg, params = hf_ingested_params(dev, cfg)
    calib = get_loaders("synthetic", nsamples=QUANT_SAMPLES,
                        seqlen=QUANT_SEQLEN, vocab_size=cfg.vocab_size)
    setup_s = time.perf_counter() - t0
    held.update(params=params, calib=calib, cfg=cfg)
    errs = {}

    def measure(fn):
        def run(W, H, wq, cfg_, device):
            Q, info = fn(W, H, wq, cfg_, device=device)
            errs[len(errs)] = quant_error(W.to(Q.device), Q, H)
            return Q, info
        return run

    def keep(fn):
        def run(*a, **k):
            held["rotated"] = fn(*a, **k)
            return held["rotated"]
        return run

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    with mock.patch.object(P, "gptq_quantize", measure(P.gptq_quantize)), \
            mock.patch.object(P.rotation, "rotate_model",
                              keep(P.rotation.rotate_model)):
        qparams, quantizers = P.quantize_model(
            params, cfg, run_rsq_config(QUANT_SAMPLES), calib, device=dev,
            stats=stats)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    held["rotate_s"] = stats["rotate_s"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    ensure(len(errs) == 7 * QUANT_LAYERS and all(
        math.isfinite(e) and e >= 0 for e in errs.values()), errs)

    t0 = time.perf_counter()
    stream = get_loaders("synthetic", eval_mode=True,
                         vocab_size=cfg.vocab_size)[: EVAL_SEQS * QUANT_SEQLEN]
    ppl_base = ppl_fullmodel(params, cfg, FP16, stream, QUANT_SEQLEN,
                             EVAL_BSZ, device=dev)
    ppl_quant = ppl_fullmodel(qparams, cfg, w4a4kv4(), stream, QUANT_SEQLEN,
                              EVAL_BSZ, device=dev)
    ppl_s = time.perf_counter() - t0
    ensure(math.isfinite(ppl_base) and ppl_quant < 1.5 * ppl_base,
           f"PPL base {ppl_base}, quantized {ppl_quant}")

    sparams = S.quantize_lm_head(to_serving_params(qparams, quantizers, cfg,
                                                   device=dev))

    def engine(a4):
        sc = S.ServingConfig(model=cfg, a4=a4, kv_int4=True, kv_hadamard=True,
                             online_had=True, max_seq=1024, attn_int8_qk=True)
        return PagedServingEngine(sparams, sc, num_slots=BATCH,
                                  page_size=512, record_logits=True,
                                  prefix_caching=False, device=dev)

    # weight-only first (prefill alone, its launches not counted), then the
    # W4A4 main path, driven as the serve phases are
    eng = engine(a4=False)
    for p in prompts:
        eng.add_request(p, max_new_tokens=NEW_TOKENS)
    eng._admit()
    w4a16 = [r.logit_trace[0] for r in eng.slots]
    del eng
    rec, launches, done = drive(engine(a4=True), prompts, cfg, PAGED_KERNELS)
    w4a4 = [r.logit_trace[0] for r in sorted(done, key=lambda r: r.uid)]
    del sparams
    rot16 = QuantPolicy(online_had_down=True, online_had_o=True,
                        norms_fused=True)
    a4 = dataclasses.replace(rot16, a=w4a4kv4().a)

    def last_logits(params, pol):
        with torch.no_grad():
            return [M.forward(params, torch.as_tensor(p[None], device=dev),
                              cfg, pol)[0, -1].float().cpu().numpy()
                    for p in prompts]

    def bf16_rounded(t):
        if isinstance(t, dict):
            return {k: bf16_rounded(v) for k, v in t.items()}
        if isinstance(t, list):
            return [bf16_rounded(v) for v in t]
        return t if t is None or not t.is_floating_point() \
            else t.bfloat16().float()

    qdev = tree_to(qparams, dev)
    f16, fa4 = last_logits(qdev, rot16), last_logits(qdev, a4)
    fa4_bf16w = last_logits(bf16_rounded(qdev), a4)
    del qdev
    torch.cuda.empty_cache()

    def c(xs, ys):
        return [float(np.corrcoef(x, y)[0, 1]) for x, y in zip(xs, ys)]

    corr = {"w4a16_vs_rot16": c(w4a16, f16), "w4a4_vs_a4": c(w4a4, fa4),
            "a4_vs_a4_bf16w": c(fa4, fa4_bf16w),
            "w4a16_vs_a4": c(w4a16, fa4)}
    bound = float(np.mean(corr["a4_vs_a4_bf16w"])) - A4_MARGIN
    log(json.dumps({"prefill_logit_corr": corr, "a4_corr_bound": bound}))
    ensure(min(corr["w4a16_vs_rot16"]) > 0.98,
           f"served (W4A16) vs fake-quant prefill logits: {corr}")
    ensure(np.mean(corr["w4a4_vs_a4"]) > bound
           > np.mean(corr["w4a16_vs_a4"]),
           f"served vs 4-bit-activation prefill logits, bound {bound}: {corr}")
    layers = stats["layers"]
    return {"quantize": {
        "model": f"llama3_8b widths, {QUANT_LAYERS} of 32 layers, seeded "
                 "random f32 weights (torch.Generator seed 0) read through "
                 "the Hugging Face ingest (models/hf.py)",
        "config": "run_rsq.sh: rotate, attncon 0.005-1, GPTQ W4 sym MSE "
                  "clip, add_until_fail",
        "reduced": {"layers": f"{QUANT_LAYERS} of 32",
                    "nsamples": f"{QUANT_SAMPLES} of the reference's 128",
                    "eval": f"{EVAL_SEQS} sequences of {QUANT_SEQLEN} "
                            "synthetic tokens"},
        "calibration": f"synthetic, {QUANT_SAMPLES} x {QUANT_SEQLEN}",
        "setup_s": setup_s, "quantize_s": quant_s,
        "rotate_s": stats["rotate_s"],
        "layer_s": [st["layer_s"] for st in layers],
        "weighting_s": [st["weighting_s"] for st in layers],
        "hessian_s": [st["hessian_s"] for st in layers],
        "gptq_s": [st["gptq_s"] for st in layers],
        "gptq_s_by_proj": [st["gptq_s_by_proj"] for st in layers],
        "full_depth_s_reckoned": stats["rotate_s"] + 32 * float(
            np.mean([st["layer_s"] for st in layers])),
        "quantize_peak_mem_gib": peak,
        "max_quant_error": max(errs.values()),
        "ppl_base_fp16": ppl_base, "ppl_quant_w4a4kv4": ppl_quant,
        "ppl_s": ppl_s, **rec}}, launches


# phase quantize's layer: with 2, the smoke after the device check took
# 194 s on an H100 (over its 180 s budget; PERF.md section 6)
E8P_LAYERS = 1


def quantize_e8p_phase(dev, prompts, held):
    """The E8P run of phase quantize: the same HF-ingested params and
    calibration, E8P_LAYERS layers, the rsq_e8p configuration (rotate,
    attncon 0.005-1, LDLQ+E8P, add_until_fail); on phase quantize's
    layers, its rotation (the same call) is reused.  Seconds of the rotation
    and per layer of the weighting, the Hessians and LDLQ (per
    projection), peak memory, the largest quant_error.  The codes reach
    serving (port-only, ROADMAP section 3): every projection's affine-int4
    re-encoding, dequantized, equals the pipeline's Q bit for bit; then
    ServingEngine serves the result weight-only as (D) does (INT4 KV,
    online Hadamards, int8 QK, int8 lm_head; rows 1, 4, 14 and 16 must
    launch), its prefill logits of each request's last prompt token held
    against the fake-quant forward on the pipeline's weights with 16-bit
    activations: corr > 0.98 (the W4A16 bound)."""
    import dataclasses

    from rsq_tpu_torch import tree_to
    from rsq_tpu_torch.kernels.matmul_w4 import unpack_w4_planar
    from rsq_tpu_torch.models import llama as M
    from rsq_tpu_torch.models.policy import QuantPolicy
    from rsq_tpu_torch.quantize import pipeline as P
    from rsq_tpu_torch.quantize.gptq import quant_error
    from rsq_tpu_torch.serving import model as S
    from rsq_tpu_torch.serving import params as SP
    from rsq_tpu_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(held["cfg"], num_layers=E8P_LAYERS)
    params = dict(held["params"], layers=held["params"]["layers"][:E8P_LAYERS])
    calib = held["calib"]
    rotate = contextlib.nullcontext()
    if E8P_LAYERS == QUANT_LAYERS:
        # the same params and seed: phase quantize's rotation is this one
        def reuse(p, c, mode, seed, device):
            ensure((c, mode, seed) == (cfg, "hadamard", 0))
            return rotated
        rotated = held["rotated"]
        rotate = mock.patch.object(P.rotation, "rotate_model", reuse)
    rotate_s = held["rotate_s"]
    held.clear()
    errs = {}

    def measure(fn):
        def run(W, H, *, add_until_fail, device):
            Q, info = fn(W, H, add_until_fail=add_until_fail, device=device)
            errs[len(errs)] = quant_error(W.to(Q.device), Q, H)
            return Q, info
        return run

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    with mock.patch.object(P, "ldlq_quantize", measure(P.ldlq_quantize)), \
            rotate:
        qparams, quantizers = P.quantize_model(
            params, cfg, run_e8p_config(QUANT_SAMPLES), calib, device=dev,
            stats=stats)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if E8P_LAYERS != QUANT_LAYERS:
        rotate_s = stats["rotate_s"]
    del params, calib, rotate
    ensure(len(errs) == 7 * E8P_LAYERS and all(
        math.isfinite(e) and e >= 0 for e in errs.values()), errs)
    ensure(len(quantizers) == 7 * E8P_LAYERS
           and all("codes" in q for q in quantizers.values()))

    sparams = SP.to_serving_params(qparams, quantizers, cfg, device=dev)
    for i, lp in enumerate(sparams["layers"]):
        for name in SP.QUANT_NAMES:
            e = lp[name]
            deq = (unpack_w4_planar(e["wp"]).float() + 0.5) * e["sh"]
            ensure(set(e) == {"wp", "sh", "b"} and torch.equal(
                deq, qparams["layers"][i][name]["w"].to(dev)),
                f"served E8P weight of layers.{i}.{name} is not Q")
            del deq
    sparams = S.quantize_lm_head(SP.fuse_for_decode(sparams))
    sc = S.ServingConfig(model=cfg, a4=False, kv_int4=True, kv_hadamard=True,
                         online_had=True, max_seq=1024, attn_int8_qk=True)
    rec, launches, done = drive(ServingEngine(sparams, sc, num_slots=BATCH,
                                              device=dev),
                                prompts, cfg, E8P_KERNELS)
    served = [r.logit_trace[0] for r in sorted(done, key=lambda r: r.uid)]
    del sparams
    rot16 = QuantPolicy(online_had_down=True, online_had_o=True,
                        norms_fused=True)
    qdev = tree_to(qparams, dev)
    with torch.no_grad():
        fq = [M.forward(qdev, torch.as_tensor(p[None], device=dev), cfg,
                        rot16)[0, -1].float().cpu().numpy() for p in prompts]
    del qdev, qparams
    torch.cuda.empty_cache()
    corr = [float(np.corrcoef(x, y)[0, 1]) for x, y in zip(served, fq)]
    log(json.dumps({"e8p_prefill_logit_corr": corr}))
    ensure(min(corr) > 0.98, f"served E8P vs fake-quant prefill: {corr}")
    layers = stats["layers"]
    return {"quantize_e8p": {
        "model": f"llama3_8b widths, {E8P_LAYERS} of 32 layers, the "
                 "HF-ingested params of phase quantize",
        "config": "run_rsq_e8p.sh: rotate, attncon 0.005-1, LDLQ+E8P "
                  "(quip_tune_iters 10), add_until_fail",
        "reduced": {"layers": f"{E8P_LAYERS} of 32 (2 took the smoke over "
                              "its time)",
                    "nsamples": f"{QUANT_SAMPLES} of the reference's 128"},
        "calibration": f"synthetic, {QUANT_SAMPLES} x {QUANT_SEQLEN}",
        "quantize_s": quant_s, "rotate_s": rotate_s,
        "rotation": "phase quantize's (the same params and seed), reused"
                    if E8P_LAYERS == QUANT_LAYERS else "its own",
        "layer_s": [st["layer_s"] for st in layers],
        "weighting_s": [st["weighting_s"] for st in layers],
        "hessian_s": [st["hessian_s"] for st in layers],
        "ldlq_s": [st["gptq_s"] for st in layers],
        "ldlq_s_by_proj": [st["gptq_s_by_proj"] for st in layers],
        "full_depth_s_reckoned": rotate_s + 32 * float(
            np.mean([st["layer_s"] for st in layers])),
        "quantize_peak_mem_gib": peak,
        "max_quant_error": max(errs.values()),
        "prefill_logit_corr": corr, **rec}}, launches


# ---------------------------------------------------------------------------
# Phase quantize_families: OPT, Gemma-2 and Falcon at their published widths
# ---------------------------------------------------------------------------

# (constructor, layers run): 1 of falcon-7b's 32 and gemma-2-9b's 42, 2 of
# opt-125m's 12
FAMILY_RUNS = (("falcon_7b", 1), ("gemma2_9b", 1), ("opt_125m", 2))
FAMILY_PROMPT, FAMILY_CHECK_LEN, FAMILY_EVAL_SEQS = 64, 32, 2
ROTATION_REL = 1e-3


def _perturb(params, g):
    """Norms off their constant init (LayerNorm w 1 + 0.1 N, b 0.05 N;
    Gemma-2's (1 + w) w 0.1 N) and OPT's linear biases 0.02 N, in place,
    so that the ingest and the LayerNorm fusion move real values."""
    def randn(t, s):
        return torch.randn(t.shape, generator=g, device=t.device) * s

    for tree in params["layers"] + [params]:
        for key, val in tree.items():
            if key.endswith("norm") and isinstance(val, dict):
                val["w"] += randn(val["w"], 0.1)
                val["b"] += randn(val["b"], 0.05)
            elif key.endswith("norm") and val is not None:
                val += randn(val, 0.1)
            elif isinstance(val, dict) and val.get("b") is not None:
                val["b"] += randn(val["b"], 0.02)


def _hf_names(params, cfg):
    """The port's params as a Hugging Face state dict of cfg's family
    ((out, in) weights as transposed views; Falcon's q/k/v fused in the
    multi-query layout; an lm_head.weight when untied) and a config object
    with its model_type."""
    def t(p):
        return p["w"].T

    def ln(sd, key, norm):
        sd[key + ".weight"], sd[key + ".bias"] = norm["w"], norm["b"]

    conf = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                num_hidden_layers=cfg.num_layers,
                num_attention_heads=cfg.num_attention_heads,
                max_position_embeddings=cfg.max_position_embeddings,
                tie_word_embeddings=cfg.tie_word_embeddings)
    sd = {}
    if cfg.family == "falcon":
        sd["transformer.word_embeddings.weight"] = params["embed"]
        ln(sd, "transformer.ln_f", params["final_norm"])
        for i, lp in enumerate(params["layers"]):
            b = f"transformer.h.{i}."
            ln(sd, b + "input_layernorm", lp["input_norm"])
            sd[b + "self_attention.query_key_value.weight"] = torch.cat(
                [t(lp["q"]), t(lp["k"]), t(lp["v"])])
            sd[b + "self_attention.dense.weight"] = t(lp["o"])
            sd[b + "mlp.dense_h_to_4h.weight"] = t(lp["fc1"])
            sd[b + "mlp.dense_4h_to_h.weight"] = t(lp["fc2"])
        conf.update(model_type="falcon", ffn_hidden_size=cfg.intermediate_size,
                    multi_query=True, new_decoder_architecture=False,
                    parallel_attn=True, rope_theta=cfg.rope_theta,
                    layer_norm_epsilon=cfg.rms_norm_eps)
    elif cfg.family == "opt":
        sd["model.decoder.embed_tokens.weight"] = params["embed"]
        sd["model.decoder.embed_positions.weight"] = params["embed_pos"]
        ln(sd, "model.decoder.final_layer_norm", params["final_norm"])
        names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
                 "v": "self_attn.v_proj", "o": "self_attn.out_proj",
                 "fc1": "fc1", "fc2": "fc2"}
        for i, lp in enumerate(params["layers"]):
            b = f"model.decoder.layers.{i}."
            ln(sd, b + "self_attn_layer_norm", lp["input_norm"])
            ln(sd, b + "final_layer_norm", lp["post_norm"])
            for n, hf in names.items():
                sd[f"{b}{hf}.weight"] = t(lp[n])
                sd[f"{b}{hf}.bias"] = lp[n]["b"]
        conf.update(model_type="opt", ffn_dim=cfg.intermediate_size,
                    do_layer_norm_before=True,
                    word_embed_proj_dim=cfg.hidden_size)
    else:
        sd["model.embed_tokens.weight"] = params["embed"]
        sd["model.norm.weight"] = params["final_norm"]
        names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
                 "v": "self_attn.v_proj", "o": "self_attn.o_proj",
                 "up": "mlp.up_proj", "gate": "mlp.gate_proj",
                 "down": "mlp.down_proj",
                 "input_norm": "input_layernorm",
                 "post_attn_norm": "post_attention_layernorm",
                 "pre_ff_norm": "pre_feedforward_layernorm",
                 "post_ff_norm": "post_feedforward_layernorm"}
        for i, lp in enumerate(params["layers"]):
            for n, hf in names.items():
                sd[f"model.layers.{i}.{hf}.weight"] = \
                    t(lp[n]) if isinstance(lp[n], dict) else lp[n]
        conf.update(model_type="gemma2",
                    intermediate_size=cfg.intermediate_size,
                    num_key_value_heads=cfg.num_key_value_heads,
                    head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                    rms_norm_eps=cfg.rms_norm_eps,
                    query_pre_attn_scalar=cfg.query_pre_attn_scalar,
                    attn_logit_softcapping=cfg.attn_logit_softcap,
                    final_logit_softcapping=cfg.final_logit_softcap,
                    sliding_window=cfg.sliding_window)
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = params["lm_head"].T
    return sd, SimpleNamespace(**conf)


def _same_tree(a, b, path=""):
    if isinstance(a, dict):
        ensure(isinstance(b, dict) and a.keys() == b.keys(), path)
        for k in a:
            _same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        ensure(isinstance(b, list) and len(a) == len(b), path)
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}.{i}")
    else:
        ensure((a is None and b is None) or torch.equal(a, b),
               f"HF ingest: {path} differs")


def family_hf_ingested(dev, cfg):
    """Seeded random f32 params of cfg's family made on the card (norms
    and OPT's biases perturbed), parked on the host, written under the
    family's Hugging Face names and read back through config_from_hf and
    params_from_state_dict: the config must equal cfg and every tensor
    come back bit for bit."""
    import dataclasses

    from rsq_tpu_torch import tree_to
    from rsq_tpu_torch.models import family
    from rsq_tpu_torch.models.hf import config_from_hf, params_from_state_dict
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    params = family.init_params(cfg, g)
    _perturb(params, g)
    if cfg.tie_word_embeddings:          # a view of the embedding: not
        del params["lm_head"]            # copied off the card twice
    params = tree_to(params, "cpu")
    if cfg.tie_word_embeddings:
        params["lm_head"] = params["embed"].T
    t1 = time.perf_counter()
    sd, conf = _hf_names(params, cfg)
    got_cfg = config_from_hf(conf)
    ensure(dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg),
           f"config_from_hf: {got_cfg}")
    got = params_from_state_dict(sd, got_cfg)
    del sd
    t2 = time.perf_counter()
    _same_tree(got, params)
    return got_cfg, got, {"init_s": t1 - t0, "ingest_s": t2 - t1,
                          "compare_s": time.perf_counter() - t2}


def family_run(dev, ctor, layers):
    """One family at its published widths on `layers` of its layers:
    the HF ingest (family_hf_ingested); rotation invariance (OPT, Falcon:
    the fused, rotated, unquantized model's f32 logits on 2 prompts of
    FAMILY_PROMPT tokens within ROTATION_REL of the largest |logit| of the
    original's; falcon-7b's 4544 takes the random orthogonal fallback, its
    18176 no fc2 Hadamard, its o the per-head one) or rotate_model refused
    (Gemma-2); quantize_model in the run_rsq.sh configuration (rotated but
    on Gemma-2; the rotation is the invariance check's, the same call),
    QUANT_SAMPLES synthetic samples of QUANT_SEQLEN tokens: seconds per
    stage and projection, the full depth reckoned from them, peak memory,
    quant_error; the quantized model's W4A16 fake-quant logits on the card
    against the CPU's on 2 prompts of FAMILY_CHECK_LEN tokens (LOGIT_MAX,
    LOGIT_RMS std of the logits); PPL on FAMILY_EVAL_SEQS synthetic
    sequences finite."""
    import dataclasses

    from rsq_tpu_torch import tree_to
    from rsq_tpu_torch.core.hadamard import hadU_supported
    from rsq_tpu_torch.eval.ppl import ppl_fullmodel
    from rsq_tpu_torch.models import family as F
    from rsq_tpu_torch.models.config import ModelConfig
    from rsq_tpu_torch.models.policy import FP16, QuantPolicy
    from rsq_tpu_torch.quantize import pipeline as P
    from rsq_tpu_torch.quantize import rotation
    from rsq_tpu_torch.quantize.data import get_loaders
    from rsq_tpu_torch.quantize.gptq import quant_error

    full = getattr(ModelConfig, ctor)()
    t0 = time.perf_counter()
    cfg, params, ingest = family_hf_ingested(
        dev, dataclasses.replace(full, num_layers=layers))
    calib = get_loaders("synthetic", nsamples=QUANT_SAMPLES,
                        seqlen=QUANT_SEQLEN, vocab_size=cfg.vocab_size)
    setup_s = time.perf_counter() - t0
    rsq = dataclasses.replace(run_rsq_config(QUANT_SAMPLES),
                              rotate=cfg.family != "gemma2")
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, FAMILY_PROMPT)))
    pol = QuantPolicy(online_had_down=rsq.rotate
                      and hadU_supported(cfg.intermediate_size),
                      online_had_o=rsq.rotate, norms_fused=rsq.rotate)
    rec = {"model": f"{ctor} widths, {layers} of {full.num_layers} layers, "
                    "seeded random f32 weights (torch.Generator seed 0, "
                    "norms perturbed) read through the Hugging Face ingest",
           "config": "run_rsq.sh: " + ("rotate, " if rsq.rotate else
                                       "no rotation (refused), ")
                     + "attncon 0.005-1, GPTQ W4 sym MSE clip, "
                       "add_until_fail",
           "reduced": {"layers": f"{layers} of {full.num_layers}",
                       "nsamples": f"{QUANT_SAMPLES} of the reference's 128",
                       "eval": f"{FAMILY_EVAL_SEQS} sequences of "
                               f"{QUANT_SEQLEN} synthetic tokens"},
           "setup_s": setup_s, "setup": ingest}

    def logits(p, x, policy):
        with torch.no_grad():
            return F.forward(p, x, cfg, policy).float()

    patch = contextlib.nullcontext()
    if rsq.rotate:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rotated = rotation.rotate_model(params, cfg, mode=rsq.rotate_mode,
                                        seed=rsq.rotation_seed, device=dev)
        torch.cuda.synchronize()
        rec["rotate_s"] = time.perf_counter() - t0
        pdev = tree_to(params, dev)
        base = logits(pdev, ids.to(dev), FP16)
        del pdev
        rdev = tree_to(rotated[0], dev)
        err = float((logits(rdev, ids.to(dev), pol) - base).abs().max()
                    / base.abs().max())
        del rdev, base
        ensure(err <= ROTATION_REL, f"{ctor}: rotated logits off by {err}")
        rec["rotation_max_err_over_max_logit"] = err

        def reuse(p, c, mode, seed, device):
            ensure((c, mode, seed) == (cfg, rsq.rotate_mode,
                                       rsq.rotation_seed))
            return rotated
        patch = mock.patch.object(rotation, "rotate_model", reuse)
    else:
        refused = False
        try:
            rotation.rotate_model(params, cfg, device=dev)
        except NotImplementedError:
            refused = True
        ensure(refused, f"{ctor}: rotate_model took Gemma-2")
        rec["rotation"] = "refused (NotImplementedError), as the reference"
    errs = {}

    def measure(fn):
        def run(W, H, wq, cfg_, device):
            Q, info = fn(W, H, wq, cfg_, device=device)
            errs[len(errs)] = quant_error(W.to(Q.device), Q, H)
            return Q, info
        return run

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    with mock.patch.object(P, "gptq_quantize", measure(P.gptq_quantize)), \
            patch:
        qparams, quantizers = P.quantize_model(params, cfg, rsq, calib,
                                               device=dev, stats=stats)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    quant_peak = torch.cuda.max_memory_allocated() / 2**30
    del params, calib
    n_lin = len(F.linear_names(cfg)) * layers
    ensure(len(errs) == n_lin == len(quantizers) and all(
        math.isfinite(e) and e >= 0 for e in errs.values()), errs)

    qdev = tree_to(qparams, dev)
    short = ids[:, :FAMILY_CHECK_LEN]
    card = logits(qdev, short.to(dev), pol).cpu()
    stream = get_loaders("synthetic", eval_mode=True, vocab_size=cfg.vocab_size
                         )[: FAMILY_EVAL_SEQS * QUANT_SEQLEN]
    t0 = time.perf_counter()
    ppl = ppl_fullmodel(qdev, cfg, pol, stream, QUANT_SEQLEN,
                        FAMILY_EVAL_SEQS, device=dev)
    ppl_s = time.perf_counter() - t0
    del qdev
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    cpu = logits(qparams, short, pol)
    sd = float(cpu.std())
    e = (card - cpu).abs()
    ensure(bool(torch.isfinite(card).all()) and math.isfinite(ppl),
           f"{ctor}: logits or PPL not finite ({ppl})")
    ensure(float(e.max()) <= LOGIT_MAX * sd
           and float(e.pow(2).mean().sqrt()) <= LOGIT_RMS * sd,
           f"{ctor}: card vs CPU logits {float(e.max()) / sd}")
    layer_s = [st["layer_s"] for st in stats["layers"]]
    rotate_s = rec.get("rotate_s", 0.0)
    rec.update({
        "calibration": f"synthetic, {QUANT_SAMPLES} x {QUANT_SEQLEN}",
        "quantize_s": quant_s, "layer_s": layer_s,
        "weighting_s": [st["weighting_s"] for st in stats["layers"]],
        "hessian_s": [st["hessian_s"] for st in stats["layers"]],
        "gptq_s": [st["gptq_s"] for st in stats["layers"]],
        "gptq_s_by_proj": [st["gptq_s_by_proj"] for st in stats["layers"]],
        "full_depth_s_reckoned": rotate_s
        + full.num_layers * float(np.mean(layer_s)),
        "quantize_peak_mem_gib": quant_peak,
        "peak_mem_gib_with_embed_and_lm_head": peak,
        "max_quant_error": max(errs.values()),
        "card_vs_cpu_max_over_std": float(e.max()) / sd,
        "card_vs_cpu_rms_over_std": float(e.pow(2).mean().sqrt()) / sd,
        "ppl_w4a16": ppl, "ppl_s": ppl_s})
    return rec


def quantize_families_phase(dev):
    """family_run for each of FAMILY_RUNS, one at a time."""
    out = {}
    for ctor, layers in FAMILY_RUNS:
        t0 = time.perf_counter()
        out[ctor] = family_run(dev, ctor, layers)
        out[ctor]["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return {"quantize_families": out}


# ---------------------------------------------------------------------------
# Phase 5: serve Llama-3-8B widths and depth
# ---------------------------------------------------------------------------

BATCH, NEW_TOKENS = 8, 32
PAGED_KERNELS = ("w4a4_matmul_paired_stacked", "w8_matmul", "decode_prep",
                 "int4_paged_decode_attention_self_append")
CONTIG_KERNELS = ("w4a4_matmul_paired_stacked", "w8_matmul", "decode_prep",
                  "int4_decode_attention_self_append")
BF16_KERNELS = ("bf16_decode_attention_stacked", "kv_append_stacked_bf16",
                "w16_matmul_stacked")
W4_KERNELS = ("w4_matmul_paired_stacked", "w4_matmul", "decode_prep",
              "int4_paged_decode_attention_self_append")
E8P_KERNELS = ("w4_affine_matmul_stacked", "w8_matmul", "decode_prep",
               "int4_decode_attention_self_append")


def serve_prompts(cfg):
    """8 prompts of 100-700 tokens, two sharing a 600-token prefix."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 600)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 40)]),
               np.concatenate([shared, rng.integers(0, cfg.vocab_size, 90)])]
    prompts += [rng.integers(0, cfg.vocab_size, int(n))
                for n in rng.integers(100, 701, BATCH - 2)]
    return prompts


def drive(eng, prompts, cfg, kernels):
    """The main path of one engine: the launch counts and the peak memory
    are reset just before the 8 admissions, then every slot decodes until
    all requests finish.  Checks every request's token count, finite
    logits (prefill and the first two steps) and that each of `kernels`
    launched.  Returns (record, launches, finished requests)."""
    from rsq_tpu_torch.kernels import KERNELS, LAUNCHES, reset_launches
    from rsq_tpu_torch.serving.native import (NativePageAllocator,
                                              NativeScheduler)
    # the engines run on the C++ allocator / scheduler, never on a silent
    # Python fallback
    if hasattr(eng, "alloc"):
        ensure(isinstance(eng.alloc, NativePageAllocator),
               f"paged engine on {type(eng.alloc).__name__}")
    else:
        ensure(isinstance(eng.sched, NativeScheduler),
               "ServingEngine without the native scheduler")
    for p in prompts:
        eng.add_request(p, max_new_tokens=NEW_TOKENS)
    eng.record_logits = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                       # counts from here on: the main path
    t0 = time.perf_counter()
    eng._admit()                           # the 8 prefills
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    ensure(all(s is not None for s in eng.slots), "a request not admitted")
    step_s, per_step, done = [], None, []
    logit_rows = [r.logit_trace[0] for r in eng.slots]
    while any(s is not None for s in eng.slots):
        nstep = len(step_s)
        # record logits on the first two steps (checked below), then time
        # steps that copy only the sampled tokens to the host
        eng.record_logits = nstep < 2
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done += eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if nstep == 2:
            per_step = {k: LAUNCHES[k] - before.get(k, 0) for k in KERNELS}
        if nstep < 2:
            logit_rows += [r.logit_trace[-1] for r in eng.slots
                           if r is not None]
        if len(step_s) > 4 * NEW_TOKENS:
            raise AssertionError("serve loop did not finish")
    launches = {k: LAUNCHES[k] for k in KERNELS}
    ensure(len(done) == BATCH, len(done))
    for r in done:
        ensure(len(r.output) == NEW_TOKENS, (r.uid, len(r.output)))
        ensure(all(0 <= t < cfg.vocab_size for t in r.output))
    for row in logit_rows:
        ensure(row.shape == (cfg.vocab_size,) and np.isfinite(row).all())
    missing = [k for k in kernels if launches[k] == 0]
    ensure(not missing, f"kernels never launched on the main path: {missing}")

    timed = step_s[2:-1] or step_s       # all 8 slots live, logits not copied
    step_ms = float(np.median(timed)) * 1e3
    prompt_tokens = int(sum(len(p) for p in prompts))
    return {
        "batch": BATCH, "prompt_tokens": prompt_tokens,
        "prompt_lens": [len(p) for p in prompts],
        "new_tokens_each": NEW_TOKENS,
        "prefill_ms_total": prefill_s * 1e3,
        "prefill_ms_per_request": prefill_s * 1e3 / BATCH,
        "prefill_tok_s": prompt_tokens / prefill_s,
        "decode_ms_per_step_median": step_ms,
        "decode_ms_per_step_min": float(np.min(timed)) * 1e3,
        "decode_steps_timed": len(timed),
        "decode_tok_s": BATCH / (step_ms / 1e3),
        "launches_per_decode_step": per_step,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}, \
        launches, done


def serve_paged(dev, cfg, params, prompts, profile: bool):
    """PagedServingEngine, W4A4 INT4-KV, page 512, max_seq 1024."""
    from rsq_tpu_torch.serving import model as S
    from rsq_tpu_torch.serving.paged import PagedServingEngine
    sc = S.ServingConfig(model=cfg, a4=True, kv_int4=True, kv_hadamard=True,
                         online_had=True, max_seq=1024, attn_int8_qk=True)
    eng = PagedServingEngine(params, sc, num_slots=BATCH, page_size=512,
                             device=dev)
    rec, launches, done = drive(eng, prompts, cfg, PAGED_KERNELS)
    reused = sorted(r.reused_pages for r in done)
    ensure(reused[-1] == 1, f"prefix cache not hit: {reused}")
    if profile:
        from rsq_tpu_torch.serving.paged import decode_step_paged_fast
        ptab = torch.as_tensor(eng.page_tables, device=dev)
        lengths = torch.full((BATCH,), 512, dtype=torch.int32, device=dev)
        toks = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
        profile_decode("serve", lambda: decode_step_paged_fast(
            params, eng.pool, ptab, lengths, toks, sc))
    return {"serve": {
        "model": "llama3_8b widths, 32 layers, random W4A4 weights (seed 0)",
        "page": 512, "max_seq": 1024, "attn_int8_qk": True,
        "int8_lm_head": True, "prefix_pages_reused": reused, **rec}}, launches


def profile_contiguous(name, eng, dev):
    """profile_decode of one step of a ServingEngine's cache."""
    from rsq_tpu_torch.serving.model import decode_step_stacked
    lengths = torch.full((BATCH,), 512, dtype=torch.int32, device=dev)
    toks = torch.zeros((BATCH,), dtype=torch.int32, device=dev)

    def step():
        eng.cache["length"] = lengths
        decode_step_stacked(eng.params, eng.cache, toks, eng.sc)

    profile_decode(name, step)


def serve_contiguous(dev, cfg, params, prompts, profile: bool):
    """Configuration (A) on the contiguous slot cache: ServingEngine, W4A4
    INT4-KV, max_seq 1024 (the bench's "contiguous" measurement)."""
    from rsq_tpu_torch.serving import model as S
    from rsq_tpu_torch.serving.engine import ServingEngine
    sc = S.ServingConfig(model=cfg, a4=True, kv_int4=True, kv_hadamard=True,
                         online_had=True, max_seq=1024, attn_int8_qk=True)
    eng = ServingEngine(params, sc, num_slots=BATCH, device=dev)
    rec, launches, _ = drive(eng, prompts, cfg, CONTIG_KERNELS)
    if profile:
        profile_contiguous("serve_contiguous", eng, dev)
    return {"serve_contiguous": {
        "model": "llama3_8b widths, 32 layers, random W4A4 weights (seed 0)",
        "max_seq": 1024, "attn_int8_qk": True, "int8_lm_head": True,
        **rec}}, launches


def serve_w4(dev, cfg, params, prompts, profile: bool):
    """Configuration (C), weight-only W4: PagedServingEngine on the W4A4
    phases' plane-major weights served with bf16 activations (a4=False)
    and an int4 lm_head, INT4-KV, page 512, max_seq 1024."""
    from rsq_tpu_torch.serving import model as S
    from rsq_tpu_torch.serving.paged import PagedServingEngine
    sc = S.ServingConfig(model=cfg, a4=False, kv_int4=True, kv_hadamard=True,
                         online_had=True, max_seq=1024, attn_int8_qk=True)
    eng = PagedServingEngine(params, sc, num_slots=BATCH, page_size=512,
                             device=dev)
    rec, launches, done = drive(eng, prompts, cfg, W4_KERNELS)
    reused = sorted(r.reused_pages for r in done)
    ensure(reused[-1] == 1, f"prefix cache not hit: {reused}")
    if profile:
        from rsq_tpu_torch.serving.paged import decode_step_paged_fast
        ptab = torch.as_tensor(eng.page_tables, device=dev)
        lengths = torch.full((BATCH,), 512, dtype=torch.int32, device=dev)
        toks = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
        profile_decode("serve_w4", lambda: decode_step_paged_fast(
            params, eng.pool, ptab, lengths, toks, sc))
    return {"serve_w4": {
        "model": "llama3_8b widths, 32 layers, the W4A4 phases' random "
                 "weights served weight-only (seed 0)",
        "page": 512, "max_seq": 1024, "attn_int8_qk": True,
        "int4_lm_head": True, "prefix_pages_reused": reused, **rec}}, launches


def e8p_serving_params(cfg, seed: int, device):
    """Stacked E8P serving params made on the card from seeded random codes
    (uniform over the 2^16 codebook) and per-layer scales, through the
    port's own pack_linear_e8p -> fuse_for_decode -> stack_layer_params:
    all seven projections affine int4 ('wpm' + 'sh', unfused), no norms, a
    bf16 embedding with lm_head = embed.T quantized to int8."""
    from rsq_tpu_torch.serving import model as S
    from rsq_tpu_torch.serving import params as SP
    dev = device
    g = torch.Generator(device=dev).manual_seed(seed)
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {"q": (d, cfg.q_dim), "k": (d, cfg.kv_dim), "v": (d, cfg.kv_dim),
              "o": (cfg.q_dim, d), "up": (d, f), "gate": (d, f),
              "down": (f, d)}
    layers = []
    for _ in range(cfg.num_layers):
        lp = {"input_norm": None, "post_norm": None}
        for name, (k, n) in shapes.items():
            codes = torch.randint(0, 1 << 16, (n, k // 8), dtype=torch.int32,
                                  generator=g, device=dev)
            scale = (torch.rand((), generator=g, device=dev) * 0.4 + 0.6) / (
                1.1 * math.sqrt(k))
            lp[name] = SP.pack_linear_e8p({"b": None},
                                          {"codes": codes, "scale": scale},
                                          dev)
        layers.append(lp)
    emb = (torch.randn((v, d), generator=g, device=dev) * 0.01).to(torch.bfloat16)
    params = SP.fuse_for_decode({"embed": emb, "final_norm": None,
                                 "lm_head": emb.T.contiguous(),
                                 "layers": layers})
    del layers
    return S.quantize_lm_head(S.stack_layer_params(params))


def serve_e8p(dev, cfg, prompts, profile: bool):
    """Configuration (D), E8P 2-bit weights served as affine int4:
    ServingEngine, INT4 slot cache, int8 lm_head, max_seq 1024."""
    from rsq_tpu_torch.serving import model as S
    from rsq_tpu_torch.serving.engine import ServingEngine
    t0 = time.perf_counter()
    params = e8p_serving_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"serve_e8p: params built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ls = params["layers_stacked"]
    ensure(all(set(ls[n]) == {"wpm", "sh", "b"} for n in
               ("q", "k", "v", "o", "up", "gate", "down")), "E8P layout")
    sc = S.ServingConfig(model=cfg, a4=False, kv_int4=True, kv_hadamard=True,
                         online_had=True, max_seq=1024, attn_int8_qk=True)
    eng = ServingEngine(params, sc, num_slots=BATCH, device=dev)
    rec, launches, _ = drive(eng, prompts, cfg, E8P_KERNELS)
    if profile:
        profile_contiguous("serve_e8p", eng, dev)
    del eng
    torch.cuda.empty_cache()
    return {"serve_e8p": {
        "model": "llama3_8b widths, 32 layers, random E8P codes (seed 0) "
                 "re-encoded to affine int4",
        "max_seq": 1024, "attn_int8_qk": True, "int8_lm_head": True,
        **rec}}, launches, params


def serve_bf16(dev, cfg, prompts, profile: bool):
    """Configuration (B), the bf16 baseline: ServingEngine on dense bf16
    weights (random_dense_params, about 15 GB), bf16 cache, no Hadamards,
    bf16 lm_head (a torch.matmul, as the reference leaves it to XLA)."""
    from rsq_tpu_torch.serving import model as S
    from rsq_tpu_torch.serving.engine import ServingEngine
    from rsq_tpu_torch.serving.params import random_dense_params
    t0 = time.perf_counter()
    params = random_dense_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"serve_bf16: params built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    sc = S.ServingConfig(model=cfg, a4=False, kv_int4=False,
                         kv_hadamard=False, online_had=False, max_seq=1024)
    eng = ServingEngine(params, sc, num_slots=BATCH, device=dev)
    rec, launches, _ = drive(eng, prompts, cfg, BF16_KERNELS)
    if profile:
        profile_contiguous("serve_bf16", eng, dev)
    return {"serve_bf16": {
        "model": "llama3_8b widths, 32 layers, random dense bf16 weights "
                 "(seed 0)", "max_seq": 1024, "bf16_lm_head": True,
        **rec}}, launches


# the per-layer phases: one equal-length batch, as prefill takes it
LAYER_PROMPT_LEN, SCAN_STEPS = 512, 4
LAYERS_KERNELS = ("w4a4_matmul_paired", "int4_decode_attention_stacked",
                  "w8_matmul")
LAYERS_W4_KERNELS = ("w4_matmul_paired", "int4_decode_attention_stacked",
                     "w4_matmul")
LAYERS_E8P_KERNELS = ("w4_affine_matmul", "int4_decode_attention_stacked",
                      "w8_matmul")
# kernels no serve phase runs, because no serving path of the reference
# calls their TPU kernels (kernel table rows 3, 7, 18)
OFF_PATH = ("int4_decode_attention_stacked_self", "kv_append_stacked",
            "int4_paged_decode_attention_stacked_self")
PAGE16_KERNELS = ("w4a4_matmul_paired_stacked", "w8_matmul", "decode_prep",
                  "paged_append_pool", "int4_paged_decode_attention_stacked")


def layer_prompts(cfg):
    """8 prompts of LAYER_PROMPT_LEN tokens (seed 1)."""
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, LAYER_PROMPT_LEN))


def drive_layers(params, sc, ids, cfg, kernels, keep: int = 0):
    """The per-layer main path: prefill of the 8 prompts, then decode_step
    on each step's argmax until every row has NEW_TOKENS new tokens, on
    unstacked params["layers"].  The launch counts and the peak memory are
    reset just before the prefill.  Checks finite logits of the prefill and
    the first steps, the tokens and the cache length, and that each of
    `kernels` launched.  Returns (record, launches, the logits of the
    prefill and the first `keep` steps, the tokens fed to those steps)."""
    from rsq_tpu_torch.kernels import KERNELS, LAUNCHES, reset_launches
    from rsq_tpu_torch.serving import model as S
    dev = params["embed"].device
    cache = S.init_cache(sc, BATCH, device=dev)
    ids_t = torch.as_tensor(ids, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                       # counts from here on: the main path
    t0 = time.perf_counter()
    logits, cache = S.prefill(params, cache, ids_t, sc)
    tok = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    trace, toks, step_s, per_step = [logits], [tok], [], None
    for n in range(NEW_TOKENS - 1):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        logits, cache = S.decode_step(params, cache, tok, sc)
        tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if n == 1:
            per_step = {k: LAUNCHES[k] - before.get(k, 0) for k in KERNELS}
        if n < keep:
            trace.append(logits)
        toks.append(tok)
    launches = {k: LAUNCHES[k] for k in KERNELS}
    out = torch.stack(toks, dim=1).cpu().numpy()
    ensure(out.shape == (BATCH, NEW_TOKENS)
           and ((0 <= out) & (out < cfg.vocab_size)).all())
    ensure(all(bool(torch.isfinite(t).all()) and t.shape == (BATCH, cfg.vocab_size)
               for t in trace[:3]), "non-finite logits")
    ensure(cache["length"].tolist() == [LAYER_PROMPT_LEN + NEW_TOKENS - 1]
           * BATCH, "cache length")
    missing = [k for k in kernels if launches[k] == 0]
    ensure(not missing, f"kernels never launched on the main path: {missing}")
    timed = step_s[1:]
    step_ms = float(np.median(timed)) * 1e3
    prompt_tokens = BATCH * LAYER_PROMPT_LEN
    return {
        "batch": BATCH, "prompt_tokens": prompt_tokens,
        "prompt_lens": [LAYER_PROMPT_LEN] * BATCH,
        "new_tokens_each": NEW_TOKENS,
        "prefill_ms_total": prefill_s * 1e3,
        "prefill_ms_per_request": prefill_s * 1e3 / BATCH,
        "prefill_tok_s": prompt_tokens / prefill_s,
        "decode_ms_per_step_median": step_ms,
        "decode_ms_per_step_min": float(np.min(timed)) * 1e3,
        "decode_steps_timed": len(timed),
        "decode_tok_s": BATCH / (step_ms / 1e3),
        "launches_per_decode_step": per_step,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}, \
        launches, trace, toks


def profile_layers(name, params, sc, ids):
    """profile_decode of one per-layer decode_step, all rows at length 512."""
    from rsq_tpu_torch.serving import model as S
    dev = params["embed"].device
    cache = S.init_cache(sc, BATCH, device=dev)
    S.prefill(params, cache, torch.as_tensor(ids, device=dev), sc)
    toks = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    lengths = cache["length"]

    def step():
        cache["length"] = lengths
        S.decode_step(params, cache, toks, sc)

    profile_decode(name, step)


def serve_layers(dev, cfg, params, name, sc, kernels, what, profile: bool,
                 keep: int = 0):
    """One per-layer phase (E and its variants) on unstacked params."""
    from rsq_tpu_torch.serving import model as S
    layers = S.unstack_layer_params(params)
    ids = layer_prompts(cfg)
    rec, launches, trace, toks = drive_layers(layers, sc, ids, cfg, kernels,
                                              keep)
    if profile:
        profile_layers(name, layers, sc, ids)
    return {name: {"model": what, "layers": cfg.num_layers,
                   "max_seq": sc.max_seq, "attn": "bf16 QK (the per-layer "
                   "path passes no int8_qk)", **rec}}, launches, trace, toks


def scan_check(dev, cfg, params, sc, trace, toks):
    """prefill_stacked and SCAN_STEPS steps of decode_step_stacked under
    RSQ_SCAN_DECODE=1 on (E)'s stacked weights, fed (E)'s tokens: the
    logits against (E)'s per-layer ones.  Both run the same functions in
    the same order on views of the same tensors: expected bit-equal, and
    held at least to the end-to-end tolerance."""
    from rsq_tpu_torch.kernels import KERNELS, LAUNCHES, reset_launches
    from rsq_tpu_torch.serving import model as S
    ids = torch.as_tensor(layer_prompts(cfg), device=dev)
    cache = S.init_cache(sc, BATCH, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = S.prefill_stacked(params, cache, ids, sc)
    got, step_s, per_step = [logits], [], None
    os.environ["RSQ_SCAN_DECODE"] = "1"
    try:
        for n in range(SCAN_STEPS):
            before = dict(LAUNCHES)
            t1 = time.perf_counter()
            logits, cache = S.decode_step_stacked(params, cache, toks[n], sc)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            if n == 1:
                per_step = {k: LAUNCHES[k] - before.get(k, 0) for k in KERNELS}
            got.append(logits)
    finally:
        del os.environ["RSQ_SCAN_DECODE"]
    total_s = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in KERNELS}
    missing = [k for k in LAYERS_KERNELS if launches[k] == 0]
    ensure(not missing, f"kernels never launched on the scan path: {missing}")
    bit_equal, worst = [], 0.0
    for a, b in zip(got, trace):
        bit_equal.append(bool(torch.equal(a, b)))
        af, bf = a.float().cpu().numpy(), b.float().cpu().numpy()
        for r in range(BATCH):
            sd = float(np.std(bf[r]))
            e = np.abs(af[r] - bf[r])
            ensure(np.isfinite(af[r]).all() and e.max() <= LOGIT_MAX * sd
                   and np.sqrt(np.mean(e ** 2)) <= LOGIT_RMS * sd,
                   "scan logits beyond the tolerance")
            worst = max(worst, float(e.max() / sd))
    return {"scan": {
        "model": "the serve_layers weights, stacked", "steps": SCAN_STEPS,
        "bit_equal_per_step": bit_equal, "max_err_over_std": worst,
        "tolerance_over_std": LOGIT_MAX,
        "wall_ms_prefill_and_steps": total_s * 1e3,
        "decode_ms_per_step_median": float(np.median(step_s)) * 1e3,
        "launches_per_decode_step": per_step}}, launches


def serve_page16(dev, cfg, params, prompts, profile: bool):
    """PagedServingEngine at page 16 (vLLM's default block size), W4A4
    INT4-KV, max_seq 1024: each step appends with the pool-append kernel
    and attends with the read-only paged kernel.  attn_int8_qk is set and,
    as in the reference, ignored at pages under 128."""
    from rsq_tpu_torch.serving import model as S
    from rsq_tpu_torch.serving.paged import PagedServingEngine
    sc = S.ServingConfig(model=cfg, a4=True, kv_int4=True, kv_hadamard=True,
                         online_had=True, max_seq=1024, attn_int8_qk=True)
    eng = PagedServingEngine(params, sc, num_slots=BATCH, page_size=16,
                             device=dev)
    rec, launches, done = drive(eng, prompts, cfg, PAGE16_KERNELS)
    reused = sorted(r.reused_pages for r in done)
    ensure(reused[-1] == 37, f"prefix cache: {reused}, expected 37 pages")
    ensure(launches["int4_paged_decode_attention_self_append"] == 0)
    if profile:
        from rsq_tpu_torch.serving.paged import decode_step_paged_fast
        ptab = torch.as_tensor(eng.page_tables, device=dev)
        lengths = torch.full((BATCH,), 512, dtype=torch.int32, device=dev)
        toks = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
        profile_decode("serve_page16", lambda: decode_step_paged_fast(
            params, eng.pool, ptab, lengths, toks, sc))
    return {"serve_page16": {
        "model": "llama3_8b widths, 32 layers, random W4A4 weights (seed 0)",
        "page": 16, "max_seq": 1024,
        "attn_int8_qk": "set, ignored at pages under 128 (as the reference)",
        "int8_lm_head": True, "prefix_pages_reused": reused, **rec}}, launches


def profile_decode(name, step):
    """One decode step, step(), with all 8 rows at length 512: its wall
    time and the time the host takes to queue it (median of 5 unprofiled
    steps), the card's busy time in it, the host-side synchronisations and
    host-to-device copies it makes (torch.profiler), and the kernel table."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    queue_ms, wall_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        queue_ms.append((t1 - t0) * 1e3)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    log(f"profile of one {name} decode step:")
    log(avg.table(sort_by="cuda_time_total", row_limit=25))
    calls = {e.key: e.count for e in avg}
    busy_ms = sum(e.self_device_time_total for e in avg
                  if e.device_type == DeviceType.CUDA) / 1e3
    wall = float(np.median(wall_ms))
    summary = {
        "step_wall_ms_median": wall, "step_wall_ms": wall_ms,
        "step_queue_ms_median": float(np.median(queue_ms)),
        "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall,
        "stream_syncs": calls.get("cudaStreamSynchronize", 0)
        + calls.get("cudaDeviceSynchronize", 0),
        "h2d_copies": sum(n for k, n in calls.items()
                          if k.startswith("Memcpy HtoD")),
        "kernel_launches": sum(n for k, n in calls.items()
                               if k in ("cudaLaunchKernel", "cuLaunchKernel",
                                        "cudaLaunchKernelExC",
                                        "cuLaunchKernelEx"))}
    log(json.dumps({"profile": {"phase": name, **summary}}))


def main(argv):
    profile = "--profile" in argv
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); this smoke runs only on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    import rsq_tpu_torch
    pkg = Path(rsq_tpu_torch.__file__).resolve().parent
    if pkg != ROOT / "rsq_tpu_torch":
        sys.exit(f"chip_smoke: rsq_tpu_torch found at {pkg}, not in {ROOT}")
    from rsq_tpu_torch.kernels import cuda_build
    from rsq_tpu_torch.models.config import ModelConfig
    from rsq_tpu_torch.serving import model as S
    from rsq_tpu_torch.serving.params import random_serving_params

    # phase 1: device
    smi = nvidia_smi()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 products
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # phase 2: build
    build_s = cuda_build.build()
    log(f"build: {build_s:.1f} s ({len(cuda_build.SOURCES)} sources, "
        "nvcc in parallel)")

    # phase 3: kernels
    cfg = ModelConfig.llama3_8b()
    g = torch.Generator(device=dev).manual_seed(0)
    log(json.dumps({**launch_floor(), "card": smi}))
    kernels = []
    for fn in (lambda: check_w4a4(dev, g), lambda: check_w8(dev, g),
               lambda: check_decode_prep(dev, g, cfg),
               lambda: check_paged_attention(dev, g, cfg),
               lambda: check_contiguous_attention(dev, g, cfg),
               lambda: check_bf16_attention(dev, g, cfg),
               lambda: check_bf16_append(dev, g, cfg),
               lambda: check_w16(dev, g, cfg),
               lambda: check_w4(dev, g, cfg),
               lambda: check_w4_affine(dev, g, cfg),
               lambda: check_w4_head(dev, g, cfg),
               lambda: check_w4a4_paired(dev, g),
               lambda: check_w4_paired(dev, g, cfg),
               lambda: check_w4_affine_unstacked(dev, g, cfg),
               lambda: check_decode_attention(dev, g, cfg),
               lambda: check_paged_read_only(dev, g, cfg),
               lambda: check_paged_append(dev, g, cfg),
               lambda: check_decode_attention(dev, g, cfg, fold=True),
               lambda: check_kv_append(dev, g, cfg),
               lambda: check_paged_read_only(dev, g, cfg, fold=True)):
        t0 = time.perf_counter()
        kernels.append(fn())
        torch.cuda.empty_cache()
        log(f"kernel {kernels[-1]['name']}: ok "
            f"({time.perf_counter() - t0:.1f} s)")

    # phase 4: small end-to-end checks against the CPU
    t0 = time.perf_counter()
    small = small_check(dev)
    t1 = time.perf_counter()
    small["small"]["quantization"] = small_quantize_check(dev)
    log(json.dumps(small))
    log(f"small: {time.perf_counter() - t0:.1f} s (engines {t1 - t0:.1f} s)")

    # phases 5 and 6: quantize, then serve -- each path's launch counts
    # start at 0 just before it; one set of weights is live at a time (the
    # W4 phases share the layers)
    prompts = serve_prompts(cfg)
    phases = []

    def run_phase(name, run):
        t0 = time.perf_counter()
        phases.append(run())
        phases[-1][0][name]["card"] = smi
        log(json.dumps(phases[-1][0]))
        log(f"{name}: {time.perf_counter() - t0:.1f} s")

    held = {}
    run_phase("quantize", lambda: quantize_phase(dev, prompts, held))
    torch.cuda.empty_cache()
    run_phase("quantize_e8p", lambda: quantize_e8p_phase(dev, prompts, held))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    families = quantize_families_phase(dev)
    families["quantize_families"]["card"] = smi
    log(json.dumps(families))
    log(f"quantize_families: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    raw = random_serving_params(cfg, seed=0, device=dev)
    params = S.quantize_lm_head(raw)
    torch.cuda.synchronize()
    log(f"serve: W4A4 params built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    run_phase("serve", lambda: serve_paged(dev, cfg, params, prompts, profile))
    run_phase("serve_contiguous", lambda: serve_contiguous(
        dev, cfg, params, prompts, profile))
    w4a4 = S.ServingConfig(model=cfg, a4=True, kv_int4=True, kv_hadamard=True,
                           online_had=True, max_seq=1024)
    layers_e = {}

    def run_layers_e():
        rec, launches, layers_e["trace"], layers_e["toks"] = serve_layers(
            dev, cfg, params, "serve_layers", w4a4, LAYERS_KERNELS,
            "llama3_8b widths, 32 layers, the W4A4 phases' random weights "
            "(seed 0), unstacked", profile, keep=SCAN_STEPS)
        return rec, launches

    run_phase("serve_layers", run_layers_e)
    run_phase("scan", lambda: scan_check(dev, cfg, params, w4a4,
                                         layers_e["trace"], layers_e["toks"]))
    layers_e.clear()
    run_phase("serve_page16", lambda: serve_page16(dev, cfg, params, prompts,
                                                   profile))
    del params
    params = S.quantize_lm_head(raw, bits=4)
    del raw
    run_phase("serve_w4", lambda: serve_w4(dev, cfg, params, prompts, profile))
    run_phase("serve_layers_w4", lambda: serve_layers(
        dev, cfg, params, "serve_layers_w4",
        S.ServingConfig(model=cfg, a4=False, kv_int4=True, kv_hadamard=True,
                        online_had=True, max_seq=1024), LAYERS_W4_KERNELS,
        "llama3_8b widths, 32 layers, the W4A4 phases' random weights served "
        "weight-only (seed 0), int4 lm_head, unstacked", profile)[:2])
    del params
    torch.cuda.empty_cache()
    e8p = {}

    def run_e8p():
        rec, launches, e8p["params"] = serve_e8p(dev, cfg, prompts, profile)
        return rec, launches

    run_phase("serve_e8p", run_e8p)
    run_phase("serve_layers_e8p", lambda: serve_layers(
        dev, cfg, e8p["params"], "serve_layers_e8p",
        S.ServingConfig(model=cfg, a4=False, kv_int4=True, kv_hadamard=True,
                        online_had=True, max_seq=1024), LAYERS_E8P_KERNELS,
        "llama3_8b widths, 32 layers, random E8P codes (seed 0) re-encoded "
        "to affine int4, unstacked", profile)[:2])
    e8p.clear()
    torch.cuda.empty_cache()
    run_phase("serve_bf16", lambda: serve_bf16(dev, cfg, prompts, profile))
    step = {name: rec[name]["decode_ms_per_step_median"]
            for rec, _ in phases for name in rec}
    log(json.dumps({"record": {
        "bf16_over_w4a4_contiguous_decode_ms":
            step["serve_bf16"] / step["serve_contiguous"],
        "w4_over_w4a4_paged_decode_ms": step["serve_w4"] / step["serve"],
        "e8p_over_w4a4_contiguous_decode_ms":
            step["serve_e8p"] / step["serve_contiguous"],
        "layers_over_w4a4_contiguous_decode_ms":
            step["serve_layers"] / step["serve_contiguous"],
        "page16_over_page512_decode_ms": step["serve_page16"] / step["serve"],
        "smoke_s_after_device_check": time.perf_counter() - t_start}}))

    for k in kernels:
        by_phase = {name: (launches[k["name"]],
                           rec[name]["launches_per_decode_step"][k["name"]])
                    for rec, launches in phases for name in rec
                    if launches[k["name"]]}
        k["launches"] = sum(n for n, _ in by_phase.values())
        k["launches_by_phase"] = {n: v[0] for n, v in by_phase.items()}
        k["launches_per_decode_step"] = {n: v[1] for n, v in by_phase.items()}
        k["card"] = smi
        if k["name"] in OFF_PATH:
            # rows 3, 7, 18: no path of the reference runs them
            ensure(k["launches"] == 0, f"{k['name']} ran on a serve path")
        else:
            ensure(k["launches"] > 0, f"{k['name']} not on any main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
