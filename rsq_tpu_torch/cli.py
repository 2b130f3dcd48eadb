"""Command-line entry point (the port of rsq_tpu.cli): quantize, eval and
serve, on the card unless --device cpu is given (it never falls back to
the CPU on its own).

  python -m rsq_tpu_torch.cli quantize --model tiny --w-bits 4 --rotate \
      --weighting attncon --min-value 0.005 --max-value 1 --w-clip \
      --add-until-fail --cal-dataset synthetic --save <dir> [--eval]
  python -m rsq_tpu_torch.cli eval --load <dir> [--a-bits 4 ...]
  python -m rsq_tpu_torch.cli quantize --model <local HF dir> --e8p \
      --rotate --add-until-fail --save <dir>
  python -m rsq_tpu_torch.cli serve --load <dir> [--attn-int8-qk]

Named models (NAMED: the Llama family, opt-125m, gemma2-9b/27b,
falcon-7b/40b and the tiny-* test configs) get seeded random weights; a
local directory is read as a Hugging Face checkpoint of any of those
families (models/hf.load_hf, which needs transformers; nothing is fetched
from the hub).  Gemma-2 quantizes without --rotate, as in the reference.
--e8p quantizes with LDLQ+E8P and saves the codes, and `serve` serves such
a checkpoint weight-only (16-bit activations) on the affine-W4 kernels,
the codes re-encoded losslessly (port-only: the reference saves no codes,
ROADMAP section 3).  `serve` takes the Llama family only, as the
reference's serving does.  Not ported yet: `longtasks` (ROADMAP item 16),
--tp > 1 and --pp > 1 (item 17).
"""

from __future__ import annotations

import argparse
import json
import logging
import time


def _build_parser():
    p = argparse.ArgumentParser(prog="rsq_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("quantize", help="run the RSQ pipeline")
    q.add_argument("--model", default="tiny",
                   help="a named config with random weights (tiny, "
                        "tiny-opt, tiny-gemma2, tiny-falcon, llama3-8b, "
                        "llama2-7b, qwen25-7b, mistral-nemo, opt-125m, "
                        "gemma2-9b, gemma2-27b, falcon-7b, falcon-40b) or "
                        "a local Hugging Face checkpoint directory")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--rotate", action="store_true")
    q.add_argument("--rotate-mode", default="hadamard",
                   choices=["hadamard", "random"])
    q.add_argument("--rotation-seed", type=int, default=0)
    q.add_argument("--fp32-had", action="store_true")
    q.add_argument("--w-bits", type=int, default=4)
    q.add_argument("--w-asym", action="store_true")
    q.add_argument("--w-clip", action="store_true")
    q.add_argument("--w-groupsize", type=int, default=-1)
    q.add_argument("--w-rtn", action="store_true")
    q.add_argument("--act-order", action="store_true")
    q.add_argument("--percdamp", type=float, default=0.01)
    q.add_argument("--add-until-fail", action="store_true")
    q.add_argument("--e8p", action="store_true")
    q.add_argument("--nf", action="store_true")
    q.add_argument("--int8-down-proj", action="store_true")
    q.add_argument("--layers-dont-quantize", type=int, nargs="*", default=[])
    q.add_argument("--nsamples", type=int, default=128)
    q.add_argument("--train-seqlen", type=int, default=2048)
    q.add_argument("--cal-dataset", default="wikitext2",
                   choices=["wikitext2", "ptb", "c4", "synthetic",
                            "retrieval", "redpajama"])
    q.add_argument("--expand-factor", type=int, default=1)
    q.add_argument("--weighting", default=None,
                   choices=[None, "attncon", "heuristic", "actnorm",
                            "actdiff", "tokenfreq", "tokensim", "cluster",
                            "dot"])
    q.add_argument("--min-value", type=float, default=1.0)
    q.add_argument("--max-value", type=float, default=3.0)
    q.add_argument("--quantile-value", type=float, default=None)
    q.add_argument("--num-bins", type=int, default=None)
    q.add_argument("--masking", type=float, default=None)
    q.add_argument("--truncate", type=float, default=None)
    q.add_argument("--reverse", action="store_true")
    q.add_argument("--method-type", default="first_half")
    q.add_argument("--weighting-apply-module", default="all")
    q.add_argument("--custom-attn-type", default=None,
                   choices=[None, "block", "window", "topk", "sink", "ss"])
    q.add_argument("--attn-length", type=int, default=None)
    q.add_argument("--num-sink-token", type=int, default=8)
    for site in ("a", "v", "k"):
        q.add_argument(f"--{site}-bits", type=int, default=16)
        q.add_argument(f"--{site}-asym", action="store_true")
        q.add_argument(f"--{site}-groupsize", type=int, default=-1)
        q.add_argument(f"--{site}-clip-ratio", type=float, default=1.0)
    q.add_argument("--eval", action="store_true", help="PPL after quant")
    q.add_argument("--eval-dataset", default="wikitext2")
    q.add_argument("--val-seqlen", type=int, default=2048)
    q.add_argument("--bsz", type=int, default=8)
    q.add_argument("--save", default=None)

    e = sub.add_parser("eval", help="evaluate a saved quantized checkpoint")
    e.add_argument("--load", required=True)
    e.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages (only 1: ROADMAP item 17)")
    e.add_argument("--eval-dataset", default="wikitext2")
    e.add_argument("--val-seqlen", type=int, default=2048)
    e.add_argument("--bsz", type=int, default=8)
    for name in ("--a-bits", "--v-bits", "--k-bits"):
        e.add_argument(name, type=int, default=16)

    s = sub.add_parser("serve", help="serve a saved quantized checkpoint "
                                     "through the paged engine")
    s.add_argument("--load", required=True)
    s.add_argument("--num-slots", type=int, default=8)
    s.add_argument("--page-size", type=int, default=512)
    s.add_argument("--max-seq", type=int, default=2048)
    s.add_argument("--max-new-tokens", type=int, default=64)
    s.add_argument("--requests", type=int, default=16)
    s.add_argument("--prompt-len", type=int, default=128)
    s.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel cards (only 1: ROADMAP item 17)")
    s.add_argument("--no-a4", action="store_true",
                   help="skip activation quantization (W4A16KV4)")
    s.add_argument("--attn-int8-qk", action="store_true")
    s.add_argument("--seed", type=int, default=0)

    sub.add_parser("longtasks", help="long-context task suites (not ported "
                                     "yet: ROADMAP item 16)")
    for cmd in (q, e, s):
        cmd.add_argument("--device", default="cuda",
                         help="cuda (default; refused without a card) or "
                              "cpu for the plain versions")
    return p


NAMED = ("llama3-8b", "llama2-7b", "qwen25-7b", "mistral-nemo", "opt-125m",
         "gemma2-9b", "gemma2-27b", "tiny", "tiny-opt", "tiny-gemma2",
         "falcon-7b", "falcon-40b", "tiny-falcon")


def _load_model(name: str, seed: int):
    import os

    import torch

    from rsq_tpu_torch.models import family
    from rsq_tpu_torch.models.config import ModelConfig
    if name not in NAMED:
        if os.path.isdir(name):
            from rsq_tpu_torch.models.hf import load_hf
            return load_hf(name)
        raise NotImplementedError(
            f"model {name!r}: not a named model nor a local directory (the "
            f"hub is not read); named: {NAMED}")
    cfg = getattr(ModelConfig, name.replace("-", "_"))()
    params = family.init_params(cfg, torch.Generator().manual_seed(seed),
                                scale=0.05 if name.startswith("tiny")
                                else 0.02)
    return cfg, params


def _policy_from_args(a, fused: bool, cfg):
    from rsq_tpu_torch.core.hadamard import hadU_supported
    from rsq_tpu_torch.core.quant import ActQuantConfig
    from rsq_tpu_torch.models.policy import KVQuantConfig, QuantPolicy

    def site(name):
        return dict(bits=getattr(a, f"{name}_bits"),
                    sym=not getattr(a, f"{name}_asym", False),
                    groupsize=getattr(a, f"{name}_groupsize", -1),
                    clip_ratio=getattr(a, f"{name}_clip_ratio", 1.0))

    return QuantPolicy(
        a=ActQuantConfig(**site("a")), v=ActQuantConfig(**site("v")),
        k=KVQuantConfig(**site("k")),
        online_had_down=fused and hadU_supported(cfg.intermediate_size),
        online_had_o=fused, fp32_had=getattr(a, "fp32_had", False),
        norms_fused=fused)


def cmd_quantize(a):
    from rsq_tpu_torch import resolve_device
    from rsq_tpu_torch.core.quant import WeightQuantConfig
    from rsq_tpu_torch.quantize import data as D
    from rsq_tpu_torch.quantize.gptq import GPTQConfig
    from rsq_tpu_torch.quantize.pipeline import RSQConfig, quantize_model
    from rsq_tpu_torch.quantize.weighting import WeightingConfig

    dev = resolve_device(a.device)
    cfg, params = _load_model(a.model, a.seed)
    logging.info("model %s: %d layers, hidden %d", a.model, cfg.num_layers,
                 cfg.hidden_size)
    calib = D.get_loaders(a.cal_dataset, nsamples=a.nsamples, seed=a.seed,
                          seqlen=a.train_seqlen, vocab_size=cfg.vocab_size)
    if a.expand_factor > 1:
        calib = D.expand_dataset(calib, a.expand_factor)
    weighting = None
    if a.weighting:
        weighting = WeightingConfig(
            method=a.weighting, min_value=a.min_value, max_value=a.max_value,
            quantile_value=a.quantile_value, num_bins=a.num_bins,
            masking=a.masking, truncate=a.truncate, reverse=a.reverse,
            method_type=a.method_type, apply_module=a.weighting_apply_module,
            custom_attn_type=a.custom_attn_type, attn_length=a.attn_length,
            num_sink_token=a.num_sink_token)
    rsq = RSQConfig(
        w=WeightQuantConfig(bits=a.w_bits, sym=not a.w_asym, mse=a.w_clip,
                            nf=a.nf),
        gptq=GPTQConfig(groupsize=a.w_groupsize, actorder=a.act_order,
                        percdamp=a.percdamp, add_until_fail=a.add_until_fail),
        weighting=weighting, rotate=a.rotate, rotate_mode=a.rotate_mode,
        rotation_seed=a.rotation_seed, w_rtn=a.w_rtn, e8p=a.e8p,
        nsamples=a.nsamples, seed=a.seed, int8_down_proj=a.int8_down_proj,
        layers_dont_quantize=tuple(a.layers_dont_quantize))

    t0 = time.time()
    qparams, quantizers = quantize_model(params, cfg, rsq, calib, device=dev)
    logging.info("quantization time: %.1fs", time.time() - t0)
    if a.save:
        from rsq_tpu_torch.quantize.checkpoint import save_quantized
        save_quantized(a.save, qparams, quantizers, cfg,
                       meta={"rotate": a.rotate, "w_bits": a.w_bits,
                             "weighting": a.weighting})
        logging.info("saved to %s", a.save)
    result = {"quant_seconds": round(time.time() - t0, 1),
              "device": str(dev)}
    if a.eval:
        from rsq_tpu_torch.eval.ppl import ppl_fullmodel
        stream = D.get_loaders(a.eval_dataset, eval_mode=True, seed=a.seed,
                               vocab_size=cfg.vocab_size)
        policy = _policy_from_args(a, fused=a.rotate, cfg=cfg)
        result.update({"ppl": ppl_fullmodel(qparams, cfg, policy, stream,
                                            a.val_seqlen, a.bsz, device=dev),
                       "dataset": a.eval_dataset, "val_seqlen": a.val_seqlen})
        print(json.dumps(result))
    return result


def cmd_eval(a):
    from rsq_tpu_torch import resolve_device
    from rsq_tpu_torch.eval.ppl import ppl_fullmodel
    from rsq_tpu_torch.quantize import data as D
    from rsq_tpu_torch.quantize.checkpoint import load_quantized

    if a.pp > 1:
        raise NotImplementedError("--pp > 1 (pipeline-parallel eval) is "
                                  "ROADMAP item 17")
    dev = resolve_device(a.device)
    params, _, cfg, manifest = load_quantized(a.load)
    policy = _policy_from_args(a, fused=manifest.get("norms_fused", False),
                               cfg=cfg)
    stream = D.get_loaders(a.eval_dataset, eval_mode=True,
                           vocab_size=cfg.vocab_size)
    ppl = ppl_fullmodel(params, cfg, policy, stream, a.val_seqlen, a.bsz,
                        device=dev)
    out = {"ppl": ppl, "dataset": a.eval_dataset, "device": str(dev)}
    print(json.dumps(out))
    return out


def cmd_serve(a):
    """Throughput run of the paged continuous-batching engine on a saved
    checkpoint; one with E8P codes is served weight-only (a4 off), as the
    affine-W4 route is."""
    import numpy as np

    from rsq_tpu_torch import resolve_device
    from rsq_tpu_torch.models.family import LLAMA_FAMILY
    from rsq_tpu_torch.quantize.checkpoint import load_quantized
    from rsq_tpu_torch.serving import model as S
    from rsq_tpu_torch.serving.paged import PagedServingEngine
    from rsq_tpu_torch.serving.params import to_serving_params

    if a.tp > 1:
        raise NotImplementedError("--tp > 1 (tensor-parallel serving) is "
                                  "ROADMAP item 17")
    dev = resolve_device(a.device)
    params, quantizers, cfg, manifest = load_quantized(a.load)
    if cfg.family not in LLAMA_FAMILY:
        raise NotImplementedError(
            f"serve: a {cfg.family} checkpoint; rsq_tpu serves the Llama "
            f"family only ({', '.join(LLAMA_FAMILY)}), and so does the "
            f"port: evaluate it with `eval`")
    sparams = to_serving_params(params, quantizers, cfg, device=dev)
    e8p = any("codes" in q for q in quantizers.values())
    sc = S.ServingConfig(model=cfg, a4=not (a.no_a4 or e8p), kv_int4=True,
                         kv_hadamard=True,
                         online_had=manifest.get("meta", {}).get("rotate",
                                                                 False),
                         max_seq=a.max_seq, attn_int8_qk=a.attn_int8_qk)
    rng = np.random.default_rng(a.seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=a.prompt_len)
               for _ in range(a.requests)]
    eng = PagedServingEngine(sparams, sc, num_slots=a.num_slots,
                             page_size=a.page_size, device=dev)
    for p in prompts:
        eng.add_request(p, max_new_tokens=a.max_new_tokens)
    t0 = time.time()
    done = eng.run_until_done()
    dt = time.time() - t0
    new_tokens = sum(len(r.output) for r in done)
    out = {"requests": len(done), "new_tokens": new_tokens,
           "seconds": round(dt, 2), "tok_per_sec": round(new_tokens / dt, 1),
           "num_slots": a.num_slots, "page_size": a.page_size,
           "e8p": e8p, "a4": sc.a4,
           "device": str(dev)}
    print(json.dumps(out))
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    a = _build_parser().parse_args(argv)
    if a.cmd == "longtasks":
        raise NotImplementedError("the long-context task suites are ROADMAP "
                                  "item 16")
    return {"quantize": cmd_quantize, "eval": cmd_eval,
            "serve": cmd_serve}[a.cmd](a)


if __name__ == "__main__":
    main()
