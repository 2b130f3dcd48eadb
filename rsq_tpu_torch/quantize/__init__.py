"""Quantization (the port of rsq_tpu.quantize): the RSQ pipeline
(`pipeline.quantize_model`: rotate, weight tokens, GPTQ or RTN per
projection group, layer-streamed), its parts (`rotation`, `weighting`,
`gptq`), calibration data (`data`), checkpoints (`checkpoint`), and the E8P
codebook half of `ldlq` that serving needs.  Not ported yet: the LDLQ
quantizer, `schedulers` and `finetune` (ROADMAP item 13)."""
