"""Quantization (the port of rsq_tpu.quantize): the RSQ pipeline
(`pipeline.quantize_model`: rotate, weight tokens, GPTQ, RTN or LDLQ+E8P
per projection group, layer-streamed), its parts (`rotation`,
`weighting`, `gptq`, `ldlq`), calibration data (`data`), checkpoints
(`checkpoint`), per-layer QAT finetuning (`finetune`) and the position
weight curves (`schedulers`).  Not ported yet: the orbax checkpoint pair
(ROADMAP item 17)."""
