"""Quantization (the port of rsq_tpu.quantize).  So far only the E8P
codebook half of `ldlq` that serving needs; the quantizers themselves
(GPTQ, RTN, LDLQ) come with the quantization pipeline."""
