"""Evaluation (the port of rsq_tpu.eval): perplexity, and the LongEval
"lines" case generator that the retrieval calibration set draws on."""
