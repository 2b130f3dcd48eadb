"""Calibration and evaluation data (the port of rsq_tpu.quantize.data,
numpy as the reference is).

Loaders return either a (nsamples, seqlen) int array of calibration
sequences or a long 1-D evaluation token stream.  HF `datasets`-backed
loaders (wikitext2 / ptb / c4) work when the dataset cache or network is
available; the `synthetic` loader generates Zipf-distributed tokens so
benchmarks and tests run hermetically.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def synthetic_tokens(vocab_size: int, n_tokens: int, seed: int = 0,
                     zipf_a: float = 1.2) -> np.ndarray:
    """Zipf-distributed token stream (natural-language-like frequencies)."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(zipf_a, size=n_tokens)
    return ((ranks - 1) % vocab_size).astype(np.int32)


def sample_sequences(stream: np.ndarray, nsamples: int, seqlen: int,
                     seed: int = 0) -> np.ndarray:
    """Random crops of length seqlen, the reference's calibration sampling
    (data_utils.py:92-101)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, stream.size - seqlen - 1, size=nsamples)
    return np.stack([stream[i: i + seqlen] for i in starts]).astype(np.int32)


def expand_dataset(seqs: np.ndarray, expand_factor: int) -> np.ndarray:
    """Roll-shift dataset expansion (data_utils.expand_dataset :184-196)."""
    if expand_factor <= 1:
        return seqs
    out = []
    shift = seqs.shape[1] // expand_factor
    for row in seqs:
        for f in range(expand_factor):
            out.append(np.roll(row, shift * f))
    return np.stack(out)


def _tokenizer(model_name: str):
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(model_name, use_fast=True)


def _hash_tokenize(text: str, vocab_size: int) -> np.ndarray:
    """Deterministic whitespace tokenizer for hermetic runs (no HF tokenizer
    download): each word hashes to a stable id in [0, vocab)."""
    import zlib
    ids = [zlib.crc32(w.encode()) % vocab_size for w in text.split()]
    return np.asarray(ids, dtype=np.int32)


def synthetic_retrieval_prompts(nsamples: int, seed: int = 0,
                                num_lines: int = 300) -> list[str]:
    """LongEval-lines-style long prompts generated offline.

    The reference's `retrieval` calibration set is a pre-built jsonl of
    synthetic retrieval testcases (data_utils.py:52-75, hard-coded local
    path); here the cases are synthesized on the fly so the loader is
    hermetic."""
    from rsq_tpu_torch.eval.tasks import generate_lines_case
    rng = np.random.default_rng(seed)
    return [generate_lines_case(num_lines, rng)["prompt"]
            for _ in range(nsamples)]


def get_retrieval(nsamples: int, seed: int, seqlen: int, model: str = "",
                  vocab_size: int = 32000, jsonl_path: str | None = None,
                  num_lines: int = 300) -> np.ndarray:
    """Synthetic-retrieval calibration crops (data_utils.get_retrieval
    :52-75): one random seqlen-crop per prompt, prompts cycled if nsamples
    exceeds the case count. jsonl_path: optional pre-built testcase file in
    the reference's format ({"prompt": ...} per line)."""
    import json
    if jsonl_path is not None:
        with open(jsonl_path) as f:
            prompts = [json.loads(line)["prompt"] for line in f]
    else:
        prompts = synthetic_retrieval_prompts(
            max(nsamples, 1), seed=seed, num_lines=num_lines)
    tok = _tokenizer(model) if model else None
    rng = np.random.default_rng(seed)
    out = []
    for idx in range(nsamples):
        p = prompts[idx % len(prompts)]
        ids = (np.asarray(tok(p, return_tensors="np").input_ids[0],
                          dtype=np.int32) if tok is not None
               else _hash_tokenize(p, vocab_size))
        if ids.size <= seqlen:           # pad short cases by tiling the prompt
            reps = seqlen // ids.size + 2
            ids = np.tile(ids, reps)
        i = rng.integers(0, ids.size - seqlen)
        out.append(ids[i: i + seqlen])
    return np.stack(out).astype(np.int32)


def get_red_pajama(nsamples: int, seed: int, seqlen: int, model: str,
                   n_docs: int = 5000) -> np.ndarray:
    """RedPajama-1T-Sample calibration crops (data_utils.get_red_pajama
    :21-49): rejection-sample documents longer than seqlen, one random crop
    each. Needs network / dataset cache."""
    import datasets
    tok = _tokenizer(model)
    ds = datasets.load_dataset("togethercomputer/RedPajama-Data-1T-Sample",
                               split="train")
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < nsamples:
        i = int(rng.integers(0, min(len(ds), n_docs)))
        ids = np.asarray(tok(ds[i]["text"], return_tensors="np").input_ids[0],
                         dtype=np.int32)
        if ids.size <= seqlen:
            continue
        j = int(rng.integers(0, ids.size - seqlen))
        out.append(ids[j: j + seqlen])
    return np.stack(out)


def load_text_dataset(name: str, split: str):
    import datasets
    if name == "wikitext2":
        ds = datasets.load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
        return "\n\n".join(ds["text"])
    if name == "ptb":
        ds = datasets.load_dataset("ptb_text_only", "penn_treebank", split=split)
        return " ".join(ds["sentence"])
    if name == "c4":
        files = {"train": "en/c4-train.00000-of-01024.json.gz",
                 "validation": "en/c4-validation.00000-of-00008.json.gz"}
        ds = datasets.load_dataset("allenai/c4", data_files={split: files[split]},
                                   split=split)
        return " ".join(ds[:1100]["text"])
    raise ValueError(f"unknown dataset {name}")


def get_loaders(name: str, *, nsamples: int = 128, seed: int = 0,
                seqlen: int = 2048, model: str = "", vocab_size: int = 32000,
                eval_mode: bool = False):
    """Reference-shaped entry point (data_utils.get_loaders :169-181).

    eval_mode: returns a 1-D token stream; else (nsamples, seqlen) crops.
    `synthetic` needs no tokenizer/network.
    """
    if name == "synthetic":
        stream = synthetic_tokens(vocab_size, 2_000_000 if not eval_mode
                                  else 600_000, seed=seed + (1 if eval_mode else 0))
        if eval_mode:
            return stream
        return sample_sequences(stream, nsamples, seqlen, seed=seed)
    if "retrieval" in name:
        if eval_mode:
            raise ValueError("retrieval is a calibration-only set")
        return get_retrieval(nsamples, seed, seqlen, model=model,
                             vocab_size=vocab_size)
    if "pajama" in name:
        if eval_mode:
            raise ValueError("only the train set is supported in RedPajama")
        return get_red_pajama(nsamples, seed, seqlen, model=model)

    tok = _tokenizer(model)
    text = load_text_dataset(name, "test" if eval_mode and name != "c4"
                             else ("validation" if eval_mode else "train"))
    ids = np.asarray(tok(text, return_tensors="np").input_ids[0], dtype=np.int32)
    if eval_mode:
        return ids
    return sample_sequences(ids, nsamples, seqlen, seed=seed)
