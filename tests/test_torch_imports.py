"""rsq_tpu_torch stands alone: importing every module of it (and the chip
smoke script) pulls in neither JAX nor rsq_tpu, and with no GPU the entry
points that default to device="cuda" raise instead of running on the CPU."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rsq_tpu_torch
from rsq_tpu_torch.kernels import KERNELS
from rsq_tpu_torch.kernels import paged_kv as TPKV
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.serving import engine as TE
from rsq_tpu_torch.serving import model as TS
from rsq_tpu_torch.serving import paged as TPG
from rsq_tpu_torch.serving import params as TP

ROOT = Path(__file__).resolve().parents[1]


def all_modules():
    return ["rsq_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(rsq_tpu_torch.__path__,
                                              "rsq_tpu_torch."))


def test_modules_import_without_jax_or_rsq_tpu():
    mods = all_modules()
    assert {"rsq_tpu_torch.serving.paged",
            "rsq_tpu_torch.serving.engine"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "from rsq_tpu_torch.serving.model import (serving_linear, "
        "serving_linear_fused, prefill, decode_step, prefill_stacked)\n"
        "from rsq_tpu_torch.serving.paged import (prefill_paged, "
        "decode_step_paged)\n"
        "from rsq_tpu_torch.kernels.paged_kv import (paged_append_pool, "
        "int4_paged_decode_attention_stacked, "
        "int4_paged_decode_attention_stacked_self)\n"
        "from rsq_tpu_torch.kernels.kv_cache import ("
        "int4_decode_attention_stacked, int4_decode_attention_stacked_self, "
        "kv_append_stacked)\n"
        "from rsq_tpu_torch.kernels.matmul_w4 import (w4a4_matmul_paired, "
        "w4_matmul_paired, w4_affine_matmul)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'rsq_tpu.')) or m == 'rsq_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


def _needs_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")


@pytest.mark.parametrize("entry", ["init_pool", "from_numpy_params",
                                   "to_serving_params",
                                   "random_serving_params", "engine",
                                   "init_cache", "random_dense_params",
                                   "serving_engine", "quantize_model",
                                   "gptq_quantize", "rtn_quantize",
                                   "rotate_model", "ppl_fullmodel",
                                   "ppl_streamed", "cli_quantize",
                                   "cli_eval", "cli_serve",
                                   "ldlq_quantize", "finetune_layer",
                                   "cli_quantize_e8p"])
def test_default_device_raises_without_cuda(entry, tmp_path):
    _needs_no_gpu()
    from rsq_tpu_torch import cli
    from rsq_tpu_torch.core.quant import WeightQuantConfig
    from rsq_tpu_torch.eval import ppl
    from rsq_tpu_torch.models.llama import init_params
    from rsq_tpu_torch.models.policy import FP16
    from rsq_tpu_torch.quantize import (finetune, gptq, ldlq, pipeline,
                                        rotation)
    from rsq_tpu_torch.quantize.checkpoint import save_quantized
    cfg = ModelConfig.tiny()
    params = init_params(cfg)
    save_quantized(str(tmp_path), params, {}, cfg)
    stream = np.arange(64) % cfg.vocab_size
    calls = {
        "quantize_model": lambda: pipeline.quantize_model(
            params, cfg, pipeline.RSQConfig(nsamples=2),
            np.zeros((2, 8), np.int64)),
        "gptq_quantize": lambda: gptq.gptq_quantize(
            torch.ones(4, 8), torch.eye(8), WeightQuantConfig()),
        "rtn_quantize": lambda: gptq.rtn_quantize(torch.ones(4, 8),
                                                  WeightQuantConfig()),
        "rotate_model": lambda: rotation.rotate_model(params, cfg),
        "ppl_fullmodel": lambda: ppl.ppl_fullmodel(params, cfg, FP16, stream,
                                                   16),
        "ppl_streamed": lambda: ppl.ppl_streamed(params, cfg, FP16, stream,
                                                 16),
        "cli_quantize": lambda: cli.main(["quantize", "--cal-dataset",
                                          "synthetic", "--nsamples", "2",
                                          "--train-seqlen", "8"]),
        "cli_eval": lambda: cli.main(["eval", "--load", str(tmp_path),
                                      "--eval-dataset", "synthetic"]),
        "cli_serve": lambda: cli.main(["serve", "--load", str(tmp_path)]),
        "cli_quantize_e8p": lambda: cli.main(["quantize", "--e8p",
                                              "--cal-dataset", "synthetic",
                                              "--nsamples", "2",
                                              "--train-seqlen", "8"]),
        "ldlq_quantize": lambda: ldlq.ldlq_quantize(torch.ones(4, 8),
                                                    torch.eye(8)),
        "finetune_layer": lambda: finetune.finetune_layer(
            params["layers"][0], {}, 0, np.zeros((2, 8, cfg.hidden_size)),
            np.zeros((2, 8, cfg.hidden_size)), cfg, FP16),
        "init_pool": lambda: TPKV.init_pool(2, 3, 2, 16, 128),
        "from_numpy_params": lambda: TP.from_numpy_params(
            {"w": np.zeros((2, 2), np.float32)}),
        "to_serving_params": lambda: TP.to_serving_params(
            {"embed": np.zeros((4, 4), np.float32)}, {}, cfg),
        "random_serving_params": lambda: TP.random_serving_params(cfg),
        "engine": lambda: TPG.PagedServingEngine(
            TP.random_serving_params(cfg, device="cpu"),
            TS.ServingConfig(model=cfg, max_seq=256)),
        "init_cache": lambda: TS.init_cache(
            TS.ServingConfig(model=cfg, max_seq=256), 2),
        "random_dense_params": lambda: TP.random_dense_params(cfg),
        "serving_engine": lambda: TE.ServingEngine(
            TP.random_dense_params(cfg, device="cpu"),
            TS.ServingConfig(model=cfg, a4=False, kv_int4=False,
                             max_seq=256)),
    }
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        calls[entry]()


def test_chip_smoke_refuses_without_cuda():
    """No card: the smoke exits nonzero before doing anything and prints no
    result line."""
    _needs_no_gpu()
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


# Each pallas_call site of rsq_tpu/kernels, by the function it sits in, and
# the port's kernel that replaces it.  _self_append_flat_call (row 20) is the
# one-grid-step twin of row 19 and shares its kernel.
PALLAS_SITES = {
    ("kv_cache.py", "decode_prep"): "decode_prep",
    ("kv_cache.py", "int4_decode_attention_stacked"):
        "int4_decode_attention_stacked",
    ("kv_cache.py", "int4_decode_attention_stacked_self"):
        "int4_decode_attention_stacked_self",
    ("kv_cache.py", "int4_decode_attention_self_append"):
        "int4_decode_attention_self_append",
    ("kv_cache.py", "bf16_decode_attention_stacked"):
        "bf16_decode_attention_stacked",
    ("kv_cache.py", "kv_append_stacked_bf16"): "kv_append_stacked_bf16",
    ("kv_cache.py", "kv_append_stacked"): "kv_append_stacked",
    ("matmul_w4.py", "w4_matmul"): "w4_matmul",
    ("matmul_w4.py", "w4_matmul_paired"): "w4_matmul_paired",
    ("matmul_w4.py", "w4_affine_matmul"): "w4_affine_matmul",
    ("matmul_w4.py", "w4a4_matmul_paired"): "w4a4_matmul_paired",
    ("matmul_w4.py", "w4a4_matmul_paired_stacked"):
        "w4a4_matmul_paired_stacked",
    ("matmul_w4.py", "w4_matmul_paired_stacked"): "w4_matmul_paired_stacked",
    ("matmul_w4.py", "w4_affine_matmul_stacked"): "w4_affine_matmul_stacked",
    ("matmul_w4.py", "w16_matmul_stacked"): "w16_matmul_stacked",
    ("matmul_w4.py", "w8_matmul"): "w8_matmul",
    ("paged_kv.py", "int4_paged_decode_attention_stacked"):
        "int4_paged_decode_attention_stacked",
    ("paged_kv.py", "int4_paged_decode_attention_stacked_self"):
        "int4_paged_decode_attention_stacked_self",
    ("paged_kv.py", "int4_paged_decode_attention_self_append"):
        "int4_paged_decode_attention_self_append",
    ("paged_kv.py", "_self_append_flat_call"):
        "int4_paged_decode_attention_self_append",
    ("paged_kv.py", "paged_append_pool"): "paged_append_pool",
}


def _pallas_sites():
    """Every pl.pallas_call in rsq_tpu/kernels/*.py, read as text (nothing
    of rsq_tpu is imported): {(file, enclosing def): "file:def line"}."""
    sites = {}
    for path in sorted((ROOT / "rsq_tpu" / "kernels").glob("*.py")):
        fn = None
        for i, line in enumerate(path.read_text().splitlines(), 1):
            m = re.match(r"def (\w+)\(", line)
            if m:
                fn = (m.group(1), i)
            if "pl.pallas_call(" in line:
                assert fn is not None, f"{path.name}:{i} outside a def"
                key = (path.name, fn[0])
                assert key not in sites, f"two sites in {key}"
                sites[key] = f"rsq_tpu/kernels/{path.name}:{fn[1]}"
    return sites


def _smoke_replaces():
    """{kernel name: the "replaces" and "also_replaces" strings} of the
    kernel checks in chip_smoke.py."""
    text = (ROOT / "chip_smoke.py").read_text()
    found = {}
    for m in re.finditer(
            r'"name": "(\w+)",\s*"route": "cuda",\s*"source": "[^"]+",\s*'
            r'"replaces": "([^"]+)"(?:,\s*"also_replaces": "([^"]+)")?', text):
        found.setdefault(m.group(1), set()).update(
            s for s in m.group(2, 3) if s)
    return found


def test_kernel_table_complete():
    """All 21 pallas_call sites map to a port kernel in KERNELS, and each
    has a check in chip_smoke.py that names the site's function as the one
    it replaces."""
    sites = _pallas_sites()
    assert len(sites) == 21
    assert set(sites) == set(PALLAS_SITES)
    assert set(PALLAS_SITES.values()) == set(KERNELS)
    replaces = _smoke_replaces()
    for key, where in sites.items():
        name = PALLAS_SITES[key]
        assert where in replaces.get(name, ()), (key, name, where)
