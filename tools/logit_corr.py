"""The quantize phase of chip_smoke.py at other init scales of its random
params: for each SCALE, the phase as the smoke runs it (RSQ pipeline at
Llama-3-8B width on 2 layers, the result served at page 512), whose
`prefill_logit_corr` line gives the served prefill logits' correlations
with the fake-quant forward and the W4A4 bound; then whether the phase's
checks held at that scale.

    python3 tools/logit_corr.py SCALE [SCALE ...]    (the smoke: 0.02)
"""

import functools
import importlib.util
import json
import sys
from pathlib import Path
from unittest import mock

import torch

HERE = Path(__file__).resolve().parents[1]


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("logit_corr: no CUDA device")
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from rsq_tpu_torch.kernels import cuda_build
    from rsq_tpu_torch.models import llama as M
    from rsq_tpu_torch.models.config import ModelConfig
    print(json.dumps({"card": cs.nvidia_smi(),
                      "build_s": cuda_build.build()}), flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    prompts = cs.serve_prompts(ModelConfig.llama3_8b())
    for scale in map(float, argv):
        init = functools.partial(M.init_params, scale=scale)
        with mock.patch.object(M, "init_params", init):
            try:
                cs.quantize_phase(dev, prompts, {})
                held = True
            except AssertionError:
                held = False
        print(json.dumps({"scale": scale, "checks_held": held}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
