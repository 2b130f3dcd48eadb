"""Run chip_smoke.py's kernel checks against the rsq_tpu_torch of another
checkout (an unpacked parent commit, say) and print one JSON line per
check: its device, events, plain and library times and, per case, the
same.  The checks come from this checkout's chip_smoke.py; the package
they call, and the kernels built, from ROOT.  Compare two checkouts in
one call on one card, in turns (parent, change, change, parent).

    python3 tools/compare_kernels.py ROOT [CHECK ...]

CHECK names a chip_smoke.py function (default: the weight-only and INT4
attention checks).
"""

import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
CHECKS = ("check_w4", "check_w4_affine", "check_w4_head", "check_w4_paired",
          "check_w4_affine_unstacked", "check_paged_attention",
          "check_contiguous_attention", "check_decode_attention",
          "check_paged_read_only")


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
