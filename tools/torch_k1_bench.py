#!/usr/bin/env python3
"""K1 (shared-prefix flash partials) alone on one NVIDIA GPU, for A/B runs.

    python3 tools/torch_k1_bench.py [--package-root DIR] [--out FILE.json]

Runs chip_smoke.py's K1 phase without the 8B model: builds the kernels,
prints K1's ptxas report, then holds K1 against its plain version at the
smoke's edge cases and at the Llama-3.1-8B decision path's shapes (prefix
chunks q[1,2048], suffix prefills q[R,256], block decodes q[R,24] against
an 8,192-slot prefix of 5,488 tokens) and times it there, cold and hot L2,
beside SDPA. --package-root measures the port package of another checkout
(say the parent commit, unpacked into a git-ignored directory), so that two
versions can be compared in one call on one card. Exits 1 if any case
disagrees, 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PLEN = 5488  # the 32-node cluster prefix of chip_smoke.py
SP = 8192  # its prefix buffer: 3 chunks of 2,048 plus one of headroom
# (step, B, S, Sp, prefix_len) on the 8B path: H 32, n_kv 8, hd 128
PATH_CASES = [
    ("prefix chunk", 1, 2048, SP, 0),
    ("prefix chunk", 1, 2048, SP, 2048),
    ("prefix chunk", 1, 2048, SP, 4096),
    ("suffix prefill", 4, 256, SP, PLEN),
    ("suffix prefill", 8, 256, SP, PLEN),
    ("block decode", 4, 24, SP, PLEN),
    ("block decode", 8, 24, SP, PLEN),
]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package-root", default=str(ROOT),
                        help="the checkout whose k8s_llm_scheduler_tpu_torch to measure")
    parser.add_argument("--out", help="also write the records to this JSON file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_k1_bench: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.package_root).resolve()))
    from k8s_llm_scheduler_tpu_torch.ops import kernels
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    print(f"package: {Path(pa.__file__).resolve().parents[1]}", flush=True)
    if not hasattr(pa, "kv_splits"):  # a K1 from before the key split
        cs._k1_splits = lambda *shape: 1
    smi = cs._smi()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    reports = kernels.build_all()
    cs.print_ptxas({k: v for k, v in reports.items() if k == "prefix_attention"})
    good, recs, _ = cs.kernel_phase(PATH_CASES, [])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"smi": smi, "k1": recs}, indent=1))
    print(f"torch_k1_bench: {'ok' if good else 'FAILED'} ({smi})", flush=True)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
