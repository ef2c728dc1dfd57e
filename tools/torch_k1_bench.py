#!/usr/bin/env python3
"""One kernel's phase of chip_smoke.py alone on one NVIDIA GPU, for A/B runs.

    python3 tools/torch_k1_bench.py [--kernel K1|K2|K3] [--untimed]
        [--package-root DIR] [--out FILE.json]

Runs chip_smoke.py's phase of one kernel without the 8B model: builds the
kernels, prints the kernel's ptxas report, then holds it against its plain
version at the smoke's edge cases and at the Llama-3.1-8B decision path's
shapes and times it there, cold and hot L2, beside its library yardstick.

- K1 (shared-prefix flash partials): prefix chunks q[1,2048], suffix
  prefills q[R,256] and block decodes q[R,24] against an 8,192-slot prefix
  of 5,488 tokens; yardstick SDPA.
- K2 (causal in-chunk flash partials): its `K2_EDGE_CASES`, then prefix
  chunks q[1,2048] at lens 2048 and 1392 and suffix prefills q[4,256] and
  q[8,256] at the smoke's suffix lengths; yardsticks SDPA with the dense
  mask and, at lens 2048, SDPA with is_causal=True.
- K3 (ragged block-decode matmul): the seven 8B weight shapes, int8 and
  bf16, x [R*24, K] for R = 4 and 8, at `K3_TOTALS` (the path's valid-token
  counts are data; chip_smoke.py measures them); yardstick torch.matmul on
  a bf16 (for int8, dequantized) weight.

--untimed only holds the kernel: K1 and K2 at their edge cases and the 8B
path's shapes, K3 at its edge cases and at the 8B shapes (R = 8), the
first call after a change to a kernel. --package-root measures
the port package of another checkout (say the parent commit, unpacked into
a git-ignored directory), so that two versions can be compared in one call
on one card. Exits 1 if any case disagrees, 2 without a CUDA device.
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
K1_CASES = [
    ("prefix chunk", 1, 2048, SP, 0),
    ("prefix chunk", 1, 2048, SP, 2048),
    ("prefix chunk", 1, 2048, SP, 4096),
    ("suffix prefill", 4, 256, SP, PLEN),
    ("suffix prefill", 8, 256, SP, PLEN),
    ("block decode", 4, 24, SP, PLEN),
    ("block decode", 8, 24, SP, PLEN),
]
# (step, B, S, lens) of K2 on the 8B path: H 32, n_kv 8, hd 128; the
# suffix lengths are the smoke's prompts' (32 nodes, fixture pods 0-7)
K2_CASES = [
    ("prefix chunk", 1, 2048, (2048,)),
    ("prefix chunk", 1, 2048, (PLEN - 2 * 2048,)),
    ("suffix prefill", 4, 256, (226, 0, 0, 0)),
    ("suffix prefill", 8, 256, (226, 228, 226, 231, 230, 230, 229, 228)),
]
# K3's valid tokens per block-decode call by wave rows R, standing in for a
# path A run: 1 and 8 (one 64-row tile; 8 is the batch's median in the
# smoke), 65 (two tiles); chip_smoke.py adds 0 and R*24.
K3_TOTALS = {4: [1, 8, 65], 8: [1, 8, 65]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("K1", "K2", "K3"), default="K1")
    parser.add_argument("--untimed", action="store_true",
                        help="hold the kernel at its cases without timing it")
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
    from k8s_llm_scheduler_tpu_torch.models.configs import LLAMA_3_1_8B
    from k8s_llm_scheduler_tpu_torch.ops import kernels
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    print(f"package: {Path(pa.__file__).resolve().parents[1]}", flush=True)
    if not hasattr(pa, "kv_splits"):  # a K1 from before the key split
        cs._k1_splits = lambda *shape: 1
    smi = cs._smi()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = {"K1": "prefix_attention", "K2": "causal_attention",
           "K3": "ragged_matmul"}[args.kernel]
    reports = kernels.build_all()
    cs.print_ptxas({k: v for k, v in reports.items() if k == lib})
    if args.kernel == "K1":
        good, recs, _ = cs.kernel_phase(K1_CASES, [], k2_edge_cases=[],
                                        timed=not args.untimed)
    elif args.kernel == "K2":
        good, _, recs = cs.kernel_phase([], K2_CASES, k1_edge_cases=[],
                                        timed=not args.untimed)
    elif args.untimed:
        edge = cs.K3_EDGE_CASES + [
            (f"8B {name}", 8 * cs.BLOCK_F, K, N, (0, 8, 65, 8 * cs.BLOCK_F))
            for name, K, N in cs.k3_weights(LLAMA_3_1_8B)
        ]
        good, recs = cs.k3_phase(LLAMA_3_1_8B, {}, edge)
    else:
        good, recs = cs.k3_phase(LLAMA_3_1_8B, K3_TOTALS)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"smi": smi, args.kernel: recs}, indent=1))
    print(f"torch_k1_bench: {args.kernel} {'ok' if good else 'FAILED'} ({smi})", flush=True)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
