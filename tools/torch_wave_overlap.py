#!/usr/bin/env python3
"""Two decision waves back to back on one NVIDIA GPU, for A/B runs of the
wave dispatcher.

    python3 tools/torch_wave_overlap.py [--package-root DIR] [--out FILE.json]

Builds Llama-3.1-8B at full width and depth (random bf16 weights from seed
0, greedy decoding, waves as CUDA graphs) with the port's package found at
--package-root (default: this checkout), serves one decision for
synthetic_nodes(32) (the 5,488-token prefix and the decision grammar get
installed) and closes the backend's worker, then runs chip_smoke.py's `two_wave_overlap`: a lone warm R=8
wave of the fixture pods' suffixes (A) and one of them reversed (B) are
timed, then A and B are submitted back to back and harvested in turn. It
prints one JSON line: the lone times, when each submit returned, when each
harvest returned (from A's submit), their ratio to the lone A and whether
the tokens equal the lone waves'. `--package-root .archive/parent` measures
a parent checkout's package (unpack it with `git archive <rev>
k8s_llm_scheduler_tpu_torch | tar -x -C .archive/parent`); run parent,
change, change, parent in one call for an A/B. About a minute a run.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package-root", default=str(ROOT),
                        help="directory holding the k8s_llm_scheduler_tpu_torch to measure")
    parser.add_argument("--out", help="also write the record to this JSON file")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))

    import torch

    import chip_smoke  # puts this checkout first on sys.path: the package root goes before it

    sys.path.insert(0, str(Path(args.package_root).resolve()))
    from k8s_llm_scheduler_tpu_torch.engine import local
    from k8s_llm_scheduler_tpu_torch.ops import kernels
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes

    if not torch.cuda.is_available():
        print("torch_wave_overlap: no CUDA device visible", file=sys.stderr)
        return 2
    kernels.build_all()
    # the settings both packages take: a parent checkout's build_local_backend may lack some
    accepted = inspect.signature(local.build_local_backend).parameters
    wanted = {"temperature": 0.0, "packed_admission": False, "max_pages_per_seq": 64}
    t0 = time.perf_counter()
    backend = local.build_local_backend(
        "llama-3.1-8b-instruct", device="cuda", seed=0, request_timeout_s=600.0,
        **{k: v for k, v in wanted.items() if k in accepted})
    build_s = time.perf_counter() - t0
    nodes, pods = synthetic_nodes(32), fixture_pods(8)
    try:
        backend.get_scheduling_decision(pods[0], nodes)
    finally:
        # the engine has one owner: the backend's worker (which would
        # prewarm sibling geometries while idle) stops before this thread
        # drives the engine
        backend.close()
    ok, rec = chip_smoke.two_wave_overlap(backend, nodes, pods)
    rec = {"package": str(Path(local.__file__).resolve().parents[1]), "smi": chip_smoke._smi(),
           "build_s": build_s, "ok": ok, **rec}
    print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
