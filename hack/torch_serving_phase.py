#!/usr/bin/env python3
"""chip_smoke.py's phase 14 (sharded serving) alone, on one GPU.

    python3 hack/torch_serving_phase.py [--json PATH]

Builds the kernels, then runs chip_smoke.py's sharded-serving functions in
its order: #1, #4 and #5 at the per-rank shapes against their plain
versions and timed (``phase_serve_kernels``), the f32 exactness of every
sharded serving program in one 4-rank world (``phase_serve_exact``), full
Llama-7B at tp=2 and full mixtral-ish at ep=2 over 2 ranks
(``phase_serve_full``), entry(), dryrun_multichip(4) and the serving bench
twins at fast size (``phase_serve_surfaces``), then the device times of
the timed calls. Every rank shares the one card over gloo. Prints each
step's seconds; with ``--json`` also writes the entries, launches and the
report there. Exits non-zero on any failed check, as chip_smoke.py does.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from gpu_provisioner_tpu_torch import bench, entry
    from gpu_provisioner_tpu_torch.models import decode as td
    from gpu_provisioner_tpu_torch.models import llama as tl
    from gpu_provisioner_tpu_torch.models import moe as tm
    from gpu_provisioner_tpu_torch.models import speculative as ts
    from gpu_provisioner_tpu_torch.ops import _cuda
    from gpu_provisioner_tpu_torch.ops import flash_attention as tfa
    from gpu_provisioner_tpu_torch.parallel import jobs, launch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    _cuda.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    deferred = []
    t = t0 = time.perf_counter()
    shapes, errs = cs.phase_serve_kernels(torch, tfa, td, dev, deferred)
    print(f"kernels {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    exact = cs.phase_serve_exact(torch, tl, tm, td, ts, jobs, launch, dev)
    print(f"exact {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    by_path, report = cs.phase_serve_full(torch, tl, tm, jobs, launch, dev)
    print(f"full size {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    twins, twin_launches = cs.phase_serve_surfaces(torch, bench, entry, tfa)
    print(f"surfaces {time.perf_counter() - t:.1f} s; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cs.device_times(torch, tfa, deferred, dev)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"shapes": shapes, "errs": errs, "exact": exact,
             "launches": by_path, "report": report, "twins": twins,
             "twin_launches": twin_launches}, default=str))
    print("serving phase ok")


if __name__ == "__main__":
    main()
