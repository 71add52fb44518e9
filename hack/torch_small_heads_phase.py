#!/usr/bin/env python3
"""chip_smoke.py's phase 18 (head dims 32 and 16 in serving) alone, on one
GPU.

    python3 hack/torch_small_heads_phase.py [--json PATH]

Builds the kernels (printing each source's nvcc seconds) and prints
ptxas's registers and spills and the HGMMA count of the head-dim-32 and
16 tensor-core instances of the forward and of the timed decode
instances, then runs chip_smoke.py's phase-18 functions in its order:
#1/#2, #4 on a bf16 and an int8 cache and #5 on both at head dims 32 and
16 against their plain versions and timed (``phase_small_kernels``), the
tiny preset, the fast bench_engine model and tiny-moe with flash against
dense in f32 (``phase_small_exact``), the fast bench_moe_decode and
bench_engine twins and the models' bf16 serving with their launches and
the backward's refusals (``phase_small_serving``), then the timed calls'
device times. Prints each step's seconds; with ``--json`` also writes the
rows, the launches and the report there. Exits non-zero on any failed
check, as chip_smoke.py does. Imports nothing of JAX.
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
    from gpu_provisioner_tpu_torch import bench
    from gpu_provisioner_tpu_torch.models import decode as td
    from gpu_provisioner_tpu_torch.models import engine as te
    from gpu_provisioner_tpu_torch.models import llama as tl
    from gpu_provisioner_tpu_torch.models import moe as tm
    from gpu_provisioner_tpu_torch.models import moe_serve as tms
    from gpu_provisioner_tpu_torch.ops import _cuda
    from gpu_provisioner_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"build {time.perf_counter() - t0:.1f} s, a source "
          f"{json.dumps(_cuda.BUILD_SECONDS)}", flush=True)
    tc = cs.tc_build_report(_cuda, logs, cs.TC_KERNELS_SMALL)
    dec = cs.decode_build_report(logs, cs.DECODE_INSTANCES_SMALL,
                                 "flash_decode_narrow")
    deferred = []
    t = t0 = time.perf_counter()
    rows = cs.phase_small_kernels(torch, tfa, td, dev, deferred)
    print(f"kernels {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    exact = cs.phase_small_exact(torch, tl, tm, td, te, tms, bench, dev)
    print(f"exact {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    launches, report = cs.phase_small_serving(torch, tl, tm, td, te, tfa,
                                              bench, dev)
    print(f"serving {time.perf_counter() - t:.1f} s; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t = time.perf_counter()
    cs.device_times(torch, tfa, deferred, dev)
    print(f"device times {time.perf_counter() - t:.1f} s", flush=True)
    for r in rows:
        name, D = r["name"].rsplit("_d", 1)
        r["launches"] = launches[int(D)][name]
        r.update(tc.get(r["name"], {}))
        if r["name"] in dec:
            r["ptxas"] = dec[r["name"]]
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"tc": tc, "decode_ptxas": dec, "rows": rows,
             "launches": launches, "report": report, "exact": exact},
            default=str))
    print(json.dumps({"kernels": rows}))
    print("head dims 32 and 16 phase ok")


if __name__ == "__main__":
    main()
