#!/usr/bin/env python3
"""chip_smoke.py's phase 19 (head dims 32 and 16 in training) alone, on one
GPU.

    python3 hack/torch_train_small_heads_phase.py [--json PATH]

Builds the kernels (printing each source's nvcc seconds) and prints
ptxas's registers and spills and the HGMMA count of the head-dim-32 and 16
tensor-core instances of the backward and triangle kernels, then runs
chip_smoke.py's phase-19 functions in its order: #6/#7 (with #1's forward)
and #3/#8/#9 at head dims 32 and 16 against their plain versions, the
triangle through the wrapper with the budget lowered, and the bf16 calls
timed (``phase_train_kernels``), tiny, the fast bench_engine model
and tiny-moe flash against dense over three f32 train steps
(``phase_small_train_exact``), then the bf16 training paths, the
pp2_tp2_flash pipeline on tiny and the triangular=True passes with their
launches (``phase_small_train``). Prints each step's seconds; with
``--json`` also writes the rows, the launches and the report there. Exits
non-zero on any failed check, as chip_smoke.py does. Imports nothing of
JAX.
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
    from gpu_provisioner_tpu_torch.models import llama as tl
    from gpu_provisioner_tpu_torch.models import moe as tm
    from gpu_provisioner_tpu_torch.models import train as tt
    from gpu_provisioner_tpu_torch.ops import _cuda
    from gpu_provisioner_tpu_torch.ops import flash_attention as tfa
    from gpu_provisioner_tpu_torch.parallel import jobs, launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"build {time.perf_counter() - t0:.1f} s, a source "
          f"{json.dumps(_cuda.BUILD_SECONDS)}", flush=True)
    tc = cs.tc_build_report(_cuda, logs,
                            cs.train_tc_kernels(_cuda, cs.SMALL_HEADS))
    t = t0 = time.perf_counter()
    fwd, rows, _ = cs.phase_train_kernels(torch, tfa, _cuda, dev,
                                          cs.SMALL_TRAIN_SPECS)
    print(f"kernels {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    exact = cs.phase_small_train_exact(torch, tl, tm, tt, bench, dev)
    print(f"exact {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    by_dim, report = cs.phase_small_train(torch, tl, tm, tt, tfa, jobs,
                                          launch, bench, dev)
    print(f"training paths {time.perf_counter() - t:.1f} s; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for r in rows:
        name, D = r["name"].rsplit("_d", 1)
        paths = by_dim[int(D)]
        r["launches"] = paths[f"d{D}_long" if name.endswith("_tri")
                              else f"d{D}_train"][name]
        r.update(tc.get(r["name"], {}))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"tc": tc, "build_seconds": _cuda.BUILD_SECONDS,
             "fwd_at_train_shape": fwd, "rows": rows, "launches": by_dim,
             "report": report, "exact": exact}, default=str))
    print(json.dumps({"kernels": rows}))
    print("head dims 32 and 16 training phase ok")


if __name__ == "__main__":
    main()
