#!/usr/bin/env python3
"""chip_smoke.py's phase 17 (head dim 64 in training) alone, on one GPU.

    python3 hack/torch_train_d64_phase.py [--json PATH]

Builds the kernels and prints ptxas's registers and spills and the HGMMA
count of the head-dim-64 tensor-core instances of the backward and
triangle kernels, then runs chip_smoke.py's phase-17 functions in its
order: #6/#7 (with #1's forward) and #3/#8/#9 at head dim 64 against their
plain versions and timed (``phase_d64_train_kernels``), a flash train step
equal to a dense one at the fast bench_train_step model's width in f32
(``phase_train_exact``), the fast model's training, its bench twin,
bench_moe_decode's model trained for three steps and a triangular=True
pass at 32k with their launches (``phase_d64_train``), and the on-card
checks (``phase_onchip_twin``). Prints each step's seconds; with ``--json``
also writes the rows, the launches and the report there. Exits non-zero
on any failed check, as chip_smoke.py does. Imports nothing of JAX.
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
    from gpu_provisioner_tpu_torch import onchip_checks as onchip
    from gpu_provisioner_tpu_torch.models import llama as tl
    from gpu_provisioner_tpu_torch.models import moe as tm
    from gpu_provisioner_tpu_torch.models import train as tt
    from gpu_provisioner_tpu_torch.ops import _cuda
    from gpu_provisioner_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    tc = cs.tc_build_report(_cuda, logs, cs.TC_KERNELS_D64_TRAIN)
    t = t0 = time.perf_counter()
    fwd, rows, _ = cs.phase_d64_train_kernels(torch, tfa, _cuda, dev)
    print(f"kernels {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    cs.phase_train_exact(torch, tl, tt, dev, cfg=bench.train_step_config(
        True), what="the fast bench_train_step model's width")
    print(f"exact {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    by_path, report = cs.phase_d64_train(torch, tl, tm, tt, tfa, bench, dev)
    print(f"full size {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    report["onchip_checks"] = cs.phase_onchip_twin(torch, onchip, dev)
    print(f"on-card checks {time.perf_counter() - t:.1f} s; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"tc": tc, "fwd_at_train_shape": fwd, "rows": rows,
             "launches": by_path, "report": report}, default=str))
    print("head-dim-64 training phase ok")


if __name__ == "__main__":
    main()
