#!/usr/bin/env python3
"""One of chip_smoke.py's serving head-dim phases alone, on one GPU:
phase 18 (head dims 32 and 16), phase 20 (head dims 96 and 80), phase 22
(head dim 256), phase 24 (head dim 100) or phase 26 (head dim 120).

    python3 hack/torch_serve_heads_phase.py [--phase 18|20|22|24|26] \
        [--json PATH]

Builds the kernels (printing each source's nvcc seconds) and prints
ptxas's registers and spills of every instance of the phase's forward
and decode sources, and the HGMMA count of its tensor-core instances,
then runs chip_smoke.py's functions of the phase in its order: #1/#2, #4
on a bf16 and an int8 cache and #5 on both at each of its head dims
against their plain versions and timed (``serve_kernels``); flash against
dense in f32 (phase 18: the tiny preset, the fast bench_engine model and
tiny-moe, ``phase_small_exact``; phase 20: the Phi-3-mini-width and
H2O-Danube-width models at 2 layers, ``phase_mid_exact``; phase 22: the
Gemma-2B-width model at 2 layers, ``phase_wide_exact``; phase 24: the
OpenLLaMA-3B-width model at 2 layers, phase 26: the H2O-Danube3-4B-width
model at 2 layers, ``phase_pad_exact`` at 100 or 120); the bf16
serving paths with their launches and the refusals
(``phase_small_serving``: the fast bench_moe_decode and bench_engine
twins, tiny and tiny-moe; ``phase_mid_serving``: both models at full
depth; ``phase_wide_serving``: Gemma-2B's width at 18 layers;
``phase_pad_serving``: OpenLLaMA-3B's width at 26 layers, then 36
refused by every serving and training call, or H2O-Danube3-4B's width at
24 layers, then 112 and 36); then the timed calls'
device times. Phase 22 also times #1 at the D = 128 training row's shape
(``wide_train_shape``); phases 24 and 26 launch every D = 100 or 120
entry into a sentinel-filled view of rows 128 wide (``pad_stores``) and
name the SDPA backend of their library calls (``library_backends``).
Phases 22, 24 and 26 read their rows beside the D = 128 rows of the same
calls. Prints
each step's seconds;
with ``--json`` also writes the rows, the launches and the report there.
Exits non-zero on any failed check, as chip_smoke.py does. Imports
nothing of JAX.
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
    ap.add_argument("--phase", type=int, choices=(18, 20, 22, 24, 26),
                    default=18)
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
    if args.phase == 18:
        dims = cs.SMALL_HEADS
        exact = lambda: cs.phase_small_exact(   # noqa: E731
            torch, tl, tm, td, te, tms, bench, dev)
        serving = lambda: cs.phase_small_serving(   # noqa: E731
            torch, tl, tm, td, te, tfa, bench, dev)
    elif args.phase == 20:
        dims = cs.MID_HEADS
        exact = lambda: cs.phase_mid_exact(   # noqa: E731
            torch, tl, tm, td, te, dev)
        serving = lambda: cs.phase_mid_serving(   # noqa: E731
            torch, tl, td, te, tfa, dev)
    elif args.phase == 22:
        dims = cs.WIDE_HEADS
        exact = lambda: cs.phase_wide_exact(   # noqa: E731
            torch, tl, tm, td, te, dev)
        serving = lambda: cs.phase_wide_serving(   # noqa: E731
            torch, tl, td, te, tfa, dev)
    else:
        D = {24: 100, 26: 120}[args.phase]
        dims = {D: cs.PAD_HEADS[D]}
        exact = lambda: cs.phase_pad_exact(   # noqa: E731
            torch, tl, tm, td, te, dev, D)
        serving = lambda: cs.phase_pad_serving(   # noqa: E731
            torch, tl, td, te, tfa, dev, D)
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"build {time.perf_counter() - t0:.1f} s, a source "
          f"{json.dumps(_cuda.BUILD_SECONDS)}", flush=True)
    for name in sorted({_cuda.entry(k, D) for D in dims
                        for k in ("flash_fwd", "flash_decode")}):
        for fn, info in cs.ptxas_info(logs.get(name, "")).items():
            print(f"  {name}: {fn}: {info}")
    reports = {D: cs.serve_build_report(_cuda, tfa, logs, D) for D in dims}
    deferred = []
    t = t0 = time.perf_counter()
    # phase 22's, 24's and 26's rows read beside the D = 128 rows of the
    # same calls
    ref = [] if args.phase < 22 else cs.serve_kernels(
        torch, tfa, td, dev, deferred, 128)
    rows = [r for D in dims
            for r in cs.serve_kernels(torch, tfa, td, dev, deferred, D)]
    stores = None
    if args.phase == 22:
        rows[0]["at_train_shape"] = cs.wide_train_shape(torch, tfa, dev)
    if args.phase >= 24:
        run = cs.PAD_RUNS[D]
        stores = cs.pad_stores(torch, tfa, td, dev, D, *run.stores,
                               run.seed + 132)
    print(f"kernels {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    exact_report = exact()
    print(f"exact {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    launches, report = serving()
    print(f"serving {time.perf_counter() - t:.1f} s; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t = time.perf_counter()
    cs.device_times(torch, tfa, deferred, dev)
    if args.phase >= 24:
        cs.library_backends(torch, deferred, rows)
    print(f"device times {time.perf_counter() - t:.1f} s", flush=True)
    for build_report in reports.values():
        cs.serve_reports(rows, build_report)
    if ref:
        cs.beside_d128(rows, {r["name"]: r for r in ref})
    for r in rows:
        name, D = r["name"].rsplit("_d", 1)
        r["launches"] = launches[int(D)][name]
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"build": reports, "rows": rows, "launches": launches,
             "report": report, "exact": exact_report, "stores": stores},
            default=str))
    print(json.dumps({"kernels": rows}))
    print(f"phase {args.phase} ok")


if __name__ == "__main__":
    main()
