#!/usr/bin/env python3
"""One of chip_smoke.py's training head-dim phases alone, on one GPU: phase
21 (head dims 96 and 80 in training), phase 23 (head dim 256 in training),
phase 25 (head dim 100 in training) or phase 27 (head dim 120 in training).

    python3 hack/torch_train_mid_heads_phase.py [--phase 21|23|25|27] \
        [--json PATH]

Builds the kernels (printing each source's nvcc seconds) and prints
ptxas's registers and spills and the HGMMA count of the phase's
tensor-core instances of the backward and triangle kernels (phases 23, 25
and 27 also every instance of their two sources, flash_bwd_wide.cu and
flash_tri_wide.cu or flash_bwd_pad.cu and flash_tri_pad.cu, the f32 ones
too), then runs chip_smoke.py's functions of the phase in its order:
#6/#7 (with #1's forward) and #3/#8/#9 at the phase's heads (21:
Phi-3-mini's 32/32 heads of 96 and H2O-Danube-1.8B's 32/8 of 80; 23:
Gemma-2B's 8/1 of 256, #6/#7 also at 16/8; 25: OpenLLaMA-3B's 32/32 of
100, #6/#7 also at 16/8; 27: H2O-Danube3-4B's 32/8 of 120, #6/#7 also at
16/8) against their plain versions, the triangle through the wrapper with
the budget lowered, and the bf16 calls timed (``phase_train_kernels``
with ``MID_TRAIN_SPECS``, ``WIDE_TRAIN_SPECS`` or ``PAD_TRAIN_SPECS``;
at 25 and 27 then ``pad_train_stores``, the five
entries' outputs against the sentinel), the widths at 2 layers flash
against dense over three f32 train steps (``phase_mid_train_exact``,
``phase_wide_train_exact``, ``phase_pad_train_exact`` at 100 or 120),
then the bf16 training paths and the triangular=True passes with their
launches (``phase_mid_train``, ``phase_wide_train``, ``phase_pad_train``
at 100 or 120). Prints
each step's seconds; with ``--json`` also
writes the rows, the launches and the report there. Exits non-zero on any
failed check, as chip_smoke.py does. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def pad_phase(cs, D):
    """Phase 25 or 27's heads, specs, exact and training functions and
    sources: chip_smoke's pad functions at head dim D."""
    return ({D: cs.PAD_HEADS[D]}, {D: cs.PAD_TRAIN_SPECS[D]},
            functools.partial(cs.phase_pad_train_exact, D=D),
            functools.partial(cs.phase_pad_train, D=D),
            ("flash_bwd_pad", "flash_tri_pad"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", type=int, choices=(21, 23, 25, 27),
                    default=21)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
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
    print(f"build {time.perf_counter() - t0:.1f} s, a source "
          f"{json.dumps(_cuda.BUILD_SECONDS)}", flush=True)
    # the phase's heads, #6-#9 specs, exact and training functions, and the
    # sources whose every instance is printed
    heads, specs, exact_fn, train_fn, sources = {
        21: (cs.MID_HEADS, cs.MID_TRAIN_SPECS, cs.phase_mid_train_exact,
             cs.phase_mid_train, ()),
        23: (cs.WIDE_HEADS, cs.WIDE_TRAIN_SPECS, cs.phase_wide_train_exact,
             cs.phase_wide_train, ("flash_bwd_wide", "flash_tri_wide")),
        25: pad_phase(cs, 100),
        27: pad_phase(cs, 120)}[args.phase]
    for name in sources:
        for fn, info in cs.ptxas_info(logs.get(name, "")).items():
            print(f"  {name}: {fn}: {info}", flush=True)
    tc = cs.tc_build_report(_cuda, logs, cs.train_tc_kernels(_cuda, heads))
    t = t0 = time.perf_counter()
    fwd, rows, _ = cs.phase_train_kernels(torch, tfa, _cuda, dev, specs)
    stores = {}
    if args.phase >= 25:
        D = next(iter(heads))
        run = cs.PAD_RUNS[D]
        stores = cs.pad_train_stores(torch, tfa, dev, D, *run.stores,
                                     run.seed + 141)
    print(f"kernels {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    exact = exact_fn(torch, tl, tm, tt, dev)
    print(f"exact {time.perf_counter() - t:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    by_dim, report = train_fn(torch, tl, tt, tfa, dev)
    print(f"training paths {time.perf_counter() - t:.1f} s; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for r in rows:
        name, D = r["name"].rsplit("_d", 1)
        paths = by_dim[int(D)]
        r["launches"] = paths[f"d{D}_long" if name.endswith("_tri")
                              else f"d{D}_train"][name]
        r.update(tc.get(r["name"], {}))
        if name in stores:
            r["at_sentinel_stores"] = stores[name]
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"tc": tc, "build_seconds": _cuda.BUILD_SECONDS,
             "fwd_at_train_shape": fwd, "rows": rows, "launches": by_dim,
             "report": report, "exact": exact, "stores": stores},
            default=str))
    print(json.dumps({"kernels": rows}))
    print(f"phase {args.phase} ok")


if __name__ == "__main__":
    main()
