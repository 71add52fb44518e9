#!/usr/bin/env python3
"""How often the first multi-threaded torch.exp of a process comes out wrong.

On the CPU, torch.exp of a float tensor goes to MKL's vector math, and ATen
splits a large tensor over the OpenMP threads. When that split call is the
process's first exp, one thread's chunk now and then comes out with a
relative error of about 1.5e-4 (6e-8 elsewhere). This script starts fresh
processes in batches, as pytest-xdist starts its workers, and counts the
bad ones in two modes:

- ``cold``: the first exp is the split one (the attention scores of
  tests/test_torch_flash.py's first case, through torch.einsum as
  ``attention_plain`` computes them);
- ``primed``: ``gpu_provisioner_tpu_torch`` is imported first, which makes
  the first exp a call on one thread (``device.prime_cpu_math``).

    python3 hack/torch_exp_first_call.py [--runs 120] [--parallel 6]

CPU only; it prints one line a mode: the runs, the bad runs and the worst
relative error.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def child(mode: str) -> None:
    if mode == "primed":
        sys.path.insert(0, str(ROOT))
        import gpu_provisioner_tpu_torch  # noqa: F401  (primes on import)
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal((2, 256, 4, 32))
                             .astype(np.float32)) for _ in range(2))
    s = torch.einsum("bshd,bkhd->bhsk", q, k) * 32 ** -0.5
    causal = torch.ones(256, 256, dtype=torch.bool).tril()
    x = torch.where(causal, s, -1e30)
    x = x - x.amax(dim=-1, keepdim=True)
    got = torch.exp(x).double()        # the process's first exp
    want = torch.exp(x.double())
    print(((got - want).abs() / want.clamp(min=1e-30)).max().item())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=120)
    ap.add_argument("--parallel", type=int, default=6)
    ap.add_argument("--child", choices=("cold", "primed"))
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return
    errs = {"cold": [], "primed": []}
    modes = [m for _ in range(args.runs) for m in errs]
    for i in range(0, len(modes), args.parallel):
        batch = modes[i:i + args.parallel]
        procs = [subprocess.Popen([sys.executable, __file__, "--child", m],
                                  stdout=subprocess.PIPE, text=True)
                 for m in batch]
        for m, p in zip(batch, procs):
            out, _ = p.communicate(timeout=300)
            errs[m].append(float(out.strip().splitlines()[-1]))
    for m, e in errs.items():
        print(f"{m}: {len(e)} runs, {sum(x > 1e-6 for x in e)} with a "
              f"relative error above 1e-6, worst {max(e):.3g}")


if __name__ == "__main__":
    main()
