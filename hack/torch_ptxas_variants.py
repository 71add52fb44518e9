#!/usr/bin/env python3
"""One kernel source built under several sets of nvcc defines, side by
side, on a machine with nvcc: ptxas's registers and spills of each kernel
and whether its SASS equals the first set's.

    python3 hack/torch_ptxas_variants.py [--root DIR] [--match TEXT] SOURCE \\
        -- "" "-DNAME=VALUE ..." ...

SOURCE names a file of ``ops/csrc`` (``flash_decode_mid`` for
``flash_decode_mid.cu``) under DIR (default: this checkout). Each quoted
argument after ``--`` is one set of extra nvcc arguments (the empty one: the source as
it builds), added to ``_cuda.NVCC_FLAGS``; every nvcc runs at once, into a
temporary directory. Prints one JSON line a kernel whose mangled name
holds TEXT (default: every kernel): per set, its registers, spills and
whether its SASS (``cuobjdump -sass``) equals the first set's; then one
line a set with its count of kernels that spill. For a choice a define
makes (a launch bound, an unroll count) before it becomes the source's.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shlex
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--match", default="")
    ap.add_argument("source")
    ap.add_argument("sets", nargs="+")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs             # ptxas_info
    spec = importlib.util.spec_from_file_location(
        "torch_ptxas_ab", ROOT / "hack" / "torch_ptxas_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)         # plain_name, sass_by_kernel
    sys.path.insert(0, args.root)
    from gpu_provisioner_tpu_torch.ops import _cuda
    src = Path(args.root) / "gpu_provisioner_tpu_torch" / "ops" / "csrc" \
        / f"{args.source}.cu"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    info, sass = [], []
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, extra in enumerate(args.sets):
            out = Path(tmp) / f"lib{i}.so"
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *shlex.split(extra),
                   "-o", str(out), str(src)]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), out, extra))
        for proc, out, extra in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                print(f"nvcc {args.source}.cu {extra!r} failed:\n{log}",
                      file=sys.stderr)
                return 1
            info.append({ab.plain_name(k): v
                         for k, v in cs.ptxas_info(log).items()})
            sass.append(ab.sass_by_kernel(subprocess.run(
                [tool, "-sass", str(out)], capture_output=True, text=True,
                check=True).stdout))
    for k in sorted(info[0]):
        if args.match not in k:
            continue
        print(json.dumps({"kernel": k, "sets": [
            {"set": extra, **inf.get(k, {}),
             "same_sass": sa.get(k) == sass[0].get(k)}
            for extra, inf, sa in zip(args.sets, info, sass)]}))
    for extra, inf in zip(args.sets, info):
        spilling = [k for k, v in inf.items() if args.match in k
                    and (v.get("spill_stores") or v.get("spill_loads"))]
        print(json.dumps({"set": extra, "kernels": len(inf),
                          "spilling": len(spilling)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
