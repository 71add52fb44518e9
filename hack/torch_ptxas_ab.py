#!/usr/bin/env python3
"""ptxas's registers and spills, and the SASS, of every kernel of two
checkouts, side by side, on a machine with nvcc.

    python3 hack/torch_ptxas_ab.py A B

A and B are directories that hold a ``gpu_provisioner_tpu_torch`` package
(an unpacked parent commit and this tree, say). Each builds its kernel
libraries (its own ``_cuda.SOURCES``) from its own sources with its own
``_cuda.build`` into a temporary directory (every nvcc process of both
runs together); the
``-Xptxas -v`` output is read per kernel, and each library's SASS
(``cuobjdump -sass``, which ships with nvcc) is cut per kernel, the
mangled names taken without their anonymous namespace's per-build hash
and each line's runs of blanks read as one (cuobjdump aligns a library's
columns to its widest instruction).
Prints, per source of A, how many of A's kernels B builds with the same
registers and spills and with the same SASS, then one line for every
kernel whose registers or spills differ or that only one side has, and
one for every kernel of A whose SASS differs in B (its instruction
counts on both sides and its first differing line), and exits non-zero
when a kernel of A differs in B in either (a kernel B adds is listed, not
a failure). ``--only s1,s2`` builds those sources alone. Imports nothing
of JAX.

    python3 hack/torch_ptxas_ab.py [--only flash_fwd,flash_fwd_mid] A B
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs   # noqa: E402  (ptxas_info)

def plain_name(mangled: str) -> str:
    """The mangled name without the anonymous namespace's per-build hash."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "", mangled)


def sass_by_kernel(text: str) -> dict:
    """{plain kernel name: its SASS} of one ``cuobjdump -sass`` listing,
    each line's runs of blanks as one (cuobjdump pads a library's columns to
    its widest instruction, so a kernel's lines shift when the library gains
    another kernel)."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            cur = plain_name(line.split("Function : ", 1)[1].strip())
            out[cur] = []
        elif cur is not None:
            out[cur].append(" ".join(line.split()))
    return {k: "\n".join(v) for k, v in out.items()}


def child(root: str, only: str = "") -> int:
    """Builds ``root``'s libraries (those named in ``only``, comma
    separated, or all) into a temporary directory and prints {"logs":
    nvcc's output, "sass": each library's SASS} as one JSON line."""
    sys.path.insert(0, root)
    from gpu_provisioner_tpu_torch.ops import _cuda
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    names = [n for n in _cuda.SOURCES if not only or n in only.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        _cuda.BUILD_DIR = Path(tmp)
        logs = _cuda.build(names)
        sass = {src: subprocess.run([tool, "-sass", str(_cuda.lib_path(src))],
                                    capture_output=True, text=True,
                                    check=True).stdout
                for src in names}
    print(json.dumps({"logs": logs, "sass": sass}))
    return 0


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        return child(sys.argv[2], sys.argv[3])
    args = sys.argv[1:]
    only = ""
    if args[:1] == ["--only"] and len(args) > 1:
        only, args = args[1], args[2:]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = [str(Path(r).resolve()) for r in args]
    procs = [subprocess.Popen([sys.executable, __file__, "--child", r, only],
                              stdout=subprocess.PIPE, text=True)
             for r in roots]
    built = []
    for r, p in zip(roots, procs):
        out, _ = p.communicate()
        if p.returncode:
            print(f"torch_ptxas_ab: the build of {r} failed", file=sys.stderr)
            return 1
        built.append(json.loads(out.strip().splitlines()[-1]))
    ok = True
    for src in built[0]["sass"]:   # A's sources (B may add one)
        a, b = ({plain_name(k): v
                 for k, v in cs.ptxas_info(x["logs"].get(src, "")).items()}
                for x in built)
        sa, sb = (sass_by_kernel(x["sass"][src]) for x in built)
        same = sum(b.get(k) == v for k, v in a.items())
        same_sass = sum(sb.get(k) == v for k, v in sa.items())
        print(json.dumps({"source": src, "kernels_a": len(a),
                          "kernels_b": len(b), "same_in_b": same,
                          "sass_kernels_a": len(sa),
                          "same_sass_in_b": same_sass}))
        for k in sorted(set(a) | set(b)):
            if a.get(k) != b.get(k):
                print(json.dumps({"kernel": k, "a": a.get(k),
                                  "b": b.get(k)}))
        for k in sorted(sa):
            if sb.get(k) != sa[k]:
                la, lb = sa[k].splitlines(), (sb.get(k) or "").splitlines()
                first = next((i for i, (x, y) in enumerate(zip(la, lb))
                              if x != y), min(len(la), len(lb)))
                print(json.dumps({"sass_differs": k, "lines_a": len(la),
                                  "lines_b": len(lb), "first": first,
                                  "a": la[first] if first < len(la) else None,
                                  "b": lb[first] if first < len(lb) else None}))
        ok &= same == len(a) and same_sass == len(sa)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
