#!/usr/bin/env python3
"""The tensor-core building blocks of ops/csrc/flash_wgmma.cuh, one product
at a time, against torch.matmul on one GPU.

    python3 hack/torch_wgmma_check.py

Builds hack/torch_wgmma_check.cu (nvcc, sm_90a, the package's flags) into
the git-ignored ops/_build/ and runs its one warpgroup on three random
64 x 128 bf16 tiles A, B, V and one 64 x 256 tile W, loaded with rows at
or past ``rows`` zero (64, then the ragged 50): s = A Bᵀ (both operands
K-major), o = bf16(s) V and g = bf16(s) B (V and B as MN-major operands,
A from registers), and h = bf16(s) W as two products over W's column
halves, the second read MN-major two swizzle atoms in (the backward's
register-A products at head dim 256); then the pieces of head dim 100
(``wgmma_check_pad``): 64 x 100 tiles whose rows start on 8-byte
boundaries only (a buffer offset by 4 values), copied in 8-byte pieces
over shared memory filled with NaN, the pad zeroed from column 100, s =
A Bᵀ in 7 k-steps, o = bf16(s) V and g = bf16(s) B (B read MN-major: the
backward's dS K, Pᵀ dO and dSᵀ Q at head dim 100), whose columns 100..127
must be 0 exactly. Each
is held against the same product in f32 by torch.matmul on the card
(relative to its largest value, 1e-5: the inputs are exact in bf16 and the
products sum in f32; o and g take the kernel's s rounded to bf16). A wrong descriptor, swizzle or fragment map gives
wrong numbers, not an error, so this is the first check of a change there.
Prints one JSON line per case and exits non-zero on a miss. Imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TOL = 1e-5


def build(_cuda) -> Path:
    src = ROOT / "hack" / "torch_wgmma_check.cu"
    out = _cuda.BUILD_DIR / "libtorch_wgmma_check.so"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                    "-o", str(out), str(src)], check=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_wgmma_check: no CUDA device", file=sys.stderr)
        return 2
    from gpu_provisioner_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = ctypes.CDLL(str(build(_cuda)))
    fn = lib.wgmma_check
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    ok = True
    for rows in (64, 50):
        a, b, v = (torch.randn(64, 128, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        w = torch.randn(64, 256, generator=g, device=dev).to(torch.bfloat16)
        s = torch.empty(64, 64, device=dev)
        o, gg = torch.empty(64, 128, device=dev), torch.empty(64, 128, device=dev)
        h = torch.empty(64, 256, device=dev)
        rc = fn(a.data_ptr(), b.data_ptr(), v.data_ptr(), w.data_ptr(), rows,
                s.data_ptr(), o.data_ptr(), gg.data_ptr(), h.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc != 0:
            print(f"torch_wgmma_check: launch failed with cudaError {rc}",
                  file=sys.stderr)
            return 1
        af, bf, vf, wf = (x.float() for x in (a, b, v, w))
        for x in (af, bf, vf, wf):
            x[rows:] = 0.0
        s_ref = af @ bf.T
        p = s.to(torch.bfloat16).float()    # the kernel's own rounding of s
        errs = {}
        for name, got, want in (("s", s, s_ref), ("o", o, p @ vf),
                                ("g", gg, p @ bf), ("h", h, p @ wf)):
            errs[name] = ((got - want).abs().max()
                          / want.abs().max()).item()
        miss = {n: e for n, e in errs.items() if not e <= TOL}
        ok &= not miss
        print(json.dumps({"rows": rows, "rel_err": errs, "tol": TOL,
                          "ok": not miss}))
    pad = lib.wgmma_check_pad
    pad.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_void_p] * 4
    pad.restype = ctypes.c_int
    for rows in (64, 50):
        D = 100
        buf = torch.randn(3, 64 * D + 4, generator=g, device=dev).to(
            torch.bfloat16)
        a, b, v = (buf[i, 4:].view(64, D) for i in range(3))
        assert a.data_ptr() % 16 == 8
        s = torch.empty(64, 64, device=dev)
        o, gg = torch.empty(64, 128, device=dev), torch.empty(64, 128,
                                                              device=dev)
        rc = pad(a.data_ptr(), b.data_ptr(), v.data_ptr(), D, rows,
                 s.data_ptr(), o.data_ptr(), gg.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc != 0:
            print(f"torch_wgmma_check: pad launch failed with cudaError {rc}",
                  file=sys.stderr)
            return 1
        af, bf, vf = (x.float() for x in (a, b, v))
        for x in (af, bf, vf):
            x[rows:] = 0.0
        s_ref = af @ bf.T
        p = s.to(torch.bfloat16).float()
        errs = {n: ((got - want).abs().max() / want.abs().max()).item()
                for n, got, want in (("s_d100", s, s_ref),
                                     ("o_d100", o[:, :D], p @ vf),
                                     ("g_d100", gg[:, :D], p @ bf))}
        pad_zero = bool((o[:, D:] == 0).all() and (gg[:, D:] == 0).all())
        miss = {n: e for n, e in errs.items() if not e <= TOL}
        ok &= not miss and pad_zero
        print(json.dumps({"rows": rows, "head_dim": D, "rel_err": errs,
                          "pad_columns_zero": pad_zero, "tol": TOL,
                          "ok": not miss and pad_zero}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
