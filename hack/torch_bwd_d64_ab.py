#!/usr/bin/env python3
"""The head-dim-64 backward kernels built for 2, 3 and 4 CTAs an SM, side
by side on one GPU: the A/B behind tc::DQ_TC_BLOCKS and tc::DKV_TC_BLOCKS.

    python3 hack/torch_bwd_d64_ab.py            # check and time
    python3 hack/torch_bwd_d64_ab.py --check    # build and check only

Builds flash_bwd.cu and flash_tri.cu once for each count of BLOCKS (nvcc's
-DTC_DQ_BLOCKS_D64=n -DTC_DKV_BLOCKS_D64=n; every nvcc started together)
into a temporary directory and prints, per count, ptxas's registers and
spills of the D = 64 tensor-core instances (flash_bwd_dq, flash_bwd_dkv,
flash_bwd_dkv_tri, and flash_bwd_dq_tri / flash_fwd_tri, which the counts
do not bound) and the persistent grids the tri entries take. Each count's
libraries then take the wrappers' calls in turn (ctypes libraries swapped
in ``_cuda``), each kernel held against its plain version (bf16 within
1e-2 and f32 within 1e-4, gradients relative to the largest plain one) at
a ragged shape (B=1, S=1000, Hq 4 / Hkv 1, causal and windowed) and, in
bf16, at the main paths' shapes: #6/#7 at (8, 2048, 16/8) causal (the
bench_moe_decode model's attention at training length) and #8/#9 at (1,
32768, 8/4) (the long-context twin's heads at head dim 64), plain at (1,
8192). Without --check each count's kernels are then timed there, the
counts in the order 2 3 4 4 3 2 (CUDA events, median of 20 launches, L2
flushed: chip_smoke.time_ms), and the medians of each count's two turns
printed. One JSON line a result, the card's name and power limit first.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs   # noqa: E402  (ptxas_info, time_ms, card_line)

BLOCKS = (2, 3, 4)
SOURCES = ("flash_bwd", "flash_tri")
D = 64
RECT = (8, 2048, 16, 8)      # B, S, Hq, Hkv of #6/#7
TRI = (1, 32768, 8, 4)       # of #8/#9
TRI_PLAIN_S = 8192
INSTANCES = {   # row -> (source, a substring of the mangled name)
    "flash_bwd_dq": ("flash_bwd", "flash_bwd_dq_tc_kernelILi64E"),
    "flash_bwd_dkv": ("flash_bwd", "flash_bwd_dkv_tc_kernelILi64E"),
    "flash_fwd_tri": ("flash_tri", "flash_fwd_tri_kernelI13__nv_bfloat16Li64E"),
    "flash_bwd_dq_tri": ("flash_tri",
                         "flash_bwd_dq_tri_kernelI13__nv_bfloat16Li64E"),
    "flash_bwd_dkv_tri": ("flash_tri", "flash_bwd_dkv_tri_tc_kernelILi64E")}


def build(_cuda, tmp: Path) -> dict:
    """{n: {source: library path}} and prints ptxas of each count's
    instances; every nvcc runs at once."""
    procs = {}
    for n in BLOCKS:
        for src in SOURCES:
            out = tmp / f"lib{src}-{n}.so"
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-DTC_DQ_BLOCKS_D64={n}",
                   f"-DTC_DKV_BLOCKS_D64={n}", "-o", str(out),
                   str(_cuda.CSRC / f"{src}.cu")]
            procs[n, src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True), out)
    libs = {}
    for (n, src), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {src}.cu at {n} CTAs an SM:\n{log}")
        libs.setdefault(n, {})[src] = out
        info = cs.ptxas_info(log)
        for row, (source, part) in INSTANCES.items():
            if source == src:
                print(json.dumps({"blocks": n, "kernel": row, "ptxas": next(
                    (v for k, v in info.items() if part in k), None)}))
    return libs


def use(_cuda, paths: dict) -> None:
    """Routes the wrappers to one count's libraries."""
    for src, path in paths.items():
        _cuda._LIBS[src] = ctypes.CDLL(str(path))
    _cuda._TRI_CTAS.clear()
    _cuda._TRI_WS.clear()


def inputs(torch, dev, B, S, Hq, Hkv, dtype, seed):
    g = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(B, S, h, D, generator=g, device=dev).to(dtype)
            for h in (Hq, Hkv, Hkv, Hq)]


def rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def check(torch, tfa, dev, n) -> None:
    """Each kernel against its plain version at this count (see above)."""
    scale = D ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        cases = [((1, 1000, 4, 1), True, None), ((1, 1000, 4, 1), True, 300),
                 ((1, 1000, 4, 1), False, None)]
        if dtype == torch.bfloat16:
            cases.append((RECT, True, None))
        for shape, causal, window in cases:
            q, k, v, dout = inputs(torch, dev, *shape, dtype, 11)
            kw = dict(causal=causal, window=window)
            out, lse = tfa.attention_plain(q, k.transpose(1, 2),
                                           v.transpose(1, 2), 0, **kw)
            delta = tfa._bwd_delta(out, dout, None).contiguous()
            want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, **kw)
            got = (tfa._launch_bwd("flash_bwd_dq", q, k, v, dout, lse, delta,
                                   scale=scale, **kw),
                   *tfa._launch_bwd("flash_bwd_dkv", q, k, v, dout, lse,
                                    delta, scale=scale, **kw))
            errs = [rel(a, b) for a, b in zip(got, want)]
            print(json.dumps({"blocks": n, "check": "rect", "dtype": str(dtype),
                              "shape": shape, "causal": causal,
                              "window": window, "rel_err": errs, "tol": tol}))
            cs.check(all(e <= tol for e in errs), f"rect backward at {n}")
            del q, k, v, dout, out, lse, delta, want, got
        for shape in [(1, 1000, 4, 1), (2, 200, 8, 8)] + (
                [(1, TRI_PLAIN_S, 8, 4)] if dtype == torch.bfloat16 else []):
            q, k, v, dout = inputs(torch, dev, *shape, dtype, 12)
            out, lse = tfa._launch_tri("flash_fwd_tri", q, k, v, scale=scale)
            ref, ref_lse = tfa.attention_plain(q, k.transpose(1, 2),
                                               v.transpose(1, 2), 0)
            delta = tfa._bwd_delta(out, dout, None).contiguous()
            kw = dict(scale=scale, dout=dout, lse=lse, delta=delta)
            got = (tfa._launch_tri("flash_bwd_dq_tri", q, k, v, **kw),
                   *tfa._launch_tri("flash_bwd_dkv_tri", q, k, v, **kw))
            want = tfa.attention_bwd_plain(q, k, v, out, lse, dout)
            e_out = (out.float() - ref.float()).abs().max().item()
            e_lse = (lse - ref_lse).abs().max().item()
            errs = [rel(a, b) for a, b in zip(got, want)]
            print(json.dumps({"blocks": n, "check": "tri", "dtype": str(dtype),
                              "shape": shape, "out_err": e_out,
                              "lse_err": e_lse, "rel_err": errs, "tol": tol}))
            cs.check(e_out <= tol and e_lse <= 1e-4
                     and all(e <= tol for e in errs), f"tri kernels at {n}")
            del q, k, v, dout, out, lse, ref, ref_lse, delta, got, want
    torch.cuda.synchronize()


def timers(torch, tfa, dev):
    """{row: fn} of the timed calls, bf16, at RECT and TRI."""
    scale = D ** -0.5
    fns = {}
    for shape, names in ((RECT, ("flash_bwd_dq", "flash_bwd_dkv")),
                         (TRI, ("flash_fwd_tri", "flash_bwd_dq_tri",
                                "flash_bwd_dkv_tri"))):
        q, k, v, dout = inputs(torch, dev, *shape, torch.bfloat16, 13)
        out, lse = tfa.flash_attention_with_lse(q, k, v)
        delta = tfa._bwd_delta(out, dout, None).contiguous()
        for name in names:
            if name.endswith("_tri"):
                kw = {} if name == "flash_fwd_tri" else dict(
                    dout=dout, lse=lse, delta=delta)
                fns[name] = (lambda name=name, q=q, k=k, v=v, kw=kw:
                             tfa._launch_tri(name, q, k, v, scale=scale,
                                             **kw))
            else:
                fns[name] = (lambda name=name, q=q, k=k, v=v, dout=dout,
                             lse=lse, delta=delta: tfa._launch_bwd(
                                 name, q, k, v, dout, lse, delta,
                                 causal=True, scale=scale))
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_bwd_d64_ab: no CUDA device", file=sys.stderr)
        return 2
    from gpu_provisioner_tpu_torch.ops import _cuda
    from gpu_provisioner_tpu_torch.ops import flash_attention as tfa
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(json.dumps({"card": cs.card_line()}))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(_cuda, Path(tmp))
        _cuda.build(("flash_fwd",))
        for n in BLOCKS:
            use(_cuda, libs[n])
            print(json.dumps({"blocks": n, "tri_ctas": {
                e: _cuda.tri_ctas(e, 1, D, dev.index)
                for e in _cuda.TRI_WHICH}}))
            check(torch, tfa, dev, n)
        if "--check" in sys.argv[1:]:
            return 0
        fns = timers(torch, tfa, dev)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        times = {n: {name: [] for name in fns} for n in BLOCKS}
        for n in BLOCKS + BLOCKS[::-1]:
            use(_cuda, libs[n])
            for name, fn in fns.items():
                times[n][name].append(cs.time_ms(fn, flush))
            print(json.dumps({"blocks": n, "ms": {
                name: t[-1] for name, t in times[n].items()}}))
        print(json.dumps({"median_ms_by_blocks": {
            n: {name: statistics.median(t) for name, t in by.items()}
            for n, by in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
