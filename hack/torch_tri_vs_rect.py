#!/usr/bin/env python3
"""The port's two causal schedules side by side on one GPU: the
rectangular attention kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu) and
the flattened-triangle ones (csrc/flash_tri.cu).

    python3 hack/torch_tri_vs_rect.py

1. f32 accuracy against f64: at (B, S, Hq, Hkv) = (1, 2048, 16, 8) and
   (1, 8192, 16, 8), causal, head dim 128, random normal inputs, the
   gradients of the rectangular backward kernels, of the triangle's and of
   the plain f32 version (``attention_bwd_plain``, cuBLAS) are each held
   against the same gradients computed in f64 on the card, as max|err| /
   max|f64| per gradient (``hack/torch_tri_sum_order.py`` replays the
   kernels' summation orders on the CPU);
2. times, bf16, causal: each tri kernel beside its rectangular kernel at
   the training shape (``chip_smoke.TRAIN_SHAPE``: B=8, S=2048, Hq 16/Hkv
   8) and at ``bench_long_context``'s layer shape (1, 8192, 8, 4): median
   of 10 CUDA-event times each, the L2 flushed before each launch, the two
   kernels alternating.

Prints one JSON object, with the card's name and power limit. Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import TRAIN_SHAPE   # noqa: E402  (B, S, Hq, Hkv)

ACCURACY_SHAPES = ((1, 2048, 16, 8), (1, 8192, 16, 8))
TIMED_SHAPES = (TRAIN_SHAPE, (1, 8192, 8, 4))
D = 128


def grads_f64(torch, q, k, v, dout):
    """(dq, dk, dv) in f64 of causal self-attention, one (batch, kv head)
    at a time so that the S² f64 tensors stay small."""
    B, S, Hq, _ = q.shape
    Hkv = k.shape[2]
    G, scale = Hq // Hkv, D ** -0.5
    dq = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float64, device=q.device)
    dv = torch.empty_like(dk)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    for b in range(B):
        for h in range(Hkv):
            heads = slice(h * G, (h + 1) * G)
            qd = q[b, :, heads].double().transpose(0, 1)     # [G, S, D]
            gd = dout[b, :, heads].double().transpose(0, 1)
            kd, vd = k[b, :, h].double(), v[b, :, h].double()
            s = (qd @ kd.T) * scale
            p = torch.softmax(s.masked_fill_(~keep, float("-inf")), dim=-1)
            del s
            delta = (gd * (p @ vd)).sum(-1, keepdim=True)
            ds = p * (gd @ vd.T - delta) * scale
            dq[b, :, heads] = (ds @ kd).transpose(0, 1)
            dk[b, :, h] = (ds.transpose(1, 2) @ qd).sum(0)
            dv[b, :, h] = (p.transpose(1, 2) @ gd).sum(0)
            del p, ds
    return dq, dk, dv


def accuracy(torch, tfa, dev):
    g = torch.Generator(dev).manual_seed(11)
    out = []
    for B, S, Hq, Hkv in ACCURACY_SHAPES:
        q, dout = (torch.randn(B, S, Hq, D, generator=g, device=dev)
                   for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, D, generator=g, device=dev)
                for _ in range(2))
        want = grads_f64(torch, q, k, v, dout)
        o, lse = tfa.flash_attention_with_lse(q, k, v)
        row = {"shape": [B, S, Hq, Hkv], "dtype": "float32"}
        for name, got in (
                ("rect", tfa.flash_attention_bwd(q, k, v, o, lse, dout)),
                ("tri", tfa.flash_attention_bwd(q, k, v, o, lse, dout,
                                                triangular=True)),
                ("plain_f32", tfa.attention_bwd_plain(q, k, v, o, lse,
                                                      dout))):
            row[name] = {n: ((a.double() - w).abs().max()
                             / w.abs().max()).item()
                         for n, a, w in zip(("dq", "dk", "dv"), got, want)}
            del got
        print(json.dumps(row), flush=True)
        out.append(row)
        del q, k, v, dout, want, o, lse
        torch.cuda.empty_cache()
    return out


def alternate_ms(torch, fns, flush, reps=10):
    """{name: median ms} of the functions in ``fns``, one launch of each in
    turn per round, the L2 flushed before each."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            flush.zero_()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b))
    return {name: statistics.median(ts) for name, ts in times.items()}


def timings(torch, tfa, _cuda, dev):
    g = torch.Generator(dev).manual_seed(12)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    scale, bf, out = D ** -0.5, torch.bfloat16, []
    for B, S, Hq, Hkv in TIMED_SHAPES:
        q, dout = (torch.randn(B, S, Hq, D, generator=g, device=dev).to(bf)
                   for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, D, generator=g, device=dev).to(bf)
                for _ in range(2))
        o, lse = tfa._launch_tri("flash_fwd_tri", q, k, v, scale=scale)
        delta = tfa._bwd_delta(o, dout, None).contiguous()
        bkw = dict(scale=scale, dout=dout, lse=lse, delta=delta)
        pairs = {
            "fwd": {
                "rect": lambda: tfa._launch(
                    "flash_fwd", q, k.transpose(1, 2), v.transpose(1, 2), 0,
                    causal=True, scale=scale, want_lse=True),
                "tri": lambda: tfa._launch_tri("flash_fwd_tri", q, k, v,
                                               scale=scale)},
            "dq": {
                "rect": lambda: tfa._launch_bwd(
                    "flash_bwd_dq", q, k, v, dout, lse, delta, causal=True,
                    scale=scale),
                "tri": lambda: tfa._launch_tri("flash_bwd_dq_tri", q, k, v,
                                               **bkw)},
            "dkv": {
                "rect": lambda: tfa._launch_bwd(
                    "flash_bwd_dkv", q, k, v, dout, lse, delta, causal=True,
                    scale=scale),
                "tri": lambda: tfa._launch_tri("flash_bwd_dkv_tri", q, k, v,
                                               **bkw)}}
        row = {"shape": [B, S, Hq, Hkv], "dtype": "bfloat16"}
        for kernel, fns in pairs.items():
            ms = alternate_ms(torch, fns, flush)
            row[kernel] = {**ms, "tri_over_rect": ms["tri"] / ms["rect"]}
        row["ctas"] = {e: _cuda.tri_ctas(e, 1, dev.index)
                       for e in _cuda.TRI_WHICH}
        print(json.dumps(row), flush=True)
        out.append(row)
        del q, k, v, dout, o, lse, delta
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_tri_vs_rect: no CUDA device", file=sys.stderr)
        return 2
    from gpu_provisioner_tpu_torch.ops import _cuda
    from gpu_provisioner_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _cuda.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "accuracy_vs_f64": accuracy(torch, tfa, dev),
           "times_ms": timings(torch, tfa, _cuda, dev)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
