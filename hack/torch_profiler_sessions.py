#!/usr/bin/env python3
"""How often a torch.profiler session loses kernel records, and how the
spun CUDA events that chip_smoke.device_ms falls back to compare with it.

    python3 hack/torch_profiler_sessions.py [--sessions 100]

One GPU. At the shapes of chip_smoke.py's at_spec_prefill rows (bf16, head
dim 128, random normal inputs from a seed): ``flash_attention_with_lse`` at
the fresh prefill (B=1, S=256, Hq 32 and 16 over Hkv 8) and
``flash_attention_cached`` at the pad_id prefill (B=8, S=256, a cache of
384, start 0, pads 0-84), and the serving decode step
(``flash_attention_decode``, B=4, S=1, ML 2048); and the library
yardstick of the first, scaled_dot_product_attention, with every kernel
but the flush's counted, as for chip_smoke.py's library_device_ms. For each, after three
warm calls: ``sessions`` profiler sessions of 20 calls one after another
in this process (chip_smoke.profiled), sorted into ``whole`` (each kernel
recorded a whole number of times a call, as chip_smoke.device_ms
requires), ``partial`` (some records lost) and ``empty`` (no record of the
kernel), with the whole sessions' device time a call (median, min, max)
and the partial ones' (min, max); and chip_smoke.spun_ms three times (CUDA
events queued behind a spin kernel). Then device_ms once on a kernel name
that no kernel has, which takes its fallback after three sessions, and
spun_ms of the first case with the host held 3 ms before each call,
longer than the first spin, beside spun_ms of the call as it is: the
spin grows until the host queues the call within it.
Writes one JSON object, with the card's name and power limit, to
chiprun_out/profiler_sessions.json and prints it. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs   # noqa: E402  (profiled, device_ms, spun_ms)

D, REPS = 128, 20


def cases(torch, tfa, dev):
    """(name, call, kernel names) at the timed shapes."""
    g = torch.Generator(dev).manual_seed(31)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    out = []
    for Hq in (32, 16):
        q, k, v = rnd(1, 256, Hq, D), rnd(1, 256, 8, D), rnd(1, 256, 8, D)
        out.append((f"flash_fwd B=1 S=256 Hq={Hq}",
                    lambda q=q, k=k, v=v: tfa.flash_attention_with_lse(
                        q, k, v), ("flash_fwd_tc_kernel",)))
    q, k, v = rnd(1, 32, 256, D), rnd(1, 8, 256, D), rnd(1, 8, 256, D)
    out.append(("scaled_dot_product_attention B=1 S=256 Hq=32",
                lambda q=q, k=k, v=v: torch.nn.functional
                .scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True), None))
    pads = torch.linspace(0, 84, 8, device=dev).int()
    for Hq in (32, 16):
        q, kc, vc = rnd(8, 256, Hq, D), rnd(8, 8, 384, D), rnd(8, 8, 384, D)
        out.append((f"flash_cached B=8 S=256 ML=384 Hq={Hq}",
                    lambda q=q, kc=kc, vc=vc: tfa.flash_attention_cached(
                        q, kc, vc, 0, pad_lens=pads),
                    ("flash_fwd_tc_kernel",)))
    q, kc, vc = rnd(4, 1, 32, D), rnd(4, 8, 2048, D), rnd(4, 8, 2048, D)
    st = torch.tensor(cs.DECODE_STARTS, device=dev)
    pd = torch.tensor(cs.DECODE_PADS, device=dev)
    out.append(("flash_decode B=4 S=1 ML=2048",
                lambda: tfa.flash_attention_decode(q, kc, vc, st,
                                                   pad_lens=pd),
                ("flash_decode",)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=100)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profiler_sessions: no CUDA device", file=sys.stderr)
        return 2
    from gpu_provisioner_tpu_torch.ops import _cuda
    from gpu_provisioner_tpu_torch.ops import flash_attention as tfa

    dev = torch.device("cuda")
    _cuda.build()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    with torch.no_grad():
        for name, call, names in cases(torch, tfa, dev):
            for _ in range(3):
                call()
            whole, partial, empty = [], [], 0
            for _ in range(args.sessions):
                kernels = cs.profiled(call, flush, names, REPS)
                ms = sum(us for _, us in kernels.values()) / REPS / 1e3
                if not kernels:
                    empty += 1
                elif all(c % REPS == 0 for c, _ in kernels.values()):
                    whole.append(ms)
                else:
                    partial.append(ms)
            row = {"name": name, "sessions": args.sessions,
                   "whole": len(whole), "partial": len(partial),
                   "empty": empty,
                   "whole_ms": ([statistics.median(whole), min(whole),
                                 max(whole)] if whole else None),
                   "partial_ms": ([min(partial), max(partial)]
                                  if partial else None),
                   "spun_ms": [cs.spun_ms(call, flush) for _ in range(3)]}
            rows.append(row)
            print(json.dumps(row), flush=True)
        # a name no kernel has: every session is empty, so device_ms
        # takes its fallback
        name, call, _ = cases(torch, tfa, dev)[0]
        ms, by = cs.device_ms(call, flush, ("no_such_kernel",))
        print(json.dumps({"forced_fallback": [name, ms, by]}), flush=True)

        def held():
            time.sleep(0.003)
            call()
        slow_host = [name, cs.spun_ms(held, flush), cs.spun_ms(call, flush)]
        print(json.dumps({"slow_host": slow_host}), flush=True)
    out = {"card": cs.card_line(), "rows": rows,
           "forced_fallback": [name, ms, by], "slow_host": slow_host}
    path = ROOT / "chiprun_out" / "profiler_sessions.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
