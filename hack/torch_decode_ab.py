#!/usr/bin/env python3
"""The serving path's cache kernels, of this repo or of other checkouts,
side by side on one GPU.

    python3 hack/torch_decode_ab.py            # this repo's kernels
    python3 hack/torch_decode_ab.py ROOT ...   # the kernels of each ROOT
    python3 hack/torch_decode_ab.py --head-dim 64 [ROOT ...]

Each ROOT is a directory that holds a ``gpu_provisioner_tpu_torch`` package
(an unpacked parent commit, a variant under study): its kernels are built
from its own sources into its own ``ops/_build/``, one process for each
ROOT in the order given (give them as A B B A to alternate).

At the shapes of chip_smoke.py's timed rows (Hq 32 / Hkv 8, head dim 128;
with ``--head-dim 64`` the bench_moe_decode model's Hq 16 / Hkv 8 of 64,
which a checkout from before the head-dim-64 kernels refuses; with 96, 80
or 120 the D = 128 shapes at that head dim; a cache of
2048, bf16 activations, random normal inputs from a seed):
``flash_attention_decode`` at the engine's decode step (B=4, S=1, per-row
starts 540/300/610/420, pads 12/0/100/56) on a bf16 and an int8 cache, and
at S=5 and S=16 from the same starts; ``flash_attention_cached`` at the
admission prefill (B=1, 256 queries at 128, pad 28) on a bf16 and an int8
cache; then, where the checkout has flash_decode's split schedule, the
bf16 decode step at each forced split count of SPLIT_SWEEP (its plan picks
9 there on 132 SMs), and last a fresh prefill through
``flash_attention_with_lse`` (causal self-attention: B=2, S=512 at head
dim 128, phase 2's serving row; B=8, S=512 at 64, the bench_moe_decode
twin's). For each: ``ms``, CUDA events around the wrapper call
(median of 20, chip_smoke.time_ms); ``host_us``, the host's time per call
over 200 calls in a row with no synchronisation (median of 5 rounds: the
wrapper's enqueue cost); ``device_ms``, the kernels' own device time from
torch.profiler (mean of 20, the decode's merge launch included,
chip_smoke.device_ms), taken after every host and event time; the L2
flushed before each timed call; and max|out - plain|. Prints one JSON
object for each ROOT, with the ROOT and the card's name and power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs   # noqa: E402  (time_ms, device_ms, the rows' shapes)

ML = 2048
# head dim -> (Hq, Hkv); 96, 80 and 120 at the D = 128 rows' heads
HEADS = {128: (32, 8), 96: (32, 8), 80: (32, 8), 120: (32, 8),
         64: (16, 8)}
PREFILL = {128: (2, 512), 96: (2, 512), 80: (2, 512), 120: (2, 512),
           64: (8, 512)}   # (B, S)
SPLIT_SWEEP = (1, 2, 4, 9, 16, 32)   # forced split counts at the decode step


def rows(torch, tfa, td, dev, D=128):
    Hq, Hkv = HEADS[D]
    g = torch.Generator(dev).manual_seed(21)
    bf = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    def int8(kc, vc):
        (k8, ks), (v8, vs) = td._quantize_kv(kc), td._quantize_kv(vc)
        return k8, v8, dict(k_scale=ks, v_scale=vs)

    def host_us(fn, calls=200, rounds=5):
        """Median over rounds of the host's time per call of ``calls``
        back-to-back calls, the card synchronised before each round only:
        the wrapper's enqueue cost while the card keeps up."""
        times = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return statistics.median(times)

    cases = []   # (name, call, plain, kernels), measured after all are built

    def decode(q, k, v, st, **kw):
        return (lambda: tfa.flash_attention_decode(q, k, v, st, **kw),
                lambda: tfa.attention_plain(q, k, v, st, **kw)[0],
                ("flash_decode",))

    def cached(q, k, v, **kw):
        return (lambda: tfa.flash_attention_cached(q, k, v, 128, **kw),
                lambda: tfa.attention_plain(q, k, v, 128, **kw)[0],
                ("flash_fwd",))

    st = torch.tensor(cs.DECODE_STARTS, dtype=torch.int32, device=dev)
    pads = torch.tensor(cs.DECODE_PADS, dtype=torch.int32, device=dev)
    kc, vc = rnd(4, Hkv, ML, D), rnd(4, Hkv, ML, D)
    k8, v8, i8 = int8(kc, vc)
    for S in (1, 5, 16):
        q = rnd(4, S, Hq, D)
        cases.append((f"flash_decode S={S}",
                      *decode(q, kc, vc, st, pad_lens=pads)))
        if S == 1:
            cases.append(("flash_decode_int8 S=1",
                          *decode(q, k8, v8, st, pad_lens=pads, **i8)))
    q = rnd(1, 256, Hq, D)
    kc1, vc1 = rnd(1, Hkv, ML, D), rnd(1, Hkv, ML, D)
    k81, v81, i81 = int8(kc1, vc1)
    pad = torch.tensor([28], dtype=torch.int32, device=dev)
    cases.append(("flash_cached", *cached(q, kc1, vc1, pad_lens=pad)))
    cases.append(("flash_cached_int8",
                  *cached(q, k81, v81, pad_lens=pad, **i81)))
    # last, so that the rows above draw the same inputs in every checkout
    if hasattr(tfa, "_decode_splits"):   # the split schedule: its CTAs
        q = rnd(4, 1, Hq, D)
        kc, vc = rnd(4, Hkv, ML, D), rnd(4, Hkv, ML, D)
        call, plain, kernels = decode(q, kc, vc, st, pad_lens=pads)
        for n in SPLIT_SWEEP:
            cases.append((f"flash_decode S=1 splits={n}",
                          forced(tfa, n, call), plain, kernels))
    B, S = PREFILL[D]
    q, k, v = rnd(B, S, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    cases.append((f"flash_fwd B={B} S={S}",
                  lambda: tfa.flash_attention_with_lse(q, k, v)[0],
                  lambda: tfa.attention_plain(q, k.transpose(1, 2),
                                              v.transpose(1, 2), 0)[0],
                  ("flash_fwd",)))

    # host and event times first: a torch.profiler session slows every
    # later launch on the host (chip_smoke.device_times)
    out = []
    for name, call, plain, _ in cases:
        err = (call().float() - plain().float()).abs().max().item()
        out.append({"name": name, "ms": cs.time_ms(call, flush),
                    "host_us": host_us(call), "max_abs_err": err})
    for r, (_, call, _, kernels) in zip(out, cases):
        r["device_ms"], r["device_ms_by"] = cs.device_ms(call, flush,
                                                         kernels)
        print(json.dumps(r), flush=True)
    return out


def forced(tfa, n, call):
    """``call`` with flash_decode's split count forced to ``n``."""
    def run():
        plan = tfa._decode_splits
        tfa._decode_splits = lambda *a: n
        try:
            return call()
        finally:
            tfa._decode_splits = plan
    return run


def main() -> int:
    roots, D = sys.argv[1:], 128
    if roots[:1] == ["--head-dim"]:
        D, roots = int(roots[1]), roots[2:]
    if len(roots) > 1:
        rc = 0
        for root in roots:
            rc |= subprocess.run([sys.executable, __file__, "--head-dim",
                                  str(D), root], timeout=900).returncode
        return rc
    root = Path(roots[0]).resolve() if roots else ROOT
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    from gpu_provisioner_tpu_torch.models import decode as td
    from gpu_provisioner_tpu_torch.ops import _cuda
    from gpu_provisioner_tpu_torch.ops import flash_attention as tfa

    dev = torch.device("cuda")
    _cuda.build()
    with torch.no_grad():
        out = {"root": str(root), "card": cs.card_line(), "head_dim": D,
               "rows": rows(torch, tfa, td, dev, D)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
