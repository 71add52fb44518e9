#!/usr/bin/env python3
"""Where the port's serving time goes on one GPU.

    python3 hack/torch_serve_profile.py [--steps 8] [--layers 32]

Builds full-width Llama-7B in bf16 with the flash kernels (seeded random
weights, ``--layers`` deep), fills a 4-slot ServeEngine (max_len 2048,
buckets 128/256/512) with four requests, then traces ``--steps`` decode
steps and one admission (a 512-bucket prefill) under torch.profiler. Prints
one JSON object: the card's name and power limit, the host wall per step,
the device time by kernel name (top 12) and in total, and the device's
idle share of the wall (1 - device busy / wall). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _trace(torch, fn):
    """(host wall s, {kernel: device us}, device busy us) of fn()."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    by_name = {}
    for evt in prof.key_averages():      # device-side events: kernels, copies
        if getattr(evt, "device_type", None) != DeviceType.CUDA \
                or getattr(evt, "is_user_annotation", False):
            continue                     # (an annotation spans kernels)
        by_name[evt.key] = by_name.get(evt.key, 0.0) + _device_us(evt)
    return wall, by_name, sum(by_name.values())


def _summary(wall, by_name, busy, n):
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms_per_step": wall * 1e3 / n,
            "device_busy_ms_per_step": busy / 1e3 / n,
            "idle_share": 1 - busy / 1e6 / wall if wall > 0 else None,
            "top_kernels_ms_per_step": {k[:90]: v / 1e3 / n for k, v in top}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gpu_provisioner_tpu_torch.models import engine as te
    from gpu_provisioner_tpu_torch.models import llama as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(tl.PRESETS["llama-7b"], n_layers=args.layers,
                              attn_impl="flash")
    params = tl.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    g = torch.Generator().manual_seed(1)
    eng = te.ServeEngine(params, cfg, slots=4, max_len=2048,
                         prefill_buckets=(128, 256, 512))
    for n in (180, 500, 350, 100):
        eng.submit(torch.randint(1, cfg.vocab_size, (n,), generator=g)
                   .tolist(), 64)
    for _ in range(4):                      # admits all four, warms up
        eng.step()
    wall, by_name, busy = _trace(
        torch, lambda: [eng.step() for _ in range(args.steps)])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "layers": args.layers,
           "decode_step": _summary(wall, by_name, busy, args.steps)}
    prompt = torch.randint(1, cfg.vocab_size, (500,), generator=g).tolist()
    eng2 = te.ServeEngine(params, cfg, slots=1, max_len=2048,
                          prefill_buckets=(512,))
    eng2.submit(prompt, 1)
    eng2.step()                             # warm-up admission
    eng2.submit(prompt, 1)
    wall, by_name, busy = _trace(torch, eng2.step)
    out["admission_512"] = _summary(wall, by_name, busy, 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
