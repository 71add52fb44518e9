#!/usr/bin/env python3
"""Where the port's serving time goes on one GPU.

    python3 hack/torch_serve_profile.py [--steps 8] [--layers N] [--moe]
                                        [ROOT]

Builds full-width Llama-7B (``--moe``: mixtral-ish, 8 experts, top-2) in
bf16 with the flash kernels (seeded random weights, ``--layers`` deep,
default the preset's depth), fills a 4-slot ServeEngine (max_len 2048,
buckets 128/256/512) with four requests, times ``--steps`` decode steps
untraced (host wall per step: median and each step), then traces
``--steps`` decode steps and one admission (a 512-bucket prefill) under
torch.profiler. Prints one JSON object: the card's name and power limit,
the untraced wall per step, the traced host wall per step, the device time
by kernel name (top 12, and every flash kernel) and in total, and the
device's idle share of the traced wall (1 - device busy / wall); with
``--moe`` also the decode step's device time by class (expert GEMMs,
dispatch and combine einsums, routing, the rest of the FFN, the attention
kernels, the rest of the attention half, the rest), from record_function
ranges put around the port's route / moe_ffn / attention half for the
traced window only, the FFN's five einsums told apart by their order.
ROOT: a
directory holding another ``gpu_provisioner_tpu_torch`` (an unpacked
parent commit) to profile instead of this repo's. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
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


def _total_device_us(evt) -> float:
    """Device time of the kernels a host-side event launched, its
    children's included."""
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _trace(torch, fn):
    """(host wall s, {kernel: device us}, device busy us, profile) of
    fn()."""
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
    return wall, by_name, sum(by_name.values()), prof


RANGES = {"route": "moe.route", "ffn": "moe.ffn",
          "attention_half": "moe.attention_half"}


def _annotated(fn, label):
    from torch.profiler import record_function

    def wrapped(*args, **kw):
        with record_function(label):
            return fn(*args, **kw)
    return wrapped


def _moe_classes(prof, by_name, busy_us, n):
    """The MoE decode step's device ms by class, per step."""
    from torch.autograd import DeviceType
    ranges = dict.fromkeys(RANGES.values(), 0.0)
    expert = dispatch = 0.0
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or evt.name not in ranges:
            continue
        ranges[evt.name] += _total_device_us(evt)
        if evt.name == RANGES["ffn"]:
            # moe_ffn's einsums in order: dispatch, gate, up, down, combine
            ein = [_total_device_us(c) for c in evt.cpu_children
                   if c.name == "aten::einsum"]
            if len(ein) != 5:
                raise SystemExit(f"moe_ffn ran {len(ein)} einsums, not 5")
            expert += sum(ein[1:4])
            dispatch += ein[0] + ein[4]
    flash = sum(v for k, v in by_name.items() if "flash_" in k)
    ffn, att = ranges[RANGES["ffn"]], ranges[RANGES["attention_half"]]
    us = {"expert_gemms": expert, "dispatch_combine_einsums": dispatch,
          "routing": ranges[RANGES["route"]],
          "ffn_rest (router product, silu, casts)":
              ffn - expert - dispatch - ranges[RANGES["route"]],
          "attention_kernels": flash,
          "attention_half_rest (norm, QKV, rope, cache write, wo)":
              att - flash,
          "rest (embedding, FFN norm, residual, lm_head, sampling)":
              busy_us - ffn - att}
    return {k: v / 1e3 / n for k, v in us.items()}


def _summary(wall, by_name, busy, n):
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms_per_step": wall * 1e3 / n,
            "device_busy_ms_per_step": busy / 1e3 / n,
            "idle_share": 1 - busy / 1e6 / wall if wall > 0 else None,
            "top_kernels_ms_per_step": {k[:90]: v / 1e3 / n for k, v in top},
            "flash_kernels_ms_per_step": {k[:90]: v / 1e3 / n
                                          for k, v in by_name.items()
                                          if "flash_" in k}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--moe", action="store_true")
    ap.add_argument("root", nargs="?", default=str(ROOT))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from gpu_provisioner_tpu_torch.models import engine as te
    from gpu_provisioner_tpu_torch.models import llama as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    if args.moe:
        from gpu_provisioner_tpu_torch.models import moe as tm
        from gpu_provisioner_tpu_torch.models import moe_serve as tms
        cfg = tm.PRESETS_MOE["mixtral-ish"]
        init = tm.init_moe_model
    else:
        cfg, init = tl.PRESETS["llama-7b"], tl.init_params
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers,
                              attn_impl="flash")
    params = init(cfg, gen, dev)
    g = torch.Generator().manual_seed(1)
    eng = te.ServeEngine(params, cfg, slots=4, max_len=2048,
                         prefill_buckets=(128, 256, 512))
    for n in (180, 500, 350, 100):
        eng.submit(torch.randint(1, cfg.vocab_size, (n,), generator=g)
                   .tolist(), 64)
    for _ in range(4):                      # admits all four, warms up
        eng.step()
    untraced = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t0) * 1e3)
    if args.moe:    # record_function ranges for the traced window only
        plain = tm.route, tms.moe_ffn, tms._attention_half
        tm.route = _annotated(tm.route, RANGES["route"])
        tms.moe_ffn = _annotated(tms.moe_ffn, RANGES["ffn"])
        tms._attention_half = _annotated(tms._attention_half,
                                         RANGES["attention_half"])
    wall, by_name, busy, prof = _trace(
        torch, lambda: [eng.step() for _ in range(args.steps)])
    if args.moe:
        tm.route, tms.moe_ffn, tms._attention_half = plain
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "root": str(Path(args.root).resolve()),
           "model": "mixtral-ish" if args.moe else "llama-7b",
           "layers": cfg.n_layers,
           "untraced_wall_ms_per_step": statistics.median(untraced),
           "untraced_wall_ms_steps": untraced,
           "decode_step": _summary(wall, by_name, busy, args.steps)}
    if args.moe:
        out["decode_step"]["device_ms_per_step_by_class"] = _moe_classes(
            prof, by_name, busy, args.steps)
    prompt = torch.randint(1, cfg.vocab_size, (500,), generator=g).tolist()
    eng2 = te.ServeEngine(params, cfg, slots=1, max_len=2048,
                          prefill_buckets=(512,))
    eng2.submit(prompt, 1)
    eng2.step()                             # warm-up admission
    eng2.submit(prompt, 1)
    wall, by_name, busy, _ = _trace(torch, eng2.step)
    out["admission_512"] = _summary(wall, by_name, busy, 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
