#!/usr/bin/env python3
"""Where the port's training step time goes on one GPU.

    python3 hack/torch_train_profile.py [--steps 2] [--head-dim 128|120]

Builds full Llama-1B (``PRESETS["llama-1b"]``, 16 layers) at chip_smoke.py's
training shape (B=8, S=2048), or with ``--head-dim 120`` the
H2O-Danube3-4B-width model (``chip_smoke.pad_models``, 24 layers) at its
phase-27 shape (B=1, S=4096), as the train state holds it: f32 masters,
bf16 activations, ``remat=True``, ``attn_impl="flash"``, AdamW; runs one
warm-up step on a fixed random batch, then traces ``--steps`` steps under
torch.profiler, then times the optimizer's step alone on the last step's
gradients (CUDA events, the median of 3). Prints one JSON object: the
card's name and power limit, the host wall per step, the device's busy
time and idle share (1 - device busy / wall), the device time per step by
class (attention forward and backward kernels, cuBLAS matrix products,
everything else: elementwise, reductions, copies, the optimizer), the top
kernels by name and the optimizer step's milliseconds. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

from torch_serve_profile import _summary, _trace   # the script's own dir

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import PAD_RUNS, TRAIN_SHAPE, pad_models   # noqa: E402

# kernel name fragments of each class, checked in this order
CLASSES = (
    ("attention_fwd", ("flash_fwd",)),
    ("attention_bwd", ("flash_bwd",)),
    ("cublas", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "sm90_")),
    ("memcpy_memset", ("Memcpy", "Memset")),
)


def _classify(by_name: dict, n: int) -> dict:
    out = {name: 0.0 for name, _ in CLASSES}
    out["elementwise_and_other"] = 0.0
    for key, us in by_name.items():
        cls = next((name for name, frags in CLASSES
                    if any(f in key for f in frags)), "elementwise_and_other")
        out[cls] += us / 1e3 / n
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--head-dim", type=int, choices=(128, 120), default=128)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    from gpu_provisioner_tpu_torch.models import llama as tl
    from gpu_provisioner_tpu_torch.models import train as tt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if args.head_dim == 128:
        cfg, (B, S) = tl.PRESETS["llama-1b"], TRAIN_SHAPE[:2]
    else:
        cfg, (B, S) = pad_models(tl)[120], PAD_RUNS[120].train
    cfg = dataclasses.replace(cfg, attn_impl="flash", remat=True)
    params, opt = tt.make_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                      dev)
    step = tt.make_train_step(cfg, opt)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                         generator=g).to(dev)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    step(params, inp, tgt)                   # warm-up: cuBLAS, allocator
    losses = []
    wall, by_name, busy, _ = _trace(
        torch, lambda: [losses.append(step(params, inp, tgt).item())
                        for _ in range(args.steps)])
    opt_ms = []
    for _ in range(3):      # the update alone, on the last step's gradients
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        opt.step()
        t1.record()
        torch.cuda.synchronize()
        opt_ms.append(t0.elapsed_time(t1))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "layers": cfg.n_layers, "batch": B, "seq": S,
           "losses": losses,
           "train_step": _summary(wall, by_name, busy, args.steps),
           "device_ms_per_step_by_class": _classify(by_name, args.steps),
           "tokens_per_s_traced": B * S * args.steps / wall,
           "optimizer_step_ms": sorted(opt_ms)[1],
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
