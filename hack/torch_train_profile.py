#!/usr/bin/env python3
"""Where the port's training step time goes on one GPU.

    python3 hack/torch_train_profile.py [--steps 2]

Builds full Llama-1B (``PRESETS["llama-1b"]``, 16 layers) as the train state
holds it: f32 masters, bf16 activations, ``remat=True``,
``attn_impl="flash"``, AdamW, at chip_smoke.py's training shape (B=8,
S=2048); runs one warm-up step on a fixed random batch,
then traces ``--steps`` steps under torch.profiler. Prints one JSON object:
the card's name and power limit, the host wall per step, the device's busy
time and idle share (1 - device busy / wall), the device time per step by
class (attention forward and backward kernels, cuBLAS matrix products,
everything else: elementwise, reductions, copies, the optimizer) and the top
kernels by name. Imports nothing of JAX.
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

from chip_smoke import TRAIN_SHAPE   # noqa: E402  (B, S, Hq, Hkv)

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
    cfg = dataclasses.replace(tl.PRESETS["llama-1b"], attn_impl="flash",
                              remat=True)
    B, S = TRAIN_SHAPE[:2]
    params, opt = tt.make_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                      dev)
    step = tt.make_train_step(cfg, opt)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                         generator=g).to(dev)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    step(params, inp, tgt)                   # warm-up: cuBLAS, allocator
    losses = []
    wall, by_name, busy = _trace(
        torch, lambda: [losses.append(step(params, inp, tgt).item())
                        for _ in range(args.steps)])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "layers": cfg.n_layers, "batch": B, "seq": S,
           "losses": losses,
           "train_step": _summary(wall, by_name, busy, args.steps),
           "device_ms_per_step_by_class": _classify(by_name, args.steps),
           "tokens_per_s_traced": B * S * args.steps / wall}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
