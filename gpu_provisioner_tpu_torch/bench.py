"""Long-context benchmark sections on one GPU.

Twins of two sections of the JAX package's ``bench.py``:
``bench_flash_op`` (one flash-attention op against the dense path, forward
and forward+backward, then the streaming shape at S=32768 with and without
``triangular=True``) and ``bench_long_context`` (a 4-layer, dim-1024 model
trained with flash attention and remat at S=8192, then with a 1024-token
sliding window at S×4). The same shapes, configurations and dict keys,
timed after the same warm-ups: on a CUDA tensor with CUDA events, on a CPU
tensor (the tests' shrunken shapes) with the host clock. Deliberate
differences:

- flash attention is the port's CUDA kernels on the card; the JAX section
  runs dense attention off the TPU and skips the sliding-window half there;
- no ``try``: a failing kernel raises, where the JAX section records
  ``fwdbwd_error`` / ``streaming_tri_error`` and goes on;
- the long-context dict also carries the timed steps' losses (``losses``,
  ``swa_losses``), so a caller can check them;
- inputs come from ``torch.Generator`` seeds 0 and 1 (``jax.random`` cannot
  be reproduced); ``shape``, ``streaming_shape``, ``cfg``, ``seq_len`` and
  ``window`` override the sizes.

Run on a machine with the card, from the repository root::

    python3 -m gpu_provisioner_tpu_torch.bench            # full size
    python3 -m gpu_provisioner_tpu_torch.bench --fast
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from .device import resolve_device
from .models.llama import LlamaConfig
from .models.train import make_train_state, make_train_step
from .ops.flash_attention import flash_attention
from .parallel.ring import dense_attention

# (B, S, Hq, Hkv, D), bf16, as bench.py's bench_flash_op
FLASH_OP_SHAPE = {True: (4, 1024, 8, 4, 128), False: (8, 4096, 16, 8, 128)}
STREAMING_SHAPE = (1, 32768, 8, 4, 128)
SWA_WINDOW = 1024
ROUNDS = 3          # best of ROUNDS, after one warm call (bench_flash_op)
OP_CALLS = 5        # calls per round of the op timings (streaming: 1)
WARM_STEPS, TIMED_STEPS = 2, 3     # bench_long_context, per model


def _elapsed_ms(dev: torch.device, fn) -> float:
    """Milliseconds that fn() takes to its end on ``dev``: CUDA events on
    the card (the end event synchronised), the host clock elsewhere."""
    if dev.type == "cuda":
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def bench_flash_op(fast: bool, device=None, *, shape=None,
                   streaming_shape=None) -> dict:
    """The flash-attention op against the dense path at (B, S, Hq, Hkv, D)
    = (4, 1024, 8, 4, 128) fast or (8, 4096, 16, 8, 128), bf16: forward,
    then the gradient of sum(out²) in q, k and v; without ``fast`` also the
    streaming shape (1, 32768, 8, 4, 128), rectangular and triangular.
    Each time is the best of ROUNDS rounds (of OP_CALLS calls each for the
    first four, one call for the streaming pair) after one warm call."""
    dev = resolve_device(device)
    B, S, Hq, Hkv, D = shape or FLASH_OP_SHAPE[fast]
    bf = torch.bfloat16

    def inputs(seed, B, S, Hq, Hkv, D):
        g = torch.Generator(dev).manual_seed(seed)
        return [torch.randn(b, s, h, d, generator=g, device=dev).to(bf)
                for b, s, h, d in ((B, S, Hq, D), (B, S, Hkv, D),
                                   (B, S, Hkv, D))]

    def best_ms(fn, calls):
        fn()
        return min(_elapsed_ms(dev, lambda: [fn() for _ in range(calls)])
                   for _ in range(ROUNDS)) / calls

    q, k, v = inputs(0, B, S, Hq, Hkv, D)
    flash_ms = best_ms(lambda: flash_attention(q, k, v), OP_CALLS)
    dense_ms = best_ms(lambda: dense_attention(q, k, v), OP_CALLS)
    out = {"seq_len": S, "flash_ms": flash_ms, "dense_ms": dense_ms,
           "flash_speedup": dense_ms / flash_ms}

    # forward + backward: the training path (the backward kernels against
    # autograd through the dense path)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def grads_of(attn):
        def f():
            loss = (attn(*leaves).float() ** 2).sum()
            return torch.autograd.grad(loss, leaves)
        return f

    out["flash_fwdbwd_ms"] = best_ms(grads_of(flash_attention), OP_CALLS)
    out["dense_fwdbwd_ms"] = best_ms(grads_of(dense_attention), OP_CALLS)
    out["flash_fwdbwd_speedup"] = (out["dense_fwdbwd_ms"]
                                   / out["flash_fwdbwd_ms"])
    del q, k, v, leaves

    if not fast:
        # the streaming regime (K/V past RESIDENT_KV_BUDGET), where
        # triangular=True takes the flattened-triangle forward; no dense
        # reference (its S² scores do not fit)
        B2, S2, Hq2, Hkv2, D2 = streaming_shape or STREAMING_SHAPE
        q2, k2, v2 = inputs(1, B2, S2, Hq2, Hkv2, D2)
        out["streaming_seq_len"] = S2
        out["streaming_ms"] = best_ms(lambda: flash_attention(q2, k2, v2), 1)
        out["streaming_tri_ms"] = best_ms(
            lambda: flash_attention(q2, k2, v2, triangular=True), 1)
    return out


def long_context_config(S: int) -> LlamaConfig:
    """bench.py's bench_long_context model: dim 1024, 4 layers, GQA 8/4,
    hidden 2816, vocab 2048, bf16, flash attention, remat."""
    return LlamaConfig(vocab_size=2048, dim=1024, n_layers=4, n_heads=8,
                       n_kv_heads=4, hidden_dim=2816, max_seq_len=S,
                       dtype="bfloat16", attn_impl="flash", remat=True)


def _time_steps(cfg: LlamaConfig, S: int, dev: torch.device):
    """(best step ms, losses of the timed steps): one batch of B=1,
    WARM_STEPS warm steps, then the best of TIMED_STEPS synchronised single
    steps."""
    params, opt = make_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                   dev)
    step = make_train_step(cfg, opt)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, S + 1), generator=g).to(dev)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    for _ in range(WARM_STEPS):
        step(params, inp, tgt).item()
    losses, times = [], []
    for _ in range(TIMED_STEPS):
        times.append(_elapsed_ms(
            dev, lambda: losses.append(step(params, inp, tgt).item())))
    return min(times), losses


def bench_long_context(fast: bool, device=None, *, cfg=None, seq_len=None,
                       window: int = SWA_WINDOW) -> dict:
    """Flash attention with remat trains at S=8192 (2048 fast) on one card,
    then a sliding-window model (``window`` 1024) at S×4 = 32768, where the
    windowed kernels do S·window work instead of S²/2."""
    dev = resolve_device(device)
    S = seq_len or (2048 if fast else 8192)
    cfg = dataclasses.replace(cfg or long_context_config(S), max_seq_len=S)
    out = {"seq_len": S}
    out["step_ms"], out["losses"] = _time_steps(cfg, S, dev)
    S2 = S * 4
    cfg_w = dataclasses.replace(cfg, max_seq_len=S2, sliding_window=window)
    out["swa_seq_len"] = S2
    out["swa_window"] = window
    out["swa_step_ms"], out["swa_losses"] = _time_steps(cfg_w, S2, dev)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "long_context": bench_long_context(args.fast),
                      "flash_op": bench_flash_op(args.fast)}))


if __name__ == "__main__":
    main()
