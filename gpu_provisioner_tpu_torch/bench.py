"""Workload, training, long-context, serving and speculative-decoding
benchmark sections on one GPU.

Twins of nine sections of the JAX package's ``bench.py``:
``bench_workload`` (the flagship model's forward throughput with dense
attention: Llama-1B, B=8, S=1024, bf16; best of 3 rounds of 10 calls after
3 warm ones), ``bench_train_step`` (a full train step of Llama-1B with
flash attention and remat at B=8, S=2048, bf16 activations, f32 masters,
``default_optimizer(mu_dtype=torch.bfloat16)``: best of 3 rounds of 5 steps
after 2 warm ones, with its tokens/s and MFU),
``bench_flash_op`` (one flash-attention op against the dense path, forward
and forward+backward, then the streaming shape at S=32768 with and without
``triangular=True``), ``bench_long_context`` (a 4-layer, dim-1024 model
trained with flash attention and remat at S=8192, then with a 1024-token
sliding window at S×4) and ``bench_speculative`` (self-draft speculative
decoding of a Llama-1B: S0=256, 96 new tokens, spec_k 4, B=1 then 8), and
the serving sections ``bench_decode`` (greedy and sampled ``generate`` of a
Llama-1B at B=8, S0=512, 128 new, then at a 4096-token cache budget with
flash and with dense attention), ``bench_moe_decode`` (a Mixtral-style
8-layer model, 8 experts, top-2, at the same shape), ``bench_engine``
(``ServeEngine`` against static ``generate`` batches on a ragged mix of 24
requests, with a self-draft and with a shared 512-token prefix) and
``bench_cached_prefill`` (the cached-prefill kernel against the dense
cached sweep at a half-full and a small-prefix cache). The
same shapes, configurations and dict keys, timed after the same warm-ups:
on a CUDA tensor with CUDA events, on a CPU tensor (the tests' shrunken
shapes) with the host clock. Deliberate differences:

- flash attention is the port's CUDA kernels on the card; the JAX section
  runs dense attention off the TPU and skips the sliding-window half there;
- ``mfu`` is model FLOPs (``_train_flops``) over the step time and the H100
  SXM's data-sheet bf16 peak (989e12 FLOP/s, ``PEAK_BF16``), and None off
  the card; the JAX section divides by its TPU generation's peak;
- no ``try``: a failing kernel raises, where the JAX section records
  ``fwdbwd_error`` / ``streaming_tri_error`` and goes on;
- the long-context dict also carries the timed steps' losses (``losses``,
  ``swa_losses``), so a caller can check them;
- inputs come from ``torch.Generator`` seeds 0 and 1 (``jax.random`` cannot
  be reproduced); ``shape``, ``streaming_shape``, ``cfg``, ``seq_len`` and
  ``window`` override the sizes;
- ``bench_speculative`` runs flash attention (the JAX section runs the
  config's default, dense) and rounds ``max_len`` up to a multiple of 128,
  where the decode kernel's gate holds (the JAX section takes the smallest
  budget, S0 + new + spec_k + 1);
- the serving sections take the best of ROUNDS runs after one warm one,
  as the JAX ones after their compile; the dense side of
  ``bench_decode``'s budget comparison and of ``bench_cached_prefill`` is
  the port's dense cached sweep (``decode._cached_attention(impl=
  "dense")``), as in the JAX sections; the sampled run reseeds its
  generator each run, as the JAX one reuses its key; every model is the
  JAX one, heads included: the serving kernels take head dims 16, 32, 64
  and 128 (``bench_engine``'s and ``bench_moe_decode``'s fast models serve
  at 8/4 heads of 32), the training kernels 64 and 128
  (``bench_train_step``'s fast model trains at 8/4 heads of 64).

Run on a machine with the card, from the repository root::

    python3 -m gpu_provisioner_tpu_torch.bench            # full size
    python3 -m gpu_provisioner_tpu_torch.bench --fast
    python3 -m gpu_provisioner_tpu_torch.bench --sections decode,engine
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time

import torch

from .device import resolve_device
from .models.decode import _cached_attention, generate
from .models.engine import ServeEngine
from .models.llama import PRESETS, LlamaConfig, forward, init_params
from .models.moe import MoEConfig, init_moe_model
from .models.speculative import speculative_generate
from .models.train import (default_optimizer, make_train_state,
                           make_train_step, param_leaves)
from .ops.flash_attention import (cached_flash_supported, flash_attention,
                                  flash_attention_cached)
from .parallel.ring import dense_attention

# (B, S, Hq, Hkv, D), bf16, as bench.py's bench_flash_op
FLASH_OP_SHAPE = {True: (4, 1024, 8, 4, 128), False: (8, 4096, 16, 8, 128)}
STREAMING_SHAPE = (1, 32768, 8, 4, 128)
SWA_WINDOW = 1024
ROUNDS = 3          # best of ROUNDS, after one warm call (bench_flash_op)
OP_CALLS = 5        # calls per round of the op timings (streaming: 1)
WARM_STEPS, TIMED_STEPS = 2, 3     # bench_long_context, per model
# (S0, new tokens, spec_k, batched B) of bench_speculative, as bench.py's
SPEC_SHAPE = {True: (64, 16, 3, 2), False: (256, 96, 4, 8)}
SPEC_ROUNDS = 3     # best of SPEC_ROUNDS runs a batch size, after one warm


# (B, S) of bench_workload and bench_train_step, as bench.py's
WORKLOAD_SHAPE = {True: (4, 512), False: (8, 1024)}
TRAIN_STEP_SHAPE = {True: (4, 512), False: (8, 2048)}
WORKLOAD_WARM, WORKLOAD_CALLS = 3, 10   # then best of ROUNDS rounds
TRAIN_WARM, TRAIN_ITERS = 2, 5          # then best of ROUNDS rounds
PEAK_BF16 = 989e12      # H100 SXM data sheet, dense bf16 FLOP/s

# (B, S0, new tokens) of bench_decode and bench_moe_decode, and
# bench_decode's serving budget (max_len), as bench.py's
DECODE_SHAPE = {True: (2, 128, 16), False: (8, 512, 128)}
DECODE_BUDGET = {True: 1024, False: 4096}
# (slots, max_len, requests) and the shared prefix of bench_engine
ENGINE_SHAPE = {True: (2, 512, 6), False: (8, 2048, 24)}
ENGINE_BUCKETS = (64, 128, 256)
PREFIX_LEN = {True: 128, False: 512}
# (B, S, max_len, Hq, Hkv, D) of bench_cached_prefill, bf16
CACHED_PREFILL_SHAPE = {True: (2, 256, 2048, 8, 4, 128),
                        False: (4, 512, 8192, 16, 8, 128)}
CACHED_CALLS = 5        # calls per round of bench_cached_prefill


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


def workload_config(fast: bool) -> LlamaConfig:
    """bench.py's flagship model: fast, vocab 2048, dim 512, 4 layers, GQA
    8/4, hidden 1408; else Llama-1B; bf16, dense attention."""
    if fast:
        return LlamaConfig(vocab_size=2048, dim=512, n_layers=4, n_heads=8,
                           n_kv_heads=4, hidden_dim=1408)
    return PRESETS["llama-1b"]


def bench_workload(fast: bool, device=None, *, cfg=None, shape=None) -> dict:
    """Forward-step throughput of the flagship model (dense attention, bf16
    weights, zero tokens): the best of ROUNDS rounds of WORKLOAD_CALLS
    forwards after WORKLOAD_WARM, at ``shape`` (B, S) (default
    WORKLOAD_SHAPE)."""
    dev = resolve_device(device)
    cfg = cfg or workload_config(fast)
    B, S = shape or WORKLOAD_SHAPE[fast]
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.zeros((B, S), dtype=torch.int32, device=dev)

    def calls(n):
        with torch.no_grad():
            for _ in range(n):
                forward(params, tokens, cfg)

    calls(WORKLOAD_WARM)
    ms = min(_elapsed_ms(dev, lambda: calls(WORKLOAD_CALLS))
             for _ in range(ROUNDS)) / WORKLOAD_CALLS
    return {"platform": dev.type, "tokens_per_s": B * S / ms * 1e3,
            "step_ms": ms}


def train_step_config(fast: bool) -> LlamaConfig:
    """bench.py's bench_train_step model, flash attention and remat: fast,
    vocab 2048, dim 512, 4 layers, 8/4 heads of 64, hidden 1408; else
    Llama-1B; bf16 activations."""
    cfg = (LlamaConfig(vocab_size=2048, dim=512, n_layers=4, n_heads=8,
                       n_kv_heads=4, hidden_dim=1408) if fast
           else PRESETS["llama-1b"])
    return dataclasses.replace(cfg, attn_impl="flash", remat=True)


def _train_flops(params: dict, cfg: LlamaConfig, batch: int,
                 seq: int) -> float:
    """Model FLOPs per train step (fwd+bwd ≈ 3× fwd): 6·P per token for the
    matmuls + causal attention scores/values (2·B·S²·H·Dh fwd, ×3)."""
    n_params = sum(p.numel() for p in param_leaves(params))
    matmul = 6.0 * n_params * batch * seq
    # QKᵀ and PV: 4·B·S²·H·Dh forward, ×3 with the backward; causal halves
    attn = (12.0 * batch * seq * seq * cfg.n_heads * cfg.head_dim
            * cfg.n_layers * 0.5)
    return matmul + attn


def bench_train_step(fast: bool, device=None, *, cfg=None,
                     shape=None) -> dict:
    """A full train step (forward, backward, the bf16-mu AdamW update) with
    flash attention and remat, and its MFU: the best of ROUNDS rounds of
    TRAIN_ITERS steps after TRAIN_WARM, at ``shape`` (B, S) (default
    TRAIN_STEP_SHAPE), one batch drawn from seed 1."""
    dev = resolve_device(device)
    cfg = cfg or train_step_config(fast)
    B, S = shape or TRAIN_STEP_SHAPE[fast]
    params, opt = make_train_state(
        cfg, torch.Generator(dev).manual_seed(0), dev,
        optimizer=functools.partial(default_optimizer,
                                    mu_dtype=torch.bfloat16))
    step = make_train_step(cfg, opt)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g).to(dev)
    inp, tgt = toks[:, :-1], toks[:, 1:]

    def steps(n):
        for _ in range(n):
            loss = step(params, inp, tgt)
        return loss.item()

    steps(TRAIN_WARM)
    ms = min(_elapsed_ms(dev, lambda: steps(TRAIN_ITERS))
             for _ in range(ROUNDS)) / TRAIN_ITERS
    flops = _train_flops(params, cfg, B, S)
    return {"platform": dev.type, "batch": B, "seq_len": S, "step_ms": ms,
            "tokens_per_s": B * S / ms * 1e3, "flops": flops,
            "mfu": flops / (ms * 1e-3) / PEAK_BF16 if dev.type == "cuda"
            else None}


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


def speculative_config(fast: bool) -> LlamaConfig:
    """bench.py's bench_speculative model: fast, vocab 2048, dim 512, 4
    layers, GQA 8/4, hidden 1408; else Llama-1B (vocab 32000, dim 2048, 16
    layers, GQA 16/8, hidden 5504); bf16, flash attention."""
    if fast:
        return LlamaConfig(vocab_size=2048, dim=512, n_layers=4, n_heads=8,
                           n_kv_heads=4, hidden_dim=1408, attn_impl="flash")
    return LlamaConfig(vocab_size=32000, dim=2048, n_layers=16, n_heads=16,
                       n_kv_heads=8, hidden_dim=5504, attn_impl="flash")


def bench_speculative(fast: bool, device=None, *, cfg=None,
                      shape=None) -> dict:
    """Speculative decoding with a SELF-draft (draft == target, so every
    proposal is accepted): the tokens/s is the acceptance upper bound. It
    times the draft steps, the wide verify call and the rollback, at B=1
    and then batched (per-row acceptance). ``shape`` = (S0, new tokens,
    spec_k, batched B) overrides SPEC_SHAPE."""
    dev = resolve_device(device)
    cfg = cfg or speculative_config(fast)
    S0, NEW, K, Bb = shape or SPEC_SHAPE[fast]
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    max_len = -(-(S0 + NEW + K + 1) // 128) * 128

    def best(B):
        """(best ms of SPEC_ROUNDS runs after a warm one, target calls)"""
        prompt = torch.zeros((B, S0), dtype=torch.int32, device=dev)

        def run():
            return speculative_generate(
                params, params, prompt, cfg, cfg, max_new_tokens=NEW,
                spec_k=K, max_len=max_len, device=dev)[1]["target_calls"]
        calls = run()
        return min(_elapsed_ms(dev, run) for _ in range(SPEC_ROUNDS)), calls

    total_ms, calls = best(1)
    out = {"new_tokens": NEW, "spec_k": K, "target_calls": calls,
           "total_ms": total_ms,
           "tokens_per_s_upper_bound": NEW / total_ms * 1e3}
    batched_ms, _ = best(Bb)
    out.update({"batch": Bb, "batched_total_ms": batched_ms,
                "batched_tokens_per_s_upper_bound": Bb * NEW / batched_ms
                * 1e3})
    return out


def _best_ms(dev: torch.device, fn, rounds: int = ROUNDS) -> float:
    """The best of ``rounds`` timed fn() after one warm call."""
    fn()
    return min(_elapsed_ms(dev, fn) for _ in range(rounds))


def decode_config(fast: bool) -> LlamaConfig:
    """bench.py's bench_decode model, bf16, flash attention: fast, vocab
    2048, dim 512, 4 layers, 8/4 heads of 64, hidden 1408; else Llama-1B.
    The JAX ones, head counts included."""
    if fast:
        return LlamaConfig(vocab_size=2048, dim=512, n_layers=4, n_heads=8,
                           n_kv_heads=4, hidden_dim=1408, attn_impl="flash")
    return LlamaConfig(vocab_size=32000, dim=2048, n_layers=16, n_heads=16,
                       n_kv_heads=8, hidden_dim=5504, attn_impl="flash")


def bench_decode(fast: bool, device=None, *, cfg=None, shape=None,
                 budget=None) -> dict:
    """Serving throughput: greedy ``generate`` at (B, S0, new) = ``shape``
    (default DECODE_SHAPE) on zero prompts, then sampled (temperature 0.8,
    top-k 50, top-p 0.95), then greedy at a cache budget of ``budget``
    tokens (default DECODE_BUDGET) with flash and with dense attention;
    each the best of ROUNDS runs after a warm one."""
    dev = resolve_device(device)
    cfg = cfg or decode_config(fast)
    B, S0, NEW = shape or DECODE_SHAPE[fast]
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    prompt = torch.zeros((B, S0), dtype=torch.int32, device=dev)
    best = _best_ms(dev, lambda: generate(params, prompt, cfg,
                                          max_new_tokens=NEW, device=dev))
    g = torch.Generator(dev)

    def sampled():
        generate(params, prompt, cfg, max_new_tokens=NEW, temperature=0.8,
                 top_k=50, top_p=0.95, generator=g.manual_seed(1),
                 device=dev)

    best_s = _best_ms(dev, sampled)
    out = {"batch": B, "prompt_len": S0, "new_tokens": NEW,
           "total_ms": best, "decode_tokens_per_s": B * NEW / best * 1e3,
           "sampled_total_ms": best_s,
           "decode_tokens_per_s_sampled": B * NEW / best_s * 1e3}
    ML = budget or DECODE_BUDGET[fast]
    for impl in ("flash", "dense"):
        cfg_i = dataclasses.replace(cfg, attn_impl=impl)
        ms = _best_ms(dev, lambda: generate(params, prompt, cfg_i,
                                            max_new_tokens=NEW, max_len=ML,
                                            device=dev))
        out[f"budget{ML}_{impl}_total_ms"] = ms
        out[f"budget{ML}_{impl}_tokens_per_s"] = B * NEW / ms * 1e3
    return out


def moe_decode_config(fast: bool) -> MoEConfig:
    """bench.py's bench_moe_decode model, bf16, flash attention, top-2,
    the JAX one: fast, vocab 2048, dim 256, 2 layers, 8/4 heads of 32,
    hidden 512, 4 experts; else vocab 32000, dim 1024, 8 layers, 16/8
    heads of 64, hidden 2816, 8 experts."""
    if fast:
        return MoEConfig(vocab_size=2048, dim=256, n_layers=2, n_heads=8,
                         n_kv_heads=4, hidden_dim=512, n_experts=4,
                         experts_per_token=2, attn_impl="flash")
    return MoEConfig(vocab_size=32000, dim=1024, n_layers=8, n_heads=16,
                     n_kv_heads=8, hidden_dim=2816, n_experts=8,
                     experts_per_token=2, attn_impl="flash")


def bench_moe_decode(fast: bool, device=None, *, cfg=None,
                     shape=None) -> dict:
    """MoE serving throughput: greedy ``generate`` of a Mixtral-style
    model (top-2 of 8 experts) at (B, S0, new) = ``shape`` (default
    DECODE_SHAPE) on zero prompts, the best of ROUNDS runs after a warm
    one."""
    dev = resolve_device(device)
    cfg = cfg or moe_decode_config(fast)
    B, S0, NEW = shape or DECODE_SHAPE[fast]
    params = init_moe_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    prompt = torch.zeros((B, S0), dtype=torch.int32, device=dev)
    best = _best_ms(dev, lambda: generate(params, prompt, cfg,
                                          max_new_tokens=NEW, device=dev))
    return {"batch": B, "prompt_len": S0, "new_tokens": NEW,
            "n_experts": cfg.n_experts, "total_ms": best,
            "decode_tokens_per_s": B * NEW / best * 1e3}


def engine_config(fast: bool) -> LlamaConfig:
    """bench.py's bench_engine model, bf16, flash attention, the JAX one:
    fast, vocab 2048, dim 256, 2 layers, 8/4 heads of 32, hidden 512; else
    Llama-1B."""
    if fast:
        return LlamaConfig(vocab_size=2048, dim=256, n_layers=2, n_heads=8,
                           n_kv_heads=4, hidden_dim=512, attn_impl="flash")
    return decode_config(False)


def bench_engine(fast: bool, device=None, *, cfg=None, shape=None,
                 prefix_len=None) -> dict:
    """Continuous batching against static batching on a ragged mix: N
    requests of 64, 128 and 192 tokens (from [1, vocab), seed 1) and 8 to
    32 new tokens (16 to 64 at full size) through one ``ServeEngine`` of
    ``slots`` rows at ``max_len`` ((slots, max_len, N) = ``shape``, default
    ENGINE_SHAPE), against slot-sized ``generate`` batches left-padded to
    their longest prompt and run to their largest budget; then the engine
    with a self-draft (spec_k 3), and the mix behind a shared prefix of
    ``prefix_len`` tokens (default PREFIX_LEN) cached against re-prefilled.
    Each timed once after one warm pass, as the JAX section."""
    dev = resolve_device(device)
    cfg = cfg or engine_config(fast)
    slots, ML, N = shape or ENGINE_SHAPE[fast]
    PFX = prefix_len or PREFIX_LEN[fast]
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    g = torch.Generator().manual_seed(1)
    lens = [64 + 64 * (i % 3) for i in range(N)]
    news = [(8 + 8 * (i % 4)) if fast else (16 + 16 * (i % 4))
            for i in range(N)]
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in lens]
    prefix = torch.randint(1, cfg.vocab_size, (PFX,), generator=g).tolist()

    def timed(fn):
        """(ms of one timed fn() after a warm one, its last result)"""
        fn()
        box = []
        ms = _elapsed_ms(dev, lambda: box.append(fn()))
        return ms, box[0]

    def drain(eng, reqs):
        for p, n, pre in reqs:
            eng.submit(p, n, prefix=pre)
        out = dict(eng.run())
        eng.finished.clear()
        return sum(len(v) for v in out.values())

    plain = [(p, n, None) for p, n in zip(prompts, news)]
    eng = ServeEngine(params, cfg, slots=slots, max_len=ML,
                      prefill_buckets=ENGINE_BUCKETS, device=dev)
    dt_engine, total = timed(lambda: drain(eng, plain))

    def run_static():
        done = 0
        for i in range(0, N, slots):
            batch = list(range(i, min(i + slots, N)))
            w = max(lens[b] for b in batch)
            new = max(news[b] for b in batch)
            toks = torch.tensor([[0] * (w - lens[b]) + prompts[b]
                                 for b in batch], dtype=torch.int32)
            generate(params, toks, cfg, max_new_tokens=new, max_len=ML,
                     pad_id=0, device=dev)
            done += sum(min(new, news[b]) for b in batch)
        return done

    dt_static, done = timed(run_static)
    eng_s = ServeEngine(params, cfg, slots=slots, max_len=ML,
                        prefill_buckets=ENGINE_BUCKETS, draft_params=params,
                        draft_cfg=cfg, spec_k=3, device=dev)
    dt_spec, total_s = timed(lambda: drain(eng_s, plain))
    eng_c = ServeEngine(params, cfg, slots=slots, max_len=ML,
                        prefill_buckets=ENGINE_BUCKETS + (PFX,), device=dev)
    eng_u = ServeEngine(params, cfg, slots=slots, max_len=ML,
                        prefill_buckets=tuple(PFX + b
                                              for b in ENGINE_BUCKETS),
                        device=dev)
    cached = [(p, n, prefix) for p, n in zip(prompts, news)]
    whole = [(prefix + p, n, None) for p, n in zip(prompts, news)]
    drain(eng_c, cached), drain(eng_u, whole)          # warm both first
    dt_pc = _elapsed_ms(dev, lambda: drain(eng_c, cached))
    dt_pu = _elapsed_ms(dev, lambda: drain(eng_u, whole))
    rate, rate_s = total / dt_engine * 1e3, total_s / dt_spec * 1e3
    static_rate = done / dt_static * 1e3
    return {"requests": N, "slots": slots,
            "engine_tokens": total, "engine_ms": dt_engine,
            "engine_tokens_per_s": rate,
            "static_ms": dt_static, "static_tokens_per_s": static_rate,
            "speedup_vs_static": rate / static_rate,
            "spec_engine_selfdraft_ms": dt_spec,
            "spec_engine_selfdraft_tokens_per_s": rate_s,
            "spec_selfdraft_cost_ratio": rate_s / rate,
            "prefix_len": PFX, "prefix_cached_ms": dt_pc,
            "prefix_uncached_ms": dt_pu,
            "prefix_cache_speedup": dt_pu / dt_pc}


def bench_cached_prefill(fast: bool, device=None, *, shape=None) -> dict:
    """Prefill continuation: the cached-prefill kernel
    (``flash_attention_cached``) against the dense masked sweep over the
    whole budget (``decode._cached_attention``, dense), bf16, at (B, S,
    max_len, Hq, Hkv, D) = ``shape`` (default CACHED_PREFILL_SHAPE): a
    half-full cache (start max_len / 2) and a small prefix (max_len / 16).
    Each the best of ROUNDS rounds of CACHED_CALLS calls after a warm
    one."""
    dev = resolve_device(device)
    B, S, ML, Hq, Hkv, D = shape or CACHED_PREFILL_SHAPE[fast]
    if not cached_flash_supported(S, ML, Hq, Hkv):
        raise ValueError(f"(S, max_len, Hq, Hkv) = {(S, ML, Hq, Hkv)} does "
                         "not tile for the cached-prefill kernel")
    g = torch.Generator(dev).manual_seed(0)
    q, kc, vc = (torch.randn(*sh, generator=g, device=dev).to(torch.bfloat16)
                 for sh in ((B, S, Hq, D), (B, Hkv, ML, D), (B, Hkv, ML, D)))
    scale = D ** -0.5

    def best_ms(fn):
        return _best_ms(dev, lambda: [fn() for _ in range(CACHED_CALLS)]) \
            / CACHED_CALLS

    out = {"new_tokens": S, "cache_len": ML}
    for tag, st in (("", ML // 2), ("small_prefix_", ML // 16)):
        f_ms = best_ms(lambda: flash_attention_cached(q, kc, vc, st,
                                                      scale=scale))
        d_ms = best_ms(lambda: _cached_attention(q, kc, vc, st, scale))
        out.update({f"{tag}start": st, f"{tag}flash_ms": f_ms,
                    f"{tag}dense_ms": d_ms,
                    f"{tag}flash_speedup": d_ms / f_ms})
    return out


SECTIONS = {"workload": bench_workload, "train_step": bench_train_step,
            "long_context": bench_long_context, "flash_op": bench_flash_op,
            "speculative": bench_speculative, "decode": bench_decode,
            "moe_decode": bench_moe_decode, "engine": bench_engine,
            "prefill_cached": bench_cached_prefill}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated, of " + ", ".join(SECTIONS))
    args = ap.parse_args(argv)
    names = args.sections.split(",")
    unknown = sorted(set(names) - set(SECTIONS))
    if unknown:
        ap.error(f"unknown sections {unknown}")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"device": torch.cuda.get_device_name(0)}
    for name in names:
        out[name] = SECTIONS[name](args.fast)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
