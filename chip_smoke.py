#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpu_provisioner_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each of which exits non-zero on a failed check:
1. card and build: the card's name and power limit, the nvcc build of every
   kernel from ops/csrc (one nvcc per source, started together);
2. each kernel against its plain PyTorch version on the card, at the main
   path's head shapes (Hq 32, Hkv 8, D 128) in bf16 and f32, then its time
   (CUDA events, L2 flushed before each launch) beside its plain version's,
   one PyTorch library call's (scaled_dot_product_attention, a yardstick the
   port never calls) and its bound (bytes over 3.35 TB/s or bf16 operations
   over 989 TFLOP/s, whichever is larger: the H100 SXM's published peaks);
3. exact tokens: Llama-7B width, 2 layers, f32: every ServeEngine stream
   equals generate() on that request alone;
4. the serving path: full Llama-7B (32 layers) in bf16 with the flash
   kernels: after one warm-up pass, three ServeEngine passes of 6 requests
   each (one shared prefix), then generate() with B=2, S0=512, fresh and
   left-padded, with every kernel's launch count read across that run;
5. both backward kernels against attention_bwd_plain on the card (bf16 and
   f32, D 128, causal, non-causal, window 1024, a non-zero lse cotangent;
   error relative to the largest plain gradient), then, at the training
   shape (B=8, S=2048 causal, Hq 16, Hkv 8, bf16), the forward kernel
   against attention_plain and both backward kernels against
   attention_bwd_plain, and each backward kernel timed beside the plain
   backward, the library yardstick (torch.autograd.grad of
   scaled_dot_product_attention, dQ/dK/dV together) and its bound;
6. exact training: Llama-1B width, 2 layers, f32: one make_train_step with
   the flash kernels and one with dense attention, from the same params and
   batch, agree in loss and every gradient, and again in the loss of a
   second step;
7. the training path: full Llama-1B (16 layers), bf16 activations, f32
   masters, remat, B=8, S=2048, AdamW: one warm-up step, then five timed
   steps on one fixed batch, with the loss falling and every kernel's
   launch count read across the five;
8. long context: the three flattened-triangle kernels (flash_tri.cu)
   called directly against their plain versions (bf16 and f32, causal, at
   (B, S, Hq, Hkv) = (1, 128, 1, 1), where the persistent grid has more
   CTAs than tiles, (1, 384, 2, 1) with an lse cotangent, (2, 2048, 16, 8)
   and (1, 8192, 16, 8)); flash_attention(triangular=True) and its
   gradients against the rectangular kernels at B=1, S=16384 and 32768,
   Hq/Hkv 8/4 (bench_flash_op's streaming shape) and 32/8 (llama-7b's
   attention at mistral-7b-ish's 32k context), bf16, with every kernel's
   launch count read across the 32k, Hq 32 forward and backward; each tri
   kernel timed at S=32768, Hq 8 beside its rectangular kernel, the SDPA
   yardstick and its bound; flash_attention_with_lse and its gradients
   against the plain versions at the bench twins' own shapes ((1, 8192, 8,
   4) causal, (1, 32768, 8, 4) with window 1024 through a plain version
   built by 1024-query chunks, (8, 4096, 16, 8) causal), one launch of
   each rectangular kernel apiece; then the bench twins
   bench_long_context and bench_flash_op at full size, each with its
   launch counts read and checked against its repetition counts;
then the card line, the kernels line and, last, the device line.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"bfloat16": 1e-2, "float32": 1e-4}
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12     # H100 SXM data sheet, dense
SEED = 0


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, reps=20, warm=3):
    """Median of per-launch CUDA-event times, the 50 MB L2 flushed before
    each launch (the serving loop reads each layer's cache cold)."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _attended(B, S, Sk, start, pads, window, sinks, causal):
    """keep [B, S, Sk]: key attendable from query, on these inputs."""
    import torch
    st = (start.long().cpu().reshape(-1) if isinstance(start, torch.Tensor)
          else torch.tensor([start])).expand(B)
    qp = (st[:, None] + torch.arange(S))[:, :, None]
    kp = torch.arange(Sk)[None, None, :]
    pad = torch.zeros(B, dtype=torch.long) if pads is None \
        else pads.long().cpu()
    keep = kp >= pad[:, None, None]
    if causal:
        keep = keep & (kp <= qp)
    if window is not None:
        w = kp > qp - window
        if sinks:
            w = w | (kp < (pad + sinks)[:, None, None])
        keep = keep & w
    return keep


def work(B, S, Hq, Hkv, D, Sk, start, pads, window, sinks, causal,
         act_bytes, kv_bytes, int8, lse):
    """(operations, bytes) the call needs on these inputs: 4·D operations
    per attended (query, key) pair and head; each input read once (the
    cache only where some query of the row attends), each output written
    once."""
    keep = _attended(B, S, Sk, start, pads, window, sinks, causal)
    pairs = int(keep.sum()) * Hq
    keys = int(keep.any(dim=1).sum()) * Hkv          # (row, kv head, key)
    nbytes = (2 * B * S * Hq * D * act_bytes          # q in, out
              + 2 * keys * D * kv_bytes                # live K and V
              + (2 * keys * 4 if int8 else 0)          # their scales
              + (B * Hq * S * 4 if lse else 0))
    return 4 * D * pairs, nbytes


def phase_kernels(torch, tfa, td, dev):
    """Each kernel against its plain version, then timed at a main-path
    shape. Returns the kernels line's entries (launches filled later)."""
    import torch.nn.functional as F
    g = torch.Generator(dev).manual_seed(SEED)
    Hq, Hkv, D, ML = 32, 8, 128, 2048

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    errs = {"flash_fwd": 0.0, "flash_cached": 0.0, "flash_decode": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for B, S, causal, window in ((2, 512, True, None),
                                     (1, 4096, True, None),
                                     (1, 4096, True, 1024),
                                     (2, 512, False, None)):
            q = rnd(B, S, Hq, D, dtype=dtype)
            k, v = rnd(B, S, Hkv, D, dtype=dtype), rnd(B, S, Hkv, D,
                                                        dtype=dtype)
            out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal,
                                                    window=window)
            ref, rlse = tfa.attention_plain(
                q, k.transpose(1, 2), v.transpose(1, 2), 0, causal=causal,
                window=window)
            e, el = err(out, ref), err(lse, rlse)
            print(f"flash_fwd {dtype} B={B} S={S} causal={causal} "
                  f"window={window}:"
                  f" max|out-plain| {e:.3g} |lse-plain| {el:.3g} (tol {tol})")
            check(e <= tol and el <= 1e-4, "flash_fwd disagrees with plain")
            if dtype == torch.bfloat16:
                errs["flash_fwd"] = max(errs["flash_fwd"], e)
            del q, k, v, out, lse, ref, rlse
        for B, S, start, pads, int8, window, sinks in (
                (1, 128, 0, [40], False, None, 0),
                (2, 512, 0, [0, 200], False, None, 0),
                (1, 512, 512, None, False, None, 0),
                (2, 256, 300, [0, 100], True, None, 0),
                (1, 256, 900, [7], False, 256, 4),
                (4, 1, [600, 300, 1500, 100], [0, 20, 0, 5], False, None, 0),
                (2, 5, 1000, None, False, None, 0),
                (2, 1, [700, 64], [0, 9], True, None, 0),
                (2, 5, [1400, 300], [4, 0], False, 300, 4)):
            q = rnd(B, S, Hq, D, dtype=dtype)
            kc, vc = rnd(B, Hkv, ML, D, dtype=dtype), rnd(B, Hkv, ML, D,
                                                         dtype=dtype)
            kw = dict(window=window, sinks=sinks)
            if int8:
                kc, kw["k_scale"] = td._quantize_kv(kc)
                vc, kw["v_scale"] = td._quantize_kv(vc)
            if pads is not None:
                kw["pad_lens"] = torch.tensor(pads, dtype=torch.int32,
                                              device=dev)
            st = (torch.tensor(start, dtype=torch.int32, device=dev)
                  if isinstance(start, list) else start)
            name = "flash_decode" if S <= tfa.DECODE_MAX_S else "flash_cached"
            fn = getattr(tfa, "flash_attention_" + name.split("_")[1])
            e = err(fn(q, kc, vc, st, **kw),
                    tfa.attention_plain(q, kc, vc, st, **kw)[0])
            print(f"{name} {dtype} B={B} S={S} start={start} pads={pads} "
                  f"int8={int8} window={window} sinks={sinks}: "
                  f"max|out-plain| {e:.3g} (tol {tol})")
            check(e <= tol, f"{name} disagrees with plain")
            if dtype == torch.bfloat16:
                errs[name] = max(errs[name], e)
    torch.cuda.synchronize()

    # timing at main-path shapes, bf16
    bf = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []

    def row(name, source, replaces, kernel, plain, library, ops_bytes):
        ops, nbytes = ops_bytes
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": errs[name], "tolerance": TOL["bfloat16"],
            "ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": time_ms(library, flush)})
        print(f"{name}: {json.dumps(rows[-1])}")

    # generate's fresh prefill: B=2, S0=512, causal self-attention
    q = rnd(2, 512, Hq, D, dtype=bf)
    k, v = rnd(2, 512, Hkv, D, dtype=bf), rnd(2, 512, Hkv, D, dtype=bf)
    row("flash_fwd", "gpu_provisioner_tpu_torch/ops/csrc/flash_fwd.cu",
        "gpu_provisioner_tpu/ops/flash_attention.py:70 (_kernel_resident), "
        ":202 (_kernel)",
        lambda: tfa.flash_attention_with_lse(q, k, v),
        lambda: tfa.attention_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                                    0),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True),
        work(2, 512, Hq, Hkv, D, 512, 0, None, None, 0, True, 2, 2, False,
             True))
    # engine admission after a cached prefix: B=1, suffix bucket 256 at
    # the prefix bucket's offset 128, the prefix's left pads masked
    q = rnd(1, 256, Hq, D, dtype=bf)
    kc, vc = rnd(1, Hkv, ML, D, dtype=bf), rnd(1, Hkv, ML, D, dtype=bf)
    pads = torch.tensor([28], dtype=torch.int32, device=dev)
    kp = torch.arange(ML, device=dev)
    mask = ((kp[None, :] <= 128 + torch.arange(256, device=dev)[:, None])
            & (kp[None, :] >= 28))[None, None]
    row("flash_cached", "gpu_provisioner_tpu_torch/ops/csrc/flash_fwd.cu",
        "gpu_provisioner_tpu/ops/flash_attention.py:468 (_kernel_cached)",
        lambda: tfa.flash_attention_cached(q, kc, vc, 128, pad_lens=pads),
        lambda: tfa.attention_plain(q, kc, vc, 128, pad_lens=pads),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kc, vc, attn_mask=mask, enable_gqa=True),
        work(1, 256, Hq, Hkv, D, ML, 128, pads, None, 0, True, 2, 2, False,
             False))
    # an engine decode step: 4 slots at their own lengths and pads
    q = rnd(4, 1, Hq, D, dtype=bf)
    kc, vc = rnd(4, Hkv, ML, D, dtype=bf), rnd(4, Hkv, ML, D, dtype=bf)
    st = torch.tensor([540, 300, 610, 420], dtype=torch.int32, device=dev)
    pads = torch.tensor([12, 0, 100, 56], dtype=torch.int32, device=dev)
    mask = ((kp[None, :] <= st[:, None]) & (kp[None, :] >= pads[:, None])
            )[:, None, None, :]
    row("flash_decode", "gpu_provisioner_tpu_torch/ops/csrc/flash_decode.cu",
        "gpu_provisioner_tpu/ops/flash_attention.py:660 (_kernel_decode)",
        lambda: tfa.flash_attention_decode(q, kc, vc, st, pad_lens=pads),
        lambda: tfa.attention_plain(q, kc, vc, st, pad_lens=pads),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kc, vc, attn_mask=mask, enable_gqa=True),
        work(4, 1, Hq, Hkv, D, ML, st, pads, None, 0, True, 2, 2, False,
             False))
    del flush
    return rows


def work_bwd(kernel, B, S, Hq, Hkv, D, causal, window, act_bytes):
    """(operations, bytes) one backward kernel needs on these inputs: per
    attended (query, key) pair and q-head, 6·D operations for dQ (S, dP,
    dS·K) and 8·D for dK/dV (S, dP, Pᵀ·dO, dSᵀ·Q); q, k, v, dO, lse and Δ
    read once, its outputs written once."""
    pairs = int(_attended(B, S, S, 0, None, window, 0, causal).sum()) * Hq
    q_side, kv_side = B * S * Hq * D * act_bytes, B * S * Hkv * D * act_bytes
    reads = 2 * q_side + 2 * kv_side + 2 * B * Hq * S * 4
    if kernel == "flash_bwd_dq":
        return 6 * D * pairs, reads + q_side
    return 8 * D * pairs, reads + 2 * kv_side


# (B, S, Hq, Hkv, causal, window, lse cotangent), D = 128
BWD_CASES = ((2, 512, 32, 8, True, None, False),
             (1, 2048, 16, 8, True, None, False),
             (1, 4096, 32, 8, True, None, False),
             (2, 512, 16, 16, False, None, False),
             (1, 4096, 32, 8, True, 1024, False),
             (2, 512, 32, 8, True, None, True))
TRAIN_SHAPE = (8, 2048, 16, 8)     # llama-1b attention: B, S, Hq, Hkv


def phase_bwd_kernels(torch, tfa, dev):
    """Both backward kernels against attention_bwd_plain, then each timed
    at the training shape. Returns the kernels line's entries."""
    import torch.nn.functional as F
    g = torch.Generator(dev).manual_seed(SEED + 3)
    D = 128

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def err(a, b):
        e = (a.float() - b.float()).abs().max().item()
        return e, e / b.float().abs().max().item()

    worst = {"flash_bwd_dq": (0.0, 0.0), "flash_bwd_dkv": (0.0, 0.0)}
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for B, S, Hq, Hkv, causal, window, cot in BWD_CASES:
            q, dout = rnd(B, S, Hq, D, dtype=dtype), rnd(B, S, Hq, D,
                                                         dtype=dtype)
            k, v = rnd(B, S, Hkv, D, dtype=dtype), rnd(B, S, Hkv, D,
                                                        dtype=dtype)
            g_lse = rnd(B, Hq, S, dtype=torch.float32) if cot else None
            kw = dict(causal=causal, window=window)
            out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
            got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, g_lse,
                                          **kw)
            want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse,
                                           **kw)
            es = [err(a, b) for a, b in zip(got, want)]
            print(f"flash_bwd {dtype} B={B} S={S} Hq={Hq} Hkv={Hkv} "
                  f"causal={causal} window={window} lse_cotangent={cot}: "
                  + ", ".join(f"{n} max|err| {e:.3g} rel {r:.3g}"
                              for n, (e, r) in zip(("dq", "dk", "dv"), es))
                  + f" (tol {tol}, relative)")
            check(all(r <= tol for _, r in es),
                  "a backward kernel disagrees with attention_bwd_plain")
            check(all(a.dtype == dtype for a in got), "gradient dtypes")
            if dtype == torch.bfloat16:
                for name, part in (("flash_bwd_dq", es[:1]),
                                   ("flash_bwd_dkv", es[1:])):
                    worst[name] = tuple(max(x) for x in zip(worst[name],
                                                            *part))
            del q, k, v, dout, out, lse, got, want
    torch.cuda.synchronize()

    # the training shape, bf16: one llama-1b layer's attention, checked
    # against the plain versions, then timed
    bf, (B, S, Hq, Hkv) = torch.bfloat16, TRAIN_SHAPE
    tol = TOL["bfloat16"]
    q, dout = rnd(B, S, Hq, D, dtype=bf), rnd(B, S, Hq, D, dtype=bf)
    k, v = rnd(B, S, Hkv, D, dtype=bf), rnd(B, S, Hkv, D, dtype=bf)
    out, lse = tfa.flash_attention_with_lse(q, k, v)
    ref, rlse = tfa.attention_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                                    0)
    (fwd_err, fwd_rel), (lse_err, _) = err(out, ref), err(lse, rlse)
    del ref, rlse
    got = tfa.flash_attention_bwd(q, k, v, out, lse, dout)
    want = tfa.attention_bwd_plain(q, k, v, out, lse, dout)
    es = [err(a, b) for a, b in zip(got, want)]
    del got, want
    print(f"training shape bf16 B={B} S={S} Hq={Hq} Hkv={Hkv} causal: "
          f"flash_fwd max|out-plain| {fwd_err:.3g} rel {fwd_rel:.3g}, "
          f"|lse-plain| {lse_err:.3g} (tol 1e-4); "
          + ", ".join(f"{n} max|err| {e:.3g} rel {r:.3g}"
                      for n, (e, r) in zip(("dq", "dk", "dv"), es))
          + f" (tol {tol}, relative)")
    check(fwd_rel <= tol and lse_err <= 1e-4,
          "flash_fwd disagrees with plain at the training shape")
    check(all(r <= tol for _, r in es), "a backward kernel disagrees with "
          "attention_bwd_plain at the training shape")
    for name, part in (("flash_bwd_dq", es[:1]), ("flash_bwd_dkv", es[1:])):
        worst[name] = tuple(max(x) for x in zip(worst[name], *part))
    delta = tfa._bwd_delta(out, dout, None).contiguous()
    lib_in = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)
    lib_dout = dout.transpose(1, 2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    plain_ms = time_ms(lambda: tfa.attention_bwd_plain(q, k, v, out, lse,
                                                       dout), flush)
    library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, lib_in, lib_dout, retain_graph=True), flush)
    rows = []
    for name, replaces in (("flash_bwd_dq", ":916 (_bwd_dq_kernel)"),
                           ("flash_bwd_dkv", ":979 (_bwd_dkv_kernel)")):
        ops, nbytes = work_bwd(name, B, S, Hq, Hkv, D, True, None, 2)
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "gpu_provisioner_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": "gpu_provisioner_tpu/ops/flash_attention.py"
                        + replaces,
            "launches": 0, "max_abs_err": worst[name][0],
            "max_rel_err": worst[name][1], "tolerance": TOL["bfloat16"],
            "ms": time_ms(lambda: tfa._launch_bwd(
                name, q, k, v, dout, lse, delta, causal=True,
                scale=D ** -0.5), flush),
            "plain_ms": plain_ms, "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": library_ms,
            "library_note": "dQ, dK and dV in one call; plain_ms likewise"})
        print(f"{name}: {json.dumps(rows[-1])}")
    del flush, lib_out, lib_in
    return fwd_err, rows


def phase_train_exact(torch, tl, tt, dev):
    """Llama-1B width, 2 layers, f32: a flash train step == a dense one."""
    cfg = dataclasses.replace(tl.PRESETS["llama-1b"], n_layers=2,
                              dtype="float32")
    g = torch.Generator().manual_seed(SEED + 4)
    batches = [torch.randint(0, cfg.vocab_size, (2, 513), generator=g)
               .to(dev) for _ in range(2)]
    losses, grads = {}, {}
    for impl in ("flash", "dense"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        params, opt = tt.make_train_state(
            c, torch.Generator(dev).manual_seed(SEED), dev)
        step = tt.make_train_step(c, opt)
        first = step(params, batches[0][:, :-1], batches[0][:, 1:]).item()
        grads[impl] = [p.grad.clone() for p in tt.param_leaves(params)]
        second = step(params, batches[1][:, :-1], batches[1][:, 1:]).item()
        losses[impl] = (first, second)
        del params, opt, step
    for i, what in enumerate(("loss", "second-step loss")):
        a, b = losses["flash"][i], losses["dense"][i]
        print(f"exact training (llama-1b width, 2 layers, f32) {what}: "
              f"flash {a!r} dense {b!r} rel {abs(a - b) / abs(b):.3g}")
        check(abs(a - b) <= 1e-5 * abs(b), f"{what}: flash != dense")
    worst = max((a - b).abs().max().item() / b.abs().max().item()
                for a, b in zip(grads["flash"], grads["dense"]))
    print(f"exact training: worst gradient leaf max|flash - dense| / "
          f"max|dense| = {worst:.3g} (tol 1e-4)")
    check(worst <= 1e-4, "flash gradients != dense gradients")


def phase_train(torch, tl, tt, tfa, dev):
    """Full Llama-1B: bf16 activations, f32 masters, remat, B=8, S=2048."""
    cfg = dataclasses.replace(tl.PRESETS["llama-1b"], attn_impl="flash",
                              remat=True)
    (B, S, _, _), steps = TRAIN_SHAPE, 5
    params, opt = tt.make_train_state(
        cfg, torch.Generator(dev).manual_seed(SEED), dev)
    step = tt.make_train_step(cfg, opt)
    g = torch.Generator().manual_seed(SEED + 5)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g).to(dev)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    warm = step(params, inp, tgt).item()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(params, inp, tgt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    launches = dict(tfa.LAUNCHES)
    ms = statistics.median(times)
    print(f"train llama-1b bf16 (f32 masters, remat, flash) B={B} S={S}: "
          f"warm-up loss {warm!r}, losses {losses}; step ms {times}, median "
          f"{ms!r} = {B * S / ms * 1e3!r} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches over {steps} steps {launches}")
    check(all(x == x and abs(x) < float("inf") for x in [warm] + losses),
          "a training loss is not finite")
    check(losses[-1] < losses[0] < warm, f"loss did not fall: {losses}")
    L = cfg.n_layers
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps}
    for name, n in want.items():
        check(launches[name] == n,
              f"{name}: {launches[name]} launches on the training path, "
              f"expected {n}")
    return launches


# (B, S, Hq, Hkv, lse cotangent) of the tri kernels against plain, D = 128
TRI_CASES = ((1, 128, 1, 1, False), (1, 384, 2, 1, True),
             (2, 2048, 16, 8, False), (1, 8192, 16, 8, False))
# (S, Hq, Hkv) at B=1, bf16: triangle against rectangle, past the plain
# versions' reach; the last is the main path of the launch counts
LONG_SHAPES = ((16384, 8, 4), (16384, 32, 8), (32768, 8, 4), (32768, 32, 8))
LONG_TOL = 2e-2
TRI_TIMED = (1, 32768, 8, 4)       # bench_flash_op's streaming shape
# tri kernel, TPU kernel it replaces, its rectangular counterpart, D·ops
TRI_KERNELS = (("flash_fwd_tri", ":308 (_kernel_tri)", "flash_fwd", 4),
               ("flash_bwd_dq_tri", ":943 (_bwd_dq_kernel_tri)",
                "flash_bwd_dq", 6),
               ("flash_bwd_dkv_tri", ":1020 (_bwd_dkv_kernel_tri)",
                "flash_bwd_dkv", 8))


def work_tri(kernel, B, S, Hq, Hkv, D, ws_bytes, act_bytes=2):
    """(operations, bytes) of one tri kernel on causal inputs: 4, 6 or 8·D
    operations per attended pair and q-head; q, k, v (and dO, lse, Δ for
    the backward) read once, the outputs written once, and the workspace
    partials written once and read once by the fixup."""
    pairs = B * S * (S + 1) // 2 * Hq
    q_side, kv_side = B * S * Hq * D * act_bytes, B * S * Hkv * D * act_bytes
    rows = B * Hq * S * 4
    per_d = next(n for name, _, _, n in TRI_KERNELS if name == kernel)
    if kernel == "flash_fwd_tri":
        nbytes = 2 * q_side + 2 * kv_side + rows
    else:
        nbytes = 2 * q_side + 2 * kv_side + 2 * rows + (
            q_side if kernel == "flash_bwd_dq_tri" else 2 * kv_side)
    return per_d * D * pairs, nbytes + ws_bytes


def tri_ws_bytes(_cuda, kernel, dev):
    """(workspace bytes written and read back, P): the two slots of each
    of the P CTAs, as the wrapper allocates them (flash_tri_ws_floats),
    counted once written and once read."""
    P = _cuda.tri_ctas(kernel, 1, dev.index)
    return 2 * P * _cuda.tri_ws_floats(kernel) * 4, P


def phase_tri_kernels(torch, tfa, dev):
    """The three flattened-triangle kernels, called directly (below the
    forward's streaming gate), against attention_plain and
    attention_bwd_plain. Returns the worst bf16 errors by kernel."""
    g = torch.Generator(dev).manual_seed(SEED + 6)
    D = 128

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def rel(a, b):
        e = (a.float() - b.float()).abs().max().item()
        return e, e / b.float().abs().max().item()

    worst = {name: (0.0, 0.0) for name, *_ in TRI_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for B, S, Hq, Hkv, cot in TRI_CASES:
            q, dout = rnd(B, S, Hq, D, dtype=dtype), rnd(B, S, Hq, D,
                                                         dtype=dtype)
            k, v = rnd(B, S, Hkv, D, dtype=dtype), rnd(B, S, Hkv, D,
                                                        dtype=dtype)
            g_lse = rnd(B, Hq, S, dtype=torch.float32) if cot else None
            scale = D ** -0.5
            out, lse = tfa._launch_tri("flash_fwd_tri", q, k, v, scale=scale)
            ref, rlse = tfa.attention_plain(q, k.transpose(1, 2),
                                            v.transpose(1, 2), 0)
            (e_out, _), (e_lse, _) = rel(out, ref), rel(lse, rlse)
            del ref, rlse
            delta = tfa._bwd_delta(out, dout, g_lse).contiguous()
            kw = dict(scale=scale, dout=dout, lse=lse, delta=delta)
            dq = tfa._launch_tri("flash_bwd_dq_tri", q, k, v, **kw)
            dk, dv = tfa._launch_tri("flash_bwd_dkv_tri", q, k, v, **kw)
            want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse)
            es = [rel(a, b) for a, b in zip((dq, dk, dv), want)]
            print(f"tri kernels {dtype} B={B} S={S} Hq={Hq} Hkv={Hkv} "
                  f"lse_cotangent={cot}: flash_fwd_tri max|out-plain| "
                  f"{e_out:.3g} |lse-plain| {e_lse:.3g}; "
                  + ", ".join(f"{n} max|err| {e:.3g} rel {r:.3g}"
                              for n, (e, r) in zip(("dq", "dk", "dv"), es))
                  + f" (tol {tol}; backward relative)")
            check(e_out <= tol and e_lse <= 1e-4,
                  "flash_fwd_tri disagrees with attention_plain")
            check(all(r <= tol for _, r in es),
                  "a tri backward kernel disagrees with attention_bwd_plain")
            check(all(a.dtype == dtype for a in (out, dq, dk, dv)),
                  "tri output dtypes")
            if dtype == torch.bfloat16:
                for name, part in (("flash_fwd_tri", [(e_out, 0.0)]),
                                   ("flash_bwd_dq_tri", es[:1]),
                                   ("flash_bwd_dkv_tri", es[1:])):
                    worst[name] = tuple(max(x) for x in zip(worst[name],
                                                            *part))
            del q, k, v, dout, out, lse, dq, dk, dv, want, delta
    torch.cuda.synchronize()
    return worst


# (B, S, Hq, Hkv, window) of the bench twins' attention, D = 128, bf16:
# bench_long_context's layers at S=8192 and its sliding-window model at
# S=32768, then bench_flash_op's op
TWIN_CASES = ((1, 8192, 8, 4, None), (1, 32768, 8, 4, 1024),
              (8, 4096, 16, 8, None))
TWIN_CHUNK = 1024


def plain_windowed(torch, tfa, q, k, v, dout, window):
    """The plain version of windowed causal self-attention and its
    gradients where the S² scores do not fit: attention_plain over chunks
    of TWIN_CHUNK queries at q0, each against keys [q0 - window + 1, q0 +
    TWIN_CHUNK) at start offset q0 - (its first key), in f32 from the
    inputs' values, and autograd's gradients of sum(out · dout) through it.
    Returns (out, lse, dq, dk, dv)."""
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    qf, kf, vf = leaves
    outs, lses = [], []
    for q0 in range(0, q.shape[1], TWIN_CHUNK):
        ks, ke = max(0, q0 - window + 1), q0 + TWIN_CHUNK
        o, lse = tfa.attention_plain(
            qf[:, q0:ke], kf[:, ks:ke].transpose(1, 2),
            vf[:, ks:ke].transpose(1, 2), q0 - ks, window=window)
        outs.append(o)
        lses.append(lse)
    out, lse = torch.cat(outs, 1), torch.cat(lses, 2)
    grads = torch.autograd.grad(out, leaves, dout.float())
    return (out.detach(), lse.detach()) + grads


def plain_causal(torch, tfa, q, k, v, dout):
    """attention_plain, then attention_bwd_plain on its out and lse, one
    batch element at a time (its S² f32 tensors alone on the card).
    Returns (out, lse, dq, dk, dv)."""
    parts = []
    for b in range(q.shape[0]):
        qb, kb, vb, gb = (t[b:b + 1] for t in (q, k, v, dout))
        o, lse = tfa.attention_plain(qb, kb.transpose(1, 2),
                                     vb.transpose(1, 2), 0)
        parts.append((o, lse) + tfa.attention_bwd_plain(qb, kb, vb, o, lse,
                                                        gb))
    return tuple(torch.cat(x) for x in zip(*parts))


def phase_twin_shapes(torch, tfa, dev):
    """flash_attention_with_lse and its gradients at the bench twins'
    shapes (TWIN_CASES) against the plain versions, with the launches of
    each forward and backward (exactly one of each rectangular kernel).
    Returns the worst bf16 errors by kernel: (absolute, relative to the
    largest plain value)."""
    g = torch.Generator(dev).manual_seed(SEED + 8)
    D, bf, tol = 128, torch.bfloat16, TOL["bfloat16"]
    worst = {"flash_fwd": (0.0, 0.0), "flash_bwd_dq": (0.0, 0.0),
             "flash_bwd_dkv": (0.0, 0.0)}
    for B, S, Hq, Hkv, window in TWIN_CASES:
        leaves = [torch.randn(B, S, h, D, generator=g, device=dev).to(bf)
                  .requires_grad_() for h in (Hq, Hkv, Hkv)]
        dout = torch.randn(B, S, Hq, D, generator=g, device=dev).to(bf)
        torch.cuda.synchronize()
        tfa.reset_launches()
        out, lse = tfa.flash_attention_with_lse(*leaves, window=window)
        got = (out, lse) + torch.autograd.grad(out, leaves, dout)
        torch.cuda.synchronize()
        launches = {n: c for n, c in tfa.LAUNCHES.items() if c}
        q, k, v = (t.detach() for t in leaves)
        want = (plain_windowed(torch, tfa, q, k, v, dout, window) if window
                else plain_causal(torch, tfa, q, k, v, dout))
        es = [((a.float() - b.float()).abs().max().item(),
               ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item())
              for a, b in zip(got, want)]
        print(f"bench twin shape bf16 B={B} S={S} Hq={Hq} Hkv={Hkv} "
              f"window={window}: max|out-plain| {es[0][0]:.3g} "
              f"|lse-plain| {es[1][0]:.3g}; "
              + ", ".join(f"{n} max|err| {e:.3g} rel {r:.3g}"
                          for n, (e, r) in zip(("dq", "dk", "dv"), es[2:]))
              + f" (tol {tol}; backward relative); launches {launches}")
        check(es[0][0] <= tol and es[1][0] <= 1e-4
              and all(r <= tol for _, r in es[2:]),
              f"flash attention disagrees with plain at B={B} S={S} "
              f"Hq={Hq} window={window}")
        check(launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1},
              f"launches at B={B} S={S} window={window}: {launches}")
        for name, part in (("flash_fwd", es[:1]), ("flash_bwd_dq", es[2:3]),
                           ("flash_bwd_dkv", es[3:])):
            worst[name] = tuple(max(x) for x in zip(worst[name], *part))
        del leaves, dout, out, lse, got, want, q, k, v
        torch.cuda.empty_cache()
    return worst


def twin_launches(bench):
    """The launches each bench twin makes at full size, from its
    repetition counts: bench_long_context trains two 4-layer models with
    remat (two forwards a layer) for WARM_STEPS + TIMED_STEPS steps each,
    windowed in the second (no triangle); bench_flash_op makes one warm
    call and ROUNDS rounds of OP_CALLS calls of the forward and of the
    forward and backward, then one warm call and ROUNDS calls of the
    streaming forward, rectangular and triangular."""
    L = bench.long_context_config(8192).n_layers
    steps = 2 * (bench.WARM_STEPS + bench.TIMED_STEPS)
    calls, streaming = 1 + bench.ROUNDS * bench.OP_CALLS, 1 + bench.ROUNDS
    return ({"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
             "flash_bwd_dkv": L * steps},
            {"flash_fwd": 2 * calls + streaming, "flash_bwd_dq": calls,
             "flash_bwd_dkv": calls, "flash_fwd_tri": streaming})


def phase_long(torch, tfa, _cuda, bench, dev, worst):
    """flash_attention(triangular=True) against the rectangular kernels at
    full width, the launch counts of the 32k, Hq 32 forward and backward,
    the tri kernels' times, and the bench twins. Returns (kernels line
    entries, launches on the long path)."""
    import torch.nn.functional as F
    g = torch.Generator(dev).manual_seed(SEED + 7)
    D, bf = 128, torch.bfloat16

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def fwd_bwd(leaves, dout, triangular):
        out, lse = tfa.flash_attention_with_lse(*leaves,
                                                triangular=triangular)
        grads = torch.autograd.grad(out, leaves, dout)
        return (out, lse) + grads

    launches = None
    for S, Hq, Hkv in LONG_SHAPES:
        leaves = [rnd(1, S, h, D).requires_grad_() for h in (Hq, Hkv, Hkv)]
        dout = rnd(1, S, Hq, D)
        want = fwd_bwd(leaves, dout, False)
        main = (S, Hq, Hkv) == LONG_SHAPES[-1]
        if main:
            torch.cuda.synchronize()
            tfa.reset_launches()
        got = fwd_bwd(leaves, dout, True)
        if main:
            torch.cuda.synchronize()
            launches = dict(tfa.LAUNCHES)
        errs = [(a.float() - b.float()).abs().max().item()
                / (1.0 if i < 2 else b.float().abs().max().item())
                for i, (a, b) in enumerate(zip(got, want))]
        print(f"triangle vs rectangle bf16 B=1 S={S} Hq={Hq} Hkv={Hkv}: "
              + ", ".join(f"{n} {e:.3g}" for n, e in zip(
                  ("max|out| ", "max|lse|", "dq rel", "dk rel", "dv rel"),
                  errs))
              + f" (tol {LONG_TOL})")
        check(all(e <= LONG_TOL for e in errs) and all(
            bool(torch.isfinite(t).all()) for t in got),
            f"triangular=True disagrees with the rectangular kernels at "
            f"S={S}, Hq={Hq}")
        del leaves, dout, want, got
    print(f"long-path launches (B=1, S={LONG_SHAPES[-1][0]}, Hq "
          f"{LONG_SHAPES[-1][1]}, triangular=True, forward and backward): "
          f"{launches}")
    for name, n in launches.items():
        want_n = 1 if name.endswith("_tri") else 0
        check(n == want_n, f"{name}: {n} launches on the long path, "
              f"expected {want_n}")

    # times at the streaming shape, bf16, beside the rectangular kernels
    B, S, Hq, Hkv = TRI_TIMED
    q, dout = rnd(B, S, Hq, D), rnd(B, S, Hq, D)
    k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    scale = D ** -0.5
    out, lse = tfa._launch_tri("flash_fwd_tri", q, k, v, scale=scale)
    delta = tfa._bwd_delta(out, dout, None).contiguous()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kw = dict(flush=flush, reps=5, warm=1)
    bkw = dict(scale=scale, dout=dout, lse=lse, delta=delta)
    tri_fns = {
        "flash_fwd_tri": lambda: tfa._launch_tri("flash_fwd_tri", q, k, v,
                                                 scale=scale),
        "flash_bwd_dq_tri": lambda: tfa._launch_tri("flash_bwd_dq_tri", q,
                                                    k, v, **bkw),
        "flash_bwd_dkv_tri": lambda: tfa._launch_tri("flash_bwd_dkv_tri", q,
                                                     k, v, **bkw)}
    rect_fns = {
        "flash_fwd": lambda: tfa._launch(
            "flash_fwd", q, k.transpose(1, 2), v.transpose(1, 2), 0,
            causal=True, scale=scale, want_lse=True),
        "flash_bwd_dq": lambda: tfa._launch_bwd(
            "flash_bwd_dq", q, k, v, dout, lse, delta, causal=True,
            scale=scale),
        "flash_bwd_dkv": lambda: tfa._launch_bwd(
            "flash_bwd_dkv", q, k, v, dout, lse, delta, causal=True,
            scale=scale)}
    lib_in = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    lib_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *[t.detach() for t in lib_in], is_causal=True, enable_gqa=True), **kw)
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, lib_in, dout.transpose(1, 2), retain_graph=True), **kw)
    del lib_out, lib_in

    # the plain versions at the largest shape whose S² scores fit
    Bp, Sp, Hqp, Hkvp = TRI_CASES[-1][:4]
    qp, doutp = rnd(Bp, Sp, Hqp, D), rnd(Bp, Sp, Hqp, D)
    kp, vp = rnd(Bp, Sp, Hkvp, D), rnd(Bp, Sp, Hkvp, D)
    outp, lsep = tfa.attention_plain(qp, kp.transpose(1, 2),
                                     vp.transpose(1, 2), 0)
    plain_fwd_ms = time_ms(lambda: tfa.attention_plain(
        qp, kp.transpose(1, 2), vp.transpose(1, 2), 0), **kw)
    plain_bwd_ms = time_ms(lambda: tfa.attention_bwd_plain(
        qp, kp, vp, outp, lsep, doutp), **kw)
    del qp, doutp, kp, vp, outp, lsep

    rows = []
    for name, replaces, rect, _ in TRI_KERNELS:
        ws, P = tri_ws_bytes(_cuda, name, dev)
        ops, nbytes = work_tri(name, B, S, Hq, Hkv, D, ws)
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
        fwd = name == "flash_fwd_tri"
        rows.append({
            "name": name, "route": "cuda",
            "source": "gpu_provisioner_tpu_torch/ops/csrc/flash_tri.cu",
            "replaces": "gpu_provisioner_tpu/ops/flash_attention.py"
                        + replaces,
            "launches": 0, "max_abs_err": worst[name][0],
            "max_rel_err": worst[name][1], "tolerance": TOL["bfloat16"],
            "ms": time_ms(tri_fns[name], **kw),
            "rect_ms": time_ms(rect_fns[rect], **kw),
            "plain_ms": plain_fwd_ms if fwd else plain_bwd_ms,
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": lib_fwd_ms if fwd else lib_bwd_ms,
            "ctas": P,
            "shape": f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal",
            "plain_note": f"plain_ms at B={Bp} S={Sp} Hq={Hqp} Hkv={Hkvp} "
                          "(the S² scores at S=32768 do not fit)"
                          + ("" if fwd else "; dQ+dK+dV, as library_ms")})
        print(f"{name}: {json.dumps(rows[-1])}")
    del flush, q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()

    want_lc, want_fo = twin_launches(bench)
    by_twin = {}
    for name, run, want in (("long_context", bench.bench_long_context,
                             want_lc),
                            ("flash_op", bench.bench_flash_op, want_fo)):
        torch.cuda.synchronize()
        tfa.reset_launches()
        t0 = time.perf_counter()
        res = run(False)
        torch.cuda.synchronize()
        by_twin[name] = dict(tfa.LAUNCHES)
        got = {n: c for n, c in tfa.LAUNCHES.items() if c}
        print(f"bench_{name} (full size, {time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(res)}; launches {got}")
        check(got == want, f"bench_{name} launches {got}, expected {want}")
        if name == "long_context":
            check(all(x == x and abs(x) < float("inf")
                      for x in res["losses"] + res["swa_losses"]),
                  "a long-context training loss is not finite")
        else:
            check(all(v > 0 and v < float("inf") for v in res.values()),
                  f"bench_flash_op: {res}")
        torch.cuda.empty_cache()
    return rows, launches, by_twin


def phase_exact(torch, tl, td, te, dev):
    """Llama-7B width, 2 layers, f32: engine streams == solo generate()."""
    cfg = dataclasses.replace(tl.PRESETS["llama-7b"], n_layers=2,
                              dtype="float32", attn_impl="flash")
    params = tl.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    g = torch.Generator().manual_seed(SEED + 1)
    prefix = torch.randint(1, cfg.vocab_size, (90,), generator=g).tolist()
    reqs = [(torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist(),
             pre) for n, pre in ((100, None), (230, None), (60, prefix),
                                 (150, None), (40, prefix))]
    eng = te.ServeEngine(params, cfg, slots=3, max_len=1024,
                         prefill_buckets=(128, 256))
    ids = [eng.submit(p, 8, prefix=pre) for p, pre in reqs]
    out = eng.run()
    for rid, (p, pre) in zip(ids, reqs):
        full = (pre or []) + p
        want = td.generate(params, torch.tensor([full]), cfg,
                           max_new_tokens=8, max_len=1024)[0].tolist()
        check(out[rid] == want, f"engine stream {rid} != generate: "
              f"{out[rid]} vs {want}")
    print(f"exact-token phase (llama-7b width, 2 layers, f32): "
          f"{len(ids)} engine streams == generate; {eng.stats()}")
    del params, eng


def phase_main(torch, tl, td, te, tfa, dev):
    """Full Llama-7B in bf16 through ServeEngine and generate()."""
    cfg = dataclasses.replace(tl.PRESETS["llama-7b"], attn_impl="flash")
    t0 = time.perf_counter()
    params = tl.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    print(f"llama-7b params on the card in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    g = torch.Generator().manual_seed(SEED + 2)
    V, new = cfg.vocab_size, 32

    def toks(n):
        return torch.randint(1, V, (n,), generator=g).tolist()

    prefix = toks(100)
    reqs = [(toks(n), pre) for n, pre in ((180, None), (500, None),
                                          (120, prefix), (350, None),
                                          (100, None), (230, prefix))]

    def serve():
        eng = te.ServeEngine(params, cfg, slots=4, max_len=2048,
                             prefill_buckets=(128, 256, 512),
                             return_logprobs=True)
        t0 = time.perf_counter()
        ids = [eng.submit(p, new, prefix=pre) for p, pre in reqs]
        out = eng.run()
        torch.cuda.synchronize()
        return eng, ids, out, time.perf_counter() - t0

    # one warm-up pass before the counts are reset, so that no timed pass
    # holds the first bf16 cuBLAS calls at these widths
    serve()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()
    rates = []
    for _ in range(3):
        eng, ids, out, wall = serve()
        for rid in ids:
            check(len(out[rid]) == new,
                  f"request {rid}: {len(out[rid])} tokens")
            check(all(0 <= t < V for t in out[rid]), f"request {rid} vocab")
            lps = eng.finished_logprobs[rid]
            check(all(lp <= 0 and lp == lp for lp in lps),
                  f"request {rid} logprobs {lps}")
        st = eng.stats()
        check(st["prefix_cache_hits"] == 1 and st["prefix_cache_misses"] == 1,
              f"prefix cache {st}")
        rates.append(st["tokens_emitted"] / wall)
    print(f"ServeEngine llama-7b bf16, smoke-run rate (3 passes after a "
          f"warm-up, each {len(ids)} requests and {st['tokens_emitted']} "
          f"tokens, admissions included): {rates} tokens/s, median "
          f"{statistics.median(rates)}; stats {st}")
    prompt = torch.tensor([toks(512), toks(512)])
    ragged = prompt.clone()
    ragged[1, :200] = 0
    for name, p, kw in (("fresh", prompt, {}),
                        ("pad_id", ragged, {"pad_id": 0})):
        t0 = time.perf_counter()
        out = td.generate(params, p, cfg, max_new_tokens=new, max_len=1024,
                          **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(tuple(out.shape) == (2, new) and bool(((out >= 0) & (out < V))
                                                    .all()),
              f"generate {name}: {tuple(out.shape)}")
        print(f"generate llama-7b bf16 B=2 S0=512 {name}: {2 * new} tokens "
              f"in {wall:.2f} s = {2 * new / wall:.1f} tokens/s")
    launches = dict(tfa.LAUNCHES)
    print(f"main-path launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, n in launches.items():
        # no backward and no triangle here
        serving = not name.startswith("flash_bwd") and "_tri" not in name
        check((n > 0) == serving,
              f"kernel {name}: {n} launches on the serving path")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "gpu_provisioner_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gpu_provisioner_tpu_torch import bench
    from gpu_provisioner_tpu_torch.models import decode as td
    from gpu_provisioner_tpu_torch.models import engine as te
    from gpu_provisioner_tpu_torch.models import llama as tl
    from gpu_provisioner_tpu_torch.models import train as tt
    from gpu_provisioner_tpu_torch.ops import _cuda
    from gpu_provisioner_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}"
          f"; tf32 matmul {torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    rows = phase_kernels(torch, tfa, td, dev)
    print(f"kernel phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_exact(torch, tl, td, te, dev)
    print(f"exact phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve = phase_main(torch, tl, td, te, tfa, dev)
    print(f"main phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()      # the serving params are gone
    t0 = time.perf_counter()
    fwd_err, bwd_rows = phase_bwd_kernels(torch, tfa, dev)
    fwd = next(r for r in rows if r["name"] == "flash_fwd")
    fwd["max_abs_err"] = max(fwd["max_abs_err"], fwd_err)
    rows += bwd_rows
    print(f"backward kernel phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_exact(torch, tl, tt, dev)
    print(f"exact training phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = phase_train(torch, tl, tt, tfa, dev)
    print(f"training phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    worst = phase_tri_kernels(torch, tfa, dev)
    twin_worst = phase_twin_shapes(torch, tfa, dev)
    tri_rows, long, by_twin = phase_long(torch, tfa, _cuda, bench, dev,
                                         worst)
    rows += tri_rows
    print(f"long-context phase {time.perf_counter() - t0:.1f} s")
    for r in rows:      # the bench twins' shapes count in the worst errors
        if r["name"] in twin_worst:
            e, rel = twin_worst[r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], e)
            if "max_rel_err" in r:
                r["max_rel_err"] = max(r["max_rel_err"], rel)
    # each kernel's launches on its own path: serving for the forward
    # kernels, training for the backward ones, the long path for the
    # triangle (every count kept, the bench twins' too)
    for r in rows:
        name = r["name"]
        r["launches_by_path"] = {"serve": serve[name], "train": train[name],
                                 "long": long[name],
                                 **{k: v[name] for k, v in by_twin.items()}}
        r["launches"] = (long if name.endswith("_tri") else train
                         if name.startswith("flash_bwd") else serve)[name]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
