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
4. the main path: full Llama-7B (32 layers) in bf16 with the flash kernels:
   after one warm-up pass, three ServeEngine passes of 6 requests each (one
   shared prefix), then generate() with B=2, S0=512, fresh and left-padded,
   with every kernel's launch count read across that run;
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


def time_ms(fn, flush, reps=20):
    """Median of per-launch CUDA-event times, the 50 MB L2 flushed before
    each launch (the serving loop reads each layer's cache cold)."""
    import torch
    for _ in range(3):
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


def work(B, S, Hq, Hkv, D, Sk, start, pads, window, sinks, causal,
         act_bytes, kv_bytes, int8, lse):
    """(operations, bytes) the call needs on these inputs: 4·D operations
    per attended (query, key) pair and head; each input read once (the
    cache only where some query of the row attends), each output written
    once."""
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
        check(n > 0, f"kernel {name} was not launched on the main path")
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
    from gpu_provisioner_tpu_torch.models import decode as td
    from gpu_provisioner_tpu_torch.models import engine as te
    from gpu_provisioner_tpu_torch.models import llama as tl
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
    launches = phase_main(torch, tl, td, te, tfa, dev)
    print(f"main phase {time.perf_counter() - t0:.1f} s")
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
