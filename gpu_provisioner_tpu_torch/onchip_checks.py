"""On-card value-level validation of every attention kernel path.

Twin of ``hack/tpu_onchip_checks.py``. The CPU tests hold the kernels'
plain versions against the JAX package; a CUDA kernel runs only on the
card, so this module runs the same comparisons there, through the same
wrappers a model calls: the rectangular and flattened-triangle forwards,
their backwards (windowed too), the cached prefill (bf16 and int8 caches,
scalar and tensor starts, pads, window, sinks), the decode and verify
blocks (per-row starts), greedy ``generate`` flash against dense and
batched speculation against plain greedy, all at head dim 64 in f32, then
a bf16 pass at head dim 128 at training and serving shapes: every kernel
finite, the S=16384 streaming and triangle forwards, and the triangle
against the rectangle, forward and backward.

Five groups, each a function of ``device`` (``run_forward_checks``,
``run_backward_checks``, ``run_cached_checks``, ``run_generate_check``,
``run_lowering_checks``) with the JAX script's check names and shapes.
Each check prints one JSON line ``{check, max_err, tol, ok}`` (``finite``
or ``tokens_equal`` in place of the error where the JAX script prints
them); the last line is ``{checks, passed, failed, platform}``; the exit
code is 0 only if every check passes. On ``device="cpu"`` the wrappers
run their plain versions (the tests call every group so, the lowering
pass at a small S: at S=16384 it is card-only).

Run on a machine with the card, from the repository root::

    python3 -m gpu_provisioner_tpu_torch.onchip_checks

Deliberate differences from the JAX script:

- one port kernel serves the TPU's resident and streaming grids, so
  ``RESIDENT_KV_BUDGET = 0`` only moves ``tri_dispatch`` (the triangle's
  forward); the streaming checks run the same kernels as the resident ones;
- no ``block_q``/``block_k``: the CUDA kernels pick their own tiles
  (ROADMAP Queue C 5);
- inputs come from ``torch.Generator`` seeds (``jax.random`` cannot be
  reproduced); the int8 lowering cache clamps ``31 x`` to [-127, 127]
  before the cast;
- tolerances are the card's own (PERF.md §2), and the printed ``tol`` is
  the one applied: the f32 forwards within 1e-4 of the dense reference,
  the f32 gradients within 1e-4 of the largest reference gradient (the
  printed ``max_err`` is then that relative error), both tighter than the
  JAX script's MXU-bounded 2e-2 / 3e-2; the bf16 triangle within 2e-2 of
  the rectangle, its gradients relative to the largest rectangular one, as
  ``chip_smoke.py``'s long-context phase holds them (bf16 gradients near
  8 differ by a bf16 step, 0.06, between two summation orders).
"""

from __future__ import annotations

import dataclasses
import json
import sys

import torch

from .device import resolve_device
from .models.decode import _cached_attention, _quantize_kv, generate
from .models.llama import LlamaConfig, init_params
from .models.speculative import speculative_generate
from .ops import flash_attention as fa
from .parallel.ring import dense_attention

TOL_F32 = 1e-4
TOL_GRAD = 1e-4       # relative to the largest reference gradient
TOL_TRI = 2e-2        # bf16 triangle against rectangle


def _line(name: str, ok: bool, **fields) -> dict:
    line = {"check": name, **fields, "ok": bool(ok)}
    print(json.dumps(line), flush=True)
    return line


def _close(name, got, ref, tol, relative=False) -> dict:
    """max |got - ref| (over max |ref| when ``relative``) within tol."""
    err = (got.float() - ref.float()).abs().max().item()
    if relative:
        err /= ref.float().abs().max().item()
    return _line(name, err <= tol, max_err=round(err, 9), tol=tol)


def _finite(name, *tensors) -> dict:
    ok = all(bool(torch.isfinite(t.float()).all()) for t in tensors)
    return _line(name, ok, finite=ok)


def _randn(g, shape, dev, dtype=torch.float32):
    return torch.randn(*shape, generator=g).to(device=dev, dtype=dtype)


def _qkv(dev, B=2, S=512, Hq=4, Hkv=2, D=64, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return tuple(_randn(g, (B, S, h, D), dev, dtype) for h in (Hq, Hkv, Hkv))


def _grads(fn, q, k, v):
    """d/d(q, k, v) of sum(fn(q, k, v)^2)."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    loss = (fn(*leaves).float() ** 2).sum()
    return torch.autograd.grad(loss, leaves)


def _streaming(fn):
    """fn() with the residency budget zeroed (the JAX script's streaming
    regime; here it moves only tri_dispatch)."""
    saved = fa.RESIDENT_KV_BUDGET
    fa.RESIDENT_KV_BUDGET = 0
    try:
        return fn()
    finally:
        fa.RESIDENT_KV_BUDGET = saved


def run_forward_checks(device) -> list:
    dev = torch.device(device)
    out = []
    for causal in (True, False):
        for Hkv in (4, 2, 1):
            q, k, v = _qkv(dev, Hkv=Hkv)
            out.append(_close(f"resident_fwd_causal={causal}_hkv={Hkv}",
                              fa.flash_attention(q, k, v, causal=causal),
                              dense_attention(q, k, v, causal=causal),
                              TOL_F32))
    q, k, v = _qkv(dev, S=512)
    out.append(_close("resident_fwd_window",
                      fa.flash_attention(q, k, v, window=100),
                      dense_attention(q, k, v, window=100), TOL_F32))

    def streaming():
        for causal in (True, False):
            q, k, v = _qkv(dev, S=1024)
            out.append(_close(f"streaming_fwd_causal={causal}",
                              fa.flash_attention(q, k, v, causal=causal),
                              dense_attention(q, k, v, causal=causal),
                              TOL_F32))
        q, k, v = _qkv(dev, S=1024)
        out.append(_close("triangular_fwd",
                          fa.flash_attention(q, k, v, triangular=True),
                          dense_attention(q, k, v), TOL_F32))
        out.append(_close("streaming_fwd_window",
                          fa.flash_attention(q, k, v, window=200),
                          dense_attention(q, k, v, window=200), TOL_F32))
    _streaming(streaming)
    return out


def run_backward_checks(device) -> list:
    dev = torch.device(device)
    out = []

    def pair(prefix, flash, dense, q, k, v):
        for nm, a, b in zip(("dq", "dk", "dv"), _grads(flash, q, k, v),
                            _grads(dense, q, k, v)):
            out.append(_close(prefix.format(nm=nm), a, b, TOL_GRAD,
                              relative=True))

    for causal in (True, False):
        for Hkv in (2, 1):
            q, k, v = _qkv(dev, B=1, S=256, Hq=2, Hkv=Hkv, D=64)
            pair(f"resident_bwd_{{nm}}_causal={causal}_hkv={Hkv}",
                 lambda *a, c=causal: fa.flash_attention(*a, causal=c),
                 lambda *a, c=causal: dense_attention(*a, causal=c),
                 q, k, v)
    q, k, v = _qkv(dev, B=1, S=512, Hq=2, Hkv=1, D=64)
    pair("windowed_bwd_{nm}",
         lambda *a: fa.flash_attention(*a, window=100),
         lambda *a: dense_attention(*a, window=100), q, k, v)

    def streaming():
        q, k, v = _qkv(dev, B=1, S=512, Hq=2, Hkv=1, D=64)
        pair("streaming_bwd_{nm}", fa.flash_attention, dense_attention,
             q, k, v)
        pair("triangular_bwd_{nm}",
             lambda *a: fa.flash_attention(*a, triangular=True),
             dense_attention, q, k, v)
    _streaming(streaming)
    return out


@torch.no_grad()
def run_cached_checks(device) -> list:
    dev = torch.device(device)
    B, S, ML, Hq, Hkv, D = 2, 128, 512, 4, 2, 64
    scale = D ** -0.5
    g = torch.Generator().manual_seed(3)
    q = _randn(g, (B, S, Hq, D), dev)
    kc = _randn(g, (B, Hkv, ML, D), dev)
    vc = _randn(g, (B, Hkv, ML, D), dev)
    out = []

    def both(name, q, kc, vc, start, kernel=fa.flash_attention_cached, **kw):
        out.append(_close(name, kernel(q, kc, vc, start, scale=scale, **kw),
                          _cached_attention(q, kc, vc, start, scale, **kw),
                          TOL_F32))

    for start in (0, 37, 384):
        both(f"cached_fwd_start={start}", q, kc, vc, start)
    # a start on the device, as the serving loop passes it
    both("cached_fwd_traced_start", q, kc, vc,
         torch.tensor(65, dtype=torch.int32, device=dev))

    # int8 mode: dequantisation inside the kernel against the dense sweep
    k_tm = _randn(g, (B, ML, Hkv, D), dev)
    v_tm = _randn(g, (B, ML, Hkv, D), dev)
    (kq, kscl), (vq, vscl) = _quantize_kv(k_tm), _quantize_kv(v_tm)

    def hm(x):
        return x.transpose(1, 2)

    i8 = dict(k_scale=hm(kscl), v_scale=hm(vscl))
    both("cached_fwd_int8", q, hm(kq), hm(vq), 130, **i8)

    # padded prefill: every query row is real at start 256
    pad = torch.tensor([0, 37], dtype=torch.int32, device=dev)
    both("cached_fwd_padded", q, kc, vc, 256, pad_lens=pad)
    both("cached_fwd_window", q, kc, vc, 320, window=100)
    both("cached_fwd_window_sinks", q, kc, vc, 320, window=100, sinks=4)
    both("cached_fwd_window_sinks_padded", q, kc, vc, 320, window=100,
         sinks=4, pad_lens=torch.tensor([0, 17], dtype=torch.int32,
                                        device=dev))

    dec = fa.flash_attention_decode
    q1 = q[:, :1].contiguous()
    for start in (0, 130, 384):
        both(f"decode_fwd_start={start}", q1, kc, vc, start, dec)
    both("decode_fwd_padded", q1, kc, vc, 384, dec, pad_lens=pad)
    both("decode_fwd_int8", q1, hm(kq), hm(vq), 384, dec, **i8)
    both("decode_fwd_window", q1, kc, vc, 384, dec, window=100)
    both("decode_fwd_window_sinks", q1, kc, vc, 384, dec, window=100,
         sinks=4)
    both("decode_fwd_window_sinks_padded", q1, kc, vc, 384, dec, window=100,
         sinks=4, pad_lens=pad)

    # per-row starts (batched speculation): reference = each row alone
    starts = torch.tensor([37, 384], dtype=torch.int32, device=dev)

    def per_row(qb):
        return torch.cat([_cached_attention(qb[b:b + 1], kc[b:b + 1],
                                            vc[b:b + 1], int(starts[b]),
                                            scale) for b in range(B)])

    out.append(_close("decode_fwd_per_row_starts",
                      dec(q1, kc, vc, starts, scale=scale), per_row(q1),
                      TOL_F32))
    # short query blocks S > 1 (the speculative verify block)
    q4 = q[:, :4].contiguous()
    both("verify_fwd_s4", q4, kc, vc, 300, dec)
    out.append(_close("verify_fwd_s4_per_row_starts",
                      dec(q4, kc, vc, starts, scale=scale), per_row(q4),
                      TOL_F32))
    both("verify_fwd_s4_window_sinks_padded", q4, kc, vc, 300, dec,
         window=100, sinks=4, pad_lens=pad)
    return out


@torch.no_grad()
def run_generate_check(device) -> list:
    """Greedy generation: the flash config emits the dense config's tokens;
    batched speculation (per-row cache lengths, the per-row-start decode
    kernel, verify blocks) emits plain greedy's, row for row."""
    dev = torch.device(device)
    cfg_d = LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                        n_kv_heads=2, hidden_dim=512, max_seq_len=1024,
                        dtype="float32", attn_impl="dense")
    cfg_f = dataclasses.replace(cfg_d, attn_impl="flash")
    params = init_params(cfg_d, torch.Generator(dev).manual_seed(7), dev)
    prompt = torch.randint(0, 256, (2, 128),
                           generator=torch.Generator().manual_seed(8)).to(dev)
    toks_d = generate(params, prompt, cfg_d, max_new_tokens=16, device=dev)
    toks_f = generate(params, prompt, cfg_f, max_new_tokens=16, device=dev)
    same = bool(torch.equal(toks_d, toks_f))
    out = [_line("generate_greedy_flash_vs_dense", same, tokens_equal=same)]
    toks_s, _ = speculative_generate(params, params, prompt, cfg_f, cfg_f,
                                     max_new_tokens=16, spec_k=3,
                                     max_len=1024, device=dev)
    same = bool(torch.equal(toks_s, toks_f))
    out.append(_line("speculative_batched_greedy_vs_plain", same,
                     tokens_equal=same))
    return out


def run_lowering_checks(device, S=1024, repeat=16) -> list:
    """Every kernel at serving and training shapes in bf16 at head dim 128,
    the streaming and triangle forwards at S·repeat (16384: past the
    residency budget) among them, finite; then the triangle against the
    rectangle, forward at S·repeat and backward at S. At these sizes
    card-only (the plain versions' S=16384 scores take 4 GiB a head); the
    tests run it on the CPU at a small S and repeat."""
    dev = torch.device(device)
    bf = torch.bfloat16
    q, k, v = _qkv(dev, B=1, S=S, Hq=4, Hkv=4, D=128, dtype=bf)
    out = [_finite("lower_resident_fwd_bf16", fa.flash_attention(q, k, v))]
    out.append(_finite("lower_resident_bwd_bf16",
                       *_grads(fa.flash_attention, q, k, v)))
    g = torch.Generator().manual_seed(1)
    kc = _randn(g, (1, 2, 2048, 128), dev, bf)
    vc = _randn(g, (1, 2, 2048, 128), dev, bf)
    with torch.no_grad():
        out.append(_finite("lower_cached_bf16", fa.flash_attention_cached(
            q[:, :128], kc, vc, 17)))
        kc8, vc8 = ((x.float() * 31).clamp(-127, 127).to(torch.int8)
                    for x in (kc, vc))
        scl = torch.full((1, 2, 2048, 1), 1 / 31.0, device=dev)
        out.append(_finite("lower_cached_int8", fa.flash_attention_cached(
            q[:, :128], kc8, vc8, 17, k_scale=scl, v_scale=scl)))
        # streaming S=16384 (past the residency budget): rectangle and
        # triangle, then the triangle's values against the rectangle's
        qs, ks, vs = (x.repeat(1, repeat, 1, 1) for x in (q, k, v))
        stream = fa.flash_attention(qs, ks, vs)
        tri = fa.flash_attention(qs, ks, vs, triangular=True)
        out.append(_finite("lower_streaming_16k_bf16", stream))
        out.append(_finite("lower_streaming_tri_16k_bf16", tri))
        out.append(_close("tri_vs_rect_fwd_16k", tri, stream, TOL_TRI))
        del qs, ks, vs, stream, tri
    g_rect = _grads(fa.flash_attention, q, k, v)
    g_tri = _grads(lambda *a: fa.flash_attention(*a, triangular=True),
                   q, k, v)
    for nm, a, b in zip(("dq", "dk", "dv"), g_tri, g_rect):
        out.append(_close(f"tri_vs_rect_bwd_{nm}", a, b, TOL_TRI,
                          relative=True))
    return out


GROUPS = (run_forward_checks, run_backward_checks, run_cached_checks,
          run_generate_check, run_lowering_checks)


def run(device) -> list:
    """Every group on ``device`` (f32 products in full f32: no TF32),
    after a first line naming it; returns the checks' lines."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"platform": dev.type, "device": name}), flush=True)
    return [line for group in GROUPS for line in group(dev)]


def main() -> int:
    dev = resolve_device(None)
    lines = run(dev)
    passed = sum(line["ok"] for line in lines)
    print(json.dumps({"checks": len(lines), "passed": passed,
                      "failed": len(lines) - passed,
                      "platform": dev.type}), flush=True)
    return 0 if passed == len(lines) else 1


if __name__ == "__main__":
    sys.exit(main())
