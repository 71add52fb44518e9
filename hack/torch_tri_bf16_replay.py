#!/usr/bin/env python3
"""The bf16 tensor-core tri kernels' rounding points, replayed on the CPU.

    python3 hack/torch_tri_bf16_replay.py

``flash_fwd_tri`` and ``flash_bwd_dq_tri`` (csrc/flash_tri.cu) take their
products on the tensor cores in bf16, where the plain versions and the JAX
kernels keep P and dS in f32. ``replay_fwd`` and ``replay_dq`` redo the
kernels' arithmetic in plain torch, key tile by key tile (64 keys): f32
scores, the online softmax with the denominator summed from the f32 P, P
rounded to bf16 before P·V (``split``: as the kernel does, two bf16 terms
hi + lo); dS = P∘(dP − Δ)·scale rounded to bf16 before dS·K. Both return
f32, before the kernels' last rounding of out and dQ to bf16.
tests/test_torch_flash_tri.py holds them against the JAX package's
kernels. This script prints, at the card tests' bf16 shapes (random normal
bf16 values from a numpy seed, causal, head dim 128), how far each replay
lies from the plain versions: in f32 (what the rounding of P or dS alone
moves: out absolute, dQ relative to its largest value), and rounded to
bf16 against the plain versions' bf16 results, as the card tests compare
(where one bf16 step of the result, 0.0156 at |out| in [2, 4), can
appear). One JSON line per shape, a few seconds each. Imports nothing of
JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gpu_provisioner_tpu_torch.ops import flash_attention as tfa  # noqa: E402

TILE = 64
# (B, S, Hq, Hkv) of the card tests' bf16 tri cases
SHAPES = ((1, 384, 2, 1), (2, 2048, 16, 8), (1, 1000, 4, 1), (2, 200, 8, 8))


def _scores(q, k, scale):
    """f32 causal scores [B, Hq, S, S] (NEG_INF where masked) and the
    kv-head index of each q-head's K/V, head-major f32."""
    B, S, Hq, _ = q.shape
    group = Hq // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(group, 2).transpose(1, 2)
    pos = torch.arange(S)
    s = torch.where(pos[None, :] <= pos[:, None], qf @ kf.transpose(-1, -2)
                    * scale, tfa.NEG_INF)
    return s, kf


def _bf16(x):
    return x.to(torch.bfloat16).float()


def replay_fwd(q, k, v, scale, *, split=True):
    """(out [B,S,Hq,D], lse [B,Hq,S]) in f32 as the tensor-core forward
    computes them, before it rounds out to bf16."""
    s, _ = _scores(q, k, scale)
    group = q.shape[2] // k.shape[2]
    vf = v.float().repeat_interleave(group, 2).transpose(1, 2)
    m = torch.full(s.shape[:-1] + (1,), tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (q.shape[-1],))
    for j in range(0, s.shape[-1], TILE):
        sj = s[..., j:j + TILE]
        m_new = torch.maximum(m, sj.amax(-1, keepdim=True))
        p = torch.where(m_new > tfa.NEG_INF / 2, torch.exp(sj - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pb = _bf16(p)
        if split:
            pb = pb + _bf16(p - pb)
        acc = acc * corr + pb @ vf[..., j:j + TILE, :]
        m = m_new
    safe = torch.where(l > 0, l, 1.0)
    out = (acc / safe).transpose(1, 2)
    lse = torch.where(l > 0, m + torch.log(safe), tfa.NEG_INF)[..., 0]
    return out, lse


def replay_dq(q, k, v, dout, out, lse, scale):
    """dQ [B,S,Hq,D] in f32 as the tensor-core dQ kernel computes it from
    the forward's out and lse (no lse cotangent), before it rounds to
    bf16."""
    s, kf = _scores(q, k, scale)
    group = q.shape[2] // k.shape[2]
    vf = v.float().repeat_interleave(group, 2).transpose(1, 2)
    gf = dout.float().transpose(1, 2)
    lse_ = lse[..., None]
    p = torch.where((s > tfa.NEG_INF / 2) & (lse_ > tfa.NEG_INF / 2),
                    torch.exp(s - lse_), 0.0)
    delta = tfa._bwd_delta(out, dout, None)[..., None]
    ds = _bf16(p * (gf @ vf.transpose(-1, -2) - delta) * scale)
    return (ds @ kf).transpose(1, 2)


def inputs(seed, B, S, Hq, Hkv, D=128):
    """q, k, v, dout: random normal values from a numpy seed, in bf16."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16)
            for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                          (B, S, Hq, D))]


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def main() -> int:
    bf = torch.bfloat16
    for i, (B, S, Hq, Hkv) in enumerate(SHAPES):
        q, k, v, dout = inputs(i, B, S, Hq, Hkv)
        scale = q.shape[-1] ** -0.5
        f32 = [t.float() for t in (q, k, v, dout)]
        ref, ref_lse = tfa.attention_plain(f32[0], f32[1].transpose(1, 2),
                                           f32[2].transpose(1, 2), 0)
        row = {"shape": [B, S, Hq, Hkv]}
        for name, split in (("one_bf16_p", False), ("split_p", True)):
            out, lse = replay_fwd(q, k, v, scale, split=split)
            err = (out.to(bf).float() - ref.to(bf).float()).abs()
            row[name] = {
                "out_f32_max_abs": (out - ref).abs().max().item(),
                "out_bf16_max_abs": err.max().item(),
                "at_abs_out": ref.flatten()[err.argmax()].abs().item(),
                "lse_max_abs": (lse - ref_lse).abs().max().item()}
        want = tfa.attention_bwd_plain(*f32[:3], out, lse, f32[3])[0]
        dq = replay_dq(q, k, v, dout, out, lse, scale)
        row["dq_f32_rel"] = _rel(dq, want)
        row["dq_bf16_rel"] = _rel(dq.to(bf), want.to(bf))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
