#!/usr/bin/env python3
"""The bf16 tensor-core kernels' rounding points, replayed on the CPU.

    python3 hack/torch_tri_bf16_replay.py

The bf16 instances of ``flash_fwd`` (self-attention, the bf16 and the int8
cache), ``flash_bwd_dq`` and ``flash_bwd_dkv`` (csrc/flash_fwd.cu,
csrc/flash_bwd.cu) and of ``flash_fwd_tri``, ``flash_bwd_dq_tri`` and
``flash_bwd_dkv_tri`` (csrc/flash_tri.cu) take their products on the
tensor cores in bf16 through csrc/flash_tc.cuh's tile steps, where the plain
versions and the JAX kernels keep P and dS in f32. ``replay_fwd``,
``replay_dq`` and ``replay_dkv`` redo the kernels' arithmetic in plain
torch: f32 scores, the online softmax over 64-key tiles with the
denominator summed from the f32 P, P rounded to bf16 before P·V (``split``:
as the kernel does, two bf16 terms hi + lo; an int8 cache's values widened
exactly to bf16, its k scales on the score columns and its v scales on P's
columns before the split); dS = P∘(dP − Δ)·scale rounded
to bf16 before dS·K; for dK/dV, 64-key × 64-query tiles of f32 Sᵀ and dPᵀ,
Pᵀ and dSᵀ each rounded to bf16 once before Pᵀ·dO and dSᵀ·Q, the group's
q-heads folded in f32. The forward and dQ take any mask ``keep_mask``
builds (causal or not, window, start, per-row starts, pads, sinks: the
cache's), dK/dV the causal and window masks. Each returns f32, before the
kernels' last rounding to bf16. tests/test_torch_flash_tri.py and
tests/test_torch_flash_tc.py hold them against the JAX package's kernels.
This script prints, at the card tests' bf16 shapes (random normal bf16
values from a numpy seed, causal, head dim 128; the last also with window
1024), how far each replay lies from the plain versions: in f32 (what the
rounding of P or dS alone moves: out absolute, the gradients relative to
their largest values), and rounded to bf16 against the plain versions'
bf16 results, as the card tests compare (where one bf16 step of the
result, 0.0156 at |out| in [2, 4), can appear). One JSON line per shape, a
few seconds each. Imports nothing of JAX.
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
WINDOW = 1024       # the windowed dK/dV case, at the last shape of S 2048


def keep_mask(B, S, Sk, *, start=0, causal=True, pad_lens=None,
              window=None, sinks=0):
    """keep [B, S, Sk]: key kp attendable from query s at position start_b
    + s (``start`` an int or B values), as attention_plain and the kernels
    mask: (!causal or kp <= qp), kp >= pad_b, and with a window (kp > qp -
    window or kp < pad_b + sinks)."""
    st = torch.as_tensor(start, dtype=torch.long).reshape(-1).expand(B)
    qp = (st[:, None] + torch.arange(S))[:, :, None]
    kp = torch.arange(Sk)[None, None, :]
    pad = (torch.zeros(B, dtype=torch.long) if pad_lens is None
           else torch.as_tensor(pad_lens, dtype=torch.long))
    keep = (kp >= pad[:, None, None]).expand(B, S, Sk)
    if causal:
        keep = keep & (kp <= qp)
    if window is not None:
        wkeep = kp > qp - window
        if sinks:
            wkeep = wkeep | (kp < (pad + sinks)[:, None, None])
        keep = keep & wkeep
    return keep


def _per_q_head(x, group):
    """[B, Sk, Hkv, ...] token-major → [B, Hq, Sk, ...], each kv head's
    slice repeated for the q-heads of its group."""
    return x.float().repeat_interleave(group, 2).transpose(1, 2)


def _scores(q, k, scale, keep=None, k_scale=None):
    """f32 scores [B, Hq, S, Sk] (NEG_INF where ``keep`` [B, S, Sk] is
    False; default causal self-attention) and each q-head's K, head-major
    f32; k token-major [B, Sk, Hkv, D]. With ``k_scale`` [B, Sk, Hkv, 1]
    (an int8 cache: k holds its int8 values), score column j is Q K_j
    times k_scale[j], as the int8 tensor-core forward scales it."""
    B, S, Hq, _ = q.shape
    Sk = k.shape[1]
    group = Hq // k.shape[2]
    if keep is None:
        keep = keep_mask(B, S, Sk)
    qf = q.float().transpose(1, 2)
    kf = _per_q_head(k, group)
    s = qf @ kf.transpose(-1, -2)
    if k_scale is not None:
        s = s * _per_q_head(k_scale, group)[..., 0][:, :, None, :]
    s = torch.where(keep[:, None], s * scale, tfa.NEG_INF)
    return s, kf


def _bf16(x):
    return x.to(torch.bfloat16).float()


def replay_fwd(q, k, v, scale, *, split=True, keep=None, k_scale=None,
               v_scale=None):
    """(out [B,S,Hq,D], lse [B,Hq,S]) in f32 as the tensor-core forward
    computes them, before it rounds out to bf16; k/v token-major [B, Sk,
    Hkv, D], ``keep`` [B, S, Sk] (default causal self-attention). A tile
    the kernels skip as dead changes nothing here (P = 0, no rescale).
    An int8 cache (k/v its int8 values, exact in bf16; ``k_scale`` /
    ``v_scale`` [B, Sk, Hkv, 1]): k_scale on the score columns, the
    denominator from the unscaled P, and P's column j times v_scale[j]
    before the split and P·V, as the int8 instance computes them."""
    s, _ = _scores(q, k, scale, keep, k_scale)
    group = q.shape[2] // k.shape[2]
    vf = _per_q_head(v, group)
    vs = None if v_scale is None else _per_q_head(v_scale, group)[..., 0]
    m = torch.full(s.shape[:-1] + (1,), tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (q.shape[-1],))
    for j in range(0, s.shape[-1], TILE):
        sj = s[..., j:j + TILE]
        m_new = torch.maximum(m, sj.amax(-1, keepdim=True))
        p = torch.where(m_new > tfa.NEG_INF / 2, torch.exp(sj - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        if vs is not None:
            p = p * vs[:, :, None, j:j + TILE]
        pb = _bf16(p)
        if split:
            pb = pb + _bf16(p - pb)
        acc = acc * corr + pb @ vf[..., j:j + TILE, :]
        m = m_new
    safe = torch.where(l > 0, l, 1.0)
    out = (acc / safe).transpose(1, 2)
    lse = torch.where(l > 0, m + torch.log(safe), tfa.NEG_INF)[..., 0]
    return out, lse


def replay_dq(q, k, v, dout, out, lse, scale, *, keep=None):
    """dQ [B,S,Hq,D] in f32 as the tensor-core dQ kernel computes it from
    the forward's out and lse (no lse cotangent), before it rounds to
    bf16; ``keep`` as replay_fwd's."""
    s, kf = _scores(q, k, scale, keep)
    group = q.shape[2] // k.shape[2]
    vf = v.float().repeat_interleave(group, 2).transpose(1, 2)
    gf = dout.float().transpose(1, 2)
    lse_ = lse[..., None]
    p = torch.where((s > tfa.NEG_INF / 2) & (lse_ > tfa.NEG_INF / 2),
                    torch.exp(s - lse_), 0.0)
    delta = tfa._bwd_delta(out, dout, None)[..., None]
    ds = _bf16(p * (gf @ vf.transpose(-1, -2) - delta) * scale)
    return (ds @ kf).transpose(1, 2)


def _keep(S, causal, window):
    """keep [S query, S key] of self-attention at positions 0..S-1."""
    pos = torch.arange(S)
    keep = torch.ones(S, S, dtype=torch.bool)
    if causal:
        keep = pos[None, :] <= pos[:, None]
    if window is not None:
        keep = keep & (pos[None, :] > pos[:, None] - window)
    return keep


def replay_dkv(q, k, v, dout, out, lse, scale, *, causal=True, window=None,
               g_lse=None):
    """(dk, dv) [B,S,Hkv,D] in f32 as the tensor-core dK/dV step
    (flash_tc.cuh's dkv_tile_tc) computes them from the forward's out and
    lse, before it rounds them to bf16: per 64-key tile, per 64-query tile
    and q-head of the group, f32 Sᵀ = K Qᵀ and dPᵀ = V dOᵀ from the bf16
    inputs, Pᵀ = exp(Sᵀ·scale − lse) (0 where masked or lse = NEG_INF),
    dSᵀ = Pᵀ∘(dPᵀ − Δ)·scale, then dV += bf16(Pᵀ)·dO and dK += bf16(dSᵀ)·Q
    summed in f32."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    qf = q.float().transpose(1, 2).reshape(B, Hkv, group, S, D)
    gf = dout.float().transpose(1, 2).reshape(B, Hkv, group, S, D)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    lse_ = lse.float().reshape(B, Hkv, group, S)
    delta = tfa._bwd_delta(out, dout, g_lse).reshape(B, Hkv, group, S)
    keep_t = _keep(S, causal, window).T                  # [key, query]
    dk = torch.zeros(B, Hkv, S, D)
    dv = torch.zeros(B, Hkv, S, D)
    for k0 in range(0, S, TILE):
        ks = slice(k0, k0 + TILE)
        for q0 in range(0, S, TILE):
            qs = slice(q0, q0 + TILE)
            for g in range(group):
                qt, gt = qf[:, :, g, qs], gf[:, :, g, qs]
                lt = lse_[:, :, g, None, qs]
                st = kf[:, :, ks] @ qt.transpose(-1, -2) * scale
                pt = torch.where(keep_t[ks, qs] & (lt > tfa.NEG_INF / 2),
                                 torch.exp(st - lt), 0.0)
                dpt = vf[:, :, ks] @ gt.transpose(-1, -2)
                dst = pt * (dpt - delta[:, :, g, None, qs]) * scale
                dv[:, :, ks] += _bf16(pt) @ gt
                dk[:, :, ks] += _bf16(dst) @ qt
    return dk.transpose(1, 2), dv.transpose(1, 2)


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
        want = tfa.attention_bwd_plain(*f32[:3], out, lse, f32[3])
        dq = replay_dq(q, k, v, dout, out, lse, scale)
        row["dq_f32_rel"] = _rel(dq, want[0])
        row["dq_bf16_rel"] = _rel(dq.to(bf), want[0].to(bf))
        for name, got, ref in zip(("dk", "dv"), replay_dkv(
                q, k, v, dout, out, lse, scale), want[1:]):
            row[f"{name}_f32_rel"] = _rel(got, ref)
            row[f"{name}_bf16_rel"] = _rel(got.to(bf), ref.to(bf))
        if S >= WINDOW:   # the rectangular kernel's windowed case
            wout, wlse = tfa.attention_plain(
                f32[0], f32[1].transpose(1, 2), f32[2].transpose(1, 2), 0,
                window=WINDOW)
            wwant = tfa.attention_bwd_plain(*f32[:3], wout, wlse, f32[3],
                                            window=WINDOW)
            for name, got, ref in zip(("dk", "dv"), replay_dkv(
                    q, k, v, dout, wout, wlse, scale, window=WINDOW),
                    wwant[1:]):
                row[f"window_{name}_f32_rel"] = _rel(got, ref)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
