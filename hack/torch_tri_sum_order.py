#!/usr/bin/env python3
"""Replay, on the CPU, the order in which the dK/dV kernels sum a key's
terms, in f32 against f64.

    python3 hack/torch_tri_sum_order.py [--S 2048] [--group 2] [--seed 0]

Both dK/dV kernels (csrc/flash_bwd.cu ``flash_bwd_dkv``, csrc/flash_tri.cu
``flash_bwd_dkv_tri``) compute every term P[q,k]·dO[q] and dS[q,k]·Q[q]
with the same tile step (``dkv_tile``), so their terms are bitwise equal;
they differ only in the order in which one f32 register sums them (one
``fmaf`` per term). This script builds the terms of one kv head (causal,
head dim 128, a GQA group of q-heads, random normal inputs as the card
checks use), rounds them to f32, and sums them in each order with an
emulated ``fmaf`` (the product is exact in f64, the sum rounded to f32):

- ``rect``: the rectangular kernel: the group's q-heads outer, queries
  ascending;
- ``tri``: the triangle: 32-query tiles descending (``_tri_decode_rev``),
  the group's q-heads inside each tile, queries ascending inside a tile;
- ``tri_group_outer``: descending tiles, q-heads outer;
- ``asc_group_inner``: ascending tiles, q-heads inside each tile;
- ``tri_cut``: ``tri`` with each key's sum split at the middle query tile
  into two f32 partials added at the end (a row cut between two shares).

Each is printed as max|sum − exact| / max|exact| over the head's dK and
dV, exact being the f64 sum of the same f32 terms.
"""

from __future__ import annotations

import argparse
import json

import torch


def terms(S: int, group: int, D: int, seed: int):
    """f32 (p, ds) [group, S, S] (query, key) and (q, dout) [group, S, D],
    computed in f64 from f32 normal inputs, causal, scale D^-0.5."""
    g = torch.Generator().manual_seed(seed)
    q, dout = (torch.randn(group, S, D, generator=g) for _ in range(2))
    k, v = (torch.randn(S, D, generator=g) for _ in range(2))
    qd, kd, vd, gd = (t.double() for t in (q, k, v, dout))
    scale = D ** -0.5
    s = torch.einsum("gqd,kd->gqk", qd, kd) * scale
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(keep, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("gqk,kd->gqd", p, vd)
    dp = torch.einsum("gqd,kd->gqk", gd, vd)
    delta = (gd * o).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    return p.float(), ds.float(), q, dout


def fma_sum(order, p, ds, q, dout):
    """(dK, dV) [S, D] f32: for (g, query) in ``order``, one emulated fmaf
    per key and column: acc = f32(acc + term·x), the product exact in f64.
    A ``None`` in ``order`` closes a partial: the running sums are added to
    the total after the last step."""
    S, D = q.shape[1], q.shape[2]
    dk = torch.zeros(S, D)
    dv = torch.zeros(S, D)
    parts = []
    for step in order:
        if step is None:
            parts.append((dk, dv))
            dk, dv = torch.zeros(S, D), torch.zeros(S, D)
            continue
        g, qq = step
        dk = (dk.double() + ds[g, qq].double()[:, None]
              * q[g, qq].double()[None, :]).float()
        dv = (dv.double() + p[g, qq].double()[:, None]
              * dout[g, qq].double()[None, :]).float()
    for pk, pv in parts:
        dk, dv = pk + dk, pv + dv
    return dk, dv


def orders(S: int, group: int, E: int = 32):
    tiles = range(S // E)
    inside = lambda t: range(t * E, (t + 1) * E)   # noqa: E731
    desc, asc = list(reversed(tiles)), list(tiles)
    tri = [(g, qq) for t in desc for g in range(group) for qq in inside(t)]
    half = len(desc) // 2
    return {
        "rect": [(g, qq) for g in range(group) for qq in range(S)],
        "tri": tri,
        "tri_group_outer": [(g, qq) for g in range(group) for t in desc
                            for qq in inside(t)],
        "asc_group_inner": [(g, qq) for t in asc for g in range(group)
                            for qq in inside(t)],
        "tri_cut": tri[:half * E * group] + [None] + tri[half * E * group:],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--S", type=int, default=2048)
    ap.add_argument("--group", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    D = 128
    p, ds, q, dout = terms(args.S, args.group, D, args.seed)
    exact_k = torch.einsum("gqk,gqd->kd", ds.double(), q.double())
    exact_v = torch.einsum("gqk,gqd->kd", p.double(), dout.double())
    out = {"S": args.S, "group": args.group, "D": D, "seed": args.seed}
    for name, order in orders(args.S, args.group).items():
        dk, dv = fma_sum(order, p, ds, q, dout)
        out[name] = {
            "dk": ((dk.double() - exact_k).abs().max()
                   / exact_k.abs().max()).item(),
            "dv": ((dv.double() - exact_v).abs().max()
                   / exact_v.abs().max()).item()}
        print(name, out[name], flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
