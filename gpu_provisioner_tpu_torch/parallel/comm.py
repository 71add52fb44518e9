"""Collectives of the sharded training step and of sharded serving,
differentiable where the step needs them.

No JAX twin module: this is the port's form of what the JAX package gets
from ``lax.ppermute`` (the ring's K/V rotation, ``parallel/ring.py``) and
of the all-reduces GSPMD inserts for tensor parallelism (Megatron's
conjugate pair) and for the gradients of the batch axes.

- ``ring_shift``: x of rank i of a group goes to rank i+1, rank i takes
  rank i-1's; its backward shifts the gradient the other way. Both
  directions post one ``isend`` and one ``irecv`` together
  (``batch_isend_irecv``): two blocking calls could deadlock at n = 2.
- ``copy_to_tp``: identity forward, all-reduce backward (before a
  column-parallel product); ``reduce_from_tp``: all-reduce forward, identity
  backward (after a row-parallel product).
- ``all_reduce_``: in place, for the gradients and the loss;
- ``sum_over``: all-reduce (sum) forward; backward, the cotangent times
  the group's size: psum's transpose where every rank's cotangent is the
  same (a global mean every rank computes alike from the sum, such as the
  MoE load-balance term's), so a step that then averages the gradients
  over the group counts the term once;
- ``gather_from_tp``: all-gather of the last dim over the ``model`` group,
  forward only: serving's vocabulary-parallel logits, gathered so that
  every rank of the group samples from the same full row (GSPMD inserts
  this gather in the JAX package).

**Transport.** NCCL takes CUDA tensors. Gloo's point-to-point ops take
host memory only, so where a group's backend is gloo and a tensor lies on
the card, it is staged explicitly through a pinned host buffer (a copy out,
the collective on the host copy, a copy back), for all-reduces as well.
That is transport only: the compute stays on the card. ``STAGED`` counts
the bytes staged (both directions) and the host seconds of the staged
collectives, from the moment this rank's earlier device work is done (the
copy out waits for it anyway) to the copy back: staging, gloo, and waiting
for the peers.

Every rank must issue the same collectives in the same order. The ring's
autograd graph has one ``ring_shift`` node a step, each fed by the one
before, and ``keep_in_graph`` ties a shifted block that no step attends to
into the graph, so that its backward shift runs on every rank.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

# bytes copied between the card and host buffers for gloo collectives, and
# host seconds inside the collectives
STAGED = {"bytes": 0, "seconds": 0.0}
_PINNED: dict = {}


def reset_staged() -> None:
    STAGED.update(bytes=0, seconds=0.0)


@contextlib.contextmanager
def _clocked(t: torch.Tensor):
    """Times a staged collective of ``t`` after the device work queued
    before it."""
    torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        STAGED["seconds"] += time.perf_counter() - t0


@dataclass(frozen=True)
class TPGroup:
    """One rank's view of its tensor-parallel (``model``) group."""
    group: object
    size: int
    rank: int


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(name: str, like: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer of ``like``'s shape and dtype, grown as needed
    and reused (one per ``name``; callers finish with it before reuse)."""
    buf = _PINNED.get((name, like.dtype))
    if buf is None or buf.numel() < like.numel():
        buf = torch.empty(like.numel(), dtype=like.dtype, pin_memory=True)
        _PINNED[(name, like.dtype)] = buf
    return buf[:like.numel()].view(like.shape)


def _to_host(name: str, t: torch.Tensor) -> torch.Tensor:
    h = _host(name, t)
    h.copy_(t)
    STAGED["bytes"] += t.numel() * t.element_size()
    return h


def _from_host(dst: torch.Tensor, h: torch.Tensor) -> None:
    dst.copy_(h)
    STAGED["bytes"] += h.numel() * h.element_size()


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a contiguous ``t`` over ``group``."""
    if not _staged(t, group):
        dist.all_reduce(t, op=op, group=group)
        return t
    with _clocked(t):
        h = _to_host("reduce", t)
        dist.all_reduce(h, op=op, group=group)
        _from_host(t, h)
    return t


def _exchange(send, recv, dst: int, src: int, group) -> None:
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group),
        dist.P2POp(dist.irecv, recv, src, group)])
    for r in reqs:
        r.wait()


def shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """Rank i's ``x`` to rank i + offset of ``group``; returns rank
    i - offset's."""
    x = x.contiguous()
    n, me = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + offset) % n)
    src = dist.get_global_rank(group, (me - offset) % n)
    if not _staged(x, group):
        out = torch.empty_like(x)
        _exchange(x, out, dst, src, group)
        return out
    with _clocked(x):
        send, recv = _to_host("send", x), _host("recv", x)
        _exchange(send, recv, dst, src, group)
        out = torch.empty_like(x)
        _from_host(out, recv)
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable shift to the next rank of ``group`` (the twin of
    ``lax.ppermute(x, axis, [(i, (i + 1) % n)])``)."""
    return _RingShift.apply(x, group)


class _KeepInGraph(torch.autograd.Function):
    """Identity on ``out``; gives ``tied`` a zero gradient."""

    @staticmethod
    def forward(ctx, out, tied):
        ctx.tied = (tied.shape, tied.dtype, tied.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.tied
        return g, torch.zeros(shape, dtype=dtype, device=device)


def keep_in_graph(out: torch.Tensor, tied: torch.Tensor) -> torch.Tensor:
    """``out``, with ``tied`` on its autograd path at zero gradient: a
    shifted K/V block that this rank never attends to still has its
    backward shift run, as every other rank's does."""
    return _KeepInGraph.apply(out, tied) if tied.requires_grad else out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_from_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """[..., n] of every rank of ``tp`` → [..., tp.size · n], the ranks'
    parts in group order (rank r's columns at [r·n, (r+1)·n)), the same on
    every rank. Forward only (serving runs under no_grad)."""
    x = x.contiguous()
    n = tp.size
    if not _staged(x, tp.group):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=tp.group)
        return torch.cat(parts, dim=-1)
    with _clocked(x):
        h = _to_host("gather_in", x)
        gathered = _host("gather", torch.empty((n, *x.shape), dtype=x.dtype,
                                               device="meta"))
        dist.all_gather(list(gathered.unbind(0)), h, group=tp.group)
        out = torch.empty(gathered.shape, dtype=x.dtype, device=x.device)
        _from_host(out, gathered)
    return torch.movedim(out, 0, -2).reshape(*x.shape[:-1], n * x.shape[-1])


def copy_to_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over ``tp`` backward:
    the input of a column-parallel product."""
    return _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """All-reduce (sum) over ``tp`` forward, identity backward: the output
    of a row-parallel product, replicated on every rank of the group."""
    return _ReduceFromTP.apply(x, tp.group)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) of ``x`` over ``group``; its backward multiplies
    the (replicated) cotangent by the group's size."""
    return _SumOver.apply(x, group)
