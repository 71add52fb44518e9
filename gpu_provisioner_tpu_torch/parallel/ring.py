"""Ring attention: exact causal attention over a sequence-sharded group,
and dense single-device attention.

Twin of ``gpu_provisioner_tpu/parallel/ring.py``: ``dense_attention_with_lse``
and ``dense_attention``; ``_lse_merge``, the merge of normalised partial
attentions by their logsumexp (also the plain version of the forward fixup
of ``ops/csrc/flash_tri.cu``); ``ring_attention`` (``_ring_flash``, whose
step calls the flash kernels, or the dense computation with
``impl="dense"``), ``zigzag_order`` and ``zigzag_ring_attention``.

Each rank holds its own [B, S/n, H, D] blocks (the JAX functions run inside
``shard_map``); ``group`` is the ``seq`` axis' process group, and rank i of
it holds sequence block i. Q stays put and the K/V block moves one rank on
each step (``comm.ring_shift``, K and V stacked into one transfer). The
flash path takes, on each step, the case the JAX package's ``lax.switch``
picks: the diagonal block a causal kernel call, an earlier block a full
(non-causal) call, a later block no call (zeros and an lse of NEG_INF).
The case follows from the rank and the step on the host, so no device
sync is needed. The kernel's lse output carries a cotangent through the
merge, which its backward folds into Δ (``ops/flash_attention.py``).
Deliberate differences:

- K/V are not rotated after the last step (the JAX loop rotates them back
  home): the same result with one transfer less;
- a last shifted block that the causal flash ring does not attend to is
  tied into the graph at zero gradient (``comm.keep_in_graph``), so that
  its backward shift runs on every rank as the forward's did (every
  zigzag step attends to its block);
- the dense ring merges its partials by logsumexp as the flash ring does
  (the JAX dense ring keeps a running max and sum), so a later block is
  skipped on both paths;
- ``zigzag_order`` returns ``torch.long`` tensors;
- the zigzag attention takes blocks of the already permuted sequence (the
  train step permutes its tokens once); the JAX ``make_attn_fn`` permutes
  global arrays around its ``shard_map``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.flash_attention import NEG_INF, attention_plain
from .comm import keep_in_graph, ring_shift


def dense_attention_with_lse(q, k, v, *, causal: bool = True,
                             scale: float | None = None,
                             window: int | None = None, sinks: int = 0):
    """Exact attention returning (out [B,Sq,Hq,D], lse [B,Hq,Sq] f32).
    q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D]. Fully-masked rows yield zeros and
    lse = NEG_INF, the kernels' convention. ``window``: query i attends keys
    in (i - window, i]; ``sinks``: keys at positions < sinks stay
    attendable (an OR against the window bound, never widening causality).
    The same function as the flash kernels' plain version, so it calls
    ``attention_plain`` on token-major K/V views."""
    return attention_plain(q, k.transpose(1, 2), v.transpose(1, 2), 0,
                           causal=causal, scale=scale, window=window,
                           sinks=sinks)


def dense_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window: int | None = None,
                    sinks: int = 0):
    """dense_attention_with_lse without the lse."""
    return dense_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                    window=window, sinks=sinks)[0]


def _lse_merge(o, L, o_i, lse_i):
    """Merge a normalized partial (o_i [B,Sq,H,D], lse_i [B,H,Sq]) into the
    running (o, L): O = (O·w + O_i·w_i)/(w + w_i), L = M + log(w + w_i),
    w = exp(L − M). The NEG_INF sentinel marks fully-masked partials
    (weight 0); both guards keep masked×masked merges finite. o comes back
    in f32."""
    o_i = o_i.float()
    M = torch.maximum(L, lse_i)
    w_old = torch.where(L > NEG_INF / 2, torch.exp(L - M), 0.0)
    w_new = torch.where(lse_i > NEG_INF / 2, torch.exp(lse_i - M), 0.0)
    z = w_old + w_new
    safe = torch.where(z > 0, z, 1.0)
    wo = (w_old / safe).transpose(1, 2)[..., None]
    wn = (w_new / safe).transpose(1, 2)[..., None]
    o = o * wo + o_i * wn
    L = torch.where(z > 0, M + torch.log(safe), NEG_INF)
    return o, L


def _ring_steps(k, v, group):
    """Yields (t, k_t, v_t) for t in 0..n-1: this rank's K/V, then the
    blocks that arrive, one rank on each step (no rotation after the last).
    Ranks step in lockstep: every rank shifts n - 1 times."""
    n = dist.get_world_size(group)
    kv = torch.stack([k, v])
    for t in range(n):
        yield t, kv[0], kv[1]
        if t < n - 1:
            kv = ring_shift(kv, group)


def _pair_attn(impl: str):
    """A step's local attention with its lse: the flash kernels, or the
    dense (plain) computation."""
    if impl == "flash":
        from ..ops.flash_attention import flash_attention_with_lse
        return flash_attention_with_lse
    return dense_attention_with_lse


def _masked(qc):
    """A step with nothing to attend to: zeros and lse NEG_INF, no call."""
    B, S, H, _ = qc.shape
    return (torch.zeros_like(qc),
            qc.new_full((B, H, S), NEG_INF, dtype=torch.float32))


def ring_attention(q, k, v, *, group, causal: bool = True,
                   scale: float | None = None, impl: str = "dense"):
    """Exact attention with K/V rotating around ``group`` (the ``seq``
    axis). q [B,Sq,Hq,D] is this rank's query block, k/v [B,Sk,Hkv,D] its
    key/value block; returns [B,Sq,Hq,D] in q's dtype. ``impl="flash"``
    runs each step's local attention through the flash kernels, else
    densely (``_ring_flash``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _ring_flash(q, k, v, group=group, causal=causal, scale=scale,
                       attn=_pair_attn(impl))


def _ring_flash(q, k, v, *, group, causal, scale, attn):
    """The ring with one ``attn`` call a step, partials merged by their
    logsumexp. The step's case comes from the host: the diagonal block a
    causal call, an earlier block a full call, a later block no call."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    B, Sq, Hq, D = q.shape
    o = q.new_zeros((B, Sq, Hq, D), dtype=torch.float32)
    L = q.new_full((B, Hq, Sq), NEG_INF, dtype=torch.float32)
    for t, k_cur, v_cur in _ring_steps(k, v, group):
        later = causal and (my - t) % n > my
        if later:
            o_i, lse_i = _masked(q)
        else:
            o_i, lse_i = attn(q, k_cur, v_cur, causal=causal and t == 0,
                              scale=scale)
        o, L = _lse_merge(o, L, o_i, lse_i)
    # a last block that lies later in the sequence arrived for nothing: tie
    # it into the graph, so that its backward shift runs here too (an
    # earlier one feeds the next shift)
    return keep_in_graph(o.to(q.dtype), k_cur) if later else o.to(q.dtype)


def zigzag_order(seq_len: int, n: int, device=None):
    """(perm, inv) as torch.long: ``perm`` places global chunk pair
    (i, 2n-1-i) on shard i. Contiguous causal sharding gives shard 0 almost
    nothing to attend and shard n-1 every step; pairing the i-th earliest
    with the i-th latest chunk gives every shard the same causal work.
    Apply ``x[:, perm]`` before sharding, ``out[:, inv]`` after."""
    if seq_len % (2 * n):
        raise ValueError(f"seq_len {seq_len} is not a multiple of 2n = "
                         f"{2 * n}")
    chunk = seq_len // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * chunk, (i + 1) * chunk))
        j = 2 * n - 1 - i
        order.extend(range(j * chunk, (j + 1) * chunk))
    perm = torch.tensor(order, dtype=torch.long, device=device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(seq_len, device=device)
    return perm, inv


def zigzag_ring_attention(q, k, v, *, group, causal: bool = True,
                          scale: float | None = None, impl: str = "flash"):
    """Ring attention over zigzag-ordered blocks: this rank's [B, 2·chunk,
    H, D] holds (early chunk ``my``, late chunk ``2n-1-my``) of the
    sequence the caller permuted with ``zigzag_order``. With the K/V pair
    from origin rank j on each step:

    - q_late × kv_early: always visible, one full call;
    - q_early × kv_early: full if j < my, diagonal if j == my, none if
      j > my;
    - q_late × kv_late: none if j < my, diagonal if j == my, full if j > my.

    So every rank makes 2n + 1 calls over the n steps: the causal ring's
    total work, balanced. Partials merge by logsumexp as in _ring_flash;
    ``impl="dense"`` computes each pair densely (with its lse)."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    B, S2, Hq, D = q.shape
    half = S2 // 2
    if scale is None:
        scale = D ** -0.5
    if not causal:                        # balanced already; the plain ring
        return ring_attention(q, k, v, group=group, causal=False,
                              scale=scale, impl=impl)
    pair_attn = _pair_attn(impl)

    def pair(qc, kc, vc, case):
        """case 0 full, 1 diagonal, 2 none."""
        if case == 2:
            return _masked(qc)
        return pair_attn(qc, kc, vc, causal=case == 1, scale=scale)

    qa, qb = q[:, :half], q[:, half:]
    oa = q.new_zeros((B, half, Hq, D), dtype=torch.float32)
    ob = torch.zeros_like(oa)
    La = q.new_full((B, Hq, half), NEG_INF, dtype=torch.float32)
    Lb = La.clone()
    for t, k_cur, v_cur in _ring_steps(k, v, group):
        j = (my - t) % n
        ka, kb = k_cur[:, :half], k_cur[:, half:]
        va, vb = v_cur[:, :half], v_cur[:, half:]
        ob, Lb = _lse_merge(ob, Lb, *pair(qb, ka, va, 0))
        oa, La = _lse_merge(oa, La, *pair(qa, ka, va,
                                          1 if j == my else 0 if j < my
                                          else 2))
        ob, Lb = _lse_merge(ob, Lb, *pair(qb, kb, vb,
                                          1 if j == my else 2 if j < my
                                          else 0))
    return torch.cat([oa, ob], dim=1).to(q.dtype)
