"""Speculative decoding: a small draft model proposes, the target verifies.

Twin of ``gpu_provisioner_tpu/models/speculative.py``. Each round the draft
autoregresses ``spec_k`` cheap tokens, the target scores all of them in ONE
cached forward (a [B, spec_k+1] block, which the decode kernel takes while
spec_k + 1 <= DECODE_MAX_S), and the longest prefix where the draft's
choices equal the target's argmax is accepted, plus one bonus token from the
target's own distribution at the first disagreement. Greedy speculative
decoding emits exactly plain greedy decoding's stream with the target;
sampled mode (temperature > 0) accepts by the Leviathan/Chen rejection step
(``_spec_accept``), so every emitted token's law is the target's filtered
distribution. Rows accept different numbers of tokens a round, so both
caches carry per-row lengths; a finished row (quota or eos) rolls back all
its round wrote and stops advancing while the batch runs on. Rollback is
length arithmetic: keys past a row's length are masked out of every later
attention and overwritten by later writes. MoE targets verify with a
drop-free capacity (``family_fns(dropless_step=True)``); draft steps do
not.

Deliberate differences from the JAX module:

- an eager host loop over rounds in place of ``lax.while_loop``: the loop
  reads ``done.any()`` once a round, its only host sync; everything else
  (acceptance, rollback, the per-row window writes into the output buffer)
  stays on the device;
- the caches are updated in place (``cached_forward``'s contract), so the
  finished-row clamp and the rollback rewrite only the length vectors;
- ``_spec_accept`` is batched over rows (the JAX function is per row and
  ``vmap``-ed): uniforms from ``torch.rand`` and the bonus token by
  Gumbel-max (``decode.sample``), both from the caller's
  ``torch.Generator``, so sampled streams are reproducible from the
  generator but not token-equal to ``jax.random``'s;
- the draft's probabilities are built only when sampling, the verify
  block's log-softmax only when logprobs are asked for, and the draft's
  last step (which only writes d_k's keys) picks no token; jit drops that
  work in the reference. So ``spec_round`` takes no ``draft_vocab``: the
  reference needs it only to shape the greedy rounds' unused draft
  probabilities;
- ``stats["target_calls"]`` is a Python int (the host counts the rounds);
- on a mesh (``mesh=``) the target and the draft are both this rank's
  shards on the same mesh (``decode.serve_shard``), the prompt and the
  rows returned its (slice, data) block; every rank of a ``model`` group
  reads the same gathered logits, so its acceptance, rollback and
  ``done.any()`` agree with its peers' and their collectives pair.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .decode import (family_fns, filter_logits, init_kv_cache, sample,
                     serve_shard, validate_sampling_args)
from .llama import LlamaConfig
from .moe import embed_table


def _spec_accept(generator, proposal, p_d, p_t):
    """Leviathan/Chen rejection step for B rows: proposal [B, k] drawn from
    the draft distributions p_d [B, k, V]; p_t [B, k+1, V] the target's at
    the same positions. Returns (m [B], bonus [B] int32): accept
    proposal[b, i] while u_i < p_t[b, i, d_i] / p_d[b, i, d_i]; at the
    first rejection (position m) the bonus is drawn from the normalised
    residual max(p_t[m] - p_d[m], 0), and from p_t[k] itself when every
    proposal was accepted."""
    B, k = proposal.shape
    rows = torch.arange(B, device=proposal.device)
    u = torch.rand((B, k), generator=generator, device=proposal.device)
    idx = proposal.long()[..., None]
    q = p_d.gather(2, idx)[..., 0]                                 # q_i(d_i)
    p = p_t[:, :k].gather(2, idx)[..., 0]
    accept = u < torch.clamp(p / torch.clamp(q, min=1e-20), max=1.0)
    m = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)    # [B]
    pt_m = p_t[rows, m]                                            # [B, V]
    # the residual at the rejected position; p_t[k] when fully accepted
    pd_m = torch.cat([p_d, torch.zeros_like(p_d[:, :1])], dim=1)[rows, m]
    resid = torch.clamp(pt_m - pd_m, min=0.0)
    s = resid.sum(dim=-1, keepdim=True)
    probs = torch.where(s > 0, resid / torch.clamp(s, min=1e-20), pt_m)
    bonus = sample(torch.log(torch.clamp(probs, min=1e-30)), generator)
    return m, bonus.to(torch.int32)


def _clamp_done(cache, done, bound: int):
    """Finished rows' lengths clamped to ``bound``: their round still writes
    spec_k+1 entries (every row runs through the same calls), which must
    stay inside max_len; what a finished row writes is never read."""
    return cache._replace(length=torch.where(
        done, torch.clamp(cache.length, max=bound),
        cache.length).to(torch.int32))


@torch.no_grad()
def spec_round(step_t, step_d, params, draft_params, last, done, cache_t,
               cache_d, generator, *, spec_k: int, max_len: int,
               sampled: bool, temperature: float = 0.0, top_k=None,
               top_p=None):
    """ONE speculative round for a batch of rows: the shared core of
    ``speculative_generate``'s loop and the engine's speculative step.
    ``last`` [B]: each row's previous token; ``done`` [B] bool: rows that
    emit nothing (their round rolls back in full). Returns (emit_vec [B,
    spec_k+1] int32, keep [B, spec_k+1] bool (True at emitted positions),
    emit_n [B], new_last [B], cache_t, cache_d, verify_logits [B, spec_k+1,
    V]: the target's logits at each block position, filtered when
    sampled). On a mesh ``step_t``/``step_d`` are ``family_fns(...,
    shard=)``'s, whose logits are whole on every rank: acceptance and
    rollback need nothing else."""
    B = last.shape[0]
    dev = last.device
    bound = max_len - (spec_k + 1)
    cache_t = _clamp_done(cache_t, done, bound)
    cache_d = _clamp_done(cache_d, done, bound)

    # draft phase: k+1 serial steps; step i consumes token i of [last,
    # d_1..d_k], so the (k+1)-th writes d_k's keys and a fully accepted
    # round leaves the draft cache consistent without a special case
    tok, proposal, draft_probs = last, [], []
    for i in range(spec_k + 1):
        lg, cache_d = step_d(draft_params, tok[:, None], cache_d)
        if i == spec_k:
            break
        if sampled:
            fl = filter_logits(lg[:, 0], temperature, top_k, top_p)
            draft_probs.append(torch.softmax(fl, dim=-1))
            tok = sample(fl, generator).to(torch.int32)
        else:
            tok = torch.argmax(lg[:, 0], dim=-1).to(torch.int32)
        proposal.append(tok)
    proposal = torch.stack(proposal, dim=1)                # [B, k] d_1..d_k

    # target phase: ONE wide verify call
    block = torch.cat([last[:, None].to(torch.int32), proposal], dim=1)
    lg, cache_t = step_t(params, block, cache_t)           # [B, k+1, V]
    ar = torch.arange(spec_k + 1, device=dev)
    if sampled:
        fl_t = filter_logits(lg, temperature, top_k, top_p)
        p_t = torch.softmax(fl_t, dim=-1)
        m, bonus = _spec_accept(generator, proposal,
                                torch.stack(draft_probs, dim=1), p_t)
        # emitted: the accepted draft tokens, then the bonus draw
        prop_pad = torch.cat([proposal, torch.zeros_like(proposal[:, :1])],
                             dim=1)
        emit_vec = torch.where(ar[None] < m[:, None], prop_pad,
                               bonus[:, None])
        new_last = bonus
        verify_logits = fl_t
    else:
        preds = torch.argmax(lg, dim=-1).to(torch.int32)   # [B, k+1]
        # the longest agreeing prefix, then the target's own next token
        agree = (proposal == preds[:, :spec_k]).to(torch.int32)
        m = torch.cumprod(agree, dim=1).sum(dim=1)
        emit_vec = preds
        new_last = preds[torch.arange(B, device=dev), m]
        verify_logits = lg
    # finished rows emit nothing: m = -1 rolls back all k+1 writes
    m = torch.where(done, -1, m)
    emit_n = m + 1
    new_last = torch.where(done, last, new_last).to(torch.int32)
    keep = ar[None] < emit_n[:, None]

    # rollback to the accepted state: both models wrote k+1 entries
    # ([last, d_1..d_k]) and keep [.., last, d_1..d_m]
    drop = spec_k - m
    cache_t = cache_t._replace(length=(cache_t.length - drop).to(torch.int32))
    cache_d = cache_d._replace(length=(cache_d.length - drop).to(torch.int32))
    return (emit_vec.to(torch.int32), keep, emit_n, new_last, cache_t,
            cache_d, verify_logits)


def _window_write(buf, n, new, keep):
    """Each row's spec_k+1 window of ``buf`` [B, BUF] at offset n[b] takes
    ``new`` where ``keep`` and keeps its contents elsewhere: one gather and
    one scatter on the device. The offset clamps into the buffer, as
    lax.dynamic_slice clamps; only finished rows (nothing kept) reach the
    clamp."""
    W = new.shape[1]
    start = torch.clamp(n, max=buf.shape[1] - W)
    idx = start[:, None].long() + torch.arange(W, device=buf.device)
    buf.scatter_(1, idx, torch.where(keep, new.to(buf.dtype),
                                     buf.gather(1, idx)))


@torch.no_grad()
def speculative_generate(params, draft_params, prompt, cfg: LlamaConfig,
                         draft_cfg: LlamaConfig, *, max_new_tokens: int,
                         spec_k: int = 4, max_len: int = None,
                         temperature: float = 0.0, top_k: int = None,
                         top_p: float = None,
                         generator: torch.Generator = None,
                         eos_id: int = None, pad_id: int = None,
                         return_logprobs: bool = False, device=None,
                         mesh=None):
    """``max_new_tokens`` tokens from the TARGET, accelerated by the draft.
    prompt [B, S0] int → (tokens [B, max_new_tokens] int32, stats) on
    ``device`` (default cuda; both models' params must live there); stats:
    ``target_calls`` (wide target forwards, the prefill's included) and
    per-row ``tokens`` [B].

    temperature 0 = greedy: exactly plain greedy's stream. temperature > 0
    needs ``generator``: the draft samples its proposals and the rejection
    step keeps each emitted token's law the target's filtered distribution.
    ``spec_k``: draft tokens a round (each round emits 1..spec_k+1). Both
    models share the vocabulary. ``eos_id``: every position after a row's
    first eos reads eos_id, and a finished row stops contributing; the loop
    exits once every row is finished. ``pad_id``: left-padded ragged
    prompts. ``return_logprobs``: also each emitted token's log-probability
    under the target's distribution at its position (greedy: unfiltered;
    sampled: filtered), as a second [B, max_new_tokens] f32 tensor; post-eos
    positions report 0. ``mesh``: as generate's, for both models."""
    dev = resolve_device(device)
    for name, p in (("params", params), ("draft_params", draft_params)):
        if embed_table(p).device != dev:
            raise ValueError(f"{name} on {embed_table(p).device}, "
                             f"speculative_generate on {dev}")
    prompt = torch.as_tensor(prompt, device=dev)
    B, S0 = prompt.shape
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("draft and target must share a vocabulary: "
                         f"{draft_cfg.vocab_size} != {cfg.vocab_size}")
    validate_sampling_args(temperature, top_k, top_p, generator)
    shard = serve_shard(mesh, dev, (params, cfg), (draft_params, draft_cfg))
    sampled = temperature > 0
    if max_len is None:
        max_len = S0 + max_new_tokens + spec_k + 1
    # the verify call may run up to spec_k+1 past the final emission
    if S0 + max_new_tokens + spec_k + 1 > max_len:
        raise ValueError(
            f"max_len={max_len} cannot hold prompt ({S0}) + "
            f"max_new_tokens ({max_new_tokens}) + verify slack "
            f"(spec_k+1 = {spec_k + 1})")

    pad_lens = None
    if pad_id is not None:
        # leading-pad count per row == index of the first real token
        pad_lens = torch.argmax((prompt != pad_id).to(torch.int32),
                                dim=1).to(torch.int32)
    prefill_t, step_t = family_fns(cfg, pad_lens=pad_lens,
                                   fresh=pad_id is None, dropless_step=True,
                                   shard=shard)
    prefill_d, step_d = family_fns(draft_cfg, pad_lens=pad_lens,
                                   fresh=pad_id is None, shard=shard)
    cache_t = init_kv_cache(cfg, B, max_len, dev, shard=shard)
    cache_d = init_kv_cache(draft_cfg, B, max_len, dev, shard=shard)
    logits_t, cache_t = prefill_t(params, prompt, cache_t)
    _, cache_d = prefill_d(draft_params, prompt, cache_d)
    # per-row lengths from here on: rows advance at their own rates
    row_len = torch.full((B,), S0, dtype=torch.int32, device=dev)
    cache_t = cache_t._replace(length=row_len)
    cache_d = cache_d._replace(length=row_len.clone())

    if sampled:
        tok0 = sample(filter_logits(logits_t, temperature, top_k, top_p),
                      generator).to(torch.int32)
    else:
        tok0 = torch.argmax(logits_t, dim=-1).to(torch.int32)
    BUF = max_new_tokens + spec_k + 1          # slack for the last window
    out = torch.zeros((B, BUF), dtype=torch.int32, device=dev)
    out[:, 0] = tok0
    lp = torch.zeros((B, BUF), dtype=torch.float32, device=dev)
    if return_logprobs:
        d0 = (filter_logits(logits_t, temperature, top_k, top_p)
              if sampled else logits_t)
        lp[:, 0] = torch.log_softmax(d0, dim=-1).gather(
            1, tok0[:, None].long())[:, 0]
    n = torch.ones((B,), dtype=torch.int32, device=dev)
    done = n >= max_new_tokens
    if eos_id is not None:
        done = done | (tok0 == eos_id)

    last, calls = tok0, 1
    while bool((~done).any()):                 # the one host sync a round
        (emit_vec, keep, emit_n, last, cache_t, cache_d,
         verify_logits) = spec_round(
            step_t, step_d, params, draft_params, last, done, cache_t,
            cache_d, generator, spec_k=spec_k, max_len=max_len,
            sampled=sampled, temperature=temperature, top_k=top_k,
            top_p=top_p)
        calls += 1
        _window_write(out, n, emit_vec, keep)
        if return_logprobs:
            # each emitted token under the target's distribution at its own
            # position (verify_logits[b, i]: after prefix + d_<i)
            wlp = torch.log_softmax(verify_logits, dim=-1).gather(
                2, emit_vec[..., None].long())[..., 0]
            _window_write(lp, n, wlp, keep)
        n = (n + emit_n).to(torch.int32)
        done = done | (n >= max_new_tokens)
        if eos_id is not None:
            done = done | (keep & (emit_vec == eos_id)).any(dim=1)

    toks = out[:, :max_new_tokens]
    lps = lp[:, :max_new_tokens]
    n_tokens = torch.clamp(n, max=max_new_tokens)
    if eos_id is not None:
        # generate()'s convention: every position after the first eos reads
        # eos_id (this also covers the last window's post-eos tail)
        is_eos = toks == eos_id
        seen = torch.cumsum(is_eos.to(torch.int32), dim=1)
        after = (seen - is_eos.to(torch.int32)) > 0
        toks = torch.where(after, eos_id, toks).to(torch.int32)
        lps = torch.where(after, 0.0, lps)      # forced eos: not a draw
        n_tokens = torch.where(is_eos.any(dim=1),
                               torch.argmax(is_eos.to(torch.int32), dim=1)
                               + 1, n_tokens).to(torch.int32)
    stats = {"target_calls": calls, "tokens": n_tokens}
    if return_logprobs:
        return toks, lps, stats
    return toks, stats


__all__ = ["speculative_generate", "spec_round"]
