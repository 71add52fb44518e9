"""Continuous-batching serving engine over the per-row KV cache.

Twin of ``gpu_provisioner_tpu/models/engine.py`` without speculation: one
pre-allocated cache of ``slots`` rows at a fixed ``max_len``; every step
advances all active slots together through one ``cached_forward`` with a
per-row length vector (the per-row-start decode kernel); a finished slot
(eos or token budget) frees at once and the next queued request is admitted
into it, its prompt left-padded to a bucket and prefilled into a one-row
cache that is then copied into the slot. Inactive slots ride through the
shared step with their write offset parked in bounds and their length
restored afterwards. Prefix caching prefills a shared prefix once (LRU) and
admits later requests by prefilling only their right-padded suffix at the
prefix row's offset. Greedy engine output per request is exactly
``generate()``'s stream for that request alone.

Deliberate differences from the JAX module:

- the cache is updated in place (slot copies and decode writes), and the
  suffix prefill of a prefix hit runs on a clone of the cached prefix row,
  which stays untouched for the next hit;
- an eager host loop in place of jitted step/prefill/insert programs;
- ``torch.Generator`` in place of ``jax.random`` keys for sampling;
- no fleet registration: the JAX engine registers itself with the JAX
  package's observability registry, which this package does not import;
  the bridge is later work;
- ``draft_params``/``draft_cfg`` (speculative serving) raise until the
  speculation slice.

Both model families serve, through ``family_fns``. MoE bucketing: expert
capacity for an admission's prefill comes from the bucket length (pads
claim no capacity but widen capacity's S), so an MoE stream equals
``generate()`` on the identically padded prompt; decode steps are dropless
either way. Prefix caching serves the dense family only: the right-padded
suffix rows would compete for MoE routing capacity.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..device import resolve_device
from .decode import (KVCache, family_fns, init_kv_cache, pick,
                     validate_sampling_args)
from .llama import LlamaConfig, resolve_attn as _resolve_attn
from .moe import MoEConfig, embed_table

DEFAULT_BUCKETS = (64, 128, 256, 512, 1024)


@dataclass
class Request:
    req_id: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    prefix: Optional[tuple[int, ...]] = None


@dataclass
class _Slot:
    req: Request
    emitted: list[int] = field(default_factory=list)
    lps: list[float] = field(default_factory=list)


class ServeEngine:
    """Slot-based continuous batching for one model.

    ``slots``: concurrent sequences (the decode batch width). ``max_len``:
    per-slot cache budget; every request must satisfy bucket(prefix) +
    bucket(prompt) + max_new_tokens <= max_len. ``prefill_buckets``:
    ascending prompt-pad lengths. Sampling (``temperature``/``top_k``/
    ``top_p``/``generator``) follows generate()'s contract. ``device``
    (default cuda) must be where the params live. ``return_logprobs``:
    record each emitted token's log-probability (generate()'s convention)
    in ``finished_logprobs``."""

    def __init__(self, params, cfg: LlamaConfig, *, slots: int = 8,
                 max_len: int = 2048,
                 prefill_buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 temperature: float = 0.0, top_k: int = None,
                 top_p: float = None, generator: torch.Generator = None,
                 draft_params=None, draft_cfg: LlamaConfig = None,
                 prefix_cache_size: int = 8, return_logprobs: bool = False,
                 device=None):
        if draft_params is not None or draft_cfg is not None:
            raise NotImplementedError(
                "speculative serving (draft_params/draft_cfg) comes with the "
                "speculation slice of the port")
        family_fns(cfg)     # the family dispatch point: other families raise
        _resolve_attn(cfg.attn_impl, cfg.sliding_window, cfg.attn_sinks)
        validate_sampling_args(temperature, top_k, top_p, generator)
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        dev = resolve_device(device)
        if embed_table(params).device != dev:
            raise ValueError(f"params on {embed_table(params).device}, "
                             f"engine on {dev}")
        self.params = params
        self.cfg = cfg
        self.device = dev
        self.slots = slots
        self.max_len = max_len
        self.buckets = tuple(sorted(set(prefill_buckets)))
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self._generator = generator
        self.return_logprobs = return_logprobs

        self.cache = init_kv_cache(cfg, slots, max_len, dev)
        self.cache = self.cache._replace(
            length=torch.zeros((slots,), dtype=torch.int32, device=dev))
        self._pads = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._last = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._slot: list[Optional[_Slot]] = [None] * slots
        self._queue: deque[Request] = deque()
        self._next_id = 0
        self.finished: dict[int, list[int]] = {}
        self.finished_logprobs: dict[int, list[float]] = {}
        self.prefix_cache_size = prefix_cache_size
        self._prefix_lru: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.prefix_misses = 0
        self.prefix_hits = 0

    # --- request lifecycle --------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None, prefix=None) -> int:
        """Queue a request; returns its id. Raises if it cannot ever fit.
        ``prefix``: shared leading tokens prefilled once and LRU-reused —
        ``prompt`` continues AFTER it."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens} (admission always emits "
                             "the prefill token)")
        p = 0
        if prefix is not None:
            prefix = tuple(int(t) for t in prefix)
            if not prefix:
                raise ValueError("empty prefix — omit it instead")
            if isinstance(self.cfg, MoEConfig):
                raise ValueError(
                    "prefix caching serves the dense family only — the "
                    "right-padded suffix rows would compete for MoE "
                    "routing capacity")
            p = self._bucket(len(prefix))   # prefixes bucket like prompts
        b = self._bucket(len(prompt))
        if p + b + max_new_tokens > self.max_len:
            raise ValueError(
                "request needs " + (f"prefix {p} + " if p else "")
                + f"bucket {b} + {max_new_tokens} new tokens > max_len "
                f"{self.max_len}")
        rid = self._next_id
        self._next_id += 1
        self._queue.append(Request(rid, prompt, max_new_tokens, eos_id,
                                   prefix))
        return rid

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def _prefill(self, tokens: list[int], pad: int, cache1: KVCache):
        """B=1 cached forward at the row cache's length (left-padded
        prompt, or a right-padded suffix after a prefix) → (logits [1, S,
        V], cache1)."""
        toks = torch.tensor([tokens], dtype=torch.int32, device=self.device)
        pads1 = torch.tensor([pad], dtype=torch.int32, device=self.device)
        step = family_fns(self.cfg, pad_lens=pads1)[1]
        return step(self.params, toks, cache1)

    def _pick(self, logits):
        return pick(logits, self.temperature, self.top_k, self.top_p,
                    self._generator, self.return_logprobs)

    def _admit(self, emitted: dict[int, list[int]]) -> None:
        """Fill free slots from the queue; admission itself emits each
        request's FIRST token (from the prefill logits) into ``emitted``."""
        for s in range(self.slots):
            if not self._queue:
                return
            if self._slot[s] is not None:
                continue
            req = self._queue.popleft()
            if req.prefix is not None:
                lg, cache1, pad, length = self._prefix_admit(req)
            else:
                b = self._bucket(len(req.prompt))
                pad = b - len(req.prompt)
                length = b
                cache1 = init_kv_cache(self.cfg, 1, self.max_len, self.device)
                logits, cache1 = self._prefill([0] * pad + req.prompt, pad,
                                               cache1)
                lg = logits[:, -1]
            tok, lp = self._pick(lg)
            tok0 = int(tok[0])
            lp0 = float(lp[0]) if self.return_logprobs else 0.0
            self._insert(cache1, s, length)
            self._pads[s] = pad
            self._last[s] = tok0
            self._slot[s] = _Slot(req, [tok0], [lp0])
            emitted.setdefault(req.req_id, []).append(tok0)
            self._maybe_finish(s)

    def _insert(self, small: KVCache, slot: int, length: int) -> None:
        """Copy a one-row cache into ``slot`` of the engine cache, in place."""
        big = self.cache
        for b, sm in ((big.k, small.k), (big.v, small.v),
                      (big.k_scale, small.k_scale),
                      (big.v_scale, small.v_scale)):
            if b is not None:
                b[:, slot] = sm[:, 0]
        big.length[slot] = length

    def _prefix_row(self, prefix: tuple[int, ...]):
        """(row cache, pad count) prefilled over the LEFT-pad-bucketed
        prefix, LRU-cached: the prefix is prefilled once per distinct
        prefix and every later request reuses the row."""
        hit = self._prefix_lru.get(prefix)
        if hit is not None:
            self.prefix_hits += 1
            self._prefix_lru.move_to_end(prefix)
            return hit
        self.prefix_misses += 1
        pad = self._bucket(len(prefix)) - len(prefix)
        c = init_kv_cache(self.cfg, 1, self.max_len, self.device)
        _, c = self._prefill([0] * pad + list(prefix), pad, c)
        self._prefix_lru[prefix] = (c, pad)
        while len(self._prefix_lru) > self.prefix_cache_size:
            self._prefix_lru.popitem(last=False)
        return c, pad

    def _prefix_admit(self, req: Request):
        """Admission via a cached prefix row: only the per-request suffix is
        prefilled, RIGHT-padded to a bucket, on a clone of the row; the
        padded tail's writes roll back via the length. The slot inherits
        the prefix row's LEFT-pad count."""
        b = self._bucket(len(req.prompt))
        r = len(req.prompt)
        pc, pad = self._prefix_row(req.prefix)
        cache1 = KVCache(*(t.clone() if isinstance(t, torch.Tensor) else t
                           for t in pc))
        logits, cache1 = self._prefill(req.prompt + [0] * (b - r), pad,
                                       cache1)
        length = self._bucket(len(req.prefix)) + r
        return logits[:, r - 1], cache1, pad, length

    def _maybe_finish(self, s: int) -> None:
        slot = self._slot[s]
        req = slot.req
        done = len(slot.emitted) >= req.max_new_tokens or (
            req.eos_id is not None and slot.emitted[-1] == req.eos_id)
        if done:
            self.finished[req.req_id] = slot.emitted
            if self.return_logprobs:
                self.finished_logprobs[req.req_id] = slot.lps
            self._slot[s] = None
            self.cache.length[s] = 0

    # --- the serving loop ---------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(s is not None for s in self._slot)

    def stats(self) -> dict:
        """Serving counters: slot occupancy, queue depth, totals,
        prefix-cache effectiveness."""
        emitted = sum(len(v) for v in self.finished.values()) + sum(
            len(s.emitted) for s in self._slot if s is not None)
        return {
            "slots": self.slots,
            "slots_active": sum(s is not None for s in self._slot),
            "queue_depth": len(self._queue),
            "requests_submitted": self._next_id,
            "requests_finished": len(self.finished),
            "tokens_emitted": emitted,
            "prefix_cache_entries": len(self._prefix_lru),
            "prefix_cache_hits": self.prefix_hits,
            "prefix_cache_misses": self.prefix_misses,
        }

    @torch.no_grad()
    def _decode(self, active: torch.Tensor):
        """One token for every slot: inactive slots park their write offset
        in bounds and get their length back afterwards."""
        length = self.cache.length
        parked = torch.clamp(length, max=self.max_len - 1)
        safe = torch.where(active, length, parked)
        step = family_fns(self.cfg, pad_lens=self._pads)[1]
        logits, cache = step(self.params, self._last[:, None],
                             self.cache._replace(length=safe))
        self.cache = cache._replace(
            length=torch.where(active, cache.length, safe).to(torch.int32))
        return self._pick(logits[:, 0])

    def step(self) -> dict[int, list[int]]:
        """Admit what fits, then advance every active slot one token.
        Returns {req_id: [tokens]} for every token emitted this step (an
        admitted request contributes its first token from the prefill)."""
        out: dict[int, list[int]] = {}
        self._admit(out)
        active_slots = [i for i, s in enumerate(self._slot) if s is not None]
        if not active_slots:
            return out
        active = torch.tensor([s is not None for s in self._slot],
                              device=self.device)
        nxt, lp = self._decode(active)
        self._last = nxt
        toks = nxt.tolist()                  # the one host sync per step
        lps = lp.tolist() if self.return_logprobs else None
        for s in active_slots:
            slot = self._slot[s]
            slot.emitted.append(toks[s])
            if lps is not None:
                slot.lps.append(lps[s])
            out.setdefault(slot.req.req_id, []).append(toks[s])
            self._maybe_finish(s)
        return out

    def run(self, max_steps: int = 100_000) -> dict[int, list[int]]:
        """Drive until every submitted request finishes; returns
        {req_id: emitted tokens}."""
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} "
                                   f"steps ({self.pending} pending)")
        return self.finished


__all__ = ["ServeEngine", "Request", "DEFAULT_BUCKETS"]
