"""Continuous-batching serving engine over the per-row KV cache.

Twin of ``gpu_provisioner_tpu/models/engine.py``: one pre-allocated cache
of ``slots`` rows at a fixed ``max_len``; every step advances all active
slots together through one ``cached_forward`` with a
per-row length vector (the per-row-start decode kernel); a finished slot
(eos or token budget) frees at once and the next queued request is admitted
into it, its prompt left-padded to a bucket and prefilled into a one-row
cache that is then copied into the slot. Inactive slots ride through the
shared step with their write offset parked in bounds and their length
restored afterwards. Prefix caching prefills a shared prefix once (LRU) and
admits later requests by prefilling only their right-padded suffix at the
prefix row's offset. Greedy engine output per request is exactly
``generate()``'s stream for that request alone. With a draft model
(``draft_params``/``draft_cfg``/``spec_k``) every step is one
``spec_round`` (models/speculative.py) across all slots: the draft keeps a
cache pool of its own (same slots, buckets and pads, prefilled at
admission), inactive slots ride through as finished rows, and each active
slot emits its accepted prefix plus one token, truncated on the host at
its quota and at eos.

Deliberate differences from the JAX module:

- the cache is updated in place (slot copies and decode writes), and the
  suffix prefill of a prefix hit runs on clones of the cached prefix rows
  (the target's and the draft's), which stay untouched for the next hit;
- an eager host loop in place of jitted step/prefill/insert programs;
- ``torch.Generator`` in place of ``jax.random`` keys for sampling;
- no fleet registration: the JAX engine registers itself with the JAX
  package's observability registry, which this package does not import;
  the bridge is later work;
- a speculative step brings its tokens, emit counts and (when asked) the
  logprobs to the host in one transfer (the reference makes two);
- on a mesh (``mesh=``; the JAX engine lets GSPMD place its slots) the
  params are this rank's shards, the slot caches and the prefix rows hold
  its kv heads, and every rank of a ``model`` group makes the same
  admission, insertion and finish decisions from the same gathered
  logits, so its collectives pair with its peers'. Nothing is cut over
  (slice, data): ranks that differ only there run replicas of the engine,
  each over the request stream its caller submits.

Both model families serve, through ``family_fns``. MoE bucketing: expert
capacity for an admission's prefill comes from the bucket length (pads
claim no capacity but widen capacity's S), so an MoE stream equals
``generate()`` on the identically padded prompt; decode steps are dropless
either way. Prefix caching serves the dense family only, for the target and
the draft alike: the right-padded suffix rows would compete for MoE routing
capacity.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..device import resolve_device
from .decode import (KVCache, family_fns, init_kv_cache, pick,
                     serve_shard, validate_sampling_args)
from .llama import LlamaConfig, resolve_attn as _resolve_attn
from .moe import MoEConfig, embed_table
from .speculative import spec_round

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
    bucket(prompt) + max_new_tokens (+ spec_k + 1 of verify slack when
    speculating) <= max_len. ``prefill_buckets``: ascending prompt-pad
    lengths. Sampling (``temperature``/``top_k``/``top_p``/``generator``)
    follows generate()'s contract. ``draft_params``/``draft_cfg``/
    ``spec_k``: speculative serving, one spec_round a step (1..spec_k+1
    tokens a slot); greedy slots emit exactly the plain engine's streams
    (MoE targets verify drop-free). ``device`` (default cuda) must be where
    the params live. ``return_logprobs``: record each emitted token's
    log-probability (generate()'s convention; speculative slots score under
    the target's verify distribution) in ``finished_logprobs``. ``mesh``:
    the params (and the draft's) are this rank's shards on it
    (``decode.serve_shard``; every rank constructs and drives its engine
    alike)."""

    def __init__(self, params, cfg: LlamaConfig, *, slots: int = 8,
                 max_len: int = 2048,
                 prefill_buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 temperature: float = 0.0, top_k: int = None,
                 top_p: float = None, generator: torch.Generator = None,
                 draft_params=None, draft_cfg: LlamaConfig = None,
                 spec_k: int = 4, prefix_cache_size: int = 8,
                 return_logprobs: bool = False, device=None, mesh=None):
        family_fns(cfg)     # the family dispatch point: other families raise
        _resolve_attn(cfg.attn_impl, cfg.sliding_window, cfg.attn_sinks)
        validate_sampling_args(temperature, top_k, top_p, generator)
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("draft_params and draft_cfg come together")
        if draft_cfg is not None:
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary: "
                                 f"{draft_cfg.vocab_size} != "
                                 f"{cfg.vocab_size}")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            family_fns(draft_cfg)
            _resolve_attn(draft_cfg.attn_impl, draft_cfg.sliding_window,
                          draft_cfg.attn_sinks)
        dev = resolve_device(device)
        for name, p in (("params", params), ("draft_params", draft_params)):
            if p is not None and embed_table(p).device != dev:
                raise ValueError(f"{name} on {embed_table(p).device}, "
                                 f"engine on {dev}")
        models = [(params, cfg)] + ([(draft_params, draft_cfg)]
                                    if draft_cfg is not None else [])
        self.shard = serve_shard(mesh, dev, *models)
        self.params = params
        self.cfg = cfg
        self.device = dev
        self.slots = slots
        self.max_len = max_len
        self.buckets = tuple(sorted(set(prefill_buckets)))
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self._generator = generator
        self.return_logprobs = return_logprobs
        self.draft_params, self.draft_cfg = draft_params, draft_cfg
        self.spec_k = spec_k
        # a speculative round may write spec_k+1 entries at a row's length
        self._slack = (spec_k + 1) if draft_cfg is not None else 0

        self.cache = self._slot_cache(cfg)
        self.draft_cache = (self._slot_cache(draft_cfg)
                            if draft_cfg is not None else None)
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

    def _slot_cache(self, cfg) -> KVCache:
        cache = init_kv_cache(cfg, self.slots, self.max_len, self.device,
                              shard=self.shard)
        return cache._replace(length=torch.zeros(
            (self.slots,), dtype=torch.int32, device=self.device))

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
            if isinstance(self.cfg, MoEConfig) or \
                    isinstance(self.draft_cfg, MoEConfig):
                raise ValueError(
                    "prefix caching serves the dense family only — the "
                    "right-padded suffix rows would compete for MoE "
                    "routing capacity")
            p = self._bucket(len(prefix))   # prefixes bucket like prompts
        b = self._bucket(len(prompt))
        if p + b + max_new_tokens + self._slack > self.max_len:
            raise ValueError(
                "request needs " + (f"prefix {p} + " if p else "")
                + f"bucket {b} + {max_new_tokens} new tokens "
                + (f"+ {self._slack} verify slack " if self._slack else "")
                + f"> max_len {self.max_len}")
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

    def _prefill(self, tokens: list[int], pad: int, cache1: KVCache,
                 draft: bool = False):
        """B=1 cached forward of the target (or, with ``draft``, the draft)
        at the row cache's length (left-padded prompt, or a right-padded
        suffix after a prefix) → (logits [1, S, V], cache1)."""
        toks = torch.tensor([tokens], dtype=torch.int32, device=self.device)
        pads1 = torch.tensor([pad], dtype=torch.int32, device=self.device)
        cfg, params = ((self.draft_cfg, self.draft_params) if draft
                       else (self.cfg, self.params))
        return family_fns(cfg, pad_lens=pads1,
                          shard=self.shard)[1](params, toks, cache1)

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
                lg, cache1, dcache1, pad, length = self._prefix_admit(req)
            else:
                b = self._bucket(len(req.prompt))
                pad = b - len(req.prompt)
                length = b
                logits, cache1, dcache1 = self._fresh_rows(
                    [0] * pad + req.prompt, pad)
                lg = logits[:, -1]
            tok, lp = self._pick(lg)
            tok0 = int(tok[0])
            lp0 = float(lp[0]) if self.return_logprobs else 0.0
            self._insert(self.cache, cache1, s, length)
            if dcache1 is not None:
                self._insert(self.draft_cache, dcache1, s, length)
            self._pads[s] = pad
            self._last[s] = tok0
            self._slot[s] = _Slot(req, [tok0], [lp0])
            emitted.setdefault(req.req_id, []).append(tok0)
            self._maybe_finish(s)

    def _fresh_rows(self, tokens: list[int], pad: int):
        """A left-padded prompt prefilled into fresh one-row caches →
        (target logits [1, S, V], target row, draft row or None)."""
        c = init_kv_cache(self.cfg, 1, self.max_len, self.device,
                          shard=self.shard)
        logits, c = self._prefill(tokens, pad, c)
        d = None
        if self.draft_cfg is not None:
            d = init_kv_cache(self.draft_cfg, 1, self.max_len, self.device,
                              shard=self.shard)
            _, d = self._prefill(tokens, pad, d, draft=True)
        return logits, c, d

    @staticmethod
    def _insert(big: KVCache, small: KVCache, slot: int, length: int) -> None:
        """Copy a one-row cache into ``slot`` of the pool ``big``, in
        place."""
        for b, sm in ((big.k, small.k), (big.v, small.v),
                      (big.k_scale, small.k_scale),
                      (big.v_scale, small.v_scale)):
            if b is not None:
                b[:, slot] = sm[:, 0]
        big.length[slot] = length

    def _prefix_row(self, prefix: tuple[int, ...]):
        """(target row cache, draft row cache or None, pad count) prefilled
        over the LEFT-pad-bucketed prefix, LRU-cached: the prefix is
        prefilled once per distinct prefix and every later request reuses
        the rows."""
        hit = self._prefix_lru.get(prefix)
        if hit is not None:
            self.prefix_hits += 1
            self._prefix_lru.move_to_end(prefix)
            return hit
        self.prefix_misses += 1
        pad = self._bucket(len(prefix)) - len(prefix)
        _, c, d = self._fresh_rows([0] * pad + list(prefix), pad)
        self._prefix_lru[prefix] = (c, d, pad)
        while len(self._prefix_lru) > self.prefix_cache_size:
            self._prefix_lru.popitem(last=False)
        return c, d, pad

    def _prefix_admit(self, req: Request):
        """Admission via a cached prefix row: only the per-request suffix is
        prefilled, RIGHT-padded to a bucket, on clones of the rows (the
        target's and the draft's); the padded tail's writes roll back via
        the length. The slot inherits the prefix row's LEFT-pad count."""
        b = self._bucket(len(req.prompt))
        r = len(req.prompt)
        pc, pd, pad = self._prefix_row(req.prefix)
        suffix = req.prompt + [0] * (b - r)
        logits, cache1 = self._prefill(suffix, pad, _clone(pc))
        dcache1 = None
        if pd is not None:
            _, dcache1 = self._prefill(suffix, pad, _clone(pd), draft=True)
        length = self._bucket(len(req.prefix)) + r
        return logits[:, r - 1], cache1, dcache1, pad, length

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
            if self.draft_cache is not None:
                self.draft_cache.length[s] = 0

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
        step = family_fns(self.cfg, pad_lens=self._pads,
                          shard=self.shard)[1]
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
        if self.draft_cfg is not None:
            return self._spec_advance(out, active_slots, active)
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

    @torch.no_grad()
    def _spec_advance(self, out, active_slots, active):
        """One speculative round for every slot (inactive ones as finished
        rows): 1..spec_k+1 tokens an active slot. Quota and eos truncation
        happen on the host; a truncated slot always finishes, so the device
        state that ran ahead of it goes with the slot."""
        step_t = family_fns(self.cfg, pad_lens=self._pads,
                            dropless_step=True, shard=self.shard)[1]
        step_d = family_fns(self.draft_cfg, pad_lens=self._pads,
                            shard=self.shard)[1]
        (emit_vec, _, emit_n, self._last, self.cache, self.draft_cache,
         verify_logits) = spec_round(
            step_t, step_d, self.params, self.draft_params, self._last,
            ~active, self.cache, self.draft_cache, self._generator,
            spec_k=self.spec_k, max_len=self.max_len,
            sampled=self.temperature > 0, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p)
        # tokens, emit counts and logprobs in one transfer: f64 holds the
        # int32 tokens and the f32 logprobs exactly
        parts = [emit_vec.double(), emit_n[:, None].double()]
        if self.return_logprobs:
            parts.append(torch.log_softmax(verify_logits, dim=-1).gather(
                2, emit_vec[..., None].long())[..., 0].double())
        host = torch.cat(parts, dim=1).tolist()   # the one host sync a step
        k1 = self.spec_k + 1
        for s in active_slots:
            slot = self._slot[s]
            req = slot.req
            row = host[s]
            new = [int(t) for t in row[:int(row[k1])]]
            new = new[:req.max_new_tokens - len(slot.emitted)]
            if req.eos_id is not None and req.eos_id in new:
                new = new[:new.index(req.eos_id) + 1]
            slot.emitted.extend(new)
            if self.return_logprobs:       # aligned with the kept tokens
                slot.lps.extend(row[k1 + 1:k1 + 1 + len(new)])
            if new:
                out.setdefault(req.req_id, []).extend(new)
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


def _clone(cache: KVCache) -> KVCache:
    return KVCache(*(t.clone() if isinstance(t, torch.Tensor) else t
                     for t in cache))


__all__ = ["ServeEngine", "Request", "DEFAULT_BUCKETS"]
