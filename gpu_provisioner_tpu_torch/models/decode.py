"""KV-cache inference: prefill, cached forward, sampling and generate.

Twin of ``gpu_provisioner_tpu/models/decode.py``: one cached forward
serves prefill (S tokens) and decode (S = 1), ``family_fns`` dispatches the
dense and the MoE family (``models/moe_serve.py``); the cache is
head-major ``[L, B, Hkv, max_len, Dh]`` with a length that is one int for
every row or a ``[B]`` tensor (per-row, as the serving engine's slots are);
ragged batches serve left-padded, pads masked out of attention and RoPE
counted from each row's first real token; an int8 cache stores per-token,
per-head f32 scales. Under ``attn_impl="flash"`` attention dispatches to
the decode kernel (short query blocks) or the cached-prefill kernel exactly
where the JAX package does, and to the dense masked sweep elsewhere.

Deliberate differences from the JAX module:

- **in-place cache update**: ``cached_forward`` writes the new keys and
  values into the cache tensors it is given (the JAX code returns a new
  cache from ``dynamic_update_slice``) and returns the same tensors with
  the new length; a caller that needs the old contents clones first;
- the fresh ``prefill`` writes into the (empty) cache it is given rather
  than building a padded one;
- an eager Python loop over layers and decode steps in place of
  ``lax.scan``/``jit``;
- ``torch.Generator`` in place of ``jax.random`` keys for sampling, drawn by
  Gumbel-max (sampled streams cannot match across the two RNGs);
- the two families share one attention half (``_attention_half``: norm,
  QKV, the cache write, int8 quantisation, ``_cached_attention``, wo), which
  ``models/moe_serve.py`` calls too, where the reference repeats it;
- ``family_step`` is eager (the reference's ``family_step_jit`` jits and
  donates the cache; here the cache is updated in place anyway);
- serving on a mesh is explicit, not a sharding of the arguments:
  ``generate(..., mesh=)`` takes this rank's shards of the params
  (``shard_params`` with ``param_specs`` or ``moe_model_specs``) and its
  (slice, data) block of the prompt, and returns its rows. A ``Shard``
  (``serve_shard``) threads through the cached forward: local heads and a
  cache of local kv heads (``kv_cache_specs``: dim 2 over ``model``, as
  the JAX specs), ``copy_to_tp`` before and ``reduce_from_tp`` after each
  row-parallel product, the vocabulary-parallel embedding, and the
  vocabulary columns of the logits gathered (``comm.gather_from_tp``), so
  that every rank of the ``model`` group picks from the same full row and
  its next collectives pair. ``seq`` and ``pipe`` > 1 are refused (the
  JAX package serves on neither). Without a mesh the code is the
  single-device path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..device import resolve_device
from ..ops.flash_attention import (_start_vector, cached_flash_supported,
                                   decode_flash_supported,
                                   flash_attention_cached,
                                   flash_attention_decode)
from ..parallel.comm import TPGroup, gather_from_tp, reduce_from_tp
from ..parallel.topology import AXIS_PIPE, AXIS_SEQ, axis_sizes
from .llama import (LlamaConfig, _embed, _logits, _mlp_half, _project_qkv,
                    _rmsnorm, _tp_heads, init_params, layer_params,
                    param_specs, resolve_attn as _resolve_attn)
from .moe import MoEConfig, embed_table, init_moe_model, moe_model_specs
from .train import Shard, check_heads, mesh_shard, shard_params, tp_group

NEG_INF = -1.0e30


class KVCache(NamedTuple):
    k: torch.Tensor     # [L, B, Hkv, max_len, Dh] head-major
    v: torch.Tensor     # [L, B, Hkv, max_len, Dh]
    length: Union[int, torch.Tensor]   # tokens written: int, or [B] int32
    # int8 mode only: per-token-per-head scales [L, B, Hkv, max_len, 1] f32
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def _kv_int8(cfg: LlamaConfig) -> bool:
    """Validated kv_cache_dtype dispatch: unknown values raise."""
    if cfg.kv_cache_dtype not in ("auto", "int8"):
        raise ValueError(f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r}; "
                         "expected 'auto'|'int8'")
    return cfg.kv_cache_dtype == "int8"


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  device=None, shard: Optional[Shard] = None) -> KVCache:
    """Zeroed cache on ``device`` (default cuda) per cfg.kv_cache_dtype:
    "auto" stores the act dtype, "int8" int8 values plus f32 scales. With
    ``shard`` it holds this rank's kv heads (n_kv_heads / model), allocated
    at that shape (``kv_cache_specs``)."""
    dev = resolve_device(device)
    tp = _tp(shard)
    hkv = cfg.n_kv_heads // (1 if tp is None else tp.size)
    shape = (cfg.n_layers, batch, hkv, max_len, cfg.head_dim)
    if _kv_int8(cfg):
        sshape = shape[:-1] + (1,)
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=dev),
                       v=torch.zeros(shape, dtype=torch.int8, device=dev),
                       length=0,
                       k_scale=torch.zeros(sshape, device=dev),
                       v_scale=torch.zeros(sshape, device=dev))
    return KVCache(k=torch.zeros(shape, dtype=cfg.act_dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.act_dtype, device=dev),
                   length=0)


def kv_cache_specs(cfg: LlamaConfig) -> KVCache:
    """The dim of each cache leaf split over ``model`` (``param_specs``'
    format; None: replicated), the twin of the JAX ``kv_cache_specs``: kv
    heads (dim 2 of [L, B, Hkv, max_len, Dh], the int8 scales' too), as
    the attention weights' columns are cut; the length replicated."""
    if _kv_int8(cfg):
        return KVCache(k=2, v=2, length=None, k_scale=2, v_scale=2)
    return KVCache(k=2, v=2, length=None)


def _tp(shard: Optional[Shard]) -> Optional[TPGroup]:
    return None if shard is None else shard.tp


def _check_shards(params: dict, cfg: LlamaConfig, mesh) -> None:
    """Raises ValueError unless every leaf of ``params`` has the shape of
    this rank's shard of cfg's tree on ``mesh`` (computed on ``meta``)."""
    if isinstance(cfg, MoEConfig):
        whole, specs = init_moe_model(cfg, None, "meta"), moe_model_specs(cfg)
    else:
        whole, specs = init_params(cfg, None, "meta"), param_specs(cfg)
    want = shard_params(whole, mesh, specs=specs)

    def walk(got, want, name):
        if isinstance(want, dict):
            if not isinstance(got, dict) or got.keys() != want.keys():
                raise ValueError(f"params{name} are not {type(cfg).__name__}"
                                 f"'s tree: keys {sorted(got)}")
            for k in want:
                walk(got[k], want[k], f"{name}[{k!r}]")
        elif tuple(got.shape) != tuple(want.shape):
            raise ValueError(
                f"params{name} is {tuple(got.shape)}, this rank's shard on "
                f"{axis_sizes(mesh)} is {tuple(want.shape)}: pass "
                "shard_params' shards of the whole tree")

    walk(params, want, "")


def serve_shard(mesh, dev: torch.device, *models) -> Optional[Shard]:
    """This rank's ``Shard`` for serving ``models`` ((params, cfg) pairs,
    all on the same mesh) on ``mesh``; None without a mesh. Refuses, with
    ValueError and before any collective: ``seq`` or ``pipe`` > 1, a
    ``model`` size that does not divide a model's heads (``mesh_shard``'s
    error), params that are not this rank's shards. Then builds the
    shard's groups collectively: every rank calls this alike."""
    if mesh is None:
        return None
    if mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for serving on {dev}")
    sizes = axis_sizes(mesh)
    for axis in (AXIS_SEQ, AXIS_PIPE):
        if sizes[axis] > 1:
            raise ValueError(
                f"serving on a mesh with {axis} = {sizes[axis]}: the port, "
                "as the JAX package, serves over slice, data, expert and "
                "model only")
    tp = tp_group(mesh)
    for params, cfg in models:
        check_heads(cfg, tp)
        _check_shards(params, cfg, mesh)
    return mesh_shard(mesh, models[0][1])


def _quantize_kv(x):
    """Per-token-per-head symmetric int8: [..., Dh] → (int8 values, f32
    scales [..., 1]). torch.round, like jnp.round, rounds half to even."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scl = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scl), -127, 127).to(torch.int8)
    return q, scl


def _is_per_row(start) -> bool:
    return isinstance(start, torch.Tensor) and start.ndim == 1


def _cached_attention(q, k_cache, v_cache, start, scale, impl="dense",
                      pad_lens=None, k_scale=None, v_scale=None,
                      window=None, sinks=0):
    """q [B, S, Hq, Dh] against one layer's head-major cache [B, Hkv,
    max_len, Dh]: key p is attendable iff p <= start + query index, with
    pads, window and sinks. ``impl="flash"`` takes the decode kernel for
    short blocks and the cached kernel for tiling prefill blocks at a
    scalar start; everything else is the dense masked sweep, whose
    pad-QUERY rows are a uniform V-average (the kernels emit zero there;
    only real positions are read)."""
    B, S, Hq, Dh = q.shape
    Hkv, max_len = k_cache.shape[1], k_cache.shape[2]
    kw = dict(scale=scale, k_scale=k_scale, v_scale=v_scale,
              pad_lens=pad_lens, window=window, sinks=sinks)
    if impl == "flash":
        if decode_flash_supported(max_len, Hq, Hkv, S=S):
            return flash_attention_decode(q, k_cache, v_cache, start, **kw)
        if not _is_per_row(start) and cached_flash_supported(
                S, max_len, Hq, Hkv):
            return flash_attention_cached(q, k_cache, v_cache, start, **kw)
    kf = k_cache.float()
    vf = v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale
        vf = vf * v_scale
    group = Hq // Hkv
    qg = q.reshape(B, S, Hkv, group, Dh)
    s = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(), kf) * scale
    key_pos = torch.arange(max_len, device=q.device)[None, None, :]  # [1,1,K]
    q_pos = (_start_vector(start, B, q.device)[:, None]
             + torch.arange(S, device=q.device))[:, :, None]      # [B,S,1]
    mask = key_pos <= q_pos                                        # [B,S,K]
    if window is not None:
        in_win = key_pos > q_pos - window
        if sinks and pad_lens is None:
            in_win = in_win | (key_pos < sinks)
        mask = mask & in_win
    if pad_lens is not None:
        pads = pad_lens.long()[:, None, None]
        live = key_pos >= pads
        mask = mask & live
        if window is not None and sinks:
            sink = key_pos < pads + sinks
            mask = mask | ((key_pos <= q_pos) & live & sink)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bqhgd", p, vf)
    return o.reshape(B, S, Hq, Dh).to(q.dtype)


def _writer(start, S: int, max_len: int, B: int, device):
    """write(buf, new): new tokens [B, S, H, D'] into the head-major buffer
    [B, H, max_len, D'] at each row's offset, in place. The offset is
    clamped to [0, max_len - S], as lax.dynamic_update_slice clamps, so a
    parked row's write stays in bounds."""
    if _is_per_row(start):
        w0 = torch.clamp(start.long(), 0, max_len - S)
        rows = torch.arange(B, device=device)[:, None]
        cols = w0[:, None] + torch.arange(S, device=device)       # [B, S]

        def write(buf, new):
            buf[rows, :, cols] = new     # advanced dims first: [B, S, H, D']
        return write
    w0 = min(max(int(start), 0), max_len - S)

    def write(buf, new):
        buf[:, :, w0:w0 + S] = new.transpose(1, 2)
    return write


def _cached_setup(tokens, cache: KVCache, cfg: LlamaConfig, pad_lens):
    """The cached forward's preamble, shared by both families → (positions,
    token_mask, write). RoPE positions count from each row's first real
    token ([S], or [B, S] with per-row lengths or pads; pad positions clip
    to 0); ``token_mask`` [B, S] marks the real tokens (None without pads),
    taken before the clip; ``write`` stores new keys and values in place."""
    _resolve_attn(cfg.attn_impl, cfg.sliding_window, cfg.attn_sinks)
    B, S = tokens.shape
    dev = tokens.device
    start = cache.length
    per_row = _is_per_row(start)
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    positions = (start.to(torch.int32)[:, None] + ar) if per_row else ar + start
    token_mask = None
    if pad_lens is not None:
        if not per_row:
            positions = positions[None, :]
        token_mask = positions >= pad_lens[:, None]
        positions = torch.clamp(positions - pad_lens[:, None], min=0)
    if _kv_int8(cfg) != (cache.k_scale is not None):
        raise ValueError(
            f"kv_cache_dtype={cfg.kv_cache_dtype!r} but the cache was "
            f"built {'WITH' if cache.k_scale is not None else 'without'} "
            "int8 scales — cfg and init_kv_cache(cfg, ...) must agree")
    return positions, token_mask, _writer(start, S, cache.k.shape[3], B, dev)


def _attention_half(x, lp, layer: int, cache: KVCache, cfg: LlamaConfig,
                    positions, write, pad_lens, tp: Optional[TPGroup] = None):
    """Norm → QKV → rope → this layer's cache write (int8 quantised under
    kv_cache_dtype="int8") → attention over the cache → wo → residual:
    the attention half of every family's cached forward. With ``tp`` the
    rank's heads, its cache's kv heads, and wo's sum over the group."""
    B, S, _ = x.shape
    a, heads = _tp_heads(_rmsnorm(x, lp["ln_attn"], cfg.norm_eps), cfg, tp)
    q, k, v = _project_qkv(a, lp, cfg, positions, heads)
    k_cache, v_cache = cache.k[layer], cache.v[layer]
    k_scl = v_scl = None
    if cache.k_scale is not None:
        kq, ks_ = _quantize_kv(k)
        vq, vs_ = _quantize_kv(v)
        k_scl, v_scl = cache.k_scale[layer], cache.v_scale[layer]
        write(k_cache, kq)
        write(v_cache, vq)
        write(k_scl, ks_)
        write(v_scl, vs_)
    else:
        write(k_cache, k)
        write(v_cache, v)
    o = _cached_attention(q, k_cache, v_cache, cache.length,
                          cfg.head_dim ** -0.5, impl=cfg.attn_impl,
                          pad_lens=pad_lens, k_scale=k_scl, v_scale=v_scl,
                          window=cfg.sliding_window, sinks=cfg.attn_sinks)
    out = o.reshape(B, S, q.shape[2] * cfg.head_dim) \
        @ lp["wo"].to(cfg.act_dtype)
    return x + (out if tp is None else reduce_from_tp(out, tp))


def full_logits(x, params: dict, cfg: LlamaConfig,
                tp: Optional[TPGroup] = None):
    """The f32 logits [B, S, V]: with ``tp`` every rank's vocabulary
    columns gathered, the same full rows on every rank of the group."""
    logits = _logits(x, params, cfg, tp)
    return logits if tp is None else gather_from_tp(logits, tp)


@torch.no_grad()
def cached_forward(params: dict, tokens, cache: KVCache, cfg: LlamaConfig,
                   pad_lens=None, shard: Optional[Shard] = None):
    """Forward over ``tokens`` [B, S] starting at cache.length; returns
    (logits [B, S, V] f32, cache). The cache tensors are updated IN PLACE
    and come back with length + S.

    ``pad_lens`` [B]: left-pad counts for ragged batches (keys below are
    masked; RoPE positions count from the first real token, pad positions
    clip to 0). Precondition, owned by the caller: length + S <= max_len.
    ``shard`` (``serve_shard``): the params, the cache's kv heads are this
    rank's; the logits come back whole on every rank."""
    positions, _, write = _cached_setup(tokens, cache, cfg, pad_lens)
    tp = _tp(shard)
    x = _embed(params, tokens, cfg, tp)
    for layer in range(cfg.n_layers):
        lp = layer_params(params, layer)
        x = _attention_half(x, lp, layer, cache, cfg, positions, write,
                            pad_lens, tp)
        x = _mlp_half(x, lp, cfg, tp)
    return (full_logits(x, params, cfg, tp),
            cache._replace(length=cache.length + tokens.shape[1]))


@torch.no_grad()
def _prefill_forward(params: dict, tokens, cache: KVCache, cfg: LlamaConfig,
                     shard: Optional[Shard] = None):
    """Prefill of an EMPTY cache: plain causal self-attention over the
    prompt (flash-kernel eligible via cfg.attn_impl) instead of the S×max_len
    cached sweep; each layer's k/v is stored once at offset 0 (int8
    quantisation at the store, so the prompt attended full-precision k/v)."""
    if cfg.sliding_window is not None:
        raise ValueError("the fresh fast path has no window mask — prefill() "
                         "routes sliding-window configs to cached_forward")
    ad = cfg.act_dtype
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    attn = _resolve_attn(cfg.attn_impl)
    int8 = _kv_int8(cfg)
    tp = _tp(shard)

    x = _embed(params, tokens, cfg, tp)
    for layer in range(cfg.n_layers):
        lp = layer_params(params, layer)
        a, heads = _tp_heads(_rmsnorm(x, lp["ln_attn"], cfg.norm_eps), cfg,
                             tp)
        q, k, v = _project_qkv(a, lp, cfg, positions, heads)
        o = attn(q, k, v)
        out = o.reshape(B, S, q.shape[2] * cfg.head_dim) @ lp["wo"].to(ad)
        x = x + (out if tp is None else reduce_from_tp(out, tp))
        x = _mlp_half(x, lp, cfg, tp)
        if int8:
            kq, kscl = _quantize_kv(k)
            vq, vscl = _quantize_kv(v)
            cache.k[layer, :, :, :S] = kq.transpose(1, 2)
            cache.v[layer, :, :, :S] = vq.transpose(1, 2)
            cache.k_scale[layer, :, :, :S] = kscl.transpose(1, 2)
            cache.v_scale[layer, :, :, :S] = vscl.transpose(1, 2)
        else:
            cache.k[layer, :, :, :S] = k.transpose(1, 2)
            cache.v[layer, :, :, :S] = v.transpose(1, 2)
    return full_logits(x, params, cfg, tp), cache._replace(length=S)


def prefill(params: dict, prompt, cache: KVCache, cfg: LlamaConfig, *,
            fresh: bool = False, pad_lens=None,
            shard: Optional[Shard] = None):
    """(last-token logits [B, V], cache) after consuming the prompt.
    ``fresh=True`` (an empty cache) takes the self-attention fast path;
    otherwise the general cached forward runs. ``pad_lens`` needs
    fresh=False; a sliding window always takes the general path.
    ``shard``: as cached_forward's."""
    if cfg.sliding_window is not None:
        fresh = False
    if fresh:
        if pad_lens is not None:
            raise ValueError("pad_lens requires fresh=False — the fresh "
                             "fast path cannot mask pad keys")
        logits, cache = _prefill_forward(params, prompt, cache, cfg, shard)
    else:
        logits, cache = cached_forward(params, prompt, cache, cfg,
                                       pad_lens=pad_lens, shard=shard)
    return logits[:, -1], cache


def prefill_chunked(params: dict, prompt, cache: KVCache, cfg: LlamaConfig,
                    *, chunk: int = 2048, pad_lens=None,
                    shard: Optional[Shard] = None):
    """(last-token logits [B, V], cache) after consuming the prompt in
    ``chunk``-sized pieces through the family's cached forward, so peak
    activation memory is O(chunk·S) for very long prompts; each piece still
    takes the cached flash kernel. Dense family: the same function as one
    cached forward over the whole prompt (each chunk attends to everything
    written before it plus its own causal prefix). MoE family: expert
    capacity is computed per chunk and tokens compete for expert slots only
    within their chunk; where neither drops, the two agree. The cache is
    updated in place, as cached_forward's is. ``shard``: as
    cached_forward's."""
    B, S = prompt.shape
    if S == 0 or chunk <= 0:
        raise ValueError(f"need a non-empty prompt (S={S}) and a positive "
                         f"chunk ({chunk})")
    step = family_step(cfg)
    logits = None
    for off in range(0, S, chunk):
        logits, cache = step(params, prompt[:, off:off + chunk], cache, cfg,
                             pad_lens=pad_lens, shard=shard)
    return logits[:, -1], cache


def family_fns(cfg, pad_lens=None, fresh: bool = False,
               dropless_step: bool = False, shard: Optional[Shard] = None):
    """(prefill_fn, step_fn), each (params, tokens, cache) → (logits,
    cache), dispatched on the config's model family: the one dispatch point
    generate() and the engine share. ``fresh``: the dense family's fast
    path for an empty cache (MoE has none and ignores it).
    ``dropless_step``: MoE only — step_fn routes with capacity = its block
    width, so a multi-token step cannot capacity-drop and its logits equal
    single-token steps' (a no-op for the dense family). ``shard``: this
    rank's place on a serving mesh (``serve_shard``), passed to both."""
    step = family_step(cfg)
    if isinstance(cfg, MoEConfig):
        from .moe_serve import moe_prefill
        return (lambda p, t, c: moe_prefill(p, t, c, cfg,
                                            pad_lens=pad_lens, shard=shard),
                lambda p, t, c: step(p, t, c, cfg, pad_lens=pad_lens,
                                     dropless=dropless_step, shard=shard))
    return (lambda p, t, c: prefill(p, t, c, cfg, fresh=fresh,
                                    pad_lens=pad_lens, shard=shard),
            lambda p, t, c: step(p, t, c, cfg, pad_lens=pad_lens,
                                 shard=shard))


def family_step(cfg):
    """The family's cached forward, (params, tokens, cache, cfg, pad_lens=,
    shard=) → (logits, cache): prefill_chunked's step, the eager twin of
    the reference's family_step_jit. Families other than dense Llama and
    MoE raise."""
    if isinstance(cfg, MoEConfig):
        from .moe_serve import moe_cached_forward
        return moe_cached_forward
    if type(cfg) is not LlamaConfig:
        raise NotImplementedError(
            f"{type(cfg).__name__}: the port serves the dense Llama and the "
            "MoE families")
    return cached_forward


def filter_logits(logits, temperature: float, top_k, top_p):
    """The serving sampling distribution: temperature → top-k → top-p."""
    logits = logits / temperature
    if top_k is not None:
        logits = _filter_top_k(logits, top_k)
    if top_p is not None:
        logits = _filter_top_p(logits, top_p)
    return logits


def validate_sampling_args(temperature: float, top_k, top_p,
                           generator) -> None:
    """Shared loud validation for every sampling entry point."""
    if temperature > 0 and generator is None:
        raise ValueError(
            "sampling (temperature>0) requires an explicit torch.Generator "
            "— sampling without one would be silently irreproducible")
    if top_k is not None and not 0 < top_k:
        raise ValueError(f"top_k must be positive, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _filter_top_k(logits, top_k: int):
    """Keep the k highest logits per row (ties with the k-th kept)."""
    vals = torch.topk(logits, top_k, dim=-1).values
    return torch.where(logits >= vals[..., -1:], logits, NEG_INF)


def _filter_top_p(logits, top_p: float):
    """Nucleus filter: the smallest set of tokens whose mass reaches top_p
    (at least one: the exclusive cumsum keeps the top token)."""
    probs = torch.softmax(logits, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    exclusive_csum = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    keep = exclusive_csum < top_p
    thresh = torch.where(keep, sorted_probs, 2.0).amin(dim=-1, keepdim=True)
    return torch.where(probs >= thresh, logits, NEG_INF)


def sample(logits, generator: torch.Generator):
    """One draw per row from softmax(logits), by Gumbel-max with noise from
    ``generator`` (NEG_INF logits are never drawn)."""
    e = torch.empty(logits.shape, dtype=torch.float32, device=logits.device)
    e.exponential_(generator=generator)
    return torch.argmax(logits - torch.log(e), dim=-1)


def pick(logits, temperature: float, top_k, top_p, generator,
         return_logprobs: bool):
    """(token int32 [B], log-prob [B] under the sampling distribution —
    greedy reports the unfiltered one; zeros when not asked for)."""
    if temperature > 0:
        dist = filter_logits(logits, temperature, top_k, top_p)
        tok = sample(dist, generator)
    else:
        dist = logits
        tok = torch.argmax(logits, dim=-1)
    if return_logprobs:
        lp = torch.log_softmax(dist, dim=-1).gather(-1, tok[:, None])[:, 0]
    else:
        lp = torch.zeros(tok.shape, device=tok.device)
    return tok.to(torch.int32), lp


@torch.no_grad()
def generate(params: dict, prompt, cfg: LlamaConfig, *, max_new_tokens: int,
             max_len: int = None, temperature: float = 0.0,
             top_k: int = None, top_p: float = None,
             generator: torch.Generator = None, pad_id: int = None,
             eos_id: int = None, return_logprobs: bool = False, device=None,
             mesh=None):
    """Autoregressive generation: prefill, then a loop of decode steps.
    prompt: [B, S0] int → [B, max_new_tokens] int32, on ``device`` (default
    cuda; the params must live there).

    ``mesh`` (``make_mesh``; every rank calls alike): ``params`` are this
    rank's shards (``shard_params`` with ``param_specs`` or
    ``moe_model_specs``), ``prompt`` its (slice, data) block of the batch
    (``batch_block``), and the rows returned its own (``serve_shard``'s
    refusals). Sampling needs the same seeded ``generator`` on every rank
    of a ``model`` group.

    temperature 0 = greedy (top_k/top_p ignored); temperature > 0 samples
    with ``generator``, which is then required. ``pad_id``: LEFT-padded
    ragged prompts (every row needs a real token). ``eos_id``: a row that
    emits it is finished and repeats eos_id from then on.
    ``return_logprobs``: also each token's log-probability under the
    sampling distribution ([B, max_new_tokens] f32; forced eos reports 0)."""
    dev = resolve_device(device)
    if embed_table(params).device != dev:
        raise ValueError(f"params on {embed_table(params).device}, generate "
                         f"on {dev}")
    prompt = torch.as_tensor(prompt, device=dev)
    B, S0 = prompt.shape
    if max_len is None:
        max_len = S0 + max_new_tokens
    if S0 + max_new_tokens > max_len:
        raise ValueError(f"prompt {S0} + {max_new_tokens} new tokens > "
                         f"max_len {max_len}")
    validate_sampling_args(temperature, top_k, top_p, generator)
    shard = serve_shard(mesh, dev, (params, cfg))

    pad_lens = None
    if pad_id is not None:
        # leading-pad count per row == index of the first real token
        pad_lens = torch.argmax((prompt != pad_id).to(torch.int32),
                                dim=1).to(torch.int32)

    prefill_fn, step_fn = family_fns(cfg, pad_lens=pad_lens,
                                     fresh=pad_id is None, shard=shard)
    cache = init_kv_cache(cfg, B, max_len, dev, shard=shard)
    logits, cache = prefill_fn(params, prompt, cache)
    args = (temperature, top_k, top_p, generator, return_logprobs)
    tok, lp = pick(logits, *args)
    done = (tok == eos_id) if eos_id is not None else None
    toks, lps = [tok], [lp]
    for _ in range(max_new_tokens - 1):
        logits, cache = step_fn(params, tok[:, None], cache)
        tok, lp = pick(logits[:, 0], *args)
        if eos_id is not None:
            tok = torch.where(done, eos_id, tok).to(torch.int32)
            lp = torch.where(done, 0.0, lp)     # forced eos: not a draw
            done = done | (tok == eos_id)
        toks.append(tok)
        lps.append(lp)
    out = torch.stack(toks, dim=1)
    if not return_logprobs:
        return out
    return out, torch.stack(lps, dim=1)
