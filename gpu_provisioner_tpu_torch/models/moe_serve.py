"""KV-cache serving for the MoE family: ``models/decode.py``'s twin over
``models/moe.py``.

Twin of ``gpu_provisioner_tpu/models/moe_serve.py``. The attention half is
the dense family's own (``decode._attention_half``: the same KVCache,
head-major layout, int8 cache and ``_cached_attention`` dispatch to the
cached-prefill and decode kernels); only the FFN half differs: each layer
routes through its experts with ``moe_ffn``. Routing at serving time:

- prefill routes as ``moe_forward`` does over the same tokens (capacity
  from the prompt length, earlier tokens claim expert slots first), with
  the left pads masked out of the claim order (``token_mask``);
- a decode step routes its one token with capacity(cfg, 1) ≥ 1 slot per
  expert and top-k picks k distinct experts, so a generated token is never
  dropped; ``dropless=True`` extends that to an S-token block.

The aux losses are not computed (the reference computes and discards
them). The cache is updated in place, as ``decode.cached_forward``'s is.

On a serving mesh (``shard``, ``decode.serve_shard``: ``expert`` and
``expert`` × ``model``, the batch over (slice, data)) the attention heads
go over ``model`` as in the dense family, and the FFN goes through
``moe_ffn(..., shard=)``: the batch replicated over ``expert``, each rank
dispatching its block to its own experts (and inner columns), the combine
summed over ``Shard.ffn``, as the training step does (an all-reduce in
place of the reference's all-to-all). Routing is the single-device one:
the claim order, the pads' mask and the dropless block are unchanged.
"""

from __future__ import annotations

import torch

from typing import Optional

from .decode import KVCache, _attention_half, _cached_setup, _tp, full_logits
from .llama import _embed, _rmsnorm, layer_params
from .moe import MoEConfig, moe_ffn, moe_layer
from .train import Shard


@torch.no_grad()
def moe_cached_forward(params: dict, tokens, cache: KVCache, cfg: MoEConfig,
                       pad_lens=None, dropless: bool = False,
                       shard: Optional[Shard] = None):
    """Forward over ``tokens`` [B, S] starting at cache.length; returns
    (logits [B, S, V] f32, cache with length + S), the cache updated in
    place. The MoE twin of decode.cached_forward — the same cache contract
    and pad_lens semantics, params in init_moe_model's layout.

    ``dropless=True``: route with capacity = S, so an S-token block's
    logits equal S single-token calls' (speculative decoding's verify
    block); prefill keeps training's capacity. ``shard``: this rank's
    place on a serving mesh (the module's doc); the logits come back whole
    on every rank."""
    positions, token_mask, write = _cached_setup(tokens, cache, cfg,
                                                 pad_lens)
    S = tokens.shape[1]
    tp = _tp(shard)
    backbone = params["backbone"]
    x = _embed(backbone, tokens, cfg, tp)
    for layer in range(cfg.n_layers):
        lp = layer_params(backbone, layer)
        x = _attention_half(x, lp, layer, cache, cfg, positions, write,
                            pad_lens, tp)
        h = _rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
        # pad positions claim no expert capacity (they sit first in the
        # claim order and would evict real tokens) and emit no output
        ffn_out, _ = moe_ffn(h, moe_layer(params, layer), cfg,
                             token_mask=token_mask,
                             cap_override=S if dropless else None,
                             shard=shard)
        x = x + ffn_out
    return (full_logits(x, backbone, cfg, tp),
            cache._replace(length=cache.length + S))


def moe_prefill(params: dict, prompt, cache: KVCache, cfg: MoEConfig, *,
                pad_lens=None, shard: Optional[Shard] = None):
    """(last-token logits [B, V], cache) after consuming the prompt: always
    the cached forward (the MoE family has no fresh-cache fast path)."""
    logits, cache = moe_cached_forward(params, prompt, cache, cfg,
                                       pad_lens=pad_lens, shard=shard)
    return logits[:, -1], cache


__all__ = ["moe_cached_forward", "moe_prefill"]
