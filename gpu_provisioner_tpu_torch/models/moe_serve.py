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
"""

from __future__ import annotations

import torch

from .decode import KVCache, _attention_half, _cached_setup
from .llama import _logits, _rmsnorm, layer_params
from .moe import MoEConfig, moe_ffn, moe_layer


@torch.no_grad()
def moe_cached_forward(params: dict, tokens, cache: KVCache, cfg: MoEConfig,
                       pad_lens=None, dropless: bool = False):
    """Forward over ``tokens`` [B, S] starting at cache.length; returns
    (logits [B, S, V] f32, cache with length + S), the cache updated in
    place. The MoE twin of decode.cached_forward — the same cache contract
    and pad_lens semantics, params in init_moe_model's layout.

    ``dropless=True``: route with capacity = S, so an S-token block's
    logits equal S single-token calls' (speculative decoding's verify
    block); prefill keeps training's capacity."""
    positions, token_mask, write = _cached_setup(tokens, cache, cfg,
                                                 pad_lens)
    S = tokens.shape[1]
    backbone = params["backbone"]
    x = backbone["embed"][tokens].to(cfg.act_dtype)
    for layer in range(cfg.n_layers):
        lp = layer_params(backbone, layer)
        x = _attention_half(x, lp, layer, cache, cfg, positions, write,
                            pad_lens)
        h = _rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
        # pad positions claim no expert capacity (they sit first in the
        # claim order and would evict real tokens) and emit no output
        ffn_out, _ = moe_ffn(h, moe_layer(params, layer), cfg,
                             token_mask=token_mask,
                             cap_override=S if dropless else None)
        x = x + ffn_out
    return _logits(x, backbone, cfg), cache._replace(length=cache.length + S)


def moe_prefill(params: dict, prompt, cache: KVCache, cfg: MoEConfig, *,
                pad_lens=None):
    """(last-token logits [B, V], cache) after consuming the prompt: always
    the cached forward (the MoE family has no fresh-cache fast path)."""
    logits, cache = moe_cached_forward(params, prompt, cache, cfg,
                                       pad_lens=pad_lens)
    return logits[:, -1], cache


__all__ = ["moe_cached_forward", "moe_prefill"]
