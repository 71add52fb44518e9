"""Mixtral-style sparse Mixture-of-Experts, on one device.

Twin of ``gpu_provisioner_tpu/models/moe.py``: the same ``MoEConfig``
fields and ``PRESETS_MOE``, the same parameter layout (``{"backbone": the
dense tree without its FFN, "moe": per-layer router and experts}``, stacked
``[L, ...]``), and the same GShard formulation: top-k routing builds a dense
one-hot dispatch tensor [B, S, E, C] (capacity C per expert, earlier
(token, choice) pairs claim slots first, overflow dropped) and the layer is
dispatch, the expert SwiGLU and the combine as einsums, at the reference's
rounding points (dispatch and the renormalised gates cast to the activation
dtype before their products). Deliberate differences:

- top-k is a stable descending sort: ``lax.top_k`` puts the lower index
  first among equal values and ``torch.topk`` promises no order, and equal
  router logits are real inputs (a zero hidden vector gives them);
- the slot one-hot is a comparison with ``arange(cap)`` under the
  in-capacity mask (``jax.nn.one_hot`` gives a zero row past ``cap``,
  ``F.one_hot`` raises);
- the router stays f32 in ``init_moe_model`` (the reference computes the
  router product in f32; a bf16 router would move near-tied gates);
- ``moe_ffn`` computes the aux losses (load balance, router z) only when
  asked: the serving path discards them, and eager torch would launch them
  anyway;
- an eager loop over the layers, ``cfg.remat`` as ``torch.utils.checkpoint``
  per block;
- ``make_moe_train_state`` and ``make_moe_train_step`` (f32 masters,
  ``models/train.py``'s in-place step over ``moe_loss_fn``), on one
  device or, with ``mesh=``, sharded: experts over ``expert`` and their
  inner width over ``model`` (``moe_param_specs``), the backbone as the
  dense model's, the batch over (slice, data, seq) and replicated over
  ``expert``. Each rank routes its whole batch block, dispatches it to
  its own experts only and sums the combine over the ``expert`` × ``model``
  group (``Shard.ffn``; the input's and the gates' cotangents summed
  there too, ``comm.copy_to_tp``): the function of the reference's
  all-to-all, by an all-reduce. Routing stays global as in the
  reference: the capacity is that of the global sequence, a rank's claim
  order starts from the claims of the sequence before its chunks in
  natural order (the per-chunk counts summed over ``seq``, the zigzag's
  two chunks too), and the load-balance term's two means are global (their
  sums all-reduced over the batch ranks, the term's gradient scaled by
  their number, ``comm.sum_over``, so the step's gradient mean counts it
  once).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel.comm import all_reduce_, copy_to_tp, reduce_from_tp, sum_over
from ..parallel.topology import AXIS_EXPERT, AXIS_MODEL
from .llama import (LlamaConfig, _block_attention_half, _embed, _logits,
                    _rmsnorm, init_params, layer_params, normal_init,
                    param_specs, resolve_attn)
from .train import (Shard, make_train_step, shard_params, train_state_from,
                    xent)


@dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2     # top-k routing (Mixtral: 2)
    capacity_factor: float = 1.25  # C = factor · k · S / E
    router_z_loss: float = 1e-3    # stabilizes router logits (ST-MoE)


PRESETS_MOE = {
    "tiny-moe": MoEConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, hidden_dim=128, max_seq_len=128,
                          n_experts=4, experts_per_token=2),
    "mixtral-ish": MoEConfig(dim=2048, n_layers=16, n_heads=16, n_kv_heads=8,
                             hidden_dim=5504, n_experts=8),
}


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    device=None, dtype: Optional[torch.dtype] = None) -> dict:
    """Per-layer MoE FFN params, stacked [L, ...], normal(0, fan_in^-1/2)
    drawn in f32 from ``generator`` on ``device`` (default cuda): experts
    stored in ``dtype`` (default cfg's activation dtype), the router in
    f32."""
    dev = resolve_device(device)
    norm = partial(normal_init, generator, dev,
                   dtype=cfg.act_dtype if dtype is None else dtype)
    L, D, F_, E = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.n_experts
    return {
        "router": norm((L, D, E), D, dtype=torch.float32),
        "w_gate": norm((L, E, D, F_), D),
        "w_up": norm((L, E, D, F_), D),
        "w_down": norm((L, E, F_, D), F_),
    }


def init_moe_model(cfg: MoEConfig, generator: torch.Generator, device=None,
                   dtype: Optional[torch.dtype] = None) -> dict:
    """Backbone (embedding, attention, norms, lm_head: init_params without
    the dense FFN) + MoE FFN params, on ``device`` (default cuda)."""
    dense = init_params(cfg, generator, device, dtype)
    for w in ("w_gate", "w_up", "w_down"):     # replaced by the experts
        del dense["blocks"][w]
    return {"backbone": dense,
            "moe": init_moe_params(cfg, generator, device, dtype)}


def moe_param_specs() -> dict:
    """The split dims of the MoE FFN's leaves (``train.split_axes``):
    experts over ``expert``, their inner width over ``model``; the router
    replicated."""
    return {"router": None,
            "w_gate": {AXIS_EXPERT: 1, AXIS_MODEL: 3},
            "w_up": {AXIS_EXPERT: 1, AXIS_MODEL: 3},
            "w_down": {AXIS_EXPERT: 1, AXIS_MODEL: 2}}


def moe_model_specs(cfg: MoEConfig) -> dict:
    """The whole MoE tree's: the backbone's as param_specs' (without the
    dense FFN), the experts' as moe_param_specs'."""
    dense = param_specs(cfg)
    for w in ("w_gate", "w_up", "w_down"):
        del dense["blocks"][w]
    return {"backbone": dense, "moe": moe_param_specs()}


def moe_layer(params: dict, layer: int) -> dict:
    """One layer's router and experts (views, no copy)."""
    return {k: v[layer] for k, v in params["moe"].items()}


def embed_table(params: dict) -> torch.Tensor:
    """The embedding, wherever the family keeps it."""
    return (params["backbone"] if "backbone" in params else params)["embed"]


def capacity(cfg: MoEConfig, seq_len: int) -> int:
    c = int(cfg.capacity_factor * cfg.experts_per_token * seq_len
            / cfg.n_experts)
    return max(1, c)


def _slots(logits, k: int, cap: int, token_mask=None, claims_before=None):
    """Top-k routing → (gates [B,S,k], onehot [B,S,k,E], slots
    [B,S,k,E,C]), f32: the renormalised gate values, each choice's expert
    and the capacity slot it claims (zero past capacity).
    ``claims_before(onehot)`` → [B, S, 1, E]: claims made before this
    block's tokens by tokens held elsewhere (a sharded sequence)."""
    B, S, E = logits.shape
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)                 # [B,S,E]
    # lax.top_k's order: among equal values the lower index first
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]             # [B,S,k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    onehot = (gate_idx[..., None] == torch.arange(E, device=dev)).float()
    if token_mask is not None:
        onehot = onehot * token_mask[:, :, None, None].float()
    flat = onehot.reshape(B, S * k, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, k, E)
    if claims_before is not None:
        pos = pos + claims_before(onehot)
    within = (pos < cap) & (onehot > 0)                           # [B,S,k,E]
    slots = ((pos.long()[..., None] == torch.arange(cap, device=dev))
             & within[..., None]).float()                         # [B,S,k,E,C]
    return gate_vals, onehot, slots


def _dispatch_combine(gates, onehot, slots):
    """(dispatch [B,S,E,C] one-hot, combine [B,S,E,C]) of _slots'
    output, the k choices folded."""
    dispatch = slots.sum(dim=2)
    combine = (slots * gates[..., None, None] * onehot[..., None]).sum(dim=2)
    return dispatch, combine


def route(logits, k: int, cap: int, token_mask=None):
    """Top-k routing → (dispatch [B,S,E,C] one-hot, combine [B,S,E,C]), f32.

    Position-in-expert by a cumulative sum over the flattened (s, k) choice
    order; choices past an expert's capacity are dropped. ``token_mask``
    [B, S] bool: False tokens (serving's left pads) claim no slot and get
    no output."""
    return _dispatch_combine(*_slots(logits, k, cap, token_mask))


def _claims_before(onehot, shard: Shard):
    """[B, S, 1, E]: for each token of this rank's block, the claims on each
    expert made in its row by the tokens of other ranks that come before it
    in natural order (and not already in the block's own cumsum). The block
    holds ``shard.chunks`` (natural indices, ascending); each chunk's
    counts are summed over ``seq`` into the row's counts of every chunk."""
    B, S, k, E = onehot.shape
    nc = len(shard.chunks)
    own = onehot.reshape(B, nc, S // nc * k, E).sum(dim=2)        # [B,nc,E]
    counts = own.new_zeros(B, shard.n_chunks, E)
    counts[:, list(shard.chunks)] = own
    all_reduce_(counts, shard.seq)
    before = (counts.cumsum(dim=1) - counts)[:, list(shard.chunks)]
    off = before - (own.cumsum(dim=1) - own)
    return off.repeat_interleave(S // nc, dim=1)[:, :, None, :]


def moe_ffn(x, lp: dict, cfg: MoEConfig, token_mask=None,
            cap_override: Optional[int] = None, aux: bool = False,
            shard: Optional[Shard] = None):
    """One MoE FFN layer: x [B, S, D] → (out [B, S, D], aux losses dict
    when ``aux``, else None). ``token_mask``: see route().
    ``cap_override=S`` makes the layer drop-free: top-k picks k distinct
    experts, so no expert receives more than S tokens, and each token's
    output is its own Σ gateᵢ·expertᵢ(x), as S single-token calls give.

    On a mesh (``shard``): ``x`` is the rank's batch block, ``lp``'s
    experts the rank's (``moe_param_specs``). The capacity is the global
    sequence's; claims continue those of the sequence before the block;
    the block goes to the rank's experts and the combine is summed over
    ``shard.ffn``; the load-balance means are the global batch's."""
    B, S, D = x.shape
    ad = cfg.act_dtype
    n_seq = 1 if shard is None else shard.n_seq
    cap = cap_override if cap_override is not None else capacity(cfg,
                                                                 S * n_seq)
    logits = x.float() @ lp["router"].float()
    claims = (partial(_claims_before, shard=shard)
              if shard is not None and shard.seq is not None else None)
    gates, onehot, slots = _slots(logits, cfg.experts_per_token, cap,
                                  token_mask, claims)
    claimed = slots.sum(dim=(2, 4)) if aux else None              # [B,S,E]
    ffn = None if shard is None else shard.ffn
    if ffn is not None:           # this rank's experts and inner columns
        n = lp["w_gate"].shape[0]
        mine = slice(shard.expert * n, (shard.expert + 1) * n)
        gates, x = copy_to_tp(gates, ffn), copy_to_tp(x, ffn)
        onehot, slots = onehot[..., mine], slots[..., mine, :]
    dispatch, combine = _dispatch_combine(gates, onehot, slots)
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(ad), x)
    h = F.silu(torch.einsum("ebcd,edf->ebcf", expert_in,
                            lp["w_gate"].to(ad)))
    h = h * torch.einsum("ebcd,edf->ebcf", expert_in, lp["w_up"].to(ad))
    expert_out = torch.einsum("ebcf,efd->ebcd", h, lp["w_down"].to(ad))
    out = torch.einsum("bsec,ebcd->bsd", combine.to(ad), expert_out)
    if ffn is not None:
        out = reduce_from_tp(out, ffn)
    if not aux:
        return out, None
    # load-balance aux loss (Switch §2.2) + router z-loss (ST-MoE)
    probs = torch.softmax(logits, dim=-1)
    sums = torch.cat([claimed.sum(dim=(0, 1)), probs.sum(dim=(0, 1))])
    tokens = B * S
    if shard is not None and shard.batch is not None:
        sums, tokens = sum_over(sums, shard.batch), tokens * shard.n_batch
    frac_tokens, frac_probs = (sums / tokens).chunk(2)            # [E] each
    lb_loss = cfg.n_experts * (frac_tokens * frac_probs).sum()
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return out, {"load_balance": lb_loss, "router_z": z_loss}


def moe_block(x, lp_dense: dict, lp_moe: dict, cfg: MoEConfig, positions,
              attn_fn, shard: Optional[Shard] = None):
    """Decoder block with the dense FFN swapped for the MoE FFN → (x, aux).
    ``shard``: the rank's place on a mesh (heads over ``model``, moe_ffn's
    sharding)."""
    tp = None if shard is None else shard.tp
    x = _block_attention_half(x, lp_dense, cfg, positions, attn_fn, tp)
    h = _rmsnorm(x, lp_dense["ln_mlp"], cfg.norm_eps)
    ffn_out, aux = moe_ffn(h, lp_moe, cfg, aux=True, shard=shard)
    return x + ffn_out, aux


def moe_forward(params: dict, tokens, cfg: MoEConfig,
                attn_fn: Optional[Callable] = None, positions=None,
                shard: Optional[Shard] = None):
    """Logits + mean aux losses. tokens: [B, S] → ([B, S, V] f32, aux
    dict). ``attn_fn`` defaults to dense attention, as in the reference;
    ``positions`` to arange(S); ``cfg.remat`` recomputes each block in the
    backward. On a mesh the params are the rank's shards (``shard``: the
    logits are its vocabulary columns)."""
    if attn_fn is None:
        attn_fn = resolve_attn("dense", cfg.sliding_window, cfg.attn_sinks)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    tp = None if shard is None else shard.tp
    backbone = params["backbone"]
    x = _embed(backbone, tokens, cfg, tp)
    auxes = []
    for layer in range(cfg.n_layers):
        args = (x, layer_params(backbone, layer), moe_layer(params, layer),
                cfg, positions, attn_fn, shard)
        if cfg.remat:
            x, aux = checkpoint(moe_block, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = moe_block(*args)
        auxes.append(aux)
    aux = {name: torch.stack([a[name] for a in auxes]).mean()
           for name in auxes[0]}
    return _logits(x, backbone, cfg, tp), aux


def moe_loss_fn(params, inputs, targets, cfg: MoEConfig, attn_fn=None,
                lb_coeff: float = 1e-2, positions=None,
                shard: Optional[Shard] = None):
    """Next-token cross entropy + lb_coeff · load balance + router_z_loss ·
    router z. inputs/targets: [B, S] int (pre-shifted); ``positions`` and
    ``shard`` as in moe_forward."""
    logits, aux = moe_forward(params, inputs, cfg, attn_fn, positions, shard)
    ce = xent(logits, targets, None if shard is None else shard.tp)
    return (ce + lb_coeff * aux["load_balance"]
            + cfg.router_z_loss * aux["router_z"])


def make_moe_train_state(cfg: MoEConfig, generator: torch.Generator,
                         device=None, optimizer: Optional[Callable] = None,
                         mesh=None):
    """(params, optimizer): f32 masters (``cfg.param_dtype``; the router is
    f32 either way) drawn from ``generator`` on ``device`` (default cuda),
    and ``optimizer`` (a callable on the leaves, default
    default_optimizer) over them. On a ``mesh`` every rank draws the whole
    tree and keeps its shards (``moe_model_specs``)."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for params on {dev}")
    params = init_moe_model(cfg, generator, dev,
                            dtype=getattr(torch, cfg.param_dtype))
    if mesh is not None:
        params = shard_params(params, mesh, specs=moe_model_specs(cfg))
    return train_state_from(params, optimizer)


def make_moe_train_step(cfg: MoEConfig, optimizer: torch.optim.Optimizer,
                        mesh=None):
    """step(params, inputs, targets) → loss: one forward and backward of
    moe_loss_fn with cfg's attention (``attn_impl="flash"``: the CUDA
    forward and backward kernels), then one optimizer step, in place; on a
    ``mesh``, make_train_step's sharded step over the rank's shards."""
    return make_train_step(cfg, optimizer, loss=moe_loss_fn, mesh=mesh)


__all__ = ["MoEConfig", "PRESETS_MOE", "capacity", "route", "moe_ffn",
           "moe_block", "init_moe_params", "init_moe_model", "moe_forward",
           "moe_loss_fn", "moe_param_specs", "moe_model_specs",
           "make_moe_train_state", "make_moe_train_step"]
