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
- ``make_moe_train_state`` and ``make_moe_train_step`` are the
  single-device twins (f32 masters, ``models/train.py``'s in-place step
  over ``moe_loss_fn``); ``moe_param_specs``/``moe_model_specs`` and the
  expert-parallel step are not ported yet (the dense step's data,
  sequence and tensor parallelism are, ``models/train.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .llama import (LlamaConfig, _block_attention_half, _logits, _rmsnorm,
                    init_params, layer_params, normal_init, resolve_attn)
from .train import make_train_step, train_state_from


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


def route(logits, k: int, cap: int, token_mask=None):
    """Top-k routing → (dispatch [B,S,E,C] one-hot, combine [B,S,E,C]), f32.

    Position-in-expert by a cumulative sum over the flattened (s, k) choice
    order; choices past an expert's capacity are dropped. ``token_mask``
    [B, S] bool: False tokens (serving's left pads) claim no slot and get
    no output."""
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
    within = (pos < cap) & (onehot > 0)                           # [B,S,k,E]
    pos_oh = ((pos.long()[..., None] == torch.arange(cap, device=dev))
              & within[..., None]).float()                        # [B,S,k,E,C]
    dispatch = pos_oh.sum(dim=2)                                  # [B,S,E,C]
    combine = (pos_oh * gate_vals[..., None, None]
               * onehot[..., None]).sum(dim=2)
    return dispatch, combine


def moe_ffn(x, lp: dict, cfg: MoEConfig, token_mask=None,
            cap_override: Optional[int] = None, aux: bool = False):
    """One MoE FFN layer: x [B, S, D] → (out [B, S, D], aux losses dict
    when ``aux``, else None). ``token_mask``: see route().
    ``cap_override=S`` makes the layer drop-free: top-k picks k distinct
    experts, so no expert receives more than S tokens, and each token's
    output is its own Σ gateᵢ·expertᵢ(x), as S single-token calls give."""
    B, S, D = x.shape
    ad = cfg.act_dtype
    cap = cap_override if cap_override is not None else capacity(cfg, S)
    logits = x.float() @ lp["router"].float()
    dispatch, combine = route(logits, cfg.experts_per_token, cap,
                              token_mask=token_mask)
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(ad), x)
    h = F.silu(torch.einsum("ebcd,edf->ebcf", expert_in,
                            lp["w_gate"].to(ad)))
    h = h * torch.einsum("ebcd,edf->ebcf", expert_in, lp["w_up"].to(ad))
    expert_out = torch.einsum("ebcf,efd->ebcd", h, lp["w_down"].to(ad))
    out = torch.einsum("bsec,ebcd->bsd", combine.to(ad), expert_out)
    if not aux:
        return out, None
    # load-balance aux loss (Switch §2.2) + router z-loss (ST-MoE)
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = dispatch.sum(dim=-1).mean(dim=(0, 1))           # [E]
    frac_probs = probs.mean(dim=(0, 1))                           # [E]
    lb_loss = cfg.n_experts * (frac_tokens * frac_probs).sum()
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return out, {"load_balance": lb_loss, "router_z": z_loss}


def moe_block(x, lp_dense: dict, lp_moe: dict, cfg: MoEConfig, positions,
              attn_fn):
    """Decoder block with the dense FFN swapped for the MoE FFN → (x, aux)."""
    x = _block_attention_half(x, lp_dense, cfg, positions, attn_fn)
    h = _rmsnorm(x, lp_dense["ln_mlp"], cfg.norm_eps)
    ffn_out, aux = moe_ffn(h, lp_moe, cfg, aux=True)
    return x + ffn_out, aux


def moe_forward(params: dict, tokens, cfg: MoEConfig,
                attn_fn: Optional[Callable] = None):
    """Logits + mean aux losses. tokens: [B, S] → ([B, S, V] f32, aux
    dict). ``attn_fn`` defaults to dense attention, as in the reference;
    ``cfg.remat`` recomputes each block in the backward."""
    if attn_fn is None:
        attn_fn = resolve_attn("dense", cfg.sliding_window, cfg.attn_sinks)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    backbone = params["backbone"]
    x = backbone["embed"][tokens].to(cfg.act_dtype)
    auxes = []
    for layer in range(cfg.n_layers):
        args = (x, layer_params(backbone, layer), moe_layer(params, layer),
                cfg, positions, attn_fn)
        if cfg.remat:
            x, aux = checkpoint(moe_block, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = moe_block(*args)
        auxes.append(aux)
    aux = {name: torch.stack([a[name] for a in auxes]).mean()
           for name in auxes[0]}
    return _logits(x, backbone, cfg), aux


def moe_loss_fn(params, inputs, targets, cfg: MoEConfig, attn_fn=None,
                lb_coeff: float = 1e-2):
    """Next-token cross entropy + lb_coeff · load balance + router_z_loss ·
    router z. inputs/targets: [B, S] int (pre-shifted)."""
    logits, aux = moe_forward(params, inputs, cfg, attn_fn=attn_fn)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    ce = (logz - gold).mean()
    return (ce + lb_coeff * aux["load_balance"]
            + cfg.router_z_loss * aux["router_z"])


def make_moe_train_state(cfg: MoEConfig, generator: torch.Generator,
                         device=None, optimizer: Optional[Callable] = None):
    """(params, optimizer): f32 masters (``cfg.param_dtype``; the router is
    f32 either way) drawn from ``generator`` on ``device`` (default cuda),
    and ``optimizer`` (a callable on the leaves, default
    default_optimizer) over them."""
    params = init_moe_model(cfg, generator, device,
                            dtype=getattr(torch, cfg.param_dtype))
    return train_state_from(params, optimizer)


def make_moe_train_step(cfg: MoEConfig, optimizer: torch.optim.Optimizer):
    """step(params, inputs, targets) → loss: one forward and backward of
    moe_loss_fn with cfg's attention (``attn_impl="flash"``: the CUDA
    forward and backward kernels), then one optimizer step, in place."""
    return make_train_step(cfg, optimizer, loss=moe_loss_fn)


__all__ = ["MoEConfig", "PRESETS_MOE", "capacity", "route", "moe_ffn",
           "moe_block", "init_moe_params", "init_moe_model", "moe_forward",
           "moe_loss_fn", "make_moe_train_state", "make_moe_train_step"]
