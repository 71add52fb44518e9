"""Single-device training step.

Twin of ``gpu_provisioner_tpu/models/train.py`` on one GPU: the same
optimizer (``default_optimizer`` is optax's ``adamw(3e-4,
weight_decay=0.1)``: b1 0.9, b2 0.999, eps 1e-8, decoupled decay on every
leaf applied to the pre-update value), the same ``loss_fn`` (f32 logits,
logsumexp minus the gold logit, mean) and ``make_forward``. With
``attn_impl="flash"`` the attention forward and backward run the CUDA
kernels through ``ops/flash_attention.py``'s autograd Function. Deliberate
differences:

- the step updates params and optimizer state in place, the twin of the JAX
  step's ``donate_argnums`` (one copy of each in device memory);
- params are f32 masters (``cfg.param_dtype``) the forward casts to the
  activation dtype at each use, and the optimizer owns its moments (f32:
  ``mu_dtype`` is not carried);
- no mesh: ``shard_params``, the ring and zigzag schedules and the pipelined
  step come with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..device import resolve_device
from .llama import LlamaConfig, forward, init_params, resolve_attn


def param_leaves(params: dict) -> list:
    """The param tensors in the tree's order (embed, blocks, ln_final,
    lm_head), the order the optimizer holds them in."""
    out = []
    for leaf in params.values():
        out.extend(param_leaves(leaf) if isinstance(leaf, dict) else [leaf])
    return out


def default_optimizer(leaves) -> torch.optim.Optimizer:
    """The one default, optax.adamw(3e-4, weight_decay=0.1)'s twin."""
    return torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.1)


def loss_fn(params, inputs, targets, cfg: LlamaConfig, attn_fn=None,
            positions=None):
    """Next-token cross entropy. inputs/targets: [B, S] int (pre-shifted).
    ``positions`` as in forward."""
    logits = forward(params, inputs, cfg, attn_fn=attn_fn,
                     positions=positions)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (logz - gold).mean()


def train_state_from(params: dict, optimizer: Optional[Callable] = None):
    """(params, optimizer) from an existing param tree: every leaf becomes
    trainable and ``optimizer`` (a callable on the leaves, default
    default_optimizer) is built over them."""
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return params, (optimizer or default_optimizer)(leaves)


def make_train_state(cfg: LlamaConfig, generator: torch.Generator,
                     device=None, optimizer: Optional[Callable] = None):
    """(params, optimizer): f32 masters (``cfg.param_dtype``) drawn from
    ``generator`` on ``device`` (default cuda) and the optimizer over them."""
    dev = resolve_device(device)
    params = init_params(cfg, generator, dev,
                         dtype=getattr(torch, cfg.param_dtype))
    return train_state_from(params, optimizer)


def make_train_step(cfg: LlamaConfig, optimizer: torch.optim.Optimizer):
    """step(params, inputs, targets) → loss (a 0-d tensor, not synced).

    One forward and backward of loss_fn with cfg's attention, then one
    optimizer step. Updates ``params`` (the tree the optimizer was built
    over) and the optimizer's state in place: the twin of the JAX step's
    ``donate_argnums``."""
    attn_fn = resolve_attn(cfg.attn_impl, cfg.sliding_window, cfg.attn_sinks)
    owned = {id(p) for group in optimizer.param_groups
             for p in group["params"]}

    def step(params, inputs, targets):
        if {id(p) for p in param_leaves(params)} != owned:
            raise ValueError("params are not the tree this optimizer was "
                             "built over")
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, inputs, targets, cfg, attn_fn)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_forward(cfg: LlamaConfig):
    """fn(params, tokens) → logits: the single-device forward (the JAX
    package's __graft_entry__ surface)."""

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn
