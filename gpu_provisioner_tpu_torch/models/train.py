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
  activation dtype at each use, and the optimizer owns its moments;
- ``default_optimizer(leaves, mu_dtype=None)`` takes the leaves (the
  callable-on-leaves convention of ``train_state_from``; pass
  ``functools.partial(default_optimizer, mu_dtype=torch.bfloat16)``). With
  no ``mu_dtype`` it is ``torch.optim.AdamW`` (foreach); with one it is
  ``AdamWMu``, which keeps optax's ``scale_by_adam(mu_dtype=)`` order;
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


ADAMW = {"lr": 3e-4, "betas": (0.9, 0.999), "eps": 1e-8,
         "weight_decay": 0.1}


class AdamWMu(torch.optim.Optimizer):
    """optax.adamw(mu_dtype=)'s twin: AdamW whose first moment is stored in
    ``mu_dtype`` (bf16 halves its memory), on ``torch._foreach_*`` ops.

    The order is optax's ``scale_by_adam``: the new mu is computed in f32
    from the stored mu (``(1 - b1)·g + b1·mu``; JAX's weak typing rounds b1
    to mu's dtype, and the jitted step forms b1·mu in f32, as XLA drops the
    product's round trip through mu's dtype), nu in f32; the
    bias-corrected update comes from that f32 mu, and only then is mu cast
    to ``mu_dtype`` for storage. Decay is decoupled and applied to the
    pre-update value, as torch's AdamW does. The per-leaf state is torch
    AdamW's (``step`` a float32 CPU scalar, ``exp_avg``, ``exp_avg_sq``),
    so the checkpoint and ``convert`` handle both alike."""

    def __init__(self, params, mu_dtype: torch.dtype, *, lr: float,
                 betas: tuple, eps: float, weight_decay: float):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay})
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        init_adam_state(self)
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            lr, (b1, b2) = group["lr"], group["betas"]
            grads = [p.grad for p in ps]
            state = [self.state[p] for p in ps]
            mus = [s["exp_avg"] for s in state]
            nus = [s["exp_avg_sq"] for s in state]
            steps = [s["step"] for s in state]
            torch._foreach_add_(steps, 1.0)
            b1_mu = torch.tensor(b1, dtype=self.mu_dtype).item()
            mu32 = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(mu32, mus, alpha=b1_mu)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
            torch._foreach_mul_(ps, 1 - lr * group["weight_decay"])
            counts = [s.item() for s in steps]
            denom = torch._foreach_sqrt(nus)
            torch._foreach_div_(denom, [(1 - b2 ** n) ** 0.5 for n in counts])
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_addcdiv_(ps, mu32, denom,
                                    [-lr / (1 - b1 ** n) for n in counts])
            torch._foreach_copy_(mus, mu32)
        return loss


def default_optimizer(leaves, mu_dtype: Optional[torch.dtype] = None
                      ) -> torch.optim.Optimizer:
    """The one default, optax.adamw(3e-4, weight_decay=0.1, mu_dtype=)'s
    twin: torch's AdamW without ``mu_dtype``, else ``AdamWMu``."""
    if mu_dtype is None:
        return torch.optim.AdamW(leaves, **ADAMW)
    return AdamWMu(leaves, mu_dtype, **ADAMW)


def adam_step(count: int) -> torch.Tensor:
    """The per-leaf ``step`` of torch's AdamW after ``count`` updates (optax's
    ``count``): a float32 CPU scalar, as neither optimizer here is fused or
    capturable."""
    return torch.tensor(float(count), dtype=torch.float32)


def init_adam_state(optimizer: torch.optim.Optimizer) -> None:
    """Gives every leaf that has no state yet the state its first step
    would make: step 0 and zero moments (mu in the optimizer's
    ``mu_dtype``), as optax's ``init`` does."""
    mu_dtype = getattr(optimizer, "mu_dtype", None)
    for group in optimizer.param_groups:
        for p in group["params"]:
            if not optimizer.state[p]:
                optimizer.state[p] = {
                    "step": adam_step(0),
                    "exp_avg": torch.zeros_like(p, dtype=mu_dtype or p.dtype),
                    "exp_avg_sq": torch.zeros_like(p)}


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


def make_train_step(cfg: LlamaConfig, optimizer: torch.optim.Optimizer,
                    loss: Callable = loss_fn):
    """step(params, inputs, targets) → loss (a 0-d tensor, not synced).

    One forward and backward of ``loss`` (the dense ``loss_fn``, or MoE's
    ``moe_loss_fn``) with cfg's attention, then one optimizer step. Updates
    ``params`` (the tree the optimizer was built over) and the optimizer's
    state in place: the twin of the JAX step's ``donate_argnums``."""
    attn_fn = resolve_attn(cfg.attn_impl, cfg.sliding_window, cfg.attn_sinks)
    owned = {id(p) for group in optimizer.param_groups
             for p in group["params"]}

    def step(params, inputs, targets):
        if {id(p) for p in param_leaves(params)} != owned:
            raise ValueError("params are not the tree this optimizer was "
                             "built over")
        optimizer.zero_grad(set_to_none=True)
        value = loss(params, inputs, targets, cfg, attn_fn)
        value.backward()
        optimizer.step()
        return value.detach()

    return step


def make_forward(cfg: LlamaConfig):
    """fn(params, tokens) → logits: the single-device forward (the JAX
    package's __graft_entry__ surface)."""

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn
