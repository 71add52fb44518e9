"""Weights and optimizer state carried across from the JAX package.

No JAX twin: the JAX package holds its params as a pytree. Given that tree
as numpy arrays (``jax.tree.map(np.asarray, params)``), ``params_from_numpy``
builds the port's params. The layouts are identical, so nothing is
reshaped or transposed. ``adam_state_from_numpy`` puts optax's
``ScaleByAdamState`` (as numpy) into the port optimizer's per-leaf state,
so a run the JAX package trained can go on in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .train import adam_step, param_leaves


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")         # a writable copy: torch shares it
    if a.dtype.name == "bfloat16":     # ml_dtypes bfloat16, which numpy lacks
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


F32_LEAVES = ("lm_head", "router")


def params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """JAX params as a dict of numpy arrays → the same dict of tensors on
    ``device`` (default cuda). ``dtype`` casts every leaf except
    ``lm_head`` and an MoE ``router`` once at load (the logits and router
    products are f32 either way); None keeps the arrays' own dtypes. The
    MoE tree (``backbone``/``moe``) converts leaf by leaf like the dense
    one."""
    dev = resolve_device(device)

    def conv(name, leaf):
        if isinstance(leaf, dict):
            return {k: conv(k, v) for k, v in leaf.items()}
        t = _tensor(np.asarray(leaf))
        if dtype is not None and name not in F32_LEAVES:
            t = t.to(dtype)
        return t.to(dev)

    return {k: conv(k, v) for k, v in tree.items()}


def _zip_leaves(params: dict, mu: dict, nu: dict):
    """(param, mu, nu) leaf triples in ``params``' order; raises where the
    trees' keys differ."""
    if mu.keys() != params.keys() or nu.keys() != params.keys():
        raise ValueError(f"moment tree keys {sorted(mu)} / {sorted(nu)} "
                         f"are not the params' {sorted(params)}")
    for k, p in params.items():
        if isinstance(p, dict):
            yield from _zip_leaves(p, mu[k], nu[k])
        else:
            yield p, mu[k], nu[k]


def adam_state_from_numpy(adam_state, params: dict,
                          optimizer: torch.optim.Optimizer) -> None:
    """Sets ``optimizer``'s per-leaf state from optax's ``ScaleByAdamState``
    (``count``, and ``mu``/``nu`` as numpy trees of ``params``' layout:
    ``jax.tree.map(np.asarray, opt_state[0])`` of an ``adamw`` state): step
    = count, exp_avg = mu in mu's own dtype, exp_avg_sq = nu, each on its
    leaf's device. Raises when mu's dtype is not the one the optimizer
    keeps (its ``mu_dtype``, else the leaf's)."""
    mu_dtype = getattr(optimizer, "mu_dtype", None)
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    if {id(p) for p in param_leaves(params)} != owned:
        raise ValueError("params are not the tree this optimizer was built "
                         "over")
    count = int(np.asarray(adam_state.count))
    for p, mu, nu in _zip_leaves(params, adam_state.mu, adam_state.nu):
        mu, nu = _tensor(np.asarray(mu)), _tensor(np.asarray(nu))
        want = mu_dtype or p.dtype
        if mu.dtype != want:
            raise ValueError(f"mu is {mu.dtype}, the optimizer keeps {want}")
        optimizer.state[p] = {"step": adam_step(count),
                              "exp_avg": mu.to(p.device),
                              "exp_avg_sq": nu.to(p.device)}
