"""Weights carried across from the JAX package.

No JAX twin: the JAX package holds its params as a pytree. Given that tree
as numpy arrays (``jax.tree.map(np.asarray, params)``), ``params_from_numpy``
builds the port's params. The layouts are identical, so nothing is
reshaped or transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


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
