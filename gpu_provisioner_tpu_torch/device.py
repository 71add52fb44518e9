"""Device choice for the port's entry points.

No JAX twin (JAX picks its backend globally). Entry points run on
``cuda`` unless the caller names another device; without a card they
raise instead of drifting to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means ``cuda``. Raises when CUDA
    is asked for (or implied) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'")
        if dev.index is None:     # compare equal to tensors' cuda:N devices
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
