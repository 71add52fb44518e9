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


def prime_cpu_math() -> None:
    """Makes the process's first CPU ``torch.exp`` a call on one thread.

    MKL sets up exp on its first call. When that first call comes from
    several OpenMP threads at once (ATen splits a large CPU tensor across
    them), one thread now and then computes its chunk with a less accurate
    exp, relative error 1.5e-4 where the others give 6e-8: enough to fail
    the 1e-5 comparisons against the JAX package.
    ``hack/torch_exp_first_call.py`` counts it in fresh processes. A
    single-threaded first call settles it before any parallel one."""
    torch.exp(torch.ones(64))
