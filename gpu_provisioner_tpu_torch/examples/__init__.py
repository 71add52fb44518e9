"""Workload examples of the port, twins of ``examples/workloads/``."""

from __future__ import annotations

import shutil
import tempfile
from typing import Callable, Optional


def run_bootstrapped(fn: Callable, device, *,
                     temporary_dir: Optional[str] = None):
    """``fn(device type[, directory])`` as this process's rank of the world
    its pod belongs to: ``parallel.bootstrap.bootstrap`` (the Node's labels
    through ``NODE_NAME``, or the ``TPU_KAITO_*`` variables) starts the
    process group, every rank runs ``fn``, and the group is destroyed.
    ``temporary_dir``: the prefix of a temporary directory rank 0 makes,
    broadcasts to every rank (``fn``'s second argument) and removes once
    every rank is done. Returns rank 0's result, None on the others."""
    import asyncio

    import torch.distributed as dist

    from ..parallel.bootstrap import bootstrap

    asyncio.run(bootstrap(device=device))
    rank = dist.get_rank()
    try:
        extra = []
        if temporary_dir is not None:
            extra = [tempfile.mkdtemp(prefix=temporary_dir) if rank == 0
                     else None]
            dist.broadcast_object_list(extra, src=0)
        out = fn(device.type, *extra)
        dist.barrier()
        if extra and rank == 0:
            shutil.rmtree(extra[0])
    finally:
        dist.destroy_process_group()
    return out if rank == 0 else None
