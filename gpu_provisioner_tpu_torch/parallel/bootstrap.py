"""In-cluster workload bootstrap: node labels → SliceTopology →
``torch.distributed``.

Twin of ``gpu_provisioner_tpu/parallel/bootstrap.py``: the labels the
instance provider stamps become a ``SliceTopology`` whose
``distributed_init_args`` start the process group. Deliberate differences:

- ``discover`` reads the environment only (``SliceTopology.from_env``).
  The JAX package's ``node_labels_from_api`` GETs the Node through the
  control plane's REST client, which the port may not import; it waits for
  the engine→fleet bridge (ROADMAP Queue A). The one-call ``bootstrap`` is
  left out: a pod calls ``discover``, then ``initialize_distributed``;
- the backend is explicit: ``nccl`` when each rank has a card of its own
  (one rank a host, the default on cuda), ``gloo`` when ranks share one
  card or run on the CPU; a caller that starts several ranks on one card
  names it (``launch.spawn_ranks`` does); nothing tries one and falls back.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

from ..device import resolve_device
from .topology import SliceTopology

ENV_NODE_NAME = "NODE_NAME"


def topology_from_labels(labels: Mapping[str, str],
                         environ: Optional[Mapping[str, str]] = None
                         ) -> SliceTopology:
    return SliceTopology.from_node_labels(labels, environ=environ)


def discover(environ: Optional[Mapping[str, str]] = None) -> SliceTopology:
    """SliceTopology for this pod from its ``TPU_KAITO_*`` variables. A pod
    that projects ``NODE_NAME`` instead needs the Node's labels from the
    API, which the port does not read yet: that raises."""
    env = environ if environ is not None else os.environ
    if env.get(ENV_NODE_NAME, ""):
        raise NotImplementedError(
            "reading the Node's labels from the API (node_labels_from_api) "
            "is not ported: project the TPU_KAITO_* variables instead")
    return SliceTopology.from_env(env)


def initialize_distributed(topo: SliceTopology, backend: Optional[str] = None,
                           device=None) -> None:
    """``torch.distributed.init_process_group`` from a discovered topology.

    ``device`` (default cuda) must exist: without a card this raises unless
    the caller passes ``device="cpu"``. A no-op for a one-process topology
    (1 host, 1 slice) and when a process group is already live. The rank
    drives card ``worker_index % device_count`` (one rank a host: card 0).
    ``backend`` defaults to ``nccl`` on cuda (one rank a host, its own
    card) and ``gloo`` on the CPU."""
    import torch
    import torch.distributed as dist

    dev = resolve_device(device)
    if topo.hosts * topo.num_slices <= 1 or dist.is_initialized():
        return
    if dev.type == "cuda":
        torch.cuda.set_device(topo.worker_index % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            **topo.distributed_init_args())
