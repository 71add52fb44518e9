"""In-cluster workload bootstrap: node labels → SliceTopology →
``torch.distributed``.

Twin of ``gpu_provisioner_tpu/parallel/bootstrap.py``. The instance
provider stamps ``tpu.kaito.sh/*`` onto node pools, and the cloud copies
pool labels onto Nodes. A pod cannot project its Node's labels through the
downward API, so:

1. the pod projects ``spec.nodeName`` into ``NODE_NAME`` (downward API,
   ``examples/workloads/jobset-multislice.yaml``);
2. ``node_labels_from_api`` GETs that Node with the pod's service account
   (RBAC: get on nodes) and returns its labels;
3. ``SliceTopology.from_node_labels`` and ``distributed_init_args`` start
   the process group (``initialize_distributed``); ``bootstrap`` does the
   three in one call. Without ``NODE_NAME``, ``discover`` reads the
   ``TPU_KAITO_*`` variables instead.

Deliberate differences:

- the Node is read by a client of this module's own on the standard
  library (``NodeConnection``, ``urllib.request``), not the control
  plane's REST client, which the port does not import: one GET with the
  bearer token (re-read from its file at every call) and the cluster's CA;
  a 429 or 5xx answer or a transport error is retried ``RETRIES`` times
  after ``BACKOFF_S``, doubling (1.4 s in all), then raises with the
  status and the path, as does any other answer that is not 2xx;
- the backend is explicit: ``nccl`` when each rank has a card of its own
  (one rank a host, the default on cuda), ``gloo`` when ranks share one
  card or run on the CPU; a caller that starts several ranks on one card
  names it (``launch.spawn_ranks`` does); nothing tries one and falls back.
"""

from __future__ import annotations

import asyncio
import json
import os
import ssl
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Mapping, Optional

from ..device import resolve_device
from .topology import SliceTopology

ENV_NODE_NAME = "NODE_NAME"
SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
# a transient failure (429, 5xx, no connection) is retried RETRIES times,
# BACKOFF_S before the first retry and twice as long before each next one
RETRIES, BACKOFF_S = 3, 0.2
TIMEOUT_S = 10.0


class NodeReadError(RuntimeError):
    """The Node could not be read: the message names the status and the
    path."""


@dataclass(frozen=True)
class NodeConnection:
    """Where the API server is and how to authenticate to it: ``token``, or
    a ``token_file`` read at every request (a projected token rotates), and
    the ``ca_file`` that signs the server's certificate (none: the
    system's)."""

    server: str
    token: str = ""
    token_file: str = ""
    ca_file: str = ""

    @classmethod
    def in_cluster(cls) -> "NodeConnection":
        """The pod's own connection: ``KUBERNETES_SERVICE_HOST``/``_PORT``,
        the service account's token and CA in ``SA_DIR``."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        if not host:
            raise NodeReadError(
                "not in a cluster: KUBERNETES_SERVICE_HOST is unset")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        return cls(server=f"https://{host}:{port}",
                   token_file=f"{SA_DIR}/token", ca_file=f"{SA_DIR}/ca.crt")

    def bearer(self) -> str:
        if self.token_file:
            with open(self.token_file) as f:
                return f.read().strip()
        return self.token

    def get(self, path: str) -> dict:
        """GET ``path`` as JSON, retrying transient failures (module
        docstring); raises NodeReadError otherwise."""
        req = urllib.request.Request(
            self.server.rstrip("/") + path,
            headers={"Authorization": f"Bearer {self.bearer()}",
                     "Accept": "application/json"})
        ctx = (ssl.create_default_context(cafile=self.ca_file or None)
               if req.type == "https" else None)
        for attempt in range(RETRIES + 1):
            try:
                with urllib.request.urlopen(req, timeout=TIMEOUT_S,
                                            context=ctx) as r:
                    return json.load(r)
            except urllib.error.HTTPError as e:
                status = e.code
                why = f"HTTP {e.code} {e.reason}"
                if status != 429 and status < 500:
                    raise NodeReadError(f"GET {path}: {why}") from e
            except urllib.error.URLError as e:
                why = f"transport error {e.reason}"
            if attempt == RETRIES:
                raise NodeReadError(f"GET {path}: {why} after {RETRIES} "
                                    "retries")
            time.sleep(BACKOFF_S * 2 ** attempt)


async def node_labels_from_api(node_name: str,
                               connection: Optional[NodeConnection] = None
                               ) -> dict[str, str]:
    """GET the Node and return its labels, through ``connection`` (default
    the pod's in-cluster one). The blocking read runs in a thread."""
    conn = connection or NodeConnection.in_cluster()
    path = f"/api/v1/nodes/{urllib.parse.quote(node_name, safe='')}"
    node = await asyncio.to_thread(conn.get, path)
    return dict(node.get("metadata", {}).get("labels") or {})


def topology_from_labels(labels: Mapping[str, str],
                         environ: Optional[Mapping[str, str]] = None
                         ) -> SliceTopology:
    return SliceTopology.from_node_labels(labels, environ=environ)


async def discover(environ: Optional[Mapping[str, str]] = None,
                   connection: Optional[NodeConnection] = None
                   ) -> SliceTopology:
    """SliceTopology for this pod: its Node's labels from the API when
    ``NODE_NAME`` is projected, else its ``TPU_KAITO_*`` variables."""
    env = environ if environ is not None else os.environ
    node_name = env.get(ENV_NODE_NAME, "")
    if node_name:
        labels = await node_labels_from_api(node_name, connection=connection)
        return SliceTopology.from_node_labels(labels, environ=env)
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


async def bootstrap(environ: Optional[Mapping[str, str]] = None,
                    connection: Optional[NodeConnection] = None, *,
                    backend: Optional[str] = None,
                    device=None) -> SliceTopology:
    """``discover`` + ``initialize_distributed``: the one-call pod
    entry point."""
    topo = await discover(environ=environ, connection=connection)
    initialize_distributed(topo, backend=backend, device=device)
    return topo
