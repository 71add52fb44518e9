"""Topology discovery: provisioner labels → a torch.distributed device mesh.

Twin of ``gpu_provisioner_tpu/parallel/topology.py``. The controller stamps
``tpu.kaito.sh/{accelerator,topology,chips,hosts,worker-index,slice-group}``
onto nodes; this module reads them back into a ``SliceTopology``, gives the
arguments of ``torch.distributed.init_process_group`` and builds the mesh
the training step shards over.

Axis convention (slowest-varying interconnect outermost), as in the JAX
package:

    (slice, data, pipe, seq, expert, model)

Batch is sharded over (slice, data), the sequence over ``seq`` (ring
attention, ``parallel/ring.py``) and dense parameters over ``model``
(tensor parallelism, ``models/llama.py``'s ``param_specs``). Deliberate
differences:

- the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
  ranks of the live process group, one rank per mesh position, laid out
  row-major (rank 1 is seq 1 in a (1, 2, 1, 2, 1, 1) mesh, rank 2 data 1);
  ``axis_sizes`` reads the axes by name, as the JAX mesh's ``shape``
  does;
- ``distributed_init_args`` gives ``init_process_group``'s
  ``init_method`` (``tcp://`` at the coordinator), ``world_size`` and
  ``rank``, with the JAX package's slice-major process ids;
- ``drop_foreign_backend_factories`` has no twin: it removes JAX backend
  plugins before the first JAX backend starts, and torch has none;
- the label keys are this module's own copy of the nine
  ``apis/labels.py`` strings it reads (the port imports nothing of the JAX
  package).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional

from ..device import resolve_device

# copies of gpu_provisioner_tpu/apis/labels.py's keys
TPU_ACCELERATOR_LABEL = "tpu.kaito.sh/accelerator"
TPU_TOPOLOGY_LABEL = "tpu.kaito.sh/topology"
TPU_CHIPS_LABEL = "tpu.kaito.sh/chips"
TPU_HOSTS_LABEL = "tpu.kaito.sh/hosts"
TPU_WORKER_INDEX_LABEL = "tpu.kaito.sh/worker-index"
TPU_SLICE_GROUP_LABEL = "tpu.kaito.sh/slice-group"
TPU_SLICE_INDEX_LABEL = "tpu.kaito.sh/slice-index"
TPU_NUM_SLICES_LABEL = "tpu.kaito.sh/num-slices"
TPU_COORDINATOR_LABEL = "tpu.kaito.sh/coordinator"

AXIS_SLICE = "slice"
AXIS_DATA = "data"
AXIS_PIPE = "pipe"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_MODEL = "model"
MESH_AXES = (AXIS_SLICE, AXIS_DATA, AXIS_PIPE, AXIS_SEQ, AXIS_EXPERT,
             AXIS_MODEL)

ENV_WORKER_ID = "TPU_WORKER_ID"
ENV_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
COORDINATOR_PORT = 8476  # the JAX package's coordinator port, kept


class TopologyError(Exception):
    """Labels/env describe no usable slice topology."""


@dataclass(frozen=True)
class SliceTopology:
    """One worker's view of the slice(s) it belongs to: what the
    provisioner wrote at create time plus the per-worker identity."""

    generation: str           # "v5e" | "v5p" | ...
    topology: str             # ICI topology, e.g. "2x4" / "2x2x4"
    chips: int                # chips in THIS slice
    hosts: int                # worker VMs in this slice
    worker_index: int = 0     # this host's index within the slice
    worker_hostnames: tuple[str, ...] = ()
    num_slices: int = 1       # slices joined over the data-center network
    slice_index: int = 0      # which slice this worker's node pool is
    slice_group: str = ""     # tpu.kaito.sh/slice-group value
    coordinator: str = ""     # global coordinator override (multi-slice)

    @property
    def chips_per_host(self) -> int:
        return self.chips // max(1, self.hosts)

    @property
    def ici_dims(self) -> tuple[int, ...]:
        return tuple(int(d) for d in self.topology.split("x"))

    @property
    def total_chips(self) -> int:
        return self.chips * self.num_slices

    def coordinator_address(self) -> str:
        """host:port of the rendezvous: the explicit override when set
        (required for multi-slice, where each slice only knows its own
        hostnames), else host 0 of this slice."""
        if self.coordinator:
            addr = self.coordinator
            return addr if ":" in addr else f"{addr}:{COORDINATOR_PORT}"
        if self.num_slices > 1:
            raise TopologyError(
                "multi-slice topology needs an explicit coordinator "
                "(slice-local hostnames can't name the global host 0) — "
                "set TPU_KAITO_COORDINATOR / SliceTopology.coordinator")
        if self.worker_hostnames:
            return f"{self.worker_hostnames[0]}:{COORDINATOR_PORT}"
        return f"localhost:{COORDINATOR_PORT}"

    def distributed_init_args(self) -> dict:
        """kwargs for ``torch.distributed.init_process_group`` (besides the
        backend); ranks are globally unique across slices (slice-major)."""
        return {
            "init_method": f"tcp://{self.coordinator_address()}",
            "world_size": self.hosts * self.num_slices,
            "rank": self.slice_index * self.hosts + self.worker_index,
        }

    @classmethod
    def from_node_labels(cls, labels: Mapping[str, str],
                         environ: Optional[Mapping[str, str]] = None,
                         num_slices: Optional[int] = None) -> "SliceTopology":
        """Build from the ``tpu.kaito.sh/*`` labels the provisioner stamped.
        Multi-slice identity comes from the labels, env vars override it;
        ``environ`` also supplies the worker id and hostnames."""
        env = environ if environ is not None else os.environ
        try:
            generation = labels[TPU_ACCELERATOR_LABEL]
            topology = labels[TPU_TOPOLOGY_LABEL]
            chips = int(labels[TPU_CHIPS_LABEL])
            hosts = int(labels[TPU_HOSTS_LABEL])
            worker = int(labels.get(TPU_WORKER_INDEX_LABEL,
                                    env.get(ENV_WORKER_ID, "0")))
            slice_index = int(
                env.get("TPU_KAITO_SLICE_INDEX")
                or labels.get(TPU_SLICE_INDEX_LABEL, "0"))
            if num_slices is None:
                num_slices = int(
                    env.get("TPU_KAITO_NUM_SLICES")
                    or labels.get(TPU_NUM_SLICES_LABEL, "1"))
        except KeyError as e:
            raise TopologyError(
                f"node labels missing {e.args[0]!r} — was this node "
                f"provisioned by tpu-provisioner? "
                f"(have: {sorted(labels)})") from e
        except ValueError as e:
            raise TopologyError(
                f"non-integer topology label/env value: {e}") from e
        hostnames = tuple(
            h for h in env.get(ENV_WORKER_HOSTNAMES, "").split(",") if h)
        return cls(generation=generation, topology=topology, chips=chips,
                   hosts=hosts, worker_index=worker,
                   worker_hostnames=hostnames, num_slices=num_slices,
                   slice_index=slice_index,
                   slice_group=labels.get(TPU_SLICE_GROUP_LABEL, ""),
                   coordinator=(env.get("TPU_KAITO_COORDINATOR")
                                or labels.get(TPU_COORDINATOR_LABEL, "")))

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "SliceTopology":
        """Build from env alone (labels projected as ``TPU_KAITO_<NAME>``
        variables, the chart's pod-spec convention)."""
        env = environ if environ is not None else os.environ
        labels = {
            TPU_ACCELERATOR_LABEL: env.get("TPU_KAITO_ACCELERATOR", ""),
            TPU_TOPOLOGY_LABEL: env.get("TPU_KAITO_TOPOLOGY", ""),
            TPU_CHIPS_LABEL: env.get("TPU_KAITO_CHIPS", ""),
            TPU_HOSTS_LABEL: env.get("TPU_KAITO_HOSTS", ""),
        }
        labels = {k: v for k, v in labels.items() if v}
        return cls.from_node_labels(labels, environ=env)


def mesh_shape_for(n_devices: int, *, num_slices: int = 1,
                   sp: int = 1, tp: int = 1, ep: int = 1, pp: int = 1,
                   dp: Optional[int] = None
                   ) -> tuple[int, int, int, int, int, int]:
    """Factor ``n_devices`` into (slice, data, pipe, seq, expert, model).
    ``dp`` defaults to whatever is left after the other axes are taken;
    raises TopologyError on non-divisibility."""
    if n_devices % num_slices:
        raise TopologyError(f"{n_devices} devices not divisible by "
                            f"num_slices={num_slices}")
    per_slice = n_devices // num_slices
    if per_slice % (sp * tp * ep * pp):
        raise TopologyError(f"{per_slice} devices/slice not divisible by "
                            f"sp*tp*ep*pp={sp}*{tp}*{ep}*{pp}")
    inferred = per_slice // (sp * tp * ep * pp)
    if dp is None:
        dp = inferred
    elif dp != inferred:
        raise TopologyError(f"dp={dp} inconsistent: {num_slices}sl×{dp}dp×"
                            f"{pp}pp×{sp}sp×{ep}ep×{tp}tp != {n_devices}")
    return (num_slices, dp, pp, sp, ep, tp)


def make_mesh(n_devices: Optional[int] = None, *, num_slices: int = 1,
              sp: int = 1, tp: int = 1, ep: int = 1, pp: int = 1,
              dp: Optional[int] = None, device=None):
    """The (slice, data, pipe, seq, expert, model) ``DeviceMesh`` over the
    live process group's ranks, for ``device``'s type (default cuda; raises
    without a card). ``n_devices`` defaults to the world size and must equal
    it. Every rank must call this, in the same order as its other meshes:
    the axes' process groups are built collectively."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a live process group: call "
                           "initialize_distributed (or spawn_ranks) first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise TopologyError(f"a mesh of {n} devices over a world of {world} "
                            "ranks: one rank per mesh position")
    shape = mesh_shape_for(n, num_slices=num_slices, sp=sp, tp=tp, ep=ep,
                           pp=pp, dp=dp)
    return init_device_mesh(dev.type, shape, mesh_dim_names=MESH_AXES)


def mesh_from_topology(topo: SliceTopology, *, sp: int = 1, tp: int = 1,
                       device=None):
    """Mesh for a discovered slice topology: ``slice`` axis = num_slices,
    the remaining ranks split dp × sp × tp. One rank per host, as
    ``distributed_init_args`` numbers them (the JAX package's one process
    per host; it meshes the hosts' chips, this mesh the hosts' ranks)."""
    return make_mesh(topo.hosts * topo.num_slices,
                     num_slices=topo.num_slices, sp=sp, tp=tp,
                     device=device)


def axis_sizes(mesh) -> dict:
    """{axis name: size} in mesh order (the JAX mesh's ``dict(shape)``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along axis ``name``."""
    return mesh.get_local_rank(name)
