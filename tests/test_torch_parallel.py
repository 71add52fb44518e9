"""The port's topology, bootstrap, mesh and launcher
(gpu_provisioner_tpu_torch/parallel) against the JAX package's, on the CPU.

Twins of tests/test_workload.py's topology cases (:32, :44, :49, :64, :81,
:92) on the same labels and environments, and of its mesh cases (:99
mesh_shape_for, :111 the mesh's axes): the port's DeviceMesh, built in one
4-rank gloo world (a module fixture spawns it once and builds every mesh),
has the JAX mesh's axis sizes and the same row-major placement of ranks as
the JAX mesh's of devices, at 4 devices of the 8-device CPU mesh. Then what
the port adds: initialize_distributed is a no-op at one process and when a
group is live, its default backend is nccl on a card of the rank's own
and gloo on the CPU, a spawned rank imports no jax, and a rank that
raises, dies or hangs fails the launch within its timeout.
"""

import asyncio
import gc
import os
import time

import jax
import pytest
import torch
import torch.distributed as dist

from gpu_provisioner_tpu import catalog
from gpu_provisioner_tpu.apis import labels as wk
from gpu_provisioner_tpu.parallel import topology as jtopo
from gpu_provisioner_tpu_torch.parallel import bootstrap, jobs, launch
from gpu_provisioner_tpu_torch.parallel import topology as ttopo

MESHES = [{"sp": 2, "tp": 2}, {"num_slices": 2, "tp": 2}, {"sp": 4},
          {"tp": 2}, {"ep": 2, "tp": 2}, {"pp": 2, "sp": 2}]


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches():
    """Drops what this module compiled once it is done: a later test in the
    same worker (the control plane's event-loop stall budget) would
    otherwise pay for those objects in every full garbage collection."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def world():
    """Every rank's mesh_case result for each of MESHES, one world."""
    cases = [{"kind": "mesh", "mesh": m} for m in MESHES]
    return launch.spawn_ranks(jobs.run_cases, 4, backend="gloo",
                              device="cpu", timeout_s=120,
                              args=(cases, "cpu"))


def _same_topology(labels, environ):
    """The port's topology from labels equals the JAX package's, field by
    field, and its process-group arguments carry the same identity."""
    want = jtopo.SliceTopology.from_node_labels(labels, environ=environ)
    got = ttopo.SliceTopology.from_node_labels(labels, environ=environ)
    assert vars(got) == vars(want)
    return got, want


def test_label_keys_are_the_jax_packages():
    for name in ("ACCELERATOR", "TOPOLOGY", "CHIPS", "HOSTS", "WORKER_INDEX",
                 "SLICE_GROUP", "SLICE_INDEX", "NUM_SLICES", "COORDINATOR"):
        key = f"TPU_{name}_LABEL"
        assert getattr(ttopo, key) == getattr(wk, key)
    assert ttopo.MESH_AXES == jtopo.MESH_AXES


def test_topology_from_catalog_labels():
    shape = catalog.lookup("v5p-32")
    labels = shape.node_labels(slice_id="pool0")
    labels[wk.TPU_WORKER_INDEX_LABEL] = "2"
    topo, _ = _same_topology(labels, {})
    assert (topo.generation, topo.topology) == ("v5p", "2x2x4")
    assert (topo.chips, topo.hosts, topo.worker_index) == (16, 4, 2)
    assert topo.chips_per_host == 4
    assert topo.ici_dims == (2, 2, 4)


def test_topology_missing_labels_error_names_key():
    for mod in (jtopo, ttopo):
        with pytest.raises(mod.TopologyError,
                           match="tpu.kaito.sh/accelerator"):
            mod.SliceTopology.from_node_labels({}, environ={})


def test_topology_from_env_and_distributed_args():
    env = {"TPU_KAITO_ACCELERATOR": "v5e", "TPU_KAITO_TOPOLOGY": "4x4",
           "TPU_KAITO_CHIPS": "16", "TPU_KAITO_HOSTS": "2",
           "TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "h0,h1",
           "TPU_KAITO_NUM_SLICES": "4", "TPU_KAITO_SLICE_INDEX": "2",
           "TPU_KAITO_COORDINATOR": "slice0-h0"}
    topo = ttopo.SliceTopology.from_env(env)
    want = jtopo.SliceTopology.from_env(env)
    assert vars(topo) == vars(want)
    assert topo.worker_index == 1 and topo.num_slices == 4
    assert topo.total_chips == 64
    # the JAX package's slice-major process ids: slice 2 of 4, worker 1 of 2
    assert want.distributed_init_args() == {
        "coordinator_address": "slice0-h0:8476", "num_processes": 8,
        "process_id": 5}
    assert topo.distributed_init_args() == {
        "init_method": "tcp://slice0-h0:8476", "world_size": 8, "rank": 5}


def test_topology_multislice_from_labels_alone():
    shape = catalog.lookup("v5e-16")
    labels = shape.node_labels(slice_id="sl2")
    labels[wk.TPU_WORKER_INDEX_LABEL] = "1"
    labels[wk.TPU_SLICE_GROUP_LABEL] = "g"
    labels[wk.TPU_SLICE_INDEX_LABEL] = "2"
    labels[wk.TPU_NUM_SLICES_LABEL] = "4"
    labels[wk.TPU_COORDINATOR_LABEL] = "gke-kaito-sl0-w0"
    topo, _ = _same_topology(labels, {})
    assert (topo.slice_index, topo.num_slices, topo.worker_index) == (2, 4, 1)
    assert topo.distributed_init_args() == {
        "init_method": "tcp://gke-kaito-sl0-w0:8476", "world_size": 8,
        "rank": 5}


def test_topology_multislice_requires_coordinator():
    for mod in (jtopo, ttopo):
        topo = mod.SliceTopology(generation="v5e", topology="4x4", chips=16,
                                 hosts=2, worker_hostnames=("h0", "h1"),
                                 num_slices=2)
        with pytest.raises(mod.TopologyError, match="coordinator"):
            topo.coordinator_address()
        one = mod.SliceTopology(generation="v5e", topology="4x4", chips=16,
                                hosts=2, worker_hostnames=("h0", "h1"))
        assert one.coordinator_address() == "h0:8476"


def test_topology_bad_label_value_is_topology_error():
    labels = {wk.TPU_ACCELERATOR_LABEL: "v5e", wk.TPU_TOPOLOGY_LABEL: "2x4",
              wk.TPU_CHIPS_LABEL: "eight", wk.TPU_HOSTS_LABEL: "1"}
    for mod in (jtopo, ttopo):
        with pytest.raises(mod.TopologyError, match="non-integer"):
            mod.SliceTopology.from_node_labels(labels, environ={})


@pytest.mark.parametrize("n,kw", [
    (8, dict(sp=2, tp=2)), (16, dict(num_slices=2, tp=4)),
    (8, dict(ep=4, tp=2)), (8, dict(pp=2, tp=2)), (8, dict(sp=3)),
    (8, dict(sp=2, tp=2, dp=4)), (6, dict(num_slices=4))])
def test_mesh_shape_factoring(n, kw):
    """The port's mesh_shape_for gives the JAX package's shape, or raises
    its error with its text."""
    try:
        want = jtopo.mesh_shape_for(n, **kw)
    except jtopo.TopologyError as e:
        with pytest.raises(ttopo.TopologyError) as got:
            ttopo.mesh_shape_for(n, **kw)
        assert str(got.value) == str(e)
    else:
        assert ttopo.mesh_shape_for(n, **kw) == want


@pytest.mark.parametrize("i", range(len(MESHES)))
def test_make_mesh_axes(world, i):
    """The port's DeviceMesh over 4 ranks against the JAX mesh over 4
    devices: the same axis names and sizes, rank r where the JAX mesh puts
    device r, and every rank's coordinates read off that layout."""
    jm = jtopo.make_mesh(4, devices=jax.devices()[:4], **MESHES[i])
    ids = [d.id for d in jm.devices.flat]
    want = dict(jm.shape)
    shape = tuple(want.values())
    for rank, res in enumerate(r[i] for r in world):
        assert res["shape"] == want
        at = ids.index(rank)
        coords = {}
        for name, size in reversed(list(zip(jm.axis_names, shape))):
            coords[name], at = at % size, at // size
        assert res["coords"] == coords


def test_spawned_ranks_import_no_jax(world):
    assert not any(r[0]["jax_loaded"] for r in world)


def test_initialize_distributed_is_a_noop_at_one_process():
    topo = ttopo.SliceTopology(generation="v5e", topology="1x1", chips=1,
                               hosts=1)
    bootstrap.initialize_distributed(topo, backend="gloo", device="cpu")
    assert not dist.is_initialized()


def test_initialize_distributed_is_idempotent_when_a_group_is_live(
        monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: called.append((a, k)))
    topo = ttopo.SliceTopology(generation="v5e", topology="4x4", chips=16,
                               hosts=2, worker_index=1,
                               worker_hostnames=("h0", "h1"))
    bootstrap.initialize_distributed(topo, backend="gloo", device="cpu")
    assert called == []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    bootstrap.initialize_distributed(topo, backend="gloo", device="cpu")
    assert called == [(("gloo",), {"init_method": "tcp://h0:8476",
                                   "world_size": 2, "rank": 1})]


def test_backend_follows_ranks_against_cards(monkeypatch):
    """One rank a host: gloo on the CPU, nccl on its own card by default;
    ranks that share a card name gloo."""
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **k: called.append(backend))
    topo = ttopo.SliceTopology(generation="v5e", topology="4x4", chips=16,
                               hosts=2, worker_index=1,
                               worker_hostnames=("h0", "h1"))
    bootstrap.initialize_distributed(topo, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    bootstrap.initialize_distributed(topo)
    bootstrap.initialize_distributed(topo, backend="gloo")  # a shared card
    assert called == ["gloo", "nccl", "gloo"]


def test_discover_reads_the_environment_and_refuses_the_api_half(
        monkeypatch):
    """Without NODE_NAME the async discover reads the TPU_KAITO_* variables
    as the JAX package's does; with it, outside a cluster (no
    KUBERNETES_SERVICE_HOST, no connection given), the API read refuses.
    tests/test_torch_bootstrap.py reads Nodes from a fake API server."""
    env = {"TPU_KAITO_ACCELERATOR": "v5e", "TPU_KAITO_TOPOLOGY": "2x4",
           "TPU_KAITO_CHIPS": "8", "TPU_KAITO_HOSTS": "1"}
    assert vars(asyncio.run(bootstrap.discover(env))) == vars(
        jtopo.SliceTopology.from_env(env))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(bootstrap.NodeReadError, match="not in a cluster"):
        asyncio.run(bootstrap.discover(dict(env, NODE_NAME="node-0")))


def test_a_rank_that_raises_fails_the_launch():
    """Both ranks send to rank 1: rank 1 raises (a send to itself) while
    rank 0 waits for its receive; the launch raises with rank 1's
    traceback and stops rank 0, long before the timeout."""
    t0 = time.monotonic()
    with pytest.raises(launch.RankError, match="rank 1 raised") as e:
        launch.spawn_ranks(dist.send, 2, backend="gloo", device="cpu",
                           timeout_s=60, args=(torch.zeros(2), 1))
    assert "Traceback" in str(e.value)
    assert time.monotonic() - t0 < 30


def test_a_rank_that_dies_fails_the_launch():
    with pytest.raises(launch.RankError, match="died with exit code 3"):
        launch.spawn_ranks(os._exit, 2, backend="gloo", device="cpu",
                           timeout_s=60, args=(3,))


def test_a_rank_that_hangs_fails_the_launch_at_its_timeout():
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] of 2"):
        launch.spawn_ranks(time.sleep, 2, backend="gloo", device="cpu",
                           timeout_s=3, args=(60,))
