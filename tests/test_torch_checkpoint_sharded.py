"""The port's checkpointing on a mesh (models/checkpoint.py with ``mesh=``)
against the JAX package's restore onto a mesh, on the CPU.

Twin of tests/test_checkpoint.py:26's second mesh: a state saved on one
mesh restores onto another, resharded. A module fixture spawns one 4-rank
gloo world that runs every case (jobs.checkpoint_case and its kin) in a
thread while the JAX reference compiles: ``tiny`` in f32 from the JAX
params, one step at dp 4 on the first of two batches, a save, the next
step on the dp-4 mesh, a restore onto (tp 2, sp 2) and the next step
there. Held:

- the restored tree's structure, and each rank's leaves bitwise equal to
  its shards of the saved tree (the whole tree, read back in this process
  with no process group: sharded → one device), ``count`` and ``step``;
- the next loss within 1e-5 of the dp-4 mesh's and of the JAX package's,
  whose ``restore_train_state`` onto make_mesh(4, tp=2, sp=2) over 4 of
  the 8 CPU devices reads its own save of the same params after the same
  step (the sharded train step's f32 tolerance);
- a single-device checkpoint restored onto the mesh: each rank's leaves
  bitwise its shards;
- a pipelined (pp 2, n_chunks 2) state through ``TrainCheckpointManager(
  mesh=)``: restored bitwise with its stamp, refused under (1, 1) on every
  rank, and its stamp read by a single-process restore;
- a save onto an existing checkpoint refused on every rank;
- the manager on a mesh saves, keeps and restores the steps orbax's
  ``CheckpointManager`` does on the same step sequences (and a restart).
"""

import dataclasses
import functools
import gc
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from gpu_provisioner_tpu.models import checkpoint as jck
from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu.models import train as jtrain
from gpu_provisioner_tpu.parallel import make_mesh
from gpu_provisioner_tpu_torch.models import checkpoint as ck
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import train as ttrain
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy
from gpu_provisioner_tpu_torch.parallel import jobs, launch

JCFG = dataclasses.replace(jl.PRESETS["tiny"], dtype="float32")
TCFG = tl.LlamaConfig(**dataclasses.asdict(JCFG))
TCFG4 = dataclasses.replace(TCFG, n_layers=4)     # pp 2 × n_chunks 2
JPARAMS = jl.init_params(jax.random.key(0), JCFG)
NPARAMS = jax.tree.map(np.asarray, JPARAMS)
TOKS = [np.random.default_rng(s).integers(0, JCFG.vocab_size, (8, 33),
                                          dtype=np.int32) for s in (1, 2)]
BATCHES = [(t[:, :-1], t[:, 1:]) for t in TOKS]
RESTORE_MESH = {"tp": 2, "sp": 2}
# (interval, keep, [the first manager's steps, the restart's steps])
SCHEDULES = [
    (2, 2, [list(range(1, 7)), [6, 7, 8, 16]]),
    (3, 2, [list(range(1, 11)), [10, 11, 13, 26]]),
    (3, 3, [[2, 3, 3, 5, 6, 7, 9, 12, 13], [13, 14, 16, 32]]),
]
NAMES = ["dp4_to_tp2_sp2", "single_to_mesh", "pipeline", "schedule"]


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches():
    """Drops what this module compiled once it is done: a later test in the
    same worker (the control plane's event-loop stall budget) would
    otherwise pay for those objects in every full garbage collection."""
    yield
    jax.clear_caches()
    gc.collect()


def _single_step_state():
    """The port's single-device state from the JAX params after one step on
    the first batch."""
    params, opt = ttrain.train_state_from(
        params_from_numpy(NPARAMS, device="cpu"))
    ttrain.make_train_step(TCFG, opt)(
        params, *(torch.from_numpy(a) for a in BATCHES[0]))
    return params, opt


@pytest.fixture(scope="module")
def ckdir(tmp_path_factory):
    return tmp_path_factory.mktemp("sharded-ckpt")


@pytest.fixture(scope="module")
def world(ckdir):
    """A callable giving {case: every rank's result}: the 4-rank world runs
    in a thread while the tests run their JAX references."""
    params, opt = _single_step_state()
    ck.save_train_state(ckdir / "single", params, opt, 1)
    cases = [
        {"kind": "checkpoint", "cfg": TCFG, "directory": str(ckdir / "a"),
         "save_mesh": {}, "restore_mesh": RESTORE_MESH, "params": NPARAMS,
         "batches": BATCHES, "leaves": True, "refusals": True},
        {"kind": "checkpoint_restore", "cfg": TCFG,
         "path": str(ckdir / "single"), "mesh": RESTORE_MESH},
        {"kind": "checkpoint_pipeline", "cfg": TCFG4,
         "directory": str(ckdir / "p"), "save_mesh": {"pp": 2},
         "restore_mesh": {"pp": 2}, "seed": 0, "batch_shape": (8, 16),
         "n_micro": 2, "n_chunks": 2, "manager": True, "refusals": True},
        {"kind": "checkpoint_schedule", "cfg": TCFG,
         "directory": str(ckdir / "s"), "mesh": {"tp": 2},
         "sequences": [(i, k, runs, f"s{n}")
                       for n, (i, k, runs) in enumerate(SCHEDULES)]},
    ]
    pool = ThreadPoolExecutor(1)
    run = pool.submit(launch.spawn_ranks, jobs.run_cases, 4, backend="gloo",
                      device="cpu", timeout_s=240, args=(cases, "cpu"))

    @functools.lru_cache(maxsize=None)
    def result():
        res = run.result()
        return {k: [r[i] for r in res] for i, k in enumerate(NAMES)}

    yield result
    result()                   # the world's error, if no test asked for it
    pool.shutdown()


def _level0(fn, *args):
    return fn.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


@functools.lru_cache(maxsize=None)
def _jax_resumed_loss(directory):
    """JAX: make_train_state from JPARAMS on dp 4 (4 CPU devices), one step
    on the first batch, save_train_state, restore_train_state onto
    make_mesh(4, tp=2, sp=2) and the next step's loss there."""
    devices = jax.devices()[:4]
    mesh = make_mesh(4, devices=devices)
    params, state, opt = jtrain.make_train_state(jax.random.key(0), JCFG,
                                                 mesh)

    def batch(m, i):
        put = lambda x: jax.device_put(jnp.asarray(x),
                                       NamedSharding(m, jtrain.BATCH_SPEC))
        return put(BATCHES[i][0]), put(BATCHES[i][1])

    step = _level0(jtrain.make_train_step(mesh, JCFG, opt), params, state,
                   *batch(mesh, 0))
    params, state, _ = step(params, state, *batch(mesh, 0))
    jck.save_train_state(f"{directory}/jax", params, state, 1)
    mesh2 = make_mesh(4, tp=2, sp=2, devices=devices)
    params, state, at = jck.restore_train_state(f"{directory}/jax", mesh2,
                                                JCFG, opt)
    step2 = _level0(jtrain.make_train_step(mesh2, JCFG, opt), params, state,
                    *batch(mesh2, 1))
    return at, float(step2(params, state, *batch(mesh2, 1))[2])


def _spec(name: str):
    """The dim a dense checkpoint leaf splits over ``model`` (None:
    replicated), by its name in the tree."""
    if name == "opt_state/count":
        return None
    keys = name.split("/")[1:]
    if keys[0] in ("mu", "nu"):
        keys = keys[1:]
    spec = tl.param_specs(TCFG)
    for k in keys:
        spec = spec[k]
    return spec


def _shard(name, whole, coords, tp=2):
    """The shard of a whole numpy leaf a rank at ``coords`` holds."""
    dim = _spec(name)
    if dim is None:
        return whole
    n = whole.shape[dim] // tp
    return np.take(whole, range(coords["model"] * n,
                                (coords["model"] + 1) * n), axis=dim)


def _whole(path, cfg=TCFG, **layout):
    """A checkpoint read back in this process (no process group) by
    name."""
    params, opt, at = ck.restore_train_state(path, cfg,
                                             ttrain.default_optimizer,
                                             device="cpu", **layout)
    tree = {"params": params, "opt_state": ck.adam_state_tree(params, opt)}
    return at, {k: v.detach().numpy() for k, v in jobs._named(tree).items()}


def test_restore_keeps_the_tree_structure(world):
    for r in world()["dp4_to_tp2_sp2"]:
        assert r["saved"].keys() == r["restored"].keys()
        assert {k: v.dtype for k, v in r["saved"].items()} == {
            k: v.dtype for k, v in r["restored"].items()}


def test_each_rank_restores_its_shards_of_the_saved_tree(world, ckdir):
    """Every rank's restored leaves equal its shards of the saved tree,
    bitwise (the ranks' own check, and the whole tree read back here with
    no process group: the dp-4 ranks saved exactly it)."""
    at, whole = _whole(ckdir / "a" / "ckpt")
    assert at == 1
    for r in world()["dp4_to_tp2_sp2"]:
        assert r["differ"] == []
        for k, v in r["saved"].items():
            np.testing.assert_array_equal(v, whole[k], err_msg=k, strict=True)
        for k, v in r["restored"].items():
            np.testing.assert_array_equal(
                v, _shard(k, whole[k], r["coords_restore"]), err_msg=k,
                strict=True)


def test_restore_gives_count_and_step(world):
    for r in world()["dp4_to_tp2_sp2"]:
        assert r["step"] == 1 and r["count"] == 1
        assert r["restored"]["opt_state/count"] == 1


def test_next_loss_matches_the_old_mesh(world):
    """The restored (tp 2, sp 2) mesh's next step against the dp-4 mesh's
    next step from the state it saved, within 1e-5, on every rank."""
    for r in world()["dp4_to_tp2_sp2"]:
        first, old, new = r["losses"]
        assert abs(new - old) <= 1e-5 * abs(old), (old, new)
    assert len({r["losses"][2] for r in world()["dp4_to_tp2_sp2"]}) == 1


def test_next_loss_matches_the_jax_restore(world, ckdir):
    """The JAX package's restore onto its (tp 2, sp 2) mesh takes the same
    next step, within 1e-5."""
    at, want = _jax_resumed_loss(str(ckdir))
    assert at == 1
    got = world()["dp4_to_tp2_sp2"][0]["losses"][2]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_single_device_checkpoint_restores_onto_the_mesh(world, ckdir):
    """A checkpoint written with no process group restores onto (tp 2, sp
    2): each rank's leaves are its shards of it, bitwise."""
    at, whole = _whole(ckdir / "single")
    for r in world()["single_to_mesh"]:
        assert r["step"] == at == 1
        assert r["leaves"].keys() == whole.keys()
        for k, v in r["leaves"].items():
            np.testing.assert_array_equal(v, _shard(k, whole[k], r["coords"]),
                                          err_msg=k, strict=True)


def test_pipelined_state_keeps_its_stamp(world, ckdir):
    """A (pp 2, n_chunks 2) state saved through the manager on its mesh
    restores bitwise under its stamp and takes its next step; a process
    with no process group reads it whole only under the same stamp."""
    res = world()["pipeline"]
    for r in res:
        assert r["differ"] == [] and r["step"] == 1
        assert r["losses"][2] == r["losses"][1]
    at, _ = _whole(ckdir / "p" / "1", TCFG4, n_stages=2, n_chunks=2)
    assert at == 1
    with pytest.raises(ValueError, match="pipeline layout"):
        _whole(ckdir / "p" / "1", TCFG4)


def test_layout_mismatch_is_refused_on_every_rank(world):
    for name, want in (("pipeline", "{'n_stages': 2, 'n_chunks': 2}"),
                       ("dp4_to_tp2_sp2", "{'n_stages': 1, 'n_chunks': 1}")):
        for r in world()[name]:
            assert r["refusals"][0] is not None
            assert f"pipeline layout {want}" in r["refusals"][0]


def test_save_onto_an_existing_checkpoint_is_refused_on_every_rank(world):
    for name in ("dp4_to_tp2_sp2", "pipeline"):
        for r in world()[name]:
            assert r["refusals"][1] is not None
            assert "already exists" in r["refusals"][1]


def test_mesh_manager_keeps_the_steps_orbax_keeps(world, tmp_path):
    """The same step sequences (and a restart over each directory) through
    orbax's bookkeeping on one device: the same steps saved, the same kept,
    the same latest on every rank; restore_latest gives the latest."""
    jmesh = make_mesh(1, devices=[jax.devices()[0]])
    jopt = jtrain.default_optimizer()
    jparams = jtrain.shard_params(jax.tree.map(jnp.copy, JPARAMS), jmesh,
                                  JCFG)
    jstate = jopt.init(jparams)
    for n, (interval, keep, runs) in enumerate(SCHEDULES):
        want = []
        for steps in runs:
            jm = jck.TrainCheckpointManager(
                tmp_path / f"s{n}", jmesh, JCFG, jopt, max_to_keep=keep,
                save_interval_steps=interval)
            saved = [s for s in steps if jm.maybe_save(s, jparams, jstate)]
            jm.wait_until_finished()
            kept = sorted(int(p.name) for p in (tmp_path / f"s{n}").iterdir()
                          if p.name.isdigit())
            want.append({"saved": saved, "kept": kept,
                         "latest": jm.latest_step()})
            jm.close()
        for r in world()["schedule"]:
            assert r[n][:-1] == want
            assert r[n][-1] == want[-1]["latest"]
