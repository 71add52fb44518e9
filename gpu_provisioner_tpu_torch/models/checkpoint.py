"""Train-state checkpointing on ``torch.distributed.checkpoint``.

Twin of ``gpu_provisioner_tpu/models/checkpoint.py``: a checkpoint is the
tree ``{params, opt_state, step, layout}``, written atomically (a temporary
directory beside the target, then ``os.replace``: a save that dies never
corrupts the previous checkpoint), and ``restore_train_state`` and
``TrainCheckpointManager`` keep the reference's contract:

- ``opt_state`` mirrors optax's ``ScaleByAdamState``: ``count`` (int32) and
  ``mu``/``nu`` trees of the params' own names, not torch's index-keyed
  ``state_dict()``, so the files hold the reference's logical tree
  (``opt_state.mu.blocks.wq``, ...);
- on a mesh (``mesh=``, ``make_mesh``'s ``DeviceMesh``) every param, mu and
  nu leaf is saved as a ``DTensor`` over the rank's shard (``placements``:
  ``Shard(dim)`` at each axis its spec splits, ``Replicate()`` elsewhere;
  the specs are ``param_specs``, or ``pipeline_param_specs`` on a mesh
  with ``pipe`` > 1: ``mesh_specs``), so the files hold each logical
  leaf once, whatever mesh wrote it; a restore reads the rank's shards of
  the mesh it is given: restore doubles as reshard, from a mesh onto
  another mesh, onto one device, or from one device onto a mesh;
- every checkpoint records its pipeline layout ``(n_stages, n_chunks)``
  (a pipelined state's blocks in storage order, ``to_pipeline_layout``),
  and restore refuses a mismatch (a silent one would permute layers), on
  every rank and before anything is allocated; a checkpoint without the
  entry restores as (1, 1);
- the restore target's shapes come from a shape-only ``init_params`` on
  the ``meta`` device (on a mesh, the rank's shards of it:
  ``shard_params``), its optimizer state's shapes and dtypes from the
  optimizer callable (required: it fixes mu's dtype); the tensors are
  allocated on ``device`` and loaded in place, and the optimizer is built
  over the plain local tensors, the shards the train steps take;
- the manager saves the first step it sees and then every
  ``save_interval_steps``, never a step at or below the newest one, names
  step directories by the step number and keeps the newest
  ``max_to_keep``: orbax's ``CheckpointManager`` rules.

Deliberate differences:

- saves are synchronous: ``wait_until_finished`` returns at once and a
  temporary directory is never seen as a step (asynchronous saves,
  ``dcp.async_save``, wait until a save's time says they matter);
- in a process group every rank saves and restores together (``dcp`` is
  collective there) into one directory on a filesystem they share: rank 0
  refuses an existing destination and names the temporary directory, and
  broadcasts either; a replicated leaf is written once (``dcp``'s
  deduplication spreads such leaves over the ranks that hold them); after
  a barrier rank 0 alone renames the directory, syncs its parent and
  deletes rotated steps, and broadcasts how that went, so the ranks raise
  together or return together (``_on_rank0``; orbax coordinates its hosts
  itself);
- ``restore_train_state`` takes ``device`` (default cuda) and, on a mesh,
  ``mesh`` as keywords, where the reference takes the mesh positionally;
- the optimizer is the port's Adam (``models/train.py``), whose per-leaf
  state the checkpoint reads and writes;
- dense only, as the reference's restore target is (``init_params``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from ..device import resolve_device
from ..parallel.topology import AXIS_PIPE, axis_sizes
from .llama import LlamaConfig, init_params, param_specs
from .train import (adam_step, init_adam_state, param_leaves,
                    pipeline_param_specs, shard_params, split_axes,
                    train_state_from)


def _layout_entry(n_stages: int, n_chunks: int) -> dict:
    return {"n_stages": int(n_stages), "n_chunks": int(n_chunks)}


def _check_layout(got: dict, n_stages: int, n_chunks: int) -> None:
    want = _layout_entry(n_stages, n_chunks)
    if got != want:
        raise ValueError(
            f"checkpoint blocks are in pipeline layout {got}, but restore "
            f"expected {want} — restoring across layouts silently permutes "
            "layers. Convert between pipeline layouts first, or restore "
            "with the matching n_stages/n_chunks.")


def _tree_map(fn, tree: dict, *rest: dict) -> dict:
    return {k: _tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def mesh_specs(mesh) -> dict:
    """The spec tree a dense state on ``mesh`` is cut by:
    ``pipeline_param_specs`` where ``pipe`` > 1, else ``param_specs`` (both
    read no field of their config)."""
    if axis_sizes(mesh)[AXIS_PIPE] > 1:
        return pipeline_param_specs(None)
    return param_specs(None)


def placements(mesh, spec) -> list:
    """One leaf's ``DTensor`` placements on ``mesh`` (``make_mesh``'s six
    axes): ``Shard(dim)`` at each axis its spec splits
    (``train.split_axes``), ``Replicate()`` at every other. A spec that
    splits one dim over two axes raises: ``shard_params`` narrows such a
    dim axis by axis, in an order DTensor's placements do not follow."""
    from torch.distributed.tensor import Replicate, Shard

    axes = split_axes(spec)
    if len(set(axes.values())) < len(axes):
        raise ValueError(f"spec {spec} splits one dim over two axes")
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for axis, dim in axes.items():
        out[names.index(axis)] = Shard(dim)
    return out


def _on_mesh(tree: dict, specs: dict, mesh) -> dict:
    """``tree``'s local shards as DTensors over ``mesh`` that alias them (so
    a load into them lands in the local tensors)."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        return _tree_map(lambda t, spec: DTensor.from_local(
            t, mesh, placements(mesh, spec), run_check=False), tree, specs)


def adam_state_tree(params: dict, optimizer: torch.optim.Optimizer) -> dict:
    """optax's ScaleByAdamState over the optimizer's own tensors: {"count":
    int32 scalar, "mu": params' tree of exp_avg, "nu": of exp_avg_sq}. Leaves
    not stepped yet get their zero state first."""
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    if {id(p) for p in param_leaves(params)} != owned:
        raise ValueError("params are not the tree this optimizer was built "
                         "over")
    init_adam_state(optimizer)
    state = optimizer.state
    counts = {int(state[p]["step"]) for p in param_leaves(params)}
    if len(counts) != 1:
        raise ValueError(f"leaves at different Adam steps {sorted(counts)}")
    return {"count": torch.tensor(counts.pop(), dtype=torch.int32),
            "mu": _tree_map(lambda p: state[p]["exp_avg"], params),
            "nu": _tree_map(lambda p: state[p]["exp_avg_sq"], params)}


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _on_rank0(fn: Callable):
    """``fn()`` on rank 0 (the one process when no process group is live),
    its result or its exception broadcast to every rank: all return the
    result or all raise the exception, so no rank is left waiting in a
    collective for a peer that raised."""
    out = [None, None]
    if _is_rank0():
        try:
            out[0] = fn()
        except Exception as e:      # raised below, on every rank
            out[1] = e
    if dist.is_initialized():
        dist.broadcast_object_list(out, src=0)
    if out[1] is not None:
        raise out[1]
    return out[0]


def _write(path, tree: dict) -> None:
    """dcp.save of ``tree`` into a temporary directory beside ``path``, then
    renamed onto it. Refuses an existing ``path``, as orbax does. In a
    process group every rank calls this alike."""
    path = Path(path)

    def begin():
        if path.exists():
            raise ValueError(f"Destination {path} already exists.")
        path.parent.mkdir(parents=True, exist_ok=True)
        return tempfile.mkdtemp(prefix=f".{path.name}.tmp-", dir=path.parent)

    def commit():
        os.replace(tmp, path)
        _fsync_dir(path.parent)

    tmp = Path(_on_rank0(begin))
    try:
        dcp.save(tree, checkpoint_id=tmp)
        if dist.is_initialized():
            dist.barrier()
        _on_rank0(commit)
    except BaseException:
        if _is_rank0():
            shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_train_state(path, params: dict, optimizer: torch.optim.Optimizer,
                     step: int, *, n_stages: int = 1, n_chunks: int = 1,
                     mesh=None) -> None:
    """Write {params, opt_state, step, layout} atomically.

    ``n_stages``/``n_chunks``: the pipeline storage layout of
    params["blocks"] (1/1 = logical layer order), checked on restore.
    ``mesh``: ``params`` are this rank's shards on it, cut by
    ``mesh_specs``; every rank of the process group calls this
    alike, and the files hold the logical tree."""
    opt_state = adam_state_tree(params, optimizer)
    if mesh is not None:
        specs = mesh_specs(mesh)
        params = _on_mesh(params, specs, mesh)
        opt_state = dict(opt_state, mu=_on_mesh(opt_state["mu"], specs, mesh),
                         nu=_on_mesh(opt_state["nu"], specs, mesh))
    _write(path, {"params": params, "opt_state": opt_state,
                  "step": int(step),
                  "layout": _layout_entry(n_stages, n_chunks)})


def _stored_layout(path: Path) -> dict:
    """The layout stamp of the checkpoint at ``path``; (1, 1) for one
    written before the stamp. Collective in a process group."""
    stored = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    if not any(k.startswith("layout.") for k in stored):
        return _layout_entry(1, 1)
    got = {"layout": _layout_entry(0, 0)}
    dcp.load(got, checkpoint_id=path)
    return got["layout"]


def _target(cfg: LlamaConfig, optimizer: Callable, dev: torch.device,
            mesh=None):
    """(restore target, its params, the optimizer over them): the params'
    shapes from a shape-only init (on a mesh the rank's shards of it),
    allocated on ``dev``; the optimizer state's from ``optimizer`` over
    them. On a mesh the target's param, mu and nu leaves are DTensors
    aliasing the plain tensors the optimizer owns."""
    shapes = init_params(cfg, None, "meta",
                         dtype=getattr(torch, cfg.param_dtype))
    if mesh is not None:
        if mesh.device_type != dev.type:
            raise ValueError(f"a {mesh.device_type} mesh for a restore onto "
                             f"{dev}")
        specs = mesh_specs(mesh)
        shapes = shard_params(shapes, mesh, specs=specs)
    params, opt = train_state_from(
        _tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                  shapes), optimizer)
    opt_state = adam_state_tree(params, opt)
    target = {"params": params, "opt_state": opt_state, "step": 0}
    if mesh is not None:
        target["params"] = _on_mesh(params, specs, mesh)
        target["opt_state"] = dict(
            opt_state, mu=_on_mesh(opt_state["mu"], specs, mesh),
            nu=_on_mesh(opt_state["nu"], specs, mesh))
    return target, params, opt


def restore_train_state(path, cfg: LlamaConfig, optimizer: Callable, *,
                        device=None, n_stages: int = 1, n_chunks: int = 1,
                        mesh=None):
    """(params, optimizer, step) restored onto ``device`` (default cuda),
    whatever device or mesh wrote the checkpoint: the whole leaves, or on
    ``mesh`` this rank's shards of them, cut by ``mesh_specs`` (every rank
    calls this alike).

    ``optimizer`` (a callable on the leaves, as ``train_state_from`` takes)
    is required, not defaulted: the target's mu dtype comes from it, and a
    bf16-mu checkpoint restored through an f32-mu optimizer would diverge
    from the uninterrupted run. ``n_stages``/``n_chunks`` must match the
    layout stamped at save time (ValueError otherwise, before anything is
    allocated)."""
    dev = resolve_device(device)
    path = Path(path)
    _check_layout(_stored_layout(path), n_stages, n_chunks)
    target, params, opt = _target(cfg, optimizer, dev, mesh)
    with torch.no_grad():
        dcp.load(target, checkpoint_id=path)
    count = int(target["opt_state"]["count"])
    for p in param_leaves(params):
        opt.state[p]["step"] = adam_step(count)
    return params, opt, int(target["step"])


class TrainCheckpointManager:
    """Rotating checkpoint schedule around save/restore_train_state: save
    the first step seen and then every ``save_interval_steps``, keep the
    newest ``max_to_keep``, resume from the newest (``restore_latest``,
    onto ``device``, and on ``mesh`` each rank's shards).
    In a process group every rank drives its manager alike: each reads the
    schedule after a barrier, so all take the same decision."""

    def __init__(self, directory, cfg: LlamaConfig, optimizer: Callable, *,
                 device=None, max_to_keep: int = 3,
                 save_interval_steps: int = 100, n_stages: int = 1,
                 n_chunks: int = 1, mesh=None):
        if max_to_keep < 1 or save_interval_steps < 1:
            raise ValueError(f"max_to_keep {max_to_keep} and "
                             f"save_interval_steps {save_interval_steps} "
                             "must be positive")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        self.optimizer = optimizer
        self.device = resolve_device(device)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.n_stages = n_stages
        self.n_chunks = n_chunks
        self.mesh = mesh

    def all_steps(self) -> list:
        """The committed steps, oldest first (a temporary directory's name
        is not a number)."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and p.is_dir())

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _should_save(self, step: int) -> bool:
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            return False
        return not steps or step % self.save_interval_steps == 0

    def maybe_save(self, step: int, params: dict,
                   optimizer: torch.optim.Optimizer) -> bool:
        """Save iff the schedule says so; returns whether a save happened."""
        if dist.is_initialized():
            dist.barrier()
        if not self._should_save(step):
            return False
        save_train_state(self.directory / str(step), params, optimizer, step,
                         n_stages=self.n_stages, n_chunks=self.n_chunks,
                         mesh=self.mesh)

        def rotate():
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old))

        _on_rank0(rotate)
        return True

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is ever in flight."""

    def restore_latest(self):
        """(params, optimizer, step) from the newest checkpoint, or None
        when the directory holds none (a fresh run)."""
        step = self.latest_step()
        if step is None:
            return None
        return restore_train_state(
            self.directory / str(step), self.cfg, self.optimizer,
            device=self.device, n_stages=self.n_stages,
            n_chunks=self.n_chunks, mesh=self.mesh)

    def close(self) -> None:
        """Nothing to release: no save runs in the background."""
