"""Train-state checkpointing on ``torch.distributed.checkpoint``.

Twin of ``gpu_provisioner_tpu/models/checkpoint.py`` on one GPU: a
checkpoint is the tree ``{params, opt_state, step, layout}``, written
atomically (a temporary directory beside the target, then ``os.replace``:
a save that dies never corrupts the previous checkpoint), and
``restore_train_state`` and ``TrainCheckpointManager`` keep the
reference's contract:

- ``opt_state`` mirrors optax's ``ScaleByAdamState``: ``count`` (int32) and
  ``mu``/``nu`` trees of the params' own names, not torch's index-keyed
  ``state_dict()``, so the files hold the reference's logical tree
  (``opt_state.mu.blocks.wq``, ...) and a multi-GPU restore can reshard
  it;
- every checkpoint records its pipeline layout ``(n_stages, n_chunks)``,
  and restore refuses a mismatch (a silent one would permute layers); a
  checkpoint without the entry restores as (1, 1);
- the restore target's shapes come from a shape-only ``init_params`` on
  the ``meta`` device, its optimizer state's shapes and dtypes from the
  optimizer callable (required: it fixes mu's dtype), and the tensors are
  allocated on ``device`` and loaded in place (``dcp`` runs as one process
  when no process group is initialised);
- the manager saves the first step it sees and then every
  ``save_interval_steps``, never a step at or below the newest one, names
  step directories by the step number and keeps the newest
  ``max_to_keep``: orbax's ``CheckpointManager`` rules.

Deliberate differences:

- saves are synchronous: ``wait_until_finished`` returns at once and a
  temporary directory is never seen as a step (asynchronous saves,
  ``dcp.async_save``, wait until a save's time says they matter);
- restore is onto one device (``device``, default cuda), the one-GPU twin
  of "onto the current mesh": restoring a card's checkpoint onto the CPU
  is the twin of restore-as-reshard; a restore onto a mesh (shards by
  ``param_specs``) is not ported yet;
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
import torch.distributed.checkpoint as dcp

from ..device import resolve_device
from .llama import LlamaConfig, init_params
from .train import adam_step, init_adam_state, param_leaves, train_state_from


def _layout_entry(n_stages: int, n_chunks: int) -> dict:
    return {"n_stages": int(n_stages), "n_chunks": int(n_chunks)}


def _check_layout(restored: dict, n_stages: int, n_chunks: int) -> None:
    got = restored.get("layout", _layout_entry(1, 1))
    want = _layout_entry(n_stages, n_chunks)
    if got != want:
        raise ValueError(
            f"checkpoint blocks are in pipeline layout {got}, but restore "
            f"expected {want} — restoring across layouts silently permutes "
            "layers. Convert between pipeline layouts first, or restore "
            "with the matching n_stages/n_chunks.")


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


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


def _write(path, tree: dict) -> None:
    """dcp.save of ``tree`` into a temporary directory beside ``path``, then
    renamed onto it. Refuses an existing ``path``, as orbax does."""
    path = Path(path)
    if path.exists():
        raise ValueError(f"Destination {path} already exists.")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{path.name}.tmp-",
                                dir=path.parent))
    try:
        dcp.save(tree, checkpoint_id=tmp)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(path.parent)


def save_train_state(path, params: dict, optimizer: torch.optim.Optimizer,
                     step: int, *, n_stages: int = 1,
                     n_chunks: int = 1) -> None:
    """Write {params, opt_state, step, layout} atomically.

    ``n_stages``/``n_chunks``: the pipeline storage layout of
    params["blocks"] (1/1 = logical layer order), checked on restore."""
    _write(path, {"params": params,
                  "opt_state": adam_state_tree(params, optimizer),
                  "step": int(step),
                  "layout": _layout_entry(n_stages, n_chunks)})


def _target(cfg: LlamaConfig, optimizer: Callable, dev: torch.device):
    """(restore target, the optimizer over its params): the params' shapes
    from a shape-only init, allocated on ``dev``; the optimizer state's
    from ``optimizer`` over them."""
    shapes = init_params(cfg, None, "meta",
                         dtype=getattr(torch, cfg.param_dtype))
    params, opt = train_state_from(
        _tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                  shapes), optimizer)
    return {"params": params, "opt_state": adam_state_tree(params, opt),
            "step": 0, "layout": _layout_entry(1, 1)}, opt


def _load(path, target: dict) -> dict:
    """dcp.load into ``target`` in place; a checkpoint written before the
    layout stamp has no ``layout`` entry, and the target drops it."""
    stored = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    if not any(k.startswith("layout.") for k in stored):
        target.pop("layout")
    with torch.no_grad():
        dcp.load(target, checkpoint_id=path)
    return target


def restore_train_state(path, cfg: LlamaConfig, optimizer: Callable, *,
                        device=None, n_stages: int = 1, n_chunks: int = 1):
    """(params, optimizer, step) restored onto ``device`` (default cuda),
    whatever device wrote the checkpoint.

    ``optimizer`` (a callable on the leaves, as ``train_state_from`` takes)
    is required, not defaulted: the target's mu dtype comes from it, and a
    bf16-mu checkpoint restored through an f32-mu optimizer would diverge
    from the uninterrupted run. ``n_stages``/``n_chunks`` must match the
    layout stamped at save time (ValueError otherwise)."""
    target, opt = _target(cfg, optimizer, resolve_device(device))
    restored = _load(Path(path), target)
    _check_layout(restored, n_stages, n_chunks)
    count = int(restored["opt_state"]["count"])
    for p in param_leaves(restored["params"]):
        opt.state[p]["step"] = adam_step(count)
    return restored["params"], opt, int(restored["step"])


class TrainCheckpointManager:
    """Rotating checkpoint schedule around save/restore_train_state: save
    the first step seen and then every ``save_interval_steps``, keep the
    newest ``max_to_keep``, resume from the newest (``restore_latest``,
    onto ``device``)."""

    def __init__(self, directory, cfg: LlamaConfig, optimizer: Callable, *,
                 device=None, max_to_keep: int = 3,
                 save_interval_steps: int = 100, n_stages: int = 1,
                 n_chunks: int = 1):
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
        if not self._should_save(step):
            return False
        save_train_state(self.directory / str(step), params, optimizer, step,
                         n_stages=self.n_stages, n_chunks=self.n_chunks)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))
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
            n_chunks=self.n_chunks)

    def close(self) -> None:
        """Nothing to release: no save runs in the background."""
