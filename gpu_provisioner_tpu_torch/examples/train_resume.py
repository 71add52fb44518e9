"""End-to-end workload example: a world of ranks → mesh → train → resume.

Twin of ``examples/workloads/train_resume.py``::

    python -m gpu_provisioner_tpu_torch.examples.train_resume            # cuda
    python -m gpu_provisioner_tpu_torch.examples.train_resume --device cpu

Two ranks (``parallel/launch.py``, gloo) form a data-parallel mesh; the
``tiny`` model trains for STEPS steps, checkpoints every SAVE_EVERY
(``models/checkpoint.py`` on the mesh), is "preempted" right after the
first checkpoint, then restores it onto a *different* mesh layout,
``make_mesh(tp=2)`` (the restore reshards), and finishes. Rank 0's lines
are printed. With ``TPU_KAITO_BOOTSTRAP=auto`` the process is instead one
rank of the world its pod belongs to: ``parallel/bootstrap.py`` reads its
Node's labels (``NODE_NAME``) and starts the process group, and the same
rank body runs over that world (``examples.run_bootstrapped``; the
checkpoint directory is rank 0's temporary one, so the ranks must share a
filesystem).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..device import resolve_device
from ..models.checkpoint import restore_train_state, save_train_state
from ..models.llama import PRESETS
from ..models.train import default_optimizer, make_train_state, make_train_step
from ..parallel.launch import spawn_ranks
from ..parallel.topology import axis_sizes, make_mesh
from . import run_bootstrapped

CFG = PRESETS["tiny"]
STEPS, SAVE_EVERY = 6, 3
WORLD = 2


def batch(step_idx: int, dev: torch.device):
    """The global batch of a step (the same on every rank; the step takes
    its rows)."""
    g = torch.Generator().manual_seed(100 + step_idx)
    toks = torch.randint(0, CFG.vocab_size, (8, CFG.max_seq_len // 32 + 1),
                         generator=g).to(dev)
    return toks[:, :-1], toks[:, 1:]


def rank_main(device: str, ckdir: str) -> list:
    """One rank of the example: its printed lines."""
    lines = []
    dev = resolve_device(device)
    mesh = make_mesh(device=device)       # data parallel over the world
    lines.append(f"mesh: {axis_sizes(mesh)}")
    params, opt = make_train_state(CFG, torch.Generator(dev).manual_seed(0),
                                   dev, optimizer=default_optimizer,
                                   mesh=mesh)
    step_fn = make_train_step(CFG, opt, mesh=mesh)
    for i in range(STEPS):
        loss = step_fn(params, *batch(i, dev))
        done = i + 1
        lines.append(f"step {done}: loss {loss.item():.4f}")
        if done % SAVE_EVERY == 0:
            save_train_state(f"{ckdir}/step{done}", params, opt, done,
                             mesh=mesh)
            lines.append(f"checkpointed at step {done}")
        if done == SAVE_EVERY:
            break                        # simulate preemption mid-run
    del params, opt, step_fn

    # --- "repair replaced the slice": resume on a different layout
    mesh2 = make_mesh(tp=2, device=device)
    lines.append(f"resuming on mesh: {axis_sizes(mesh2)}")
    params, opt, start = restore_train_state(
        f"{ckdir}/step{SAVE_EVERY}", CFG, default_optimizer, device=dev,
        mesh=mesh2)
    step_fn = make_train_step(CFG, opt, mesh=mesh2)
    for i in range(start, STEPS):
        loss = step_fn(params, *batch(i, dev))
        lines.append(f"step {i + 1} (resumed): loss {loss.item():.4f}")
    lines.append("done")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="what the ranks compute on (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    from . import train_resume   # rank_main by its module's name, for ranks

    if os.environ.get("TPU_KAITO_BOOTSTRAP", "") == "auto":
        lines = run_bootstrapped(train_resume.rank_main, dev,
                                 temporary_dir="torch-train-")
    else:
        with tempfile.TemporaryDirectory(prefix="torch-train-") as ckdir:
            lines = spawn_ranks(train_resume.rank_main, WORLD,
                                backend="gloo", device=dev, timeout_s=300,
                                args=(dev.type, ckdir))[0]
    if lines is not None:
        print("\n".join(lines))


if __name__ == "__main__":
    main()
