"""End-to-end workload example on one device: train → checkpoint → resume.

Twin of ``examples/workloads/train_resume.py``, single-device half::

    python -m gpu_provisioner_tpu_torch.examples.train_resume            # cuda
    python -m gpu_provisioner_tpu_torch.examples.train_resume --device cpu

The ``tiny`` model trains for STEPS steps, checkpoints every SAVE_EVERY
(``models/checkpoint.py``), is "preempted" right after the first
checkpoint, then restores it with ``restore_train_state`` onto the device
and finishes. The reference's resume onto a *different* mesh layout and
its ``TPU_KAITO_BOOTSTRAP`` path (a slice bootstrapped from the
provisioner's node labels) are not ported: the restore onto another mesh
waits (ROADMAP Queue A 3).
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from ..device import resolve_device
from ..models.checkpoint import restore_train_state, save_train_state
from ..models.llama import PRESETS
from ..models.train import default_optimizer, make_train_state, make_train_step

CFG = PRESETS["tiny"]
STEPS, SAVE_EVERY = 6, 3


def batch(step_idx: int, dev: torch.device):
    g = torch.Generator().manual_seed(100 + step_idx)
    toks = torch.randint(0, CFG.vocab_size, (8, CFG.max_seq_len // 32 + 1),
                         generator=g).to(dev)
    return toks[:, :-1], toks[:, 1:]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    print(f"device: {dev}")
    with tempfile.TemporaryDirectory(prefix="torch-train-") as ckdir:
        params, opt = make_train_state(
            CFG, torch.Generator(dev).manual_seed(0), dev,
            optimizer=default_optimizer)
        step_fn = make_train_step(CFG, opt)
        for i in range(STEPS):
            loss = step_fn(params, *batch(i, dev))
            done = i + 1
            print(f"step {done}: loss {loss.item():.4f}")
            if done % SAVE_EVERY == 0:
                save_train_state(f"{ckdir}/step{done}", params, opt, done)
                print(f"checkpointed at step {done}")
            if done == SAVE_EVERY:
                break                    # simulate preemption mid-run
        del params, opt, step_fn

        # --- the job restarts: a fresh process state restores the newest
        print(f"resuming on device: {dev}")
        params, opt, start = restore_train_state(
            f"{ckdir}/step{SAVE_EVERY}", CFG, default_optimizer, device=dev)
        step_fn = make_train_step(CFG, opt)
        for i in range(start, STEPS):
            loss = step_fn(params, *batch(i, dev))
            print(f"step {i + 1} (resumed): loss {loss.item():.4f}")
    print("done")


if __name__ == "__main__":
    main()
