"""Start a world of ranks on this host, one process each.

No JAX twin: ``jax.distributed`` has no launcher (the JAX package's
processes are the pods the provisioner starts). ``spawn_ranks`` starts one
process per rank with ``torch.multiprocessing`` (start method ``spawn``),
joins them into a process group at a free localhost port and returns each
rank's result. The ranks use this host's loopback interface, so gloo
binds there (``GLOO_SOCKET_IFNAME=lo`` unless the caller set it).

There is no fallback that hides a failure: a rank that raises, dies, or
outlives ``timeout_s`` fails the call. The launcher then gives the other
ranks a bounded grace to end by themselves (a peer that lost the failed
rank fails too, and either may report first; a rank at low priority on a
loaded host may wake late), terminates those still running (which may wait
in a collective for the failed one) and raises naming every failed rank:
its traceback, its exit code, or that the launcher stopped it.

The ranks pass a barrier once they have all joined the group, before any
runs ``fn``, so that a rank that fails at once cannot fail a slower peer's
join. A rank imports ``fn``'s module and torch, nothing of the caller's
module (pickled by reference, ``fn`` must live at the top level of an
importable module: this package or the script that calls). On the CPU each
rank runs torch on one thread, at the lowest scheduling priority (nice 19),
so that a world of ranks computing flat out does not starve the host's
other processes. On the card each rank drives card ``rank %
device_count``: all of them card 0 on a one-card machine (with gloo).
Ranks must not build the kernels at once: the caller builds them first
(``ops._cuda.build()``), and the ranks only load them.
"""

from __future__ import annotations

import contextlib
import os
import queue
import socket
import time
import traceback
from datetime import timedelta
from typing import Callable, Sequence

from ..device import resolve_device


_FLUSH_S = 2.0
# after a failure, once its settle window has closed: the seconds the ranks
# still running get to end by themselves before the launcher stops them
# (only a failed launch waits, and a rank hung in a collective at most this)
_GRACE_S = 10.0
# a CPU world's ranks yield the host's cores to its other work first
_CPU_NICE = 19


class RankError(RuntimeError):
    """A rank raised or died; the message holds its traceback."""


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device_type, timeout_s, work,
               results):
    import torch
    import torch.distributed as dist

    try:
        fn, args = work.get()
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # one host
        if device_type == "cpu":
            torch.set_num_threads(1)
            os.nice(_CPU_NICE)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}",
            world_size=world, rank=rank, timeout=timedelta(seconds=timeout_s))
        # every rank has joined before any runs fn: a rank that fails at
        # once and tears its group down would otherwise fail a slower
        # peer's join, which would then report that and not its own fate
        dist.barrier()
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *, backend: str, device=None,
                timeout_s: float = 120.0, args: Sequence = ()) -> list:
    """Runs ``fn(*args)`` on ``world_size`` ranks of a new ``backend``
    process group and returns [rank 0's result, rank 1's, ...] (each
    pickled back). ``device`` (default cuda; raises without a card) is the
    device type the ranks compute on. Raises RankError (every failed
    rank's traceback, or its exit code, or that it was stopped) when a rank
    raises or dies, TimeoutError when the ranks have not all returned
    within ``timeout_s``; either way every rank is stopped first. After a
    failure the ranks still running get ``_GRACE_S`` seconds from the close
    of the settle window to end by themselves, each one that does then
    named with its exit code or traceback, and each one that does not named
    as stopped."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    ctx = mp.get_context("spawn")
    work, results = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(r, world_size, port, backend, dev.type, timeout_s, work,
              results))
        for r in range(world_size)]
    for p in procs:
        p.start()
    # the function and its arguments go through a queue, not the process
    # arguments: a start whose pickled arguments outgrow the pipe's buffer
    # waits until that rank has imported its modules, one rank after another
    for _ in procs:
        work.put((fn, tuple(args)))
    out: dict = {}
    errors: dict = {}            # rank → what went wrong
    exited: dict = {}            # rank → when it was first seen gone
    settle = None                # after a failure: when to stop collecting
    first_error = None           # when the first failure was seen
    deadline = time.monotonic() + timeout_s

    def take(rank, ok, payload):
        if ok:
            out[rank] = payload
        else:
            errors[rank] = f"raised:\n{payload}"

    try:
        while len(out) + len(errors) < world_size:
            now = time.monotonic()
            if settle is not None and now >= settle:
                break
            if now >= deadline:
                if errors:
                    break
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(out))} of "
                    f"{world_size} did not return within {timeout_s} s")
            try:
                rank, ok, payload = results.get(
                    timeout=min(deadline - now, 0.2))
            except queue.Empty:
                # a rank that exited had its result flushed to the queue
                # first: give the pipe a moment before calling it dead
                for r, p in enumerate(procs):
                    if r in out or r in errors or p.exitcode is None:
                        continue
                    if now - exited.setdefault(r, now) > _FLUSH_S:
                        errors[r] = (f"died with exit code {p.exitcode} and "
                                     "no result")
                        settle = settle or now + _FLUSH_S
                        first_error = first_error or now
                continue
            take(rank, ok, payload)
            if not ok:
                # the others' errors follow (a peer that lost this rank
                # fails too): collect them for a moment, then report all
                now = time.monotonic()
                settle = settle or now + _FLUSH_S
                first_error = first_error or now
        if errors:
            # the window closed: the ranks still running get a grace to end
            # by themselves, the pipe read meanwhile (a rank that put a
            # result cannot exit before the pipe has taken it); then every
            # rank gone without a result is named with its exit code, and
            # every one still running as stopped
            stop = time.monotonic() + _GRACE_S
            while True:
                running = [r for r, p in enumerate(procs) if r not in out
                           and r not in errors and p.exitcode is None]
                with contextlib.suppress(queue.Empty):
                    while True:
                        take(*results.get(timeout=0.05))
                if not running or time.monotonic() >= stop:
                    break
            for r, p in enumerate(procs):
                if r in out or r in errors:
                    continue
                errors[r] = (
                    f"died with exit code {p.exitcode} and no result"
                    if p.exitcode is not None else
                    "stopped by the launcher, still running "
                    f"{time.monotonic() - first_error:.1f} s after the "
                    "first error")
            raise RankError("\n".join(f"rank {r} {e}"
                                      for r, e in sorted(errors.items())))
    finally:
        if len(out) < world_size:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        work.close()
        work.cancel_join_thread()     # copies a dead rank never took
        results.close()
    return [out[r] for r in range(world_size)]
