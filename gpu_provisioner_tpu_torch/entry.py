"""The graft entry: the single-device forward and a dry run of every
parallelism regime on a world of ranks.

Twin of ``__graft_entry__.py``. ``entry()`` gives (fn, example_args), the
forward of the flagship (``tiny``) model; ``dryrun_multichip(n)`` runs one
program a regime on n ranks, tiny shapes:

- ``dense``: one train step over (slice, data, seq, model);
- ``pipeline``: one gpipe-interleaved step over (data, pipe, model);
- ``moe``: one MoE step over (data, expert, model);
- ``serving``: generate on a bf16 (the act dtype) cache, generate on an
  int8 cache with left pads and eos, self-draft speculative decoding and
  a ``ServeEngine``, on tp-sharded weights over (data, model);
- ``serving_moe``: MoE generate over (data, expert, model).

It asserts what the reference asserts (finite values, speculation equal to
plain decode row for row, the engine's streams equal to generate's) and
prints the same lines: ``dryrun_multichip [<regime>] ok: mesh=...`` and
the axes > 1 the cases covered. Deliberate differences:

- every regime runs on one world of n ranks (``parallel/launch.py``
  ``spawn_ranks``, gloo, one process a rank; ``parallel/jobs.py``'s
  ``train_case`` and ``serving_case``), where the reference is one
  process over n devices;
- no fallback: ``device`` (default cuda) is the one the ranks compute on,
  and without a card the call raises, where the reference's ``_devices``
  falls back to the CPU; on the card the kernels are built first (the
  ranks only load them);
- the batches and the weights come from ``torch.Generator`` seeds
  (``jax.random`` cannot be reproduced).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .device import resolve_device
from .models.llama import PRESETS, init_params
from .models.moe import PRESETS_MOE
from .models.train import make_forward
from .parallel import jobs
from .parallel.launch import spawn_ranks
from .parallel.topology import MESH_AXES, TopologyError, mesh_shape_for

SERVE_NEW = 4           # tokens each serving program generates
WORLD_TIMEOUT_S = 600.0


def entry(device=None):
    """(fn, example_args): the single-device forward on the flagship model,
    params drawn from seed 0 on ``device`` (default cuda)."""
    dev = resolve_device(device)
    cfg = PRESETS["tiny"]
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.zeros((2, 32), dtype=torch.int32, device=dev)
    return make_forward(cfg), (params, tokens)


def _viable(n: int, **split) -> bool:
    try:
        mesh_shape_for(n, **split)
        return True
    except TopologyError:
        return False


def _pick_cases(n: int) -> list[tuple[str, dict]]:
    """(regime, mesh split) cases for n ranks: the first viable dense split,
    plus pipeline, MoE, serving and MoE-serving cases where n allows, so
    that every mesh axis > 1 is exercised across the set."""
    cases: list[tuple[str, dict]] = []
    for cand in ({"num_slices": 2, "sp": 2, "tp": 2},
                 {"num_slices": 1, "sp": 2, "tp": 2},
                 {"num_slices": 1, "sp": 2, "tp": 1},
                 {"num_slices": 1, "sp": 1, "tp": 2},
                 {"num_slices": 1, "sp": 1, "tp": 1}):
        if _viable(n, **cand):
            cases.append(("dense", cand))
            break
    for cand in ({"pp": 2, "tp": 2}, {"pp": 2}):
        if n >= 4 and _viable(n, **cand):
            cases.append(("pipeline", cand))
            break
    for cand in ({"ep": 2, "tp": 2}, {"ep": 2}):
        if n >= 4 and _viable(n, **cand):
            cases.append(("moe", cand))
            break
    for cand in ({"tp": 2},):
        if n >= 2 and _viable(n, **cand):
            cases.append(("serving", cand))
            break
    for cand in ({"ep": 2, "tp": 2}, {"ep": 2}):
        if n >= 4 and _viable(n, **cand):
            cases.append(("serving_moe", cand))
            break
    if not cases:
        raise TopologyError(f"no factorization for {n} devices")
    return cases


def _shape(n: int, split: dict) -> dict:
    return dict(zip(MESH_AXES, mesh_shape_for(n, **split)))


def _batch(shape: dict) -> int:
    """(slice × data) × an even multiplier ≥ 8 / (slice × data): divisible
    by the batch's split and by n_micro = 2 at any n."""
    bs = shape["slice"] * shape["data"]
    mult = max(2, -(-8 // bs))
    return bs * (mult + mult % 2)


def _serving_programs(batch: int, moe: bool) -> list:
    """The reference's serving programs on a [batch, 8] prompt of ones."""
    ones = np.ones((batch, 8), np.int32)
    if moe:
        return [{"name": "fp", "kind": "generate", "prompt": ones,
                 "new": SERVE_NEW, "max_len": 32}]
    pads = ones.copy()
    pads[0, :3] = 0                                       # 3 pads
    return [{"name": "fp", "kind": "generate", "prompt": ones,
             "new": SERVE_NEW},
            {"name": "int8", "kind": "generate", "prompt": pads,
             "new": SERVE_NEW, "cfg": {"kv_cache_dtype": "int8"},
             "pad_id": 0, "eos_id": 1},
            {"name": "spec", "kind": "speculative", "prompt": ones,
             "new": SERVE_NEW, "spec_k": 2},
            {"name": "engine", "kind": "engine", "slots": 2, "max_len": 32,
             "buckets": (8,), "requests": [([1] * 8, SERVE_NEW, None)] * 2}]


def _case(regime: str, split: dict, shape: dict) -> dict:
    """The jobs.py case of one regime."""
    mesh = dict(split)
    batch = _batch(shape)
    if regime == "serving":
        return {"kind": "serving", "mesh": mesh, "cfg": PRESETS["tiny"],
                "programs": _serving_programs(batch, False), "seed": 0}
    if regime == "serving_moe":
        return {"kind": "serving_moe", "mesh": mesh,
                "cfg": PRESETS_MOE["tiny-moe"],
                "programs": _serving_programs(batch, True), "seed": 2}
    case = {"kind": "train", "mesh": mesh, "cfg": PRESETS["tiny"], "seed": 0,
            "batch_shape": (batch, 64)}
    if regime == "pipeline":
        # f32 and 4 layers, as the reference (its CPU dry run cannot take
        # bf16 collectives there); n_chunks 2: the interleaved schedule
        case.update(kind="pipeline", n_micro=2, n_chunks=2,
                    cfg=dataclasses.replace(PRESETS["tiny"], n_layers=4,
                                            dtype="float32"))
    elif regime == "moe":
        case.update(kind="moe", cfg=PRESETS_MOE["tiny-moe"])
    return case


def _ensure(cond, msg) -> None:
    """The reference's assert, kept under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


def _serving_value(regime: str, ranks: list, vocab: int):
    """Checks one serving regime's ranks as the reference does and returns
    (metric, value): the mean token of the int8 program (the MoE program's
    for serving_moe) over the whole batch."""
    rows = {}
    for r in ranks:
        progs = r["programs"]
        fp = progs["fp"]["out"]
        check = progs.get("int8", progs["fp"])["out"]
        lo, hi = progs["fp"]["rows"]
        for out in (fp, check):
            _ensure(out.shape == (hi - lo, SERVE_NEW), out.shape)
            _ensure(int(out.min()) >= 0 and int(out.max()) < vocab,
                    f"tokens outside the vocabulary: {out}")
        if regime == "serving":
            _ensure((progs["spec"]["out"] == fp).all(),
                    "sharded speculative != plain decode")
            want = [int(t) for t in fp[0]]
            _ensure(all(s == want for s in progs["engine"]["out"]),
                    "sharded engine != generate stream")
        rows[lo, hi] = check
    value = float(np.concatenate([rows[k] for k in sorted(rows)]).mean())
    return "mean_token", value


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Every regime of ``_pick_cases(n_devices)`` on one world of
    ``n_devices`` ranks computing on ``device`` (default cuda; raises
    without a card; all ranks on card ``rank % device_count``): one
    program each, its checks, and the reference's lines."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from .ops import _cuda
        _cuda.build()           # the ranks load the kernels, never build
    picked = _pick_cases(n_devices)
    shapes = [_shape(n_devices, split) for _, split in picked]
    cases = [_case(regime, split, shape)
             for (regime, split), shape in zip(picked, shapes)]
    res = spawn_ranks(jobs.run_cases, n_devices, backend="gloo", device=dev,
                      timeout_s=WORLD_TIMEOUT_S, args=(cases, dev.type))
    axes_hit: set[str] = set()
    for i, ((regime, _), shape, case) in enumerate(zip(picked, shapes,
                                                       cases)):
        ranks = [r[i] for r in res]
        if regime.startswith("serving"):
            metric, value = _serving_value(regime, ranks,
                                           case["cfg"].vocab_size)
        else:
            losses = [r["losses"][0] for r in ranks]
            _ensure(all(x == losses[0] for x in losses),
                    f"ranks disagree on the loss: {losses}")
            metric, value = "loss", losses[0]
        _ensure(math.isfinite(value),
                f"non-finite {metric} {value} [{regime}] on mesh {shape}")
        axes_hit |= {ax for ax, size in shape.items() if size > 1}
        print(f"dryrun_multichip [{regime}] ok: mesh={shape} "
              f"{metric}={value:.4f}")
    print(f"dryrun_multichip ok: n={n_devices} axes>1 covered: "
          f"{sorted(axes_hit)}")
