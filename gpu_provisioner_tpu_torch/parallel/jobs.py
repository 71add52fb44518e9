"""What one rank of a spawned world computes, case by case.

No JAX twin. ``run_cases`` is the function ``launch.spawn_ranks`` hands the
ranks when a caller (a test, ``chip_smoke.py``) wants several sharded runs
out of one world: every rank builds every case's mesh in the same order
(the meshes' process groups are built collectively) and returns one result
a case, which the caller assembles with ``assemble`` and holds against a
single-process run. The cases:

- ``mesh``: the mesh's axis sizes, this rank's coordinates, whether
  ``make_attn_fn(mesh)`` is plain ``dense_attention``, and whether jax was
  imported in this process;
- ``attention``: ``make_attn_fn`` on the rank's blocks of global q/k/v
  (batch over slice·data, sequence over ``seq``, heads over ``model``;
  blocks of the zigzag-permuted sequence under that schedule), and with
  ``dout`` its gradients: each block returned with its global index;
- ``train`` (``pipeline``, ``moe``): ``make_train_state``/
  ``make_train_step`` on the mesh (``make_pipeline_train_state``/
  ``make_pipeline_train_step``; ``make_moe_train_state``/
  ``make_moe_train_step``), from given params (numpy, the JAX layout) or
  a seed, over given or seeded batches: losses, step times (synchronised
  host clock), bytes staged through the host a step and the host seconds
  in the collectives, peak memory, kernel launches over the timed steps,
  and, given a reference (a single-process step, saved with
  ``torch.save``), how far this rank's gradients and updated shards after
  the first step lie from its shards of it;
- ``pipeline_forward``: ``make_pipeline_forward``'s logits on the last
  stage; ``refusals``: the ValueErrors of the pipelined step's
  preconditions and of ``make_train_step`` on a ``pipe`` mesh;
- ``serving`` (``serving_moe``): a list of serving programs on the mesh,
  through the entry points a user calls (``generate``,
  ``speculative_generate``, ``ServeEngine``, ``cached_forward`` with
  ``mesh=``/``shard=``), from the rank's shards of given params (numpy,
  the JAX layout) or of a seeded tree: each program's tokens (the rank's
  rows of a global prompt, or the engine's streams) or logits, its wall
  times, its kernel launches, the bytes staged through the host and the
  host seconds in the collectives, and peak memory; ``serve_refusals``:
  the ValueErrors of serving on meshes and params it refuses.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..models.convert import params_from_numpy
from ..models.decode import cached_forward, generate, init_kv_cache, serve_shard
from ..models.engine import ServeEngine
from ..models.llama import init_params, param_specs
from ..models.moe import (init_moe_model, make_moe_train_state,
                          make_moe_train_step, moe_model_specs)
from ..models.speculative import speculative_generate
from ..models.train import (batch_rows, make_attn_fn, make_pipeline_forward,
                            make_pipeline_train_state,
                            make_pipeline_train_step, make_train_state,
                            make_train_step, pipeline_param_specs,
                            shard_params, train_state_from)
from ..ops import flash_attention as tfa
from . import comm
from .pipeline import to_pipeline_layout
from .ring import dense_attention, zigzag_order
from .topology import (AXIS_DATA, AXIS_MODEL, AXIS_PIPE, AXIS_SEQ,
                       AXIS_SLICE, axis_index, axis_sizes, make_mesh)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _coords(mesh) -> dict:
    return {a: axis_index(mesh, a) for a in mesh.mesh_dim_names}


def mesh_case(device, mesh: dict) -> dict:
    m = make_mesh(**mesh, device=device)
    return {"shape": axis_sizes(m), "coords": _coords(m),
            "dense_is_default": make_attn_fn(m) is dense_attention,
            "jax_loaded": "jax" in sys.modules}


def attention_case(device, mesh: dict, q, k, v, dout=None, *,
                   schedule: str = "ring", impl: str = "dense",
                   causal: bool = True, dtype: str = "float32",
                   replicate_batch: bool = False) -> dict:
    """Rank blocks of make_attn_fn(mesh, impl, schedule) on global q
    [B,S,Hq,D], k/v [B,S,Hkv,D] (numpy) → {"index": (batch slice, sequence
    positions, q-head slice, kv-head slice), "out", and with ``dout`` "dq",
    "dk", "dv"} as f32 numpy. ``replicate_batch``: every rank takes all
    rows (a batch dim the spec leaves unsharded)."""
    dev = resolve_device(device)
    m = make_mesh(**mesh, device=device)
    sizes = axis_sizes(m)
    B, S, Hq, _ = q.shape
    Hkv = k.shape[2]
    nb = 1 if replicate_batch else sizes[AXIS_SLICE] * sizes[AXIS_DATA]
    bi = 0 if replicate_batch else (axis_index(m, AXIS_SLICE)
                                    * sizes[AXIS_DATA]
                                    + axis_index(m, AXIS_DATA))
    ns, si = sizes[AXIS_SEQ], axis_index(m, AXIS_SEQ)
    nm, mi = sizes[AXIS_MODEL], axis_index(m, AXIS_MODEL)
    pos = (zigzag_order(S, ns)[0] if schedule == "zigzag" and ns > 1
           else torch.arange(S))[si * S // ns:(si + 1) * S // ns].numpy()
    rows = slice(bi * B // nb, (bi + 1) * B // nb)
    qh = slice(mi * Hq // nm, (mi + 1) * Hq // nm)
    kh = slice(mi * Hkv // nm, (mi + 1) * Hkv // nm)
    act = getattr(torch, dtype)

    def block(a, heads):
        t = torch.from_numpy(np.ascontiguousarray(a[rows][:, pos][:, :, heads]))
        return t.to(dev, act).requires_grad_(dout is not None)

    ql, kl, vl = block(q, qh), block(k, kh), block(v, kh)
    attn = make_attn_fn(m, impl, schedule)
    out = attn(ql, kl, vl, causal=causal)
    res = {"index": (rows, pos, qh, kh), "out": _numpy(out)}
    if dout is not None:
        out.backward(block(dout, qh).detach())
        res.update(dq=_numpy(ql.grad), dk=_numpy(kl.grad), dv=_numpy(vl.grad))
    return res


def assemble(parts: list, name: str, shape) -> np.ndarray:
    """The global array ``name`` from attention_case results (replicas
    write the same values)."""
    out = np.zeros(shape, np.float32)
    for p in parts:
        rows, pos, qh, kh = p["index"]
        out[rows, pos, kh if name in ("dk", "dv") else qh] = p[name]
    return out


def spec_leaves(tree, specs, prefix=""):
    """(name, leaf, spec) for every leaf of a param tree: its split dim or
    {axis: dim} (``train.split_axes``)."""
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from spec_leaves(leaf, specs[key], f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", leaf, specs[key]


def seeded_batch(cfg, B, S, seed, dev):
    """(inputs, targets) [B, S] of tokens drawn from ``seed`` on ``dev``:
    the same on every rank and in the caller."""
    g = torch.Generator(dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device=dev)
    return toks[:, :-1], toks[:, 1:]


def _family(kind: str, cfg, mesh, n_chunks: int = 1):
    """(specs, layout) of a ``kind`` of train case ("train": the dense
    model, "pipeline", "moe"): the spec tree its leaves are cut by, and
    the map of a whole tree in the JAX layout to the one it is cut from
    (the pipelined blocks' storage order)."""
    if kind == "moe":
        return moe_model_specs(cfg), lambda tree: tree
    if kind == "pipeline":
        n = axis_sizes(mesh)[AXIS_PIPE]
        return pipeline_param_specs(cfg), lambda tree: dict(
            tree, blocks=to_pipeline_layout(tree["blocks"], cfg.n_layers, n,
                                            n_chunks))
    return param_specs(cfg), lambda tree: tree


def _state_and_step(kind, dev, m, cfg, params, seed, n_micro, n_chunks):
    """(params, optimizer, step) of a train case, through the entry points a
    user calls."""
    specs, layout = _family(kind, cfg, m, n_chunks)
    if params is not None:
        p, opt = train_state_from(shard_params(
            layout(params_from_numpy(params, device=dev)), m, specs=specs))
    else:
        g = torch.Generator(dev).manual_seed(seed)
        p, opt = (make_moe_train_state(cfg, g, dev, mesh=m) if kind == "moe"
                  else make_pipeline_train_state(cfg, g, m, dev,
                                                 n_chunks=n_chunks)
                  if kind == "pipeline" else make_train_state(cfg, g, dev,
                                                              mesh=m))
    if kind == "pipeline":
        step = make_pipeline_train_step(cfg, opt, m, n_micro, n_chunks)
    elif kind == "moe":
        step = make_moe_train_step(cfg, opt, m)
    else:
        step = make_train_step(cfg, opt, mesh=m)
    return p, opt, step


def train_case(device, mesh: dict, cfg, *, params=None, seed: int = 0,
               batches=None, batch_shape=None, batch_seed=None,
               steps: int = 1, warm: int = 0, reference=None,
               kind: str = "train", n_micro: int = 4,
               n_chunks: int = 1) -> dict:
    """``warm`` + ``steps`` sharded train steps of ``cfg`` on ``mesh``:
    the dense step (``kind`` "train"), the pipelined one ("pipeline",
    ``n_micro``, ``n_chunks``) or the MoE one ("moe").
    params: a numpy tree in the JAX layout (else drawn from ``seed``);
    batches: a list of (inputs, targets) numpy pairs, one a step, cycled
    (else one batch of ``batch_shape`` (B, S) drawn from ``batch_seed``,
    default seed + 1: ``seeded_batch``). ``reference``: the path of a
    ``torch.save``d {"grads": tree, "params": tree} of one single-process
    step from the same params and first batch (full leaves, the JAX
    layout): the first step's gradients and updated params are held
    against this rank's shards of it (``reference_errors``)."""
    dev = resolve_device(device)
    m = make_mesh(**mesh, device=device)
    p, opt, step = _state_and_step(kind, dev, m, cfg, params, seed, n_micro,
                                   n_chunks)
    cuda = dev.type == "cuda"
    if cuda:        # the whole tree each rank drew: give it back to the card
        torch.cuda.empty_cache()
    if batches is None:
        data = [seeded_batch(cfg, *batch_shape, seed + 1 if batch_seed is None
                             else batch_seed, dev)]
    else:
        data = [tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in b)
                for b in batches]
    res = {"losses": [], "step_ms": [], "staged_bytes": [], "comm_s": [],
           "coords": _coords(m)}
    for i in range(warm + steps):
        if i == warm:
            tfa.reset_launches()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
        comm.reset_staged()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(p, *data[i % len(data)])
        value = loss.item()
        if cuda:
            torch.cuda.synchronize()
        if i >= warm:
            res["step_ms"].append((time.perf_counter() - t0) * 1e3)
            res["staged_bytes"].append(comm.STAGED["bytes"])
            res["comm_s"].append(comm.STAGED["seconds"])
        res["losses"].append(value)
        if i == 0 and reference is not None:
            res.update(reference_errors(
                p, torch.load(reference, mmap=True, map_location="cpu"), m,
                *_family(kind, cfg, m, n_chunks)))
    res["launches"] = dict(tfa.LAUNCHES)
    res["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    del p, opt, step
    if cuda:
        torch.cuda.empty_cache()
    return res


def pipeline_forward_case(device, mesh: dict, cfg, params, tokens, *,
                          n_micro: int = 4, n_chunks: int = 1) -> dict:
    """make_pipeline_forward on the rank's block of ``tokens`` ([B, S]
    numpy) from ``params`` (numpy, the JAX layout): this rank's
    coordinates and, on the last stage, its logits (f32 numpy)."""
    dev = resolve_device(device)
    m = make_mesh(**mesh, device=device)
    specs, layout = _family("pipeline", cfg, m, n_chunks)
    tree = shard_params(layout(params_from_numpy(params, device=dev)), m,
                        specs=specs)
    with torch.no_grad():
        logits, _ = make_pipeline_forward(cfg, m, n_micro, n_chunks)(
            tree, torch.from_numpy(np.asarray(tokens)).to(dev))
    return {"coords": _coords(m),
            "logits": None if logits is None else _numpy(logits)}


def refusals_case(device, mesh: dict, cfg, attempts: list) -> list:
    """The ValueError message of each attempt on ``mesh`` (None where it
    went through): ("pipeline", n_micro, n_chunks, B) builds
    make_pipeline_train_step and takes a step on a [B, 8] batch; ("train",)
    builds make_train_step."""
    dev = resolve_device(device)
    m = make_mesh(**mesh, device=device)
    out = []
    for kind, *args in attempts:
        p, opt = make_pipeline_train_state(
            cfg, torch.Generator(dev).manual_seed(0), m, dev)
        try:
            if kind == "train":
                make_train_step(cfg, opt, mesh=m)
            else:
                n_micro, n_chunks, B = args
                step = make_pipeline_train_step(cfg, opt, m, n_micro,
                                                n_chunks)
                step(p, *seeded_batch(cfg, B, 8, 1, dev))
        except ValueError as e:
            out.append(str(e))
        else:
            out.append(None)
    return out


def reference_errors(params: dict, ref: dict, mesh, specs: dict,
                     layout=lambda tree: tree) -> dict:
    """This rank's gradients and params against its shards (``specs``) of
    the single-process ``ref`` ({"grads", "params"} trees, mapped by
    ``layout`` first): the worst leaf's max|g - ref| / max|ref|, and
    max|p - ref| where |g_ref| >= 1e-7 (below that the sign of AdamW's
    first update, ±lr, follows the summation order) and over every
    element."""
    grads, new = (shard_params(layout(ref[k]), mesh, specs=specs)
                  for k in ("grads", "params"))
    g_err = p_err = p_all = 0.0
    for (_, p, _), (_, g, _), (_, w, _) in zip(
            spec_leaves(params, specs), spec_leaves(grads, specs),
            spec_leaves(new, specs)):
        g, w = g.to(p.device), w.to(p.device)
        scale = g.abs().max().clamp_min(torch.finfo(g.dtype).tiny)
        g_err = max(g_err, ((p.grad - g).abs().max() / scale).item())
        d = (p.detach() - w).abs()
        p_all = max(p_all, d.max().item())
        p_err = max(p_err, (d * (g.abs() >= 1e-7)).max().item())
    return {"grad_err": g_err, "param_err": p_err, "param_err_all": p_all}


def serving_params(kind: str, dev, mesh, cfg, params=None, seed: int = 0):
    """This rank's shards (``param_specs``, or ``moe_model_specs`` for
    ``kind`` "moe") of ``params`` (numpy, the JAX layout) or of the tree
    drawn from ``seed``."""
    moe = kind == "moe"
    if params is not None:
        tree = params_from_numpy(params, device=dev)
    else:
        g = torch.Generator(dev).manual_seed(seed)
        tree = (init_moe_model if moe else init_params)(cfg, g, dev)
    out = shard_params(tree, mesh, specs=moe_model_specs(cfg) if moe
                       else param_specs(cfg))
    del tree
    if dev.type == "cuda":    # the whole tree: give it back to the card
        torch.cuda.empty_cache()
    return out


def _program(prog: dict, p, cfg, m, dev) -> dict:
    """One serving program on this rank (see serving_case)."""
    kind = prog["kind"]
    c = dataclasses.replace(cfg, **prog.get("cfg", {}))
    res = {}
    if kind == "engine":
        spec_k = prog.get("spec_k")
        eng = ServeEngine(p, c, slots=prog["slots"], max_len=prog["max_len"],
                          prefill_buckets=prog["buckets"], device=dev,
                          mesh=m, **({} if spec_k is None else dict(
                              draft_params=p, draft_cfg=c, spec_k=spec_k)))

        def run():
            ids = [eng.submit(t, n, prefix=pre)
                   for t, n, pre in prog["requests"]]
            out = dict(eng.run())
            eng.finished.clear()
            return [out[i] for i in ids]
    else:
        prompt = np.asarray(prog["prompt"])
        rows = batch_rows(m, prompt.shape[0])
        res["rows"] = (rows.start, rows.stop)
        x = torch.from_numpy(prompt[rows]).to(dev)
        new = prog.get("new", 0)
        if kind == "generate":
            def run():
                return _numpy(generate(
                    p, x, c, max_new_tokens=new, max_len=prog.get("max_len"),
                    pad_id=prog.get("pad_id"), eos_id=prog.get("eos_id"),
                    device=dev, mesh=m)).astype(np.int32)
        elif kind == "speculative":
            def run():
                return _numpy(speculative_generate(
                    p, p, x, c, c, max_new_tokens=new,
                    spec_k=prog["spec_k"], max_len=prog.get("max_len"),
                    pad_id=prog.get("pad_id"), device=dev,
                    mesh=m)[0]).astype(np.int32)
        else:             # "forward": one cached_forward from an empty cache
            shard = serve_shard(m, dev, (p, c))

            def run():
                cache = init_kv_cache(c, x.shape[0], prog["max_len"], dev,
                                      shard=shard)
                logits, cache = cached_forward(p, x, cache, c, shard=shard)
                res["length"] = int(cache.length)
                return _numpy(logits)
    for _ in range(prog.get("warm", 0)):
        run()
    cuda = dev.type == "cuda"
    tfa.reset_launches()
    comm.reset_staged()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    res["ms"] = []
    for _ in range(prog.get("runs", 1)):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        if cuda:
            torch.cuda.synchronize()
        res["ms"].append((time.perf_counter() - t0) * 1e3)
    res.update(out=out, launches=dict(tfa.LAUNCHES),
               staged_bytes=comm.STAGED["bytes"],
               comm_s=comm.STAGED["seconds"],
               peak_bytes=torch.cuda.max_memory_allocated() if cuda
               else None)
    if kind == "engine":
        res["stats"] = eng.stats()
    return res


def serving_case(device, mesh: dict, cfg, programs: list, *, params=None,
                 seed: int = 0, kind: str = "dense") -> dict:
    """``programs`` on ``mesh`` from this rank's shards of ``params`` (numpy,
    the JAX layout) or of the tree drawn from ``seed`` (``kind`` "moe":
    the MoE family). A program is a dict: ``kind`` "generate" (``prompt``
    [B, S] numpy, the global batch, of which the rank serves its block;
    ``new``, and ``max_len``, ``pad_id``, ``eos_id``), "speculative"
    (self-draft, ``spec_k``), "engine" (``requests`` [(tokens, new,
    prefix or None)], the same on every rank; ``slots``, ``max_len``,
    ``buckets``, and ``spec_k`` for a self-draft) or "forward" (the
    logits of one ``cached_forward`` of the rank's rows into an empty
    cache of ``max_len``); ``cfg``: changes to ``cfg``; ``warm`` untimed
    runs, then ``runs`` timed ones. Returns the rank's coordinates and a
    result a program: ``out`` (tokens or logits of the rank's ``rows`` of
    the prompt, or the engine's streams, of the last run), ``ms`` a run,
    and, over the timed runs, ``launches``, ``staged_bytes``, ``comm_s``
    and ``peak_bytes``."""
    dev = resolve_device(device)
    m = make_mesh(**mesh, device=device)
    p = serving_params(kind, dev, m, cfg, params, seed)
    out = {"coords": _coords(m),
           "programs": {g["name"]: _program(g, p, cfg, m, dev)
                        for g in programs}}
    del p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


serving_moe_case = partial(serving_case, kind="moe")


def serve_refusals_case(device, cfg, attempts: list, params=None) -> list:
    """The ValueError message of ``generate`` on each attempt (None where it
    went through): (mesh, "shards") serves this rank's shards of
    ``params`` (numpy, the JAX layout) on the mesh, (mesh, "whole") the
    whole tree."""
    dev = resolve_device(device)
    whole = params_from_numpy(params, device=dev)
    out = []
    for mesh, which in attempts:
        m = make_mesh(**mesh, device=device)
        try:
            p = whole if which == "whole" else shard_params(
                whole, m, specs=param_specs(cfg))
            generate(p, torch.ones((1, 4), dtype=torch.int32), cfg,
                     max_new_tokens=2, device=dev, mesh=m)
        except ValueError as e:
            out.append(str(e))
        else:
            out.append(None)
    return out


CASES = {"mesh": mesh_case, "attention": attention_case, "train": train_case,
         "pipeline": partial(train_case, kind="pipeline"),
         "moe": partial(train_case, kind="moe"),
         "pipeline_forward": pipeline_forward_case,
         "refusals": refusals_case,
         "serving": serving_case, "serving_moe": serving_moe_case,
         "serve_refusals": serve_refusals_case}


def run_cases(cases: list, device) -> list:
    """Every case ({"kind": ..., its arguments}) on this rank, in order."""
    return [CASES[c["kind"]](device, **{k: v for k, v in c.items()
                                         if k != "kind"}) for c in cases]
