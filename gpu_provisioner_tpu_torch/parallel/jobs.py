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
  the ValueErrors of serving on meshes and params it refuses;
- ``checkpoint`` (``checkpoint_pipeline``): a step on one mesh, a save
  (``save_train_state(mesh=)`` or ``TrainCheckpointManager(mesh=)``), the
  next step, a restore onto another mesh and its next step: the losses,
  the leaves that differ from the rank's shards of the saved tree, save
  and restore seconds, bytes written, the CUDA tensors handed to
  collectives meanwhile, the launches after the restore, and the
  refusals of a wrong layout stamp and an existing destination;
  ``checkpoint_restore``: a checkpoint written anywhere restored onto a
  mesh; ``checkpoint_schedule``: the manager's saved, kept and latest
  steps on a mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models import checkpoint as ck
from ..models.convert import params_from_numpy
from ..models.decode import cached_forward, generate, init_kv_cache, serve_shard
from ..models.engine import ServeEngine
from ..models.llama import init_params, param_specs
from ..models.moe import (init_moe_model, make_moe_train_state,
                          make_moe_train_step, moe_model_specs)
from ..models.speculative import speculative_generate
from ..models.train import (batch_rows, default_optimizer, make_attn_fn,
                            make_pipeline_forward, make_pipeline_train_state,
                            make_pipeline_train_step, make_train_state,
                            make_train_step, param_leaves,
                            pipeline_param_specs, shard_params,
                            train_state_from)
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


def _state_and_step(kind, dev, m, cfg, params, seed, n_micro, n_chunks,
                    optimizer=None):
    """(params, optimizer, step) of a train case, through the entry points a
    user calls (``optimizer``: a callable on the leaves, default
    ``default_optimizer``)."""
    specs, layout = _family(kind, cfg, m, n_chunks)
    if params is not None:
        p, opt = train_state_from(shard_params(
            layout(params_from_numpy(params, device=dev)), m, specs=specs),
            optimizer)
    else:
        g = torch.Generator(dev).manual_seed(seed)
        p, opt = (make_moe_train_state(cfg, g, dev, optimizer, mesh=m)
                  if kind == "moe"
                  else make_pipeline_train_state(cfg, g, m, dev, optimizer,
                                                 n_chunks=n_chunks)
                  if kind == "pipeline" else make_train_state(
                      cfg, g, dev, optimizer, mesh=m))
    return p, opt, _step_fn(kind, cfg, opt, m, n_micro, n_chunks)


def _step_fn(kind, cfg, opt, m, n_micro, n_chunks):
    """The train step of a ``kind`` of train case over ``opt``."""
    if kind == "pipeline":
        return make_pipeline_train_step(cfg, opt, m, n_micro, n_chunks)
    if kind == "moe":
        return make_moe_train_step(cfg, opt, m)
    return make_train_step(cfg, opt, mesh=m)


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


# the c10d functions a checkpoint's collectives may reach, each wrapped by
# _cuda_collectives in both namespaces that export it
_COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_reduce",
                "all_to_all", "all_to_all_single", "broadcast", "gather",
                "irecv", "isend", "recv", "reduce", "reduce_scatter",
                "reduce_scatter_tensor", "scatter", "send")


@contextlib.contextmanager
def _cuda_collectives():
    """Counts, by function, the CUDA tensors handed to a c10d collective
    while the block runs (the object collectives' tensors included): a
    gloo group refuses them in its p2p and stages nothing, so a checkpoint
    must pass none. Yields the {name: count} dict."""
    from torch.distributed import distributed_c10d as c10d

    seen: dict = {}
    saved = []

    def wrap(name, fn):
        def counted(*args, **kwargs):
            for a in list(args) + list(kwargs.values()):
                for t in a if isinstance(a, (list, tuple)) else [a]:
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        seen[name] = seen.get(name, 0) + 1
            return fn(*args, **kwargs)
        return counted

    for mod in (c10d, dist):
        for name in _COLLECTIVES:
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, wrap(name, getattr(mod, name)))
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _named(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _ckpt_tree(p, opt) -> dict:
    """The checkpoint tree's tensors of a state, as copies on their
    device."""
    tree = {"params": p, "opt_state": ck.adam_state_tree(p, opt)}

    def copy(t):
        return ({k: copy(v) for k, v in t.items()} if isinstance(t, dict)
                else t.detach().clone())
    return copy(tree)


def _numpy_leaves(tree: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in _named(tree).items()}


def _differing(a: dict, b: dict) -> list:
    """Names of the leaves of trees a and b not equal in dtype, shape and
    every value."""
    a, b = _named(a), _named(b)
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or not torch.equal(a[k], b[k]))


def _narrowed(tree: dict, mesh, specs: dict) -> dict:
    """This rank's shards on ``mesh`` of a whole checkpoint tree."""
    opt = tree["opt_state"]
    return {"params": shard_params(tree["params"], mesh, specs=specs),
            "opt_state": {"count": opt["count"],
                          **{k: shard_params(opt[k], mesh, specs=specs)
                             for k in ("mu", "nu")}}}


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def checkpoint_case(device, cfg, directory, *, save_mesh: dict,
                    restore_mesh: dict, params=None, seed: int = 0,
                    batches=None, batch_shape=None, kind: str = "train",
                    n_micro: int = 4, n_chunks: int = 1,
                    manager: bool = False, leaves: bool = False,
                    refusals: bool = False) -> dict:
    """A save on one mesh and a restore onto another, through the entry
    points a user calls: the dense (``kind`` "train") or pipelined
    ("pipeline", ``n_micro``, ``n_chunks``; the layout stamp (pipe size,
    n_chunks)) state of ``cfg`` on ``save_mesh`` from ``params`` (numpy,
    the JAX layout) or ``seed``, through ``default_optimizer``; one
    step on the first of two batches (numpy pairs, else drawn from seed +
    1 and seed + 2 at ``batch_shape``); a save of step 1 into
    ``directory`` (``save_train_state(mesh=)`` into ``directory``/ckpt,
    or with ``manager`` a ``TrainCheckpointManager(mesh=)``); the next
    step on the old mesh; then a restore onto ``restore_mesh``
    (``restore_train_state(mesh=)``, or a new manager's
    ``restore_latest``) and the next step there.

    Returns this rank's coordinates on both meshes, the losses (first
    step, the old mesh's next, the restored mesh's next), the restored
    step and count, the checkpoint leaves that differ from this rank's
    shards of the saved tree (``differ``: the same mesh's saved shards,
    or the narrowing of the whole saved tree a save mesh without model
    or pipe sharding holds), save and restore seconds, the bytes written,
    the CUDA tensors the collectives of the save and the restore were
    handed (``cuda_collectives``), the kernel launches of the step after
    the restore and peak memory; with ``leaves`` the saved and restored
    leaves as numpy; with ``refusals`` the ValueError messages of a
    restore under another layout stamp and of a save onto the existing
    checkpoint."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    m = make_mesh(**save_mesh, device=device)
    p, opt, step = _state_and_step(kind, dev, m, cfg, params, seed, n_micro,
                                   n_chunks)
    if cuda:        # the whole tree each rank drew: give it back to the card
        torch.cuda.empty_cache()
    if batches is None:
        data = [seeded_batch(cfg, *batch_shape, seed + i, dev)
                for i in (1, 2)]
    else:
        data = [tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in b)
                for b in batches]
    layout = {"n_stages": axis_sizes(m)[AXIS_PIPE], "n_chunks": n_chunks}
    path = Path(directory) / ("1" if manager else "ckpt")

    def timed(fn):
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        with _cuda_collectives() as seen:
            out = fn()
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
        return out, time.perf_counter() - t0, seen

    res = {"coords_save": _coords(m), "losses": [step(p, *data[0]).item()]}
    if manager:
        mgr = ck.TrainCheckpointManager(directory, cfg, default_optimizer,
                                        device=dev, mesh=m,
                                        save_interval_steps=1, **layout)
        saved_now, res["save_s"], seen_save = timed(
            lambda: mgr.maybe_save(1, p, opt))
        if not saved_now:
            raise RuntimeError("the manager did not save step 1")
    else:
        _, res["save_s"], seen_save = timed(lambda: ck.save_train_state(
            path, p, opt, 1, mesh=m, **layout))
    res["bytes_written"] = _dir_bytes(path)
    saved = _ckpt_tree(p, opt)
    res["losses"].append(step(p, *data[1]).item())
    del p, opt, step
    if cuda:
        torch.cuda.empty_cache()

    m2 = m if restore_mesh == save_mesh else make_mesh(**restore_mesh,
                                                       device=device)
    if manager:
        mgr2 = ck.TrainCheckpointManager(directory, cfg, default_optimizer,
                                         device=dev, mesh=m2, **layout)
        (p, opt, at), res["restore_s"], seen_restore = timed(
            mgr2.restore_latest)
    else:
        (p, opt, at), res["restore_s"], seen_restore = timed(
            lambda: ck.restore_train_state(path, cfg, default_optimizer,
                                           device=dev, mesh=m2, **layout))
    res.update(coords_restore=_coords(m2), step=at,
               count=int(opt.state[param_leaves(p)[0]]["step"]),
               cuda_collectives={"save": seen_save,
                                 "restore": seen_restore})
    restored = _ckpt_tree(p, opt)
    if m2 is m:
        want = saved
    elif all(axis_sizes(m)[a] == 1 for a in (AXIS_MODEL, AXIS_PIPE)):
        want = _narrowed(saved, m2, ck.mesh_specs(m2))
    else:
        raise ValueError("a restore onto another mesh is checked against "
                         "a save mesh that holds the whole tree")
    res["differ"] = _differing(want, restored)
    if leaves:
        res["saved"] = _numpy_leaves(saved)
        res["restored"] = _numpy_leaves(restored)
    del saved, restored, want
    step2 = _step_fn(kind, cfg, opt, m2, n_micro, n_chunks)
    tfa.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    res["losses"].append(step2(p, *data[1]).item())
    res["launches"] = dict(tfa.LAUNCHES)
    res["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    if refusals:
        other = ({"n_stages": 1, "n_chunks": 1}
                 if layout != {"n_stages": 1, "n_chunks": 1}
                 else {"n_stages": 2, "n_chunks": 1})
        res["refusals"] = [
            _refused(lambda: ck.restore_train_state(
                path, cfg, default_optimizer, device=dev, mesh=m2, **other)),
            _refused(lambda: ck.save_train_state(path, p, opt, 1, mesh=m2,
                                                 **layout))]
    del p, opt, step2
    if cuda:
        torch.cuda.empty_cache()
    return res


def _refused(fn):
    """fn()'s ValueError message, None where it went through."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def checkpoint_restore_case(device, cfg, path, mesh: dict) -> dict:
    """``restore_train_state(path, mesh=)`` of a dense checkpoint (written
    anywhere, one device included): this rank's coordinates, the restored
    step and the checkpoint leaves as numpy."""
    dev = resolve_device(device)
    m = make_mesh(**mesh, device=device)
    p, opt, at = ck.restore_train_state(path, cfg, default_optimizer,
                                        device=dev, mesh=m)
    return {"coords": _coords(m), "step": at,
            "leaves": _numpy_leaves(_ckpt_tree(p, opt))}


def checkpoint_schedule_case(device, cfg, directory, mesh: dict,
                             sequences: list) -> list:
    """``TrainCheckpointManager(mesh=)`` over step sequences: for each
    (interval, keep, [steps, ...], a subdirectory), and for each list of
    steps a new manager over that subdirectory (a restart), the steps it
    saved, the step directories kept and the latest step; then the step
    ``restore_latest`` gives on the mesh."""
    dev = resolve_device(device)
    m = make_mesh(**mesh, device=device)
    p, opt = make_train_state(cfg, torch.Generator(dev).manual_seed(0), dev,
                              mesh=m)
    out = []
    for interval, keep, runs, sub in sequences:
        d = Path(directory) / sub
        got = []
        for steps in runs:
            mgr = ck.TrainCheckpointManager(
                d, cfg, default_optimizer, device=dev, mesh=m,
                max_to_keep=keep, save_interval_steps=interval)
            saved = [s for s in steps if mgr.maybe_save(s, p, opt)]
            got.append({"saved": saved, "kept": mgr.all_steps(),
                        "latest": mgr.latest_step()})
        got.append(mgr.restore_latest()[2])
        out.append(got)
    return out


CASES = {"mesh": mesh_case, "attention": attention_case, "train": train_case,
         "pipeline": partial(train_case, kind="pipeline"),
         "moe": partial(train_case, kind="moe"),
         "pipeline_forward": pipeline_forward_case,
         "refusals": refusals_case,
         "serving": serving_case, "serving_moe": serving_moe_case,
         "serve_refusals": serve_refusals_case,
         "checkpoint": checkpoint_case,
         "checkpoint_pipeline": partial(checkpoint_case, kind="pipeline"),
         "checkpoint_restore": checkpoint_restore_case,
         "checkpoint_schedule": checkpoint_schedule_case}


def run_cases(cases: list, device) -> list:
    """Every case ({"kind": ..., its arguments}) on this rank, in order."""
    return [CASES[c["kind"]](device, **{k: v for k, v in c.items()
                                         if k != "kind"}) for c in cases]
