"""Pipeline parallelism: the decoder blocks' layers cut over ``pipe``.

Twin of ``gpu_provisioner_tpu/parallel/pipeline.py``: the same layer order
(``interleave_layer_order``, ``to_pipeline_layout``,
``from_pipeline_layout``), the same static schedule (``pipeline_apply``:
T = n_micro·n_chunks + n_stages - 1 ticks; on tick t stage s works on
item k = t - s, which is round r = k // (v·S), chunk c = (k % (v·S)) // S,
slot i = k % S, microbatch r·S + i; stage 0 feeds a fresh microbatch when
c = 0, every other item consumes the state that arrived the tick before)
and the same preconditions (``pipelined_blocks``). gpipe is n_chunks = 1;
n_chunks = v > 1 is Megatron's interleaved schedule (arXiv:2104.04473
§2.2): stage s holds the layers of virtual stages c·S + s.

Each rank runs one stage eagerly; ``group`` is the ``pipe`` axis' process
group. The state moves one stage on between ticks (``comm.ring_shift``;
its backward is the reverse shift, the transpose of ``ppermute``).
Deliberate differences:

- the ramp's garbage ticks (k < 0 or k ≥ n_micro·n_chunks) compute
  nothing: the state that arrived passes on as it is (the reference
  computes them and discards the result, as SPMD needs static shapes).
  Every rank still shifts between every two ticks, so the collectives
  match; a stage's flash launches are n_micro·n_chunks chunk applications
  a step, not T;
- there is no shift after the last tick (its state is read by no one);
- the outputs stay on the last stage, which computes the head and the
  loss (the reference broadcasts them to every stage with a psum);
- the schedule's autograd graph is one chain on every rank: the first
  state is a leaf that asks for a gradient, a fed microbatch ties the
  state it replaces into the graph at zero gradient
  (``comm.keep_in_graph``), and the caller ties the last tick's state
  (``tail``) into its loss. So every rank's backward runs every shift's
  reverse, in the same order, as its peers' do.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .comm import keep_in_graph, ring_shift


def interleave_layer_order(n_layers: int, n_stages: int,
                           n_chunks: int) -> list[int]:
    """Storage order of the stacked layer dim such that a contiguous cut of
    it over ``pipe`` hands stage s its virtual stages {c·n_stages + s}:
    position (s, c, l) holds logical layer (c·n_stages + s)·Lv + l."""
    lv = n_layers // (n_stages * n_chunks)
    order = []
    for s in range(n_stages):
        for c in range(n_chunks):
            base = (c * n_stages + s) * lv
            order.extend(range(base, base + lv))
    return order


def _take(blocks: dict, order: list) -> dict:
    idx = torch.tensor(order, dtype=torch.long)
    return {k: v[idx.to(v.device)] for k, v in blocks.items()}


def to_pipeline_layout(blocks: dict, n_layers: int, n_stages: int,
                       n_chunks: int) -> dict:
    """Stacked block params from logical layer order into the interleaved
    storage order (the identity order for n_chunks = 1); copies."""
    return _take(blocks, interleave_layer_order(n_layers, n_stages,
                                                n_chunks))


def from_pipeline_layout(blocks: dict, n_layers: int, n_stages: int,
                         n_chunks: int) -> dict:
    """Inverse of to_pipeline_layout."""
    order = interleave_layer_order(n_layers, n_stages, n_chunks)
    inv = [0] * n_layers
    for new, old in enumerate(order):
        inv[old] = new
    return _take(blocks, inv)


def pipeline_apply(stage_fn: Callable, n_chunks: int, n_micro: int,
                   stage_params: dict, x_micro, *, group):
    """Runs the microbatches through the stage ring; every rank of
    ``group`` calls this with its own stage's params.

    stage_fn(chunk_params, x) -> y applies one chunk's layers, its params
    the ``stage_params`` leading-dim slice of layers_per_chunk
    (stage_params: [n_chunks·layers_per_chunk, ...]). x_micro: n_micro
    tensors [mb, ...], read on stage 0; the other stages read only the
    first one's shape, dtype and device. Returns (outputs, tail): the
    n_micro final states in microbatch order on the last stage (None
    elsewhere), and the last tick's state, which the caller must tie into
    what it differentiates."""
    n_stages, stage = dist.get_world_size(group), dist.get_rank(group)
    if n_chunks > 1 and n_micro % n_stages:
        raise ValueError(f"the interleaved schedule needs n_micro % n_stages"
                         f" == 0, got {n_micro} and {n_stages}")
    items = n_micro * n_chunks
    lv = next(iter(stage_params.values())).shape[0] // n_chunks
    chunks = [{k: a[c * lv:(c + 1) * lv] for k, a in stage_params.items()}
              for c in range(n_chunks)]
    last = stage == n_stages - 1
    outputs = [None] * n_micro
    y = torch.zeros_like(x_micro[0]).requires_grad_()
    for t in range(items + n_stages - 1):
        if t:
            y = ring_shift(y, group)
        k = t - stage
        if not 0 <= k < items:
            continue                      # a garbage tick: pass y on
        c = (k % (n_chunks * n_stages)) // n_stages
        micro = k // (n_chunks * n_stages) * n_stages + k % n_stages
        if stage == 0 and c == 0:
            y = keep_in_graph(x_micro[micro], y)
        y = stage_fn(chunks[c], y)
        if last and c == n_chunks - 1:
            outputs[micro] = y
    return (outputs if last else None), y


def pipelined_blocks(block_fn: Callable, n_layers: int, n_micro: int,
                     n_chunks: int = 1, *, group) -> Callable:
    """The stacked blocks pipelined over ``group`` (the ``pipe`` axis).

    block_fn(layer_params, x) -> x applies one layer. Returns fn(blocks, x)
    -> (out, tail): ``blocks`` this stage's [n_layers / n_stages, ...]
    slice of the stacked layers in interleaved storage order
    (to_pipeline_layout), x the rank's [B, ...] batch block (read on stage
    0; elsewhere only its shape, dtype and device), cut into n_micro
    microbatches; ``out`` the [B, ...] output on the last stage (None
    elsewhere), ``tail`` as in pipeline_apply."""
    n_stages = dist.get_world_size(group)
    if n_layers % (n_stages * n_chunks):
        raise ValueError(f"n_layers = {n_layers} does not split into "
                         f"n_stages·n_chunks = {n_stages}·{n_chunks} chunks")
    if n_chunks > 1 and n_micro % n_stages:
        raise ValueError(f"the interleaved schedule needs n_micro % n_stages"
                         f" == 0, got {n_micro} and {n_stages}")

    def stage_fn(chunk_params, x):
        for layer in range(next(iter(chunk_params.values())).shape[0]):
            x = block_fn({k: v[layer] for k, v in chunk_params.items()}, x)
        return x

    def apply(blocks: dict, x: torch.Tensor):
        if x.shape[0] % n_micro:
            raise ValueError(f"a batch block of {x.shape[0]} rows does not "
                             f"split into n_micro = {n_micro} microbatches")
        outputs, tail = pipeline_apply(stage_fn, n_chunks, n_micro, blocks,
                                       x.chunk(n_micro), group=group)
        out: Optional[torch.Tensor] = (None if outputs is None
                                       else torch.cat(outputs))
        return out, tail

    return apply
