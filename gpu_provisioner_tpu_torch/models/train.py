"""Training step, on one device or sharded over a mesh.

Twin of ``gpu_provisioner_tpu/models/train.py``: the same
optimizer (``default_optimizer`` is optax's ``adamw(3e-4,
weight_decay=0.1)``: b1 0.9, b2 0.999, eps 1e-8, decoupled decay on every
leaf applied to the pre-update value), the same ``loss_fn`` (f32 logits,
logsumexp minus the gold logit, mean) and ``make_forward``. With
``attn_impl="flash"`` the attention forward and backward run the CUDA
kernels through ``ops/flash_attention.py``'s autograd Function. Deliberate
differences:

- the step updates params and optimizer state in place, the twin of the JAX
  step's ``donate_argnums`` (one copy of each in device memory);
- params are f32 masters (``cfg.param_dtype``) the forward casts to the
  activation dtype at each use, and the optimizer owns its moments;
- ``default_optimizer(leaves, mu_dtype=None)`` takes the leaves (the
  callable-on-leaves convention of ``train_state_from``; pass
  ``functools.partial(default_optimizer, mu_dtype=torch.bfloat16)``). With
  no ``mu_dtype`` it is ``torch.optim.AdamW`` (a leaf at a time); with one
  it is ``AdamWMu``, which keeps optax's ``scale_by_adam(mu_dtype=)`` order;
- on a mesh (``make_mesh``: data, sequence and tensor parallelism over
  ``slice``, ``data``, ``seq`` and ``model``; the batch and the dense
  model are replicated over ``expert``; ``pipe`` > 1 takes the pipelined
  step), each rank holds its shards (``shard_params`` narrows the whole
  tree every rank draws from the same seeded generator), takes its block
  of the global batch (``batch_block``, BATCH_SPEC's twin), runs the
  forward and backward with global positions, then all-reduces the
  gradients (and the loss) over the ranks the batch is cut over, in a few
  flat buckets, and divides by their number: the global mean's gradient,
  as GSPMD's psum gives. AdamW works element by element, so each rank's
  step on its own shards is the global step. A loss on a mesh takes the
  rank's place as a ``Shard`` (built once a step function) in place of
  the JAX package's sharding annotations;
- a leaf of a spec tree names the dims it is split along: None
  (replicated), an int (the dim split over ``model``: ``param_specs``),
  or {axis: dim} for a leaf split over several axes (the JAX
  PartitionSpec's entries, e.g. the pipelined blocks' ``{"pipe": 0,
  "model": 2}``, ``pipeline_param_specs``; the experts' ``{"expert": 1,
  "model": 3}``, ``moe.moe_param_specs``);
- the pipelined step (``make_pipeline_train_step``, gpipe or interleaved
  over ``pipe``, composed with slice, data, sequence and tensor
  parallelism): the embedding on the first stage, the blocks through
  ``parallel/pipeline.py``, the final norm, the head and the loss on the
  last stage only; the loss value and the gradients of the leaves
  replicated over ``pipe`` (``embed``, ``ln_final``, ``lm_head``, each
  computed on one stage) are summed over the ``pipe`` group before the
  batch mean, so the gradient is the plain one, counted once. With
  ``seq`` > 1 the stages attend through the ring over contiguous sequence
  blocks (the reference keeps ``seq`` a GSPMD axis inside stages and
  ignores ``seq_schedule``: the same function);
- the MoE step on a mesh (``moe.make_moe_train_step(mesh=)``) adds
  expert parallelism (``models/moe.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from math import prod
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import set_checkpoint_early_stop

from ..device import resolve_device
from ..parallel.comm import (TPGroup, all_reduce_, keep_in_graph,
                             reduce_from_tp)
from ..parallel.pipeline import pipelined_blocks, to_pipeline_layout
from ..parallel.ring import ring_attention, zigzag_order, zigzag_ring_attention
from ..parallel.topology import (AXIS_DATA, AXIS_EXPERT, AXIS_MODEL,
                                 AXIS_PIPE, AXIS_SEQ, AXIS_SLICE, axis_index,
                                 axis_sizes)
from .llama import (LlamaConfig, _block, _embed, _logits, forward,
                    init_params, param_specs, resolve_attn)

# gradient elements a bucket of the batch all-reduce holds (256 MB in f32)
GRAD_BUCKET = 1 << 26


def param_leaves(params: dict) -> list:
    """The param tensors in the tree's order (embed, blocks, ln_final,
    lm_head), the order the optimizer holds them in."""
    out = []
    for leaf in params.values():
        out.extend(param_leaves(leaf) if isinstance(leaf, dict) else [leaf])
    return out


ADAMW = {"lr": 3e-4, "betas": (0.9, 0.999), "eps": 1e-8,
         "weight_decay": 0.1}


class AdamWMu(torch.optim.Optimizer):
    """optax.adamw(mu_dtype=)'s twin: AdamW whose first moment is stored in
    ``mu_dtype`` (bf16 halves its memory), on ``torch._foreach_*`` ops.

    The order is optax's ``scale_by_adam``: the new mu is computed in f32
    from the stored mu (``(1 - b1)·g + b1·mu``; JAX's weak typing rounds b1
    to mu's dtype, and the jitted step forms b1·mu in f32, as XLA drops the
    product's round trip through mu's dtype), nu in f32; the
    bias-corrected update comes from that f32 mu, and only then is mu cast
    to ``mu_dtype`` for storage. Decay is decoupled and applied to the
    pre-update value, as torch's AdamW does. The per-leaf state is torch
    AdamW's (``step`` a float32 CPU scalar, ``exp_avg``, ``exp_avg_sq``),
    so the checkpoint and ``convert`` handle both alike."""

    def __init__(self, params, mu_dtype: torch.dtype, *, lr: float,
                 betas: tuple, eps: float, weight_decay: float):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay})
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        init_adam_state(self)
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            lr, (b1, b2) = group["lr"], group["betas"]
            grads = [p.grad for p in ps]
            state = [self.state[p] for p in ps]
            mus = [s["exp_avg"] for s in state]
            nus = [s["exp_avg_sq"] for s in state]
            steps = [s["step"] for s in state]
            torch._foreach_add_(steps, 1.0)
            b1_mu = torch.tensor(b1, dtype=self.mu_dtype).item()
            mu32 = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(mu32, mus, alpha=b1_mu)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
            torch._foreach_mul_(ps, 1 - lr * group["weight_decay"])
            counts = [s.item() for s in steps]
            denom = torch._foreach_sqrt(nus)
            torch._foreach_div_(denom, [(1 - b2 ** n) ** 0.5 for n in counts])
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_addcdiv_(ps, mu32, denom,
                                    [-lr / (1 - b1 ** n) for n in counts])
            torch._foreach_copy_(mus, mu32)
        return loss


def default_optimizer(leaves, mu_dtype: Optional[torch.dtype] = None
                      ) -> torch.optim.Optimizer:
    """The one default, optax.adamw(3e-4, weight_decay=0.1, mu_dtype=)'s
    twin: torch's AdamW without ``mu_dtype``, else ``AdamWMu``. AdamW takes
    its leaves one at a time (``foreach=False``, the path it takes on the
    CPU by default): its foreach step holds an f32 temporary the size of
    every leaf together, 4 bytes a parameter on top of the 16 of the state,
    where this one holds a leaf's."""
    if mu_dtype is None:
        return torch.optim.AdamW(leaves, foreach=False, **ADAMW)
    return AdamWMu(leaves, mu_dtype, **ADAMW)


def adam_step(count: int) -> torch.Tensor:
    """The per-leaf ``step`` of torch's AdamW after ``count`` updates (optax's
    ``count``): a float32 CPU scalar, as neither optimizer here is fused or
    capturable."""
    return torch.tensor(float(count), dtype=torch.float32)


def init_adam_state(optimizer: torch.optim.Optimizer) -> None:
    """Gives every leaf that has no state yet the state its first step
    would make: step 0 and zero moments (mu in the optimizer's
    ``mu_dtype``), as optax's ``init`` does."""
    mu_dtype = getattr(optimizer, "mu_dtype", None)
    for group in optimizer.param_groups:
        for p in group["params"]:
            if not optimizer.state[p]:
                optimizer.state[p] = {
                    "step": adam_step(0),
                    "exp_avg": torch.zeros_like(p, dtype=mu_dtype or p.dtype),
                    "exp_avg_sq": torch.zeros_like(p)}


@dataclass(frozen=True)
class Shard:
    """What a loss needs of this rank's place on a mesh (``mesh_shard``
    builds it once a step function). ``tp``: the ``model`` group (heads,
    the dense FFN's inner width, the vocabulary). ``ffn``: the group the
    MoE FFN's experts and inner width are cut over (``expert`` ×
    ``model``), ``expert`` this rank's ``expert`` coordinate. ``batch``:
    the (slice, data, seq) ranks the batch is cut over, ``n_batch`` their
    number. ``seq``: the ``seq`` group and ``n_seq`` its size; ``chunks``
    the natural-order indices of the sequence chunks the rank's block
    holds, in block order, out of ``n_chunks`` (the ring's one block, the
    zigzag's pair)."""
    tp: Optional[TPGroup] = None
    ffn: Optional[TPGroup] = None
    expert: int = 0
    batch: object = None
    n_batch: int = 1
    seq: object = None
    n_seq: int = 1
    chunks: tuple = (0,)
    n_chunks: int = 1


def xent(logits, targets, tp: Optional[TPGroup] = None):
    """Mean next-token cross entropy of f32 logits [B, S, V]: logsumexp
    minus the gold logit. With ``tp`` the logits are this rank's vocabulary
    columns: the logsumexp is the group's (the max, then the sum of exp,
    each all-reduced) and the gold logit comes from the rank that owns the
    target, the same f32 function."""
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets.long()[..., None])[..., 0]
        return (logz - gold).mean()
    cols = logits.shape[-1]
    m = all_reduce_(logits.detach().amax(dim=-1), tp.group,
                    dist.ReduceOp.MAX)
    logz = m + reduce_from_tp(torch.exp(logits - m[..., None]).sum(-1),
                              tp).log()
    local = targets.long() - tp.rank * cols
    own = (local >= 0) & (local < cols)
    gold = logits.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
    gold = reduce_from_tp(torch.where(own, gold, 0.0), tp)
    return (logz - gold).mean()


def loss_fn(params, inputs, targets, cfg: LlamaConfig, attn_fn=None,
            positions=None, shard: Optional[Shard] = None):
    """Next-token cross entropy. inputs/targets: [B, S] int (pre-shifted).
    ``positions`` as in forward. On a mesh, ``shard``'s ``tp``: the
    params are this rank's shards and the logits its vocabulary columns
    (``xent``)."""
    tp = shard.tp if shard is not None else None
    logits = forward(params, inputs, cfg, attn_fn=attn_fn,
                     positions=positions, tp=tp)
    return xent(logits, targets, tp)


def train_state_from(params: dict, optimizer: Optional[Callable] = None):
    """(params, optimizer) from an existing param tree: every leaf becomes
    trainable and ``optimizer`` (a callable on the leaves, default
    default_optimizer) is built over them."""
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return params, (optimizer or default_optimizer)(leaves)


def split_axes(spec) -> dict:
    """{axis: dim} of one leaf's spec: None is replicated, an int the dim
    split over ``model``, a dict itself."""
    if spec is None:
        return {}
    return {AXIS_MODEL: spec} if isinstance(spec, int) else dict(spec)


def shard_params(params: dict, mesh, cfg: Optional[LlamaConfig] = None,
                 specs: Optional[dict] = None) -> dict:
    """This rank's shards of ``params``: each leaf narrowed (and copied)
    along each dim its ``specs`` entry splits (default ``param_specs(cfg)``;
    ``split_axes``) to the rank's coordinate on that axis; replicated
    leaves kept as they are."""
    if specs is None:
        specs = param_specs(cfg)
    sizes = axis_sizes(mesh)

    def cut(x, spec):
        if isinstance(x, dict):
            return {k: cut(v, spec[k]) for k, v in x.items()}
        out = x
        for axis, dim in split_axes(spec).items():
            n = sizes[axis]
            if n == 1:
                continue
            if out.shape[dim] % n:
                raise ValueError(f"dim {dim} of a {tuple(out.shape)} leaf "
                                 f"does not split over {axis} = {n}")
            size = out.shape[dim] // n
            out = out.narrow(dim, axis_index(mesh, axis) * size, size)
        return out if out is x else out.clone()

    return cut(params, specs)


def make_train_state(cfg: LlamaConfig, generator: torch.Generator,
                     device=None, optimizer: Optional[Callable] = None,
                     mesh=None):
    """(params, optimizer): f32 masters (``cfg.param_dtype``) drawn from
    ``generator`` on ``device`` (default cuda) and the optimizer over them.
    On a ``mesh`` every rank draws the whole tree (the same numbers from the
    same seed) and keeps its shards (``shard_params``)."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for params on {dev}")
    params = init_params(cfg, generator, dev,
                         dtype=getattr(torch, cfg.param_dtype))
    if mesh is not None:
        params = shard_params(params, mesh, cfg)
    return train_state_from(params, optimizer)


def make_attn_fn(mesh, impl: str = "dense", seq_schedule: str = "ring",
                 window: Optional[int] = None, sinks: int = 0) -> Callable:
    """Attention on a rank's blocks: ring (or, with ``seq_schedule=
    "zigzag"``, the balanced zigzag ring over blocks of the permuted
    sequence) over ``seq`` when that axis is sharded; otherwise cfg's
    attention on the rank's own batch rows and heads. A sliding window with
    a sharded sequence is not implemented, as in the JAX package: that
    raises."""
    attn = resolve_attn(impl, window, sinks)      # validates every branch
    if axis_sizes(mesh)[AXIS_SEQ] > 1:
        if window is not None:
            raise NotImplementedError(
                "sliding_window × sequence-parallel ring attention is not "
                "implemented; train SWA models with sp=1")
        ring = (zigzag_ring_attention if seq_schedule == "zigzag"
                else ring_attention)
        return partial(ring, group=mesh.get_group(AXIS_SEQ), impl=impl)
    return attn


def batch_block(x: torch.Tensor, mesh, perm=None) -> torch.Tensor:
    """This rank's [B/(slice·data), S/seq] block of the global [B, S, ...]
    ``x`` (BATCH_SPEC's twin: batch over (slice, data), sequence over
    ``seq``), after ``x[:, perm]`` when the zigzag permutation is given. A
    1-d ``x`` is a sequence alone (positions)."""
    sizes = axis_sizes(mesh)
    if perm is not None:
        x = x[perm] if x.ndim == 1 else x[:, perm]
    ns, si = sizes[AXIS_SEQ], axis_index(mesh, AXIS_SEQ)
    S = x.shape[-1 if x.ndim == 1 else 1]
    if S % ns:
        raise ValueError(f"S = {S} does not split over seq = {ns}")
    if x.ndim == 1:
        return x[si * S // ns:(si + 1) * S // ns]
    return x[batch_rows(mesh, x.shape[0]), si * S // ns:(si + 1) * S // ns]


def batch_rows(mesh, B: int) -> slice:
    """This rank's rows of a global batch of B: the batch over (slice,
    data)."""
    sizes = axis_sizes(mesh)
    nb = sizes[AXIS_SLICE] * sizes[AXIS_DATA]
    bi = (axis_index(mesh, AXIS_SLICE) * sizes[AXIS_DATA]
          + axis_index(mesh, AXIS_DATA))
    if B % nb:
        raise ValueError(f"B = {B} does not split over slice·data = {nb}")
    return slice(bi * B // nb, (bi + 1) * B // nb)


def tp_group(mesh) -> Optional[TPGroup]:
    """This rank's ``model`` group, None when the axis has size 1."""
    n = axis_sizes(mesh)[AXIS_MODEL]
    if n == 1:
        return None
    return TPGroup(mesh.get_group(AXIS_MODEL), n, axis_index(mesh, AXIS_MODEL))


def axes_group(mesh, axes: tuple):
    """The process group of the ranks that differ from this one along
    ``axes`` only, None when that is this rank alone. Built collectively:
    every rank calls this with the same ``axes``."""
    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    n = prod(mesh.shape[i] for i in keep)
    if n == 1:
        return None
    ranks = mesh.mesh.permute(*rest, *keep).reshape(-1, n).tolist()
    group, _ = dist.new_subgroups_by_enumeration(ranks)
    return group


def batch_group(mesh):
    """The process group of the (slice, data, seq) ranks the batch is cut
    over, the ranks that share this rank's pipe, expert and model
    coordinates. None when there is one. Built collectively."""
    return axes_group(mesh, (AXIS_SLICE, AXIS_DATA, AXIS_SEQ))


def check_heads(cfg: LlamaConfig, tp: Optional[TPGroup]) -> None:
    """Raises ValueError when the ``model`` group does not divide cfg's
    query and kv heads."""
    if tp is not None and (cfg.n_heads % tp.size or cfg.n_kv_heads % tp.size):
        raise ValueError(f"model = {tp.size} does not divide the heads "
                         f"({cfg.n_heads} q, {cfg.n_kv_heads} kv)")


def mesh_shard(mesh, cfg: LlamaConfig, zigzag: bool = False) -> Shard:
    """This rank's ``Shard`` of ``mesh`` (its groups built collectively:
    every rank calls this). ``zigzag``: the rank's block holds the
    zigzag's chunk pair of the sequence, else one contiguous block."""
    sizes = axis_sizes(mesh)
    tp = tp_group(mesh)
    check_heads(cfg, tp)
    n_exp, n_seq = sizes[AXIS_EXPERT], sizes[AXIS_SEQ]
    ffn = tp
    if n_exp > 1:
        group = axes_group(mesh, (AXIS_EXPERT, AXIS_MODEL))
        ffn = TPGroup(group, dist.get_world_size(group),
                      dist.get_rank(group))
    my = axis_index(mesh, AXIS_SEQ)
    batch = batch_group(mesh)
    return Shard(
        tp=tp, ffn=ffn, expert=axis_index(mesh, AXIS_EXPERT), batch=batch,
        n_batch=1 if batch is None else dist.get_world_size(batch),
        seq=mesh.get_group(AXIS_SEQ) if n_seq > 1 else None, n_seq=n_seq,
        chunks=(my, 2 * n_seq - 1 - my) if zigzag else (my,),
        n_chunks=2 * n_seq if zigzag else n_seq)


def _reduce_grads(group, leaves: list, loss: torch.Tensor,
                  mean: bool = True) -> torch.Tensor:
    """All-reduces (sums) every leaf's gradient and ``loss`` over ``group``
    in flat buckets of at most GRAD_BUCKET elements, and with ``mean``
    divides by the group's size; returns the reduced loss. A leaf without
    a gradient takes zeros first."""
    n = dist.get_world_size(group)
    loss = loss.reshape(1).float()
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [loss] + [p.grad for p in leaves]
    start = 0
    while start < len(grads):
        end, numel = start + 1, grads[start].numel()
        while end < len(grads) and numel + grads[end].numel() <= GRAD_BUCKET:
            numel += grads[end].numel()
            end += 1
        part = grads[start:end]
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in part]), group)
        if mean:
            flat.div_(n)
        chunks = flat.split([g.numel() for g in part])
        torch._foreach_copy_(part, [c.view_as(g) for c, g in zip(chunks,
                                                                 part)])
        start = end
    return loss[0]


def _owner_check(optimizer: torch.optim.Optimizer) -> Callable:
    """check(params): raises unless ``params`` is the tree ``optimizer``
    was built over."""
    owned = {id(p) for group in optimizer.param_groups
             for p in group["params"]}

    def check(params):
        if {id(p) for p in param_leaves(params)} != owned:
            raise ValueError("params are not the tree this optimizer was "
                             "built over")

    return check


def make_train_step(cfg: LlamaConfig, optimizer: torch.optim.Optimizer,
                    loss: Callable = loss_fn, mesh=None):
    """step(params, inputs, targets) → loss (a 0-d tensor, not synced).

    One forward and backward of ``loss`` (the dense ``loss_fn``, or MoE's
    ``moe_loss_fn``) with cfg's attention, then one optimizer step. Updates
    ``params`` (the tree the optimizer was built over) and the optimizer's
    state in place: the twin of the JAX step's ``donate_argnums``.

    On a ``mesh`` (every rank calls this, and then the step, with the same
    global [B, S] batch): the rank's block of the batch (under
    ``cfg.seq_schedule="zigzag"`` with ``seq`` > 1, of the batch permuted
    by ``zigzag_order`` once, positions travelling with the tokens), the
    forward with global positions and the rank's ``Shard``, the backward,
    the gradients and the loss averaged over the (slice, data, seq) ranks,
    then the optimizer step on the rank's shards; the loss returned is the
    global mean's. Remat's recompute replays a block's collectives, so it
    runs whole (no early stop) on every rank. A mesh with ``pipe`` > 1
    raises: that is ``make_pipeline_train_step``'s."""
    check = _owner_check(optimizer)
    if mesh is None:
        attn_fn = resolve_attn(cfg.attn_impl, cfg.sliding_window,
                               cfg.attn_sinks)

        def step(params, inputs, targets):
            check(params)
            optimizer.zero_grad(set_to_none=True)
            value = loss(params, inputs, targets, cfg, attn_fn)
            value.backward()
            optimizer.step()
            return value.detach()

        return step

    sizes = axis_sizes(mesh)
    if sizes[AXIS_PIPE] > 1:
        raise ValueError("a mesh with pipe > 1 trains through "
                         "make_pipeline_train_step")
    n_seq = sizes[AXIS_SEQ]
    zigzag = cfg.seq_schedule == "zigzag" and n_seq > 1
    attn_fn = make_attn_fn(mesh, cfg.attn_impl, cfg.seq_schedule,
                           cfg.sliding_window, cfg.attn_sinks)
    shard = mesh_shard(mesh, cfg, zigzag)

    def step(params, inputs, targets):
        check(params)
        S = inputs.shape[1]
        perm = zigzag_order(S, n_seq, inputs.device)[0] if zigzag else None
        positions = (torch.arange(S, device=inputs.device) if perm is None
                     else perm).to(torch.int32)
        optimizer.zero_grad(set_to_none=True)
        with set_checkpoint_early_stop(False):
            value = loss(params, batch_block(inputs, mesh, perm),
                         batch_block(targets, mesh, perm), cfg, attn_fn,
                         positions=batch_block(positions, mesh), shard=shard)
        value.backward()
        value = value.detach()
        if shard.batch is not None:
            value = _reduce_grads(shard.batch, param_leaves(params), value)
        optimizer.step()
        return value

    return step


def pipeline_param_specs(cfg: LlamaConfig) -> dict:
    """param_specs with the blocks' stacked layer dim split over ``pipe``
    as well (their weight dims keep their ``model`` split); the embedding,
    ``ln_final`` and ``lm_head`` keep theirs (they run outside the
    pipeline)."""
    specs = param_specs(cfg)
    specs["blocks"] = {k: {AXIS_PIPE: 0, **split_axes(d)}
                       for k, d in specs["blocks"].items()}
    return specs


def make_pipeline_train_state(cfg: LlamaConfig, generator: torch.Generator,
                              mesh, device=None,
                              optimizer: Optional[Callable] = None,
                              n_chunks: int = 1):
    """(params, optimizer) for the pipelined step: every rank draws the
    whole tree from ``generator`` on ``device`` (default cuda), as
    make_train_state does, permutes the blocks' layers into the schedule's
    storage order (``to_pipeline_layout``) and keeps its shards
    (``pipeline_param_specs``)."""
    dev = resolve_device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for params on {dev}")
    params = init_params(cfg, generator, dev,
                         dtype=getattr(torch, cfg.param_dtype))
    if n_chunks > 1:
        params["blocks"] = to_pipeline_layout(
            params["blocks"], cfg.n_layers, axis_sizes(mesh)[AXIS_PIPE],
            n_chunks)
    params = shard_params(params, mesh, specs=pipeline_param_specs(cfg))
    return train_state_from(params, optimizer)


def _pipeline_forward(cfg: LlamaConfig, mesh, shard: Shard, n_micro: int,
                      n_chunks: int) -> Callable:
    """make_pipeline_forward's function over an existing ``shard``."""
    sizes = axis_sizes(mesh)
    n_batch = sizes[AXIS_SLICE] * sizes[AXIS_DATA]
    pipe = mesh.get_group(AXIS_PIPE)
    first = axis_index(mesh, AXIS_PIPE) == 0
    attn_fn = make_attn_fn(mesh, cfg.attn_impl, "ring", cfg.sliding_window,
                           cfg.attn_sinks)
    tp = shard.tp

    def fn(params, inputs):
        B, S = inputs.shape
        if B % (n_micro * n_batch):
            raise ValueError(f"B = {B} does not split into n_micro = "
                             f"{n_micro} microbatches over slice·data = "
                             f"{n_batch}")
        positions = batch_block(
            torch.arange(S, dtype=torch.int32, device=inputs.device), mesh)
        apply = pipelined_blocks(
            lambda lp, h: _block(h, lp, cfg, positions, attn_fn, tp),
            cfg.n_layers, n_micro, n_chunks, group=pipe)
        inp = batch_block(inputs, mesh)
        x = (_embed(params, inp, cfg, tp) if first else inp.new_empty(
            (*inp.shape, cfg.dim), dtype=cfg.act_dtype))
        out, tail = apply(params["blocks"], x)
        return (None if out is None else _logits(out, params, cfg, tp)), tail

    return fn


def make_pipeline_forward(cfg: LlamaConfig, mesh, n_micro: int = 4,
                          n_chunks: int = 1) -> Callable:
    """fn(params, inputs) → (logits, tail): the rank's block of the global
    [B, S] ``inputs`` (B split into n_micro microbatches that each divide
    over (slice, data)) through the embedding on the first stage, the
    blocks pipelined over ``pipe`` (``pipelined_blocks``: cfg's attention,
    the ring over ``seq`` when that axis is cut, tensor parallel within
    each stage, no remat), and the final norm and the head on the last
    stage: its f32 logits [B/(slice·data), S/seq, V/model], None on the
    other stages. ``tail`` as in ``pipeline_apply``. Params as
    ``make_pipeline_train_state`` lays them out (the same ``n_chunks``).
    Every rank calls this, and then ``fn``, alike."""
    return _pipeline_forward(cfg, mesh, mesh_shard(mesh, cfg), n_micro,
                             n_chunks)


def make_pipeline_train_step(cfg: LlamaConfig,
                             optimizer: torch.optim.Optimizer, mesh,
                             n_micro: int = 4, n_chunks: int = 1):
    """step(params, inputs, targets) → loss: the twin of the JAX
    ``make_pipeline_train_step(mesh, cfg, n_micro, n_chunks)``.

    Every rank calls it with the same global [B, S] batch. The forward is
    ``make_pipeline_forward``'s; the last stage takes the loss of its
    logits. After the backward the loss and the gradients of ``embed``,
    ``ln_final`` and ``lm_head`` (each computed on one stage) are summed
    over ``pipe``, then every gradient and the loss are averaged over the
    (slice, data, seq) ranks, and the optimizer steps."""
    check = _owner_check(optimizer)
    shard = mesh_shard(mesh, cfg)
    forward_fn = _pipeline_forward(cfg, mesh, shard, n_micro, n_chunks)
    pipe = mesh.get_group(AXIS_PIPE)

    def step(params, inputs, targets):
        check(params)
        optimizer.zero_grad(set_to_none=True)
        logits, tail = forward_fn(params, inputs)
        value = (inputs.new_zeros((), dtype=torch.float32) if logits is None
                 else xent(logits, batch_block(targets, mesh), shard.tp))
        keep_in_graph(value, tail).backward()
        value = _reduce_grads(pipe, [params["embed"], params["ln_final"],
                                     params["lm_head"]], value.detach(),
                              mean=False)
        if shard.batch is not None:
            value = _reduce_grads(shard.batch, param_leaves(params), value)
        optimizer.step()
        return value

    return step


def make_forward(cfg: LlamaConfig):
    """fn(params, tokens) → logits: the single-device forward (the JAX
    package's __graft_entry__ surface)."""

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn
