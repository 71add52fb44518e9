"""The port's expert-parallel MoE train step (models/moe.py's
make_moe_train_step with ``mesh=``) against the JAX package on the CPU.

A module fixture spawns one 4-rank gloo world that runs every case
(jobs.run_cases): ``tiny-moe`` in f32 from the JAX params over one numpy
batch (B 8, S 64). While it runs, the JAX references compile (LLVM level
0): jax.value_and_grad of the plain moe_loss_fn on the whole batch and one
optax AdamW step from it (saved for the ranks, which hold their shards of
the gradients and params against them: loss 1e-5 relative, gradients 1e-4
of the largest, params 1e-5 where |g| >= 1e-7), and JAX's
make_moe_train_step, once a schedule and capacity, whose losses every
case's must equal within 1e-5 (the same function on every mesh shape).

Twins of tests/test_parallel_extra.py :51 (ep 2, tp 2: the loss falls over
four steps) and :200 (sp 2, ep 2 under the zigzag schedule), and the cases
where a sharded router could part from the global one: capacity overflow
(capacity_factor 0.5, which drops choices: its loss is not the dropless
one's) at (dp 2, ep 2) (the load-balance means over the batch ranks), at
(sp 2, ep 2) zigzag (claims continue those of the chunks before, in
natural order, across the zigzag's pairs; the capacity is the global
sequence's) and at (sp 2, tp 2) under the ring (contiguous blocks, the
FFN's inner width over ``model``). And the dense make_train_step on an
``expert`` mesh: the batch and the model replicated over it, the losses
the single-process step's.
"""

import dataclasses
import functools
import gc
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

from gpu_provisioner_tpu.models import moe as jm
from gpu_provisioner_tpu.models import train as jtrain
from gpu_provisioner_tpu.parallel import make_mesh
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import moe as tm
from gpu_provisioner_tpu_torch.models import train as ttrain
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy
from gpu_provisioner_tpu_torch.parallel import jobs, launch

JCFG = dataclasses.replace(jm.PRESETS_MOE["tiny-moe"], dtype="float32")
TCFG = tm.MoEConfig(**dataclasses.asdict(JCFG))
JPARAMS = jm.init_moe_model(jax.random.key(0), JCFG)
NPARAMS = jax.tree.map(np.asarray, JPARAMS)
TOKS = np.random.default_rng(1).integers(0, JCFG.vocab_size, (8, 65),
                                         dtype=np.int32)
OVERFLOW = 0.5             # capacity_factor: 16 slots for ~32 claims
LEVEL0 = {"xla_backend_optimization_level": 0}

# case → (mesh, cfg changes, steps)
CASES = {
    "ep2_tp2": ({"ep": 2, "tp": 2}, {}, 4),
    "dp2_ep2_overflow": ({"ep": 2}, {"capacity_factor": OVERFLOW}, 3),
    "sp2_ep2_zigzag": ({"sp": 2, "ep": 2}, {"seq_schedule": "zigzag"}, 3),
    "sp2_ep2_zigzag_overflow": ({"sp": 2, "ep": 2},
                                {"seq_schedule": "zigzag",
                                 "capacity_factor": OVERFLOW}, 3),
    "sp2_tp2_overflow": ({"sp": 2, "tp": 2},
                         {"capacity_factor": OVERFLOW}, 3),
}
# (capacity_factor, schedule) → the mesh JAX's step compiles on
JAX_STEPS = {(1.25, "ring"): {"ep": 2, "tp": 2},
             (OVERFLOW, "ring"): {"ep": 2},
             (OVERFLOW, "zigzag"): {"sp": 2, "ep": 2}}
DENSE = dataclasses.replace(tl.PRESETS["tiny"], dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches():
    """Drops what this module compiled once it is done (a later test in the
    same worker would pay for those objects in every garbage collection)."""
    yield
    jax.clear_caches()
    gc.collect()


def _level0(jitted, *args):
    return jitted.lower(*args).compile(compiler_options=LEVEL0)


def _cfg(case):
    return dataclasses.replace(JCFG, **CASES[case][1])


@functools.lru_cache(maxsize=None)
def _plain(capacity_factor):
    """jax.value_and_grad of moe_loss_fn at JPARAMS on the whole batch (dense
    attention), and the params after one optax AdamW step (numpy)."""
    cfg = dataclasses.replace(JCFG, capacity_factor=capacity_factor)
    vg = _level0(jax.jit(jax.value_and_grad(
        lambda p, i, o: jm.moe_loss_fn(p, i, o, cfg))), JPARAMS,
        TOKS[:, :-1], TOKS[:, 1:])
    loss, grads = vg(JPARAMS, TOKS[:, :-1], TOKS[:, 1:])
    opt = jtrain.default_optimizer()
    updates, _ = opt.update(grads, opt.init(JPARAMS), JPARAMS)
    new = optax.apply_updates(JPARAMS, updates)
    return float(loss), jax.tree.map(np.array, grads), jax.tree.map(
        np.array, new)


@functools.lru_cache(maxsize=None)
def _jax_steps(capacity_factor, schedule, steps=4):
    """The losses of JAX's make_moe_train_step over ``steps`` steps of the
    batch, on JAX_STEPS' mesh (4 devices of the CPU mesh)."""
    cfg = dataclasses.replace(JCFG, capacity_factor=capacity_factor,
                              seq_schedule=schedule)
    mesh = make_mesh(4, devices=jax.devices()[:4],
                     **JAX_STEPS[capacity_factor, schedule])
    params = jtrain.shard_params(jax.tree.map(jnp.copy, JPARAMS), mesh,
                                 specs=jm.moe_model_specs(cfg))
    opt = jtrain.default_optimizer()
    state = opt.init(params)
    put = lambda x: jax.device_put(jnp.asarray(x),
                                   NamedSharding(mesh, jtrain.BATCH_SPEC))
    inp, tgt = put(TOKS[:, :-1]), put(TOKS[:, 1:])
    step = _level0(jm.make_moe_train_step(mesh, cfg, opt), params, state,
                   inp, tgt)
    layout = tuple(step.input_shardings[0][:2])
    losses = []
    for _ in range(steps):
        params, state = jax.device_put((params, state), layout)
        params, state, loss = step(params, state, inp, tgt)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A callable giving {case: every rank's result}: the 4-rank world runs
    in a thread while the tests compile their JAX references."""
    d = tmp_path_factory.mktemp("reference")
    cases = []
    for name, (mesh, changes, steps) in CASES.items():
        ref = d / f"{name}.pt"
        _, grads, new = _plain(_cfg(name).capacity_factor)
        torch.save({"grads": params_from_numpy(grads, "cpu"),
                    "params": params_from_numpy(new, "cpu")}, ref)
        cases.append({"kind": "moe", "mesh": mesh,
                      "cfg": dataclasses.replace(TCFG, **changes),
                      "params": NPARAMS,
                      "batches": [(TOKS[:, :-1], TOKS[:, 1:])],
                      "steps": steps, "reference": str(ref)})
    cases.append({"kind": "train", "mesh": {"ep": 2}, "cfg": DENSE,
                  "seed": 0, "batch_shape": (8, 32), "steps": 2})
    pool = ThreadPoolExecutor(1)
    run = pool.submit(launch.spawn_ranks, jobs.run_cases, 4, backend="gloo",
                      device="cpu", timeout_s=240, args=(cases, "cpu"))
    names = list(CASES) + ["dense_on_expert_mesh"]

    @functools.lru_cache(maxsize=None)
    def result():
        res = run.result()
        return {k: [r[i] for r in res] for i, k in enumerate(names)}

    yield result
    result()                   # the world's error, if no test asked for it
    pool.shutdown()


def _losses(results):
    losses = [r["losses"] for r in results]
    assert all(x == losses[0] for x in losses), losses   # every rank agrees
    return losses[0]


@pytest.mark.parametrize("case", list(CASES))
def test_moe_losses_match_the_jax_step(world, case):
    """Every step's loss against JAX's make_moe_train_step (one compile a
    schedule and capacity; ep 2 × tp 2's losses are the zigzag default
    case's twin too: the same function) within 1e-5; the losses fall
    (:51 over four steps at ep 2, tp 2; :200 at sp 2, ep 2 zigzag)."""
    cfg = _cfg(case)
    schedule = ("zigzag" if cfg.capacity_factor == OVERFLOW
                and cfg.seq_schedule == "zigzag" else "ring")
    want = _jax_steps(cfg.capacity_factor, schedule)
    got = _losses(world()[case])
    np.testing.assert_allclose(got, want[:len(got)], atol=1e-5, rtol=0)
    assert np.isfinite(got).all() and got[-1] < got[0]


@pytest.mark.parametrize("case", list(CASES))
def test_moe_step_matches_the_plain_gradient(world, case):
    """The first step's loss is the plain moe_loss_fn's on the whole batch
    (1e-5 relative); each rank's gradient shards are jax.value_and_grad's
    (1e-4 of the largest: the load-balance term counted once, the gates'
    and the input's cotangents summed over the experts) and its updated
    shards the AdamW step's (1e-5 where |g| >= 1e-7)."""
    want = _plain(_cfg(case).capacity_factor)[0]
    got = _losses(world()[case])[0]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    for r in world()[case]:
        assert r["grad_err"] <= 1e-4, (r["coords"], r["grad_err"])
        assert r["param_err"] <= 1e-5, (r["coords"], r["param_err"])


def test_overflow_cases_drop_choices():
    """The low capacity drops choices: its loss is not the dropless one's
    (a capacity that holds every claim)."""
    dropless = dataclasses.replace(JCFG, capacity_factor=float(
        JCFG.n_experts))
    free = float(jm.moe_loss_fn(JPARAMS, TOKS[:, :-1], TOKS[:, 1:],
                                dropless))
    assert abs(_plain(OVERFLOW)[0] - free) > 1e-3


def test_dense_step_on_an_expert_mesh(world):
    """make_train_step takes a mesh with expert > 1 for the dense model:
    each expert rank trains the same replica of its batch block, and the
    losses are the single-process step's on the same seeded params and
    batch."""
    params, opt = ttrain.make_train_state(
        DENSE, torch.Generator().manual_seed(0), "cpu")
    step = ttrain.make_train_step(DENSE, opt)
    batch = jobs.seeded_batch(DENSE, 8, 32, 1, torch.device("cpu"))
    want = [step(params, *batch).item() for _ in range(2)]
    np.testing.assert_allclose(_losses(world()["dense_on_expert_mesh"]),
                               want, atol=1e-5, rtol=0)
