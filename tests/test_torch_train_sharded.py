"""The port's sharded train step (models/train.py on a make_mesh mesh)
against the JAX package's make_train_step on the same mesh shape, on the
CPU.

A module fixture spawns one 4-rank gloo world that runs every case
(jobs.train_case) from the JAX params of ``tiny`` in f32 and the same numpy
batches; the JAX steps run on 4 devices of the 8-device CPU mesh, compiled
at LLVM level 0. Twins of tests/test_workload.py:

- :150 param_specs covers every leaf, splitting the dim the JAX
  PartitionSpec puts on ``model``;
- :182 the step at (sp, tp) = (1, 1) (data parallel over 4 ranks) and
  (2, 2): the losses of three steps within 1e-5 of JAX's (the JAX test
  asks only that they fall; ``tiny`` runs here in f32 so that they can be
  held tightly), and the flash path (its plain version here) at (2, 2);
- :195 2 slices × tp 2;
- :319 the zigzag schedule's loss equals the ring's (and JAX's);

and in every case each rank's gradient shards after the first step equal
its shards of jax.grad of the JAX loss_fn (the losses alone would not
show a wrong scale of the gradient mean: AdamW's update does not see it),
and its updated shards the JAX step's params;

and the single-device step (mesh=None) is today's: no process group, and
on the data-parallel case's batch the losses of JAX's step over 4 devices
(the same function as on one), within 1e-5.
"""

import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding

from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu.models import train as jtrain
from gpu_provisioner_tpu.parallel import make_mesh
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import train as ttrain
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy
from gpu_provisioner_tpu_torch.parallel import jobs, launch

JCFG = dataclasses.replace(jl.PRESETS["tiny"], dtype="float32")
TCFG = tl.LlamaConfig(**dataclasses.asdict(JCFG))
JPARAMS = jl.init_params(jax.random.key(0), JCFG)
NPARAMS = jax.tree.map(np.asarray, JPARAMS)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches():
    """Drops what this module compiled once it is done: a later test in the
    same worker (the control plane's event-loop stall budget) would
    otherwise pay for those objects in every full garbage collection."""
    yield
    jax.clear_caches()
    gc.collect()


def _toks(seed, B, S):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (B, S + 1), dtype=np.int32)


# case → (mesh, port cfg changes, tokens, steps); the JAX twin runs the same
# mesh and tokens with the ring schedule and dense attention unless the
# changes name the zigzag schedule
CASES = {
    "dp": ({"sp": 1, "tp": 1}, {}, _toks(1, 8, 64), 3),
    "sp2_tp2": ({"sp": 2, "tp": 2}, {}, _toks(1, 8, 64), 3),
    "sp2_tp2_flash": ({"sp": 2, "tp": 2}, {"attn_impl": "flash"},
                      _toks(1, 8, 64), 3),
    "slices": ({"num_slices": 2, "tp": 2}, {}, _toks(2, 8, 32), 1),
    "sp4_ring": ({"sp": 4}, {"max_seq_len": 64}, _toks(3, 4, 64), 1),
    "sp4_zigzag": ({"sp": 4}, {"max_seq_len": 64, "seq_schedule": "zigzag"},
                   _toks(3, 4, 64), 1),
}


# case → the JAX case (and its cfg changes) whose first step is its
# reference: the flash case's is the dense one's, the ring's the zigzag's
# (the same function of the same params and tokens)
ZIGZAG = {"max_seq_len": 64, "seq_schedule": "zigzag"}
REFERENCE = {"dp": ("dp", {}), "sp2_tp2": ("sp2_tp2", {}),
             "sp2_tp2_flash": ("sp2_tp2", {}), "slices": ("slices", {}),
             "sp4_ring": ("sp4_zigzag", ZIGZAG),
             "sp4_zigzag": ("sp4_zigzag", ZIGZAG)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """{case: every rank's train_case result}, one 4-rank world. Each case
    holds its first step against its JAX reference, saved for the ranks:
    jax.grad of the JAX loss_fn and the JAX step's updated params."""
    d = tmp_path_factory.mktemp("reference")
    cases = []
    for name, (mesh, changes, t, steps) in CASES.items():
        jcase, jchanges = REFERENCE[name]
        ref = d / f"{name}.pt"
        torch.save({"grads": params_from_numpy(_jax_grads(jcase), "cpu"),
                    "params": params_from_numpy(
                        _jax_case(jcase, **jchanges)[1], "cpu")}, ref)
        cases.append({"kind": "train", "mesh": mesh,
                      "cfg": dataclasses.replace(TCFG, **changes),
                      "params": NPARAMS, "batches": [(t[:, :-1], t[:, 1:])],
                      "steps": steps, "reference": str(ref)})
    res = launch.spawn_ranks(jobs.run_cases, 4, backend="gloo", device="cpu",
                             timeout_s=240, args=(cases, "cpu"))
    return {k: [r[i] for r in res] for i, k in enumerate(CASES)}


def _jax_losses(mesh, cfg, toks, steps):
    """JAX's make_train_step from JPARAMS (make_train_state's key) over
    ``steps`` steps of one batch, compiled at LLVM level 0: the losses, and
    the params after the first step (numpy)."""
    params, opt_state, opt = jtrain.make_train_state(jax.random.key(0), cfg,
                                                     mesh)
    put = lambda x: jax.device_put(jnp.asarray(x),
                                   NamedSharding(mesh, jtrain.BATCH_SPEC))
    inp, tgt = put(toks[:, :-1]), put(toks[:, 1:])
    step = jtrain.make_train_step(mesh, cfg, opt).lower(
        params, opt_state, inp, tgt).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, inp, tgt)
        losses.append(float(loss))
        if i == 0:      # copied: the next step donates these buffers
            first = jax.tree.map(np.array, params)
    return losses, first


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    """jax.grad of the JAX loss_fn at JPARAMS on ``case``'s tokens, on one
    device: the global mean's gradient, which every mesh must reach."""
    toks = CASES[case][2]
    grad = jax.jit(jax.grad(lambda p, i, t: jtrain.loss_fn(p, i, t, JCFG)))
    g = grad.lower(JPARAMS, toks[:, :-1], toks[:, 1:]).compile(
        compiler_options={"xla_backend_optimization_level": 0})(
        JPARAMS, toks[:, :-1], toks[:, 1:])
    return jax.tree.map(np.array, g)


def _port_losses(world, case):
    losses = [r["losses"] for r in world[case]]
    assert all(x == losses[0] for x in losses), losses   # every rank agrees
    return losses[0]


@functools.lru_cache(maxsize=None)
def _jax_case(case, **changes):
    """(losses, params after the first step) of JAX's step on ``case``."""
    mesh_kw, _, toks, steps = CASES[case]
    mesh = make_mesh(4, devices=jax.devices()[:4], **mesh_kw)
    return _jax_losses(mesh, dataclasses.replace(JCFG, **changes), toks,
                       steps)


def test_param_specs_cover_params():
    """:150: the port's split dims name the JAX PartitionSpec's ``model``
    entry for every leaf, within the leaf's rank."""
    params = tl.init_params(TCFG, torch.Generator(), device="cpu")
    specs = tl.param_specs(TCFG)
    jspecs = jl.param_specs(JCFG)
    leaves = list(jobs.spec_leaves(params, specs))
    assert len(leaves) == len(jax.tree.leaves(JPARAMS))
    for name, leaf, dim in leaves:
        jspec = jspecs
        for part in name.split("/"):
            jspec = jspec[part]
        assert len(jspec) <= leaf.ndim
        want = [i for i, a in enumerate(jspec) if a == "model"]
        assert ([dim] if dim is not None else []) == want, name


@pytest.mark.parametrize("case", ["dp", "sp2_tp2"])
def test_train_step_losses_match_jax(world, case):
    """:182 at (sp, tp) = (1, 1) and (2, 2): three steps, held to JAX's."""
    got = _port_losses(world, case)
    want = _jax_case(case)[0]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[-1] < got[0]


def test_flash_train_step_on_the_mesh_matches_jax(world):
    """The flash path at (sp, tp) = (2, 2) (the flash ring, its plain
    version on the CPU) against JAX's dense step: the same function."""
    got = _port_losses(world, "sp2_tp2_flash")
    np.testing.assert_allclose(got, _port_losses(world, "sp2_tp2"),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, _jax_case("sp2_tp2")[0], atol=1e-5,
                               rtol=0)


def test_train_step_multislice_mesh(world):
    """:195: 2 slices × tp 2 — the batch over (slice, data), gradients
    averaged across slices."""
    got = _port_losses(world, "slices")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_case("slices")[0], atol=1e-5,
                               rtol=0)


def test_zigzag_train_step_matches_ring(world):
    """:319: the zigzag schedule's loss is the ring's (the tokens permuted,
    positions travelling with them), and JAX's zigzag step's."""
    ring, zig = (_port_losses(world, c) for c in ("sp4_ring", "sp4_zigzag"))
    np.testing.assert_allclose(zig, ring, atol=1e-5, rtol=0)
    want = _jax_case("sp4_zigzag", **ZIGZAG)[0]
    np.testing.assert_allclose(zig, want, atol=1e-5, rtol=0)


def test_single_device_step_is_unchanged():
    """mesh=None: the step runs without a process group, and its losses
    over three steps are JAX's on the same params and batch."""
    params, opt = ttrain.train_state_from(params_from_numpy(NPARAMS,
                                                            device="cpu"))
    step = ttrain.make_train_step(TCFG, opt)
    toks = CASES["dp"][2]
    inp, tgt = (torch.from_numpy(a).long() for a in (toks[:, :-1],
                                                     toks[:, 1:]))
    got = [step(params, inp, tgt).item() for _ in range(3)]
    assert not dist.is_initialized()
    np.testing.assert_allclose(got, _jax_case("dp")[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_gradients_match_jax(world, case):
    """Each rank's gradient shards after the first step against its shards
    of jax.grad of the JAX loss_fn, the worst leaf's max error within 1e-4
    of that leaf's largest gradient: a sum where the mean belongs, or a
    leaf scaled by a group's size, fails here, though AdamW's update hides
    it from the losses. And its updated shards against the JAX step's
    params within 1e-5 where |g| >= 1e-7 (below that the sign of AdamW's
    first ±lr update follows the summation order)."""
    for r in world[case]:
        assert r["grad_err"] <= 1e-4, (r["coords"], r["grad_err"])
        assert r["param_err"] <= 1e-5, (r["coords"], r["param_err"])
