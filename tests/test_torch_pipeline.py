"""The port's pipelined train step (parallel/pipeline.py, models/train.py's
make_pipeline_train_step) against the JAX package on the CPU.

A module fixture spawns one 4-rank gloo world that runs every case
(jobs.run_cases): ``tiny`` at 4 layers in f32 from the JAX params and
numpy batches. While it runs, the JAX references compile (LLVM level 0):
jax.value_and_grad of the plain loss_fn on the whole batch, which the
pipelined gradient must equal counted once, one optax AdamW step from it
(both saved for the ranks, which hold their shards of the gradients and
params against them), and JAX's make_pipeline_train_step over three
steps, once a schedule (f32: the JAX pipeline CHECK-fails in bf16 on the
CPU); the tests that need the JAX pipeline come first. Twins of
tests/test_parallel_extra.py:

- :85 the layout round trip and the order [0, 1, 4, 5, 2, 3, 6, 7];
- :95 the pipelined forward against the plain one, bf16, 6e-2;
- :156, :163, :169, :176 pp×tp, pp×sp, the interleaved schedule and the
  flash path (its plain version here) at S = 128, and (pp 2, dp 2): the
  first step's loss within 1e-5 (relative) of the plain loss and JAX's
  pipelined step's, each rank's gradients within 1e-4 of the largest and
  its params within 1e-5 where |g| >= 1e-7 (the sharded step's limits,
  not the reference's 1e-2), the losses of three steps JAX's pipelined
  step's (gpipe and interleaved, compiled once each) within 1e-5;
- :185 from make_pipeline_train_state's seeded draw the loss falls;

and of tests/test_tpu_pod.py, which runs only on a TPU pod: :58 the bf16
pipeline's first-step loss within 5e-2 of JAX's plain loss; :89 the bf16
zigzag ring attention at (B, 512, 4, 64) against dense attention, 5e-2.
Also the schedule's preconditions as ValueErrors and make_train_step
refusing a ``pipe`` mesh.
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

from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu.models import train as jtrain
from gpu_provisioner_tpu.parallel import make_mesh
from gpu_provisioner_tpu.parallel import pipeline as jpipe
from gpu_provisioner_tpu.parallel.ring import dense_attention as jdense
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy
from gpu_provisioner_tpu_torch.parallel import jobs, launch
from gpu_provisioner_tpu_torch.parallel import pipeline as tpipe

JCFG = dataclasses.replace(jl.PRESETS["tiny"], n_layers=4, dtype="float32")
TCFG = tl.LlamaConfig(**dataclasses.asdict(JCFG))
JPARAMS = jl.init_params(jax.random.key(0), JCFG)     # f32 masters either
NPARAMS = jax.tree.map(np.asarray, JPARAMS)           # way: bf16 cases too
JCFG2 = jl.PRESETS["tiny"]                            # 2 layers, bf16
JPARAMS2 = jl.init_params(jax.random.key(0), JCFG2)
LEVEL0 = {"xla_backend_optimization_level": 0}


def _toks(seed, B, S):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (B, S + 1), dtype=np.int32)


TOKS = {"short": _toks(1, 8, 32), "flash": _toks(2, 4, 128),
        "bf16": _toks(3, 4, 32), "forward": _toks(4, 8, 32)[:, :-1]}

# case → (mesh, n_chunks, cfg changes, tokens, steps); every case runs
# n_micro = 2
CASES = {
    "pp2_dp2": ({"pp": 2}, 1, {}, "short", 3),
    "pp2_tp2": ({"pp": 2, "tp": 2}, 1, {}, "short", 3),
    "pp2_tp2_interleaved": ({"pp": 2, "tp": 2}, 2, {}, "short", 3),
    "pp2_sp2": ({"pp": 2, "sp": 2}, 1, {}, "short", 3),
    "pp2_tp2_flash": ({"pp": 2, "tp": 2}, 1, {"attn_impl": "flash"},
                      "flash", 2),
    "bf16": ({"pp": 2}, 1, {"dtype": "bfloat16"}, "bf16", 1),
}
# the pipelined forward's case (:95) and the bf16 zigzag attention's (:89)
ATT_SHAPE = (2, 512, 4, 64)
# (attempt, the ValueError's words; None: it goes through) on (pp 2, dp 2)
REFUSALS = ((("pipeline", 2, 4, 8), "n_layers = 4 does not split"),
            (("pipeline", 3, 2, 12), "n_micro % n_stages"),
            (("pipeline", 2, 1, 6), "B = 6 does not split"),
            (("pipeline", 2, 2, 8), None),
            (("train",), "make_pipeline_train_step"))


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches():
    """Drops what this module compiled once it is done (a later test in the
    same worker would pay for those objects in every garbage collection)."""
    yield
    jax.clear_caches()
    gc.collect()


def _level0(jitted, *args):
    return jitted.lower(*args).compile(compiler_options=LEVEL0)


@functools.lru_cache(maxsize=None)
def _plain(toks_key):
    """jax.value_and_grad of the plain loss_fn at JPARAMS on the whole
    batch, and the params after one optax AdamW step from it (numpy)."""
    t = TOKS[toks_key]
    vg = _level0(jax.jit(jax.value_and_grad(
        lambda p, i, o: jtrain.loss_fn(p, i, o, JCFG))), JPARAMS, t[:, :-1],
        t[:, 1:])
    loss, grads = vg(JPARAMS, t[:, :-1], t[:, 1:])
    opt = jtrain.default_optimizer()
    updates, _ = opt.update(grads, opt.init(JPARAMS), JPARAMS)
    new = optax.apply_updates(JPARAMS, updates)
    return float(loss), jax.tree.map(np.array, grads), jax.tree.map(
        np.array, new)


@functools.lru_cache(maxsize=None)
def _jax_pipeline(n_chunks):
    """The losses of JAX's make_pipeline_train_step at (pp 2, tp 2) (4
    devices of the CPU mesh) with ``n_chunks``, from JPARAMS in its layout,
    f32 and dense attention, over three steps of the "short" batch: one
    compile a schedule."""
    mesh = make_mesh(4, devices=jax.devices()[:4], pp=2, tp=2)
    params = jax.tree.map(jnp.copy, JPARAMS)
    params["blocks"] = jpipe.to_pipeline_layout(
        params["blocks"], JCFG.n_layers, mesh.shape["pipe"], n_chunks)
    params = jtrain.shard_params(params, mesh,
                                 specs=jtrain.pipeline_param_specs(JCFG))
    opt = jtrain.default_optimizer()
    state = opt.init(params)
    put = lambda x: jax.device_put(jnp.asarray(x),
                                   NamedSharding(mesh, jtrain.BATCH_SPEC))
    t = TOKS["short"]
    inp, tgt = put(t[:, :-1]), put(t[:, 1:])
    step = _level0(jtrain.make_pipeline_train_step(
        mesh, JCFG, n_micro=2, n_chunks=n_chunks, optimizer=opt), params,
        state, inp, tgt)
    layout = tuple(step.input_shardings[0][:2])
    losses = []
    for _ in range(3):
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
    for name, (mesh, n_chunks, changes, key, steps) in CASES.items():
        t = TOKS[key]
        case = {"kind": "pipeline", "mesh": mesh, "n_micro": 2,
                "n_chunks": n_chunks,
                "cfg": dataclasses.replace(TCFG, **changes),
                "params": NPARAMS, "batches": [(t[:, :-1], t[:, 1:])],
                "steps": steps}
        if name != "bf16":
            _, grads, new = _plain(key)
            ref = d / f"{name}.pt"
            torch.save({"grads": params_from_numpy(grads, "cpu"),
                        "params": params_from_numpy(new, "cpu")}, ref)
            case["reference"] = str(ref)
        cases.append(case)
    cases.append({"kind": "pipeline", "mesh": {"pp": 2}, "cfg": TCFG,
                  "seed": 0, "batch_shape": (8, 32), "steps": 4,
                  "n_micro": 2})
    cases.append({"kind": "pipeline_forward", "mesh": {"pp": 2},
                  "cfg": tl.LlamaConfig(**dataclasses.asdict(JCFG2)),
                  "params": jax.tree.map(np.asarray, JPARAMS2),
                  "tokens": TOKS["forward"], "n_micro": 2})
    q, k, v = _attention_inputs()
    cases.append({"kind": "attention", "mesh": {"sp": 2}, "q": q, "k": k,
                  "v": v, "schedule": "zigzag", "impl": "flash",
                  "dtype": "bfloat16"})
    cases.append({"kind": "refusals", "mesh": {"pp": 2}, "cfg": TCFG,
                  "attempts": [a for a, _ in REFUSALS]})
    pool = ThreadPoolExecutor(1)
    run = pool.submit(launch.spawn_ranks, jobs.run_cases, 4, backend="gloo",
                      device="cpu", timeout_s=240, args=(cases, "cpu"))
    names = list(CASES) + ["seeded", "forward", "attention", "refusals"]

    @functools.lru_cache(maxsize=None)
    def result():
        res = run.result()
        return {k: [r[i] for r in res] for i, k in enumerate(names)}

    yield result
    result()                   # the world's error, if no test asked for it
    pool.shutdown()


def _attention_inputs():
    ks = jax.random.split(jax.random.key(0), 3)
    return tuple(np.asarray(jax.random.normal(kk, ATT_SHAPE, jnp.bfloat16)
                            .astype(jnp.float32)) for kk in ks)


def _losses(results):
    losses = [r["losses"] for r in results]
    assert all(x == losses[0] for x in losses), losses   # every rank agrees
    return losses[0]


def test_interleave_layer_order_roundtrip():
    """:85: stage 0 holds virtual stages 0 and 2 (layers 0, 1, then 4, 5),
    stage 1 virtual stages 1 and 3; the layout round trip is the
    identity, and the order is JAX's for other shapes too."""
    assert tpipe.interleave_layer_order(8, 2, 2) == [0, 1, 4, 5, 2, 3, 6, 7]
    for shape in ((8, 2, 2), (12, 2, 3), (8, 4, 1), (16, 4, 2)):
        assert (tpipe.interleave_layer_order(*shape)
                == jpipe.interleave_layer_order(*shape))
    blocks = {"w": torch.arange(8), "b": torch.arange(16).reshape(8, 2)}
    there = tpipe.to_pipeline_layout(blocks, 8, 2, 2)
    assert there["w"].tolist() == [0, 1, 4, 5, 2, 3, 6, 7]
    back = tpipe.from_pipeline_layout(there, 8, 2, 2)
    for name, leaf in blocks.items():
        assert torch.equal(back[name], leaf)


@pytest.mark.parametrize("case", ["pp2_dp2", "pp2_tp2",
                                  "pp2_tp2_interleaved", "pp2_sp2"])
def test_pipeline_losses_match_the_jax_pipeline(world, case):
    """The three losses against JAX's make_pipeline_train_step with the
    case's schedule (compiled once a schedule, at (pp 2, tp 2): the same
    function on every mesh shape)."""
    want = _jax_pipeline(CASES[case][1])
    np.testing.assert_allclose(_losses(world()[case]), want, atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("case", ["pp2_dp2", "pp2_tp2",
                                  "pp2_tp2_interleaved", "pp2_sp2",
                                  "pp2_tp2_flash"])
def test_pipeline_step_matches_the_plain_gradient(world, case):
    """:156 (pp×tp), :163 (pp×sp), :169 (interleaved), :176 (flash at
    S=128) and (pp 2, dp 2): the first step's loss is the plain loss_fn's
    (1e-5 relative), each rank's gradient shards are jax.value_and_grad's
    counted once (1e-4 of the largest) and its updated shards the AdamW
    step's (1e-5 where |g| >= 1e-7); the losses fall."""
    want = _plain(CASES[case][3])[0]
    got = _losses(world()[case])
    assert abs(got[0] - want) <= 1e-5 * abs(want), (got[0], want)
    for r in world()[case]:
        assert r["grad_err"] <= 1e-4, (r["coords"], r["grad_err"])
        assert r["param_err"] <= 1e-5, (r["coords"], r["param_err"])
    assert got[-1] < got[0]


def test_pipeline_train_step_loss_decreases(world):
    """:185: make_pipeline_train_state's seeded draw at pp 2, dp 2, four
    steps of one batch: the loss falls, finite on every rank."""
    losses = _losses(world()["seeded"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_bf16_pipeline_train_step(world):
    """test_tpu_pod.py:58, which JAX can only run on a pod: bf16
    activations at pp 2 (dp 2), two microbatches; the first step's loss
    within 5e-2 of JAX's plain (non-pipelined) bf16 loss."""
    t = TOKS["bf16"]
    cfg = dataclasses.replace(JCFG, dtype="bfloat16")
    want = float(jtrain.loss_fn(JPARAMS, t[:, :-1], t[:, 1:], cfg))
    got = _losses(world()["bf16"])[0]
    assert np.isfinite(got) and abs(got - want) < 5e-2, (got, want)


def test_bf16_zigzag_ring_attention(world):
    """test_tpu_pod.py:89: the zigzag ring (flash; its plain version here)
    over sp 2 in bf16 at (B, 512, 4, 64), assembled from the ranks'
    blocks, against JAX's dense attention within 5e-2."""
    q, k, v = _attention_inputs()
    want = np.asarray(jdense(*(jnp.asarray(a, jnp.bfloat16)
                               for a in (q, k, v))).astype(jnp.float32))
    got = jobs.assemble(world()["attention"], "out", want.shape)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


def test_pipeline_preconditions_raise(world):
    """The reference's preconditions, as ValueErrors on every rank: layers
    that do not split into stages·chunks, an interleaved n_micro that
    does not divide by the stages, a batch that does not split into
    microbatches over (slice, data); a valid interleaved step goes
    through; make_train_step refuses a pipe mesh and names the pipelined
    step."""
    for r in world()["refusals"]:
        for (attempt, words), got in zip(REFUSALS, r):
            if words is None:
                assert got is None, (attempt, got)
            else:
                assert got is not None and words in got, (attempt, got)


def test_pipelined_forward_matches_plain(world):
    """:95: tiny (bf16 activations) at pp 2, dp 2, two microbatches: the
    last stage's logits of each data rank's rows against JAX's plain
    forward within 6e-2."""
    want = np.asarray(jl.forward(JPARAMS2, jnp.asarray(TOKS["forward"]),
                                 JCFG2))
    got = np.full(want.shape, np.nan, np.float32)
    rows = want.shape[0] // 2
    for r in world()["forward"]:
        assert (r["logits"] is None) == (r["coords"]["pipe"] == 0)
        if r["logits"] is not None:
            d = r["coords"]["data"]
            got[d * rows:(d + 1) * rows] = r["logits"]
    np.testing.assert_allclose(got, want, atol=6e-2, rtol=6e-2)
