"""The port's sharded serving (generate, speculative_generate, ServeEngine
and cached_forward with ``mesh=``/``shard=``) against the JAX package's
sharded serving and the port's single-process serving, on the CPU.

A module fixture spawns one 4-rank gloo world that runs every case
(``jobs.serving_case``, ``jobs.serve_refusals_case``) from the JAX params
(``tiny`` and ``tiny-moe`` in f32) on the same numpy prompts; the JAX
programs run jitted on 4 devices of the 8-device CPU mesh, compiled at LLVM
level 0, while the world runs. Tolerances: in f32 the tokens are exact and
logits within 1e-4 (the single-device twin's, ``test_torch_decode.py``);
flash against dense under the same sharding in bf16 within the reference's
3e-2. The twins:

- tests/test_decode.py:62 ``generate`` on ``tp=2`` (data 2 × model 2 of
  the 4 ranks): the JAX tp-sharded ``generate``'s tokens, the JAX
  single-device one's and the port's single-process one's; and
  ``kv_cache_specs`` splits dim 2 over ``model`` (bf16 and int8 caches);
- :150 ``cached_forward`` with ``attn_impl="flash"`` on ``tp=2`` at S=128,
  max_len 256: the dense impl's logits under the same sharding (bf16,
  3e-2), JAX's flash-on-mesh logits in f32 (1e-4);
- ``__graft_entry__.py``'s ``serving`` regime on (data 2, model 2): a
  fresh cache, an int8 cache with left pads and eos, self-draft
  speculation (equal to plain greedy row for row) and ``ServeEngine``
  streams (equal to generate's rows, one through a shared prefix), each
  the single-process port's and JAX's sharded programs' tokens;
- the ``serving_moe`` regime: ``tiny-moe`` on ``ep=2`` and (``ep=2``,
  ``tp=2``), fresh and left-padded, the single-process MoE ``generate``'s
  and JAX's expert-mesh ``generate``'s tokens;
- the refusals: ``seq`` or ``pipe`` > 1, a ``model`` size that does not
  divide the heads, params that are not the rank's shards.
"""

import dataclasses
import functools
import gc
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gpu_provisioner_tpu.models import decode as jd
from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu.models import moe as jm
from gpu_provisioner_tpu.models import train as jtrain
from gpu_provisioner_tpu.models.speculative import (
    speculative_generate as jspec)
from gpu_provisioner_tpu.parallel import make_mesh
from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import moe as tm
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy
from gpu_provisioner_tpu_torch.models.speculative import speculative_generate
from gpu_provisioner_tpu_torch.models.train import Shard
from gpu_provisioner_tpu_torch.parallel import jobs, launch
from gpu_provisioner_tpu_torch.parallel.comm import TPGroup

JCFG = dataclasses.replace(jl.PRESETS["tiny"], dtype="float32",
                           max_seq_len=512)
TCFG = tl.LlamaConfig(**dataclasses.asdict(JCFG))
JPARAMS = jl.init_params(jax.random.key(0), JCFG)
NPARAMS = jax.tree.map(np.asarray, JPARAMS)
TPARAMS = params_from_numpy(NPARAMS, device="cpu")
JMOE = dataclasses.replace(jm.PRESETS_MOE["tiny-moe"], dtype="float32")
TMOE = tm.MoEConfig(**dataclasses.asdict(JMOE))
JMOE_PARAMS = jm.init_moe_model(jax.random.key(2), JMOE)
NMOE = jax.tree.map(np.asarray, JMOE_PARAMS)
TMOE_PARAMS = params_from_numpy(NMOE, device="cpu")
LEVEL0 = {"xla_backend_optimization_level": 0}
ATOL, BF16_TOL = 1e-4, 3e-2
NEW = 4


def _tokens(seed, shape, vocab=JCFG.vocab_size):
    return np.random.default_rng(seed).integers(1, vocab, shape,
                                                dtype=np.int32)


TP62 = _tokens(1, (2, 6))                 # test_decode.py:62's prompt shape
PROMPT = _tokens(3, (8, 8))               # the serving regime's batch
PADDED = PROMPT.copy()
PADDED[0, :3] = 0                         # 3 pads, as the regime's
PADDED[5, :5] = 0
FLASH_PROMPT = _tokens(4, (2, 128))       # :150's S=128
MOE_PROMPT = _tokens(5, (4, 8), JMOE.vocab_size)
MOE_PADDED = MOE_PROMPT.copy()
MOE_PADDED[0, :3] = 0


def _port_generate(params, prompt, cfg, **kw):
    return td.generate(params, torch.from_numpy(prompt), cfg,
                       max_new_tokens=NEW, device="cpu", **kw).numpy()


# the int8 program's eos: the second token of row 1's stream, so that row
# finishes early
EOS = int(_port_generate(TPARAMS, PADDED, dataclasses.replace(
    TCFG, kv_cache_dtype="int8"), pad_id=0)[1, 1])
ENGINE = [(PROMPT[i].tolist(), NEW, None) for i in range(4)] + [
    (PROMPT[4, 5:].tolist(), NEW, PROMPT[4, :5].tolist())]
SERVING = [
    {"name": "tp62", "kind": "generate", "prompt": TP62, "new": NEW},
    {"name": "fp", "kind": "generate", "prompt": PROMPT, "new": NEW},
    {"name": "int8", "kind": "generate", "prompt": PADDED, "new": NEW,
     "cfg": {"kv_cache_dtype": "int8"}, "pad_id": 0, "eos_id": EOS},
    {"name": "spec", "kind": "speculative", "prompt": PROMPT, "new": NEW,
     "spec_k": 2},
    {"name": "engine", "kind": "engine", "requests": ENGINE, "slots": 2,
     "max_len": 32, "buckets": (8,)},
    {"name": "flash_f32", "kind": "forward", "prompt": FLASH_PROMPT,
     "max_len": 256, "cfg": {"attn_impl": "flash"}},
    {"name": "flash_bf16", "kind": "forward", "prompt": FLASH_PROMPT,
     "max_len": 256, "cfg": {"attn_impl": "flash", "dtype": "bfloat16"}},
    {"name": "dense_bf16", "kind": "forward", "prompt": FLASH_PROMPT,
     "max_len": 256, "cfg": {"dtype": "bfloat16"}}]
MOE_MESHES = {"ep2": {"ep": 2}, "ep2_tp2": {"ep": 2, "tp": 2}}
MOE_PROGRAMS = [
    {"name": "fresh", "kind": "generate", "prompt": MOE_PROMPT, "new": NEW,
     "max_len": 32},
    {"name": "padded", "kind": "generate", "prompt": MOE_PADDED,
     "new": NEW, "max_len": 32, "pad_id": 0}]
REFUSALS = {"seq": ({"sp": 2}, "shards", "seq = 2"),
            "pipe": ({"pp": 2}, "shards", "pipe = 2"),
            "heads": ({"tp": 4}, "shards", "does not divide the heads"),
            "whole": ({"tp": 2}, "whole", "this rank's shard")}


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches():
    """Drops what this module compiled once it is done (a later test in the
    same worker would pay for those objects in every garbage collection)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def world():
    """A callable giving {case: every rank's result}: the 4-rank world runs
    in a thread while the tests compile their JAX references."""
    cases = [{"kind": "mesh", "mesh": {"tp": 2}},
             {"kind": "serving", "mesh": {"tp": 2}, "cfg": TCFG,
              "programs": SERVING, "params": NPARAMS}]
    cases += [{"kind": "serving_moe", "mesh": mesh, "cfg": TMOE,
               "programs": MOE_PROGRAMS, "params": NMOE}
              for mesh in MOE_MESHES.values()]
    cases.append({"kind": "serve_refusals", "cfg": TCFG, "params": NPARAMS,
                  "attempts": [(m, w) for m, w, _ in REFUSALS.values()]})
    pool = ThreadPoolExecutor(1)
    run = pool.submit(launch.spawn_ranks, jobs.run_cases, 4, backend="gloo",
                      device="cpu", timeout_s=240, args=(cases, "cpu"))
    names = ["mesh", "serving"] + list(MOE_MESHES) + ["refusals"]

    @functools.lru_cache(maxsize=None)
    def result():
        res = run.result()
        return {k: [r[i] for r in res] for i, k in enumerate(names)}

    yield result
    result()                   # the world's error, if no test asked for it
    pool.shutdown()


def _level0(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=LEVEL0)(*args)


@functools.lru_cache(maxsize=None)
def _jax_mesh(**split):
    return make_mesh(4, devices=jax.devices()[:4], **split)


@functools.lru_cache(maxsize=None)
def _jax_tp_params():
    return jtrain.shard_params(JPARAMS, _jax_mesh(tp=2), JCFG)


@functools.lru_cache(maxsize=None)
def _jax_serving(name):
    """The JAX package's program ``name`` on its tp-sharded params (the
    mesh's data 2 × model 2), as __graft_entry__'s serving regime runs it."""
    p = _jax_tp_params()
    if name == "tp62":
        out = _level0(lambda p, t: jd.generate(p, t, JCFG,
                                               max_new_tokens=NEW), p, TP62)
    elif name == "fp":
        out = _level0(lambda p, t: jd.generate(p, t, JCFG,
                                               max_new_tokens=NEW), p, PROMPT)
    elif name == "int8":
        cfg8 = dataclasses.replace(JCFG, kv_cache_dtype="int8")
        out = _level0(lambda p, t: jd.generate(
            p, t, cfg8, max_new_tokens=NEW, pad_id=0, eos_id=EOS), p, PADDED)
    elif name == "spec":
        out = _level0(lambda p, t: jspec(p, p, t, JCFG, JCFG,
                                         max_new_tokens=NEW, spec_k=2)[0],
                      p, PROMPT)
    else:                        # :150: the flash cached forward, f32
        cfg = dataclasses.replace(JCFG, attn_impl="flash")
        out = _level0(lambda p, t: jd.cached_forward(
            p, t, jd.init_kv_cache(cfg, 2, 256), cfg)[0], p, FLASH_PROMPT)
    return np.asarray(out)


def _assembled(ranks, program):
    """The global rows of ``program`` from the ranks' blocks; the ranks of
    a ``model`` group must agree on theirs."""
    out = {}
    for r in ranks:
        rows = tuple(r["programs"][program]["rows"])
        got = r["programs"][program]["out"]
        if rows in out:
            np.testing.assert_array_equal(got, out[rows])
        out[rows] = got
    return np.concatenate([out[k] for k in sorted(out)])


def test_no_rank_imported_jax(world):
    assert not any(r["jax_loaded"] for r in world()["mesh"])


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_kv_cache_specs_split_kv_heads_over_model(kv_dtype):
    """The JAX kv_cache_specs' ``model`` entry is dim 2 of every cache leaf
    (the scales' too), the length replicated; a rank's cache is built at
    its kv heads' shape."""
    jcfg = dataclasses.replace(JCFG, kv_cache_dtype=kv_dtype)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    jspecs, tspecs = jd.kv_cache_specs(jcfg), td.kv_cache_specs(tcfg)
    for name in jd.KVCache._fields:
        want, got = getattr(jspecs, name), getattr(tspecs, name)
        if want is None:                   # no scales in an "auto" cache
            assert got is None, name
            continue
        dims = [i for i, a in enumerate(want) if a == "model"]
        assert got == (dims[0] if dims else None), name
    assert td.kv_cache_specs(tcfg).k == 2 and jspecs.k == P(
        None, None, "model", None, None)
    shard = Shard(tp=TPGroup(None, 2, 1))
    cache = td.init_kv_cache(tcfg, 3, 16, "cpu", shard=shard)
    whole = td.init_kv_cache(tcfg, 3, 16, "cpu")
    for name in ("k", "v", "k_scale", "v_scale"):
        t, w = getattr(cache, name), getattr(whole, name)
        if w is None:
            assert t is None
            continue
        assert t.shape[2] == tcfg.n_kv_heads // 2
        assert t.shape[:2] + t.shape[3:] == w.shape[:2] + w.shape[3:]


def test_generate_tensor_parallel_on_mesh(world):
    """Twin of test_decode.py:62: the ranks' rows of generate on tp=2 equal
    the JAX tp-sharded generate's, the JAX single-device one's and the
    port's single-process one's."""
    got = _assembled(world()["serving"], "tp62")
    host = np.asarray(_level0(lambda p, t: jd.generate(
        p, t, JCFG, max_new_tokens=NEW), JPARAMS, TP62))
    np.testing.assert_array_equal(_jax_serving("tp62"), host)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, _port_generate(TPARAMS, TP62, TCFG))


def test_flash_prefill_on_tp_mesh_matches_dense(world):
    """Twin of test_decode.py:150: flash cached_forward on a tp=2 mesh (the
    rank's kv heads in its cache) within 3e-2 of dense under the same
    sharding in bf16; in f32 within 1e-4 of the JAX flash forward on the
    mesh (its Pallas kernel in interpret mode)."""
    ranks = world()["serving"]
    for r in ranks:
        progs = r["programs"]
        assert progs["flash_bf16"]["length"] == 128
        np.testing.assert_allclose(progs["flash_bf16"]["out"],
                                   progs["dense_bf16"]["out"],
                                   atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(_assembled(ranks, "flash_f32"),
                               _jax_serving("flash"), atol=ATOL, rtol=0)


@pytest.mark.parametrize("program", ["fp", "int8", "spec"])
def test_serving_regime_matches_single_process_and_jax(world, program):
    """The serving regime's programs on (data 2, model 2): every rank's rows
    equal the port's single-process run and the JAX package's sharded one;
    speculation equals plain greedy row for row."""
    got = _assembled(world()["serving"], program)
    if program == "int8":
        want = _port_generate(TPARAMS, PADDED, dataclasses.replace(
            TCFG, kv_cache_dtype="int8"), pad_id=0, eos_id=EOS)
        assert (want[1, 1:] == EOS).all()       # row 1 finished at eos
    elif program == "spec":
        want = speculative_generate(TPARAMS, TPARAMS, torch.from_numpy(
            PROMPT), TCFG, TCFG, max_new_tokens=NEW, spec_k=2,
            device="cpu")[0].numpy()
        np.testing.assert_array_equal(got, _assembled(world()["serving"],
                                                      "fp"))
    else:
        want = _port_generate(TPARAMS, PROMPT, TCFG)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_serving(program))


def test_serving_engine_streams_equal_generate_rows(world):
    """ServeEngine on the tp-sharded params (the same request stream on
    every rank, one request through a cached prefix): each stream is its
    row of generate on the batch, the port's single-process one and the
    JAX package's sharded one."""
    want = _port_generate(TPARAMS, PROMPT, TCFG)
    np.testing.assert_array_equal(want, _jax_serving("fp"))
    for r in world()["serving"]:
        eng = r["programs"]["engine"]
        assert eng["out"] == want[:5].tolist()
        assert eng["stats"]["prefix_cache_misses"] == 1
        assert eng["stats"]["requests_submitted"] == 5


@functools.lru_cache(maxsize=None)
def _jax_moe(mesh_name, program):
    mesh = _jax_mesh(**MOE_MESHES[mesh_name])
    params = jtrain.shard_params(JMOE_PARAMS, mesh,
                                 specs=jm.moe_model_specs(JMOE))
    pad = {"pad_id": 0} if program == "padded" else {}
    prompt = MOE_PADDED if program == "padded" else MOE_PROMPT
    return np.asarray(_level0(lambda p, t: jd.generate(
        p, t, JMOE, max_new_tokens=NEW, max_len=32, **pad), params, prompt))


@pytest.mark.parametrize("program", ["fresh", "padded"])
@pytest.mark.parametrize("mesh_name", list(MOE_MESHES))
def test_serving_moe_matches_single_process_and_jax(world, mesh_name,
                                                    program):
    """tiny-moe on an expert mesh (the batch over data, replicated over
    expert; the experts' combine summed over expert × model): every rank's
    rows equal the single-process MoE generate and JAX's expert-mesh
    generate."""
    got = _assembled(world()[mesh_name], program)
    pad = {"pad_id": 0} if program == "padded" else {}
    prompt = MOE_PADDED if program == "padded" else MOE_PROMPT
    want = td.generate(TMOE_PARAMS, torch.from_numpy(prompt), TMOE,
                       max_new_tokens=NEW, max_len=32, device="cpu",
                       **pad).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_moe(mesh_name, program))


@pytest.mark.parametrize("case", list(REFUSALS))
def test_serving_refusals(world, case):
    """seq or pipe > 1, a model size that does not divide the heads (4 q,
    2 kv at tp 4: mesh_shard's ValueError) and the whole tree on a tp=2
    mesh are refused on every rank, before any collective."""
    i = list(REFUSALS).index(case)
    for r in world()["refusals"]:
        assert r[i] is not None and REFUSALS[case][2] in r[i], r[i]
