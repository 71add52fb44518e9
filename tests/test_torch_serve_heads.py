"""The serving paths at head dims 32 and 16 against the JAX package, on the
CPU.

On the card the forward, cached and decode kernels take head dims 32 and
16 (the D = 64 tensor-core tile partly filled; the decode block in 4 or 8
row groups), so the fast bench_engine and bench_moe_decode models serve at
their JAX 8/4 heads of 32 and tiny-moe at its 4/2 of 16. Here the port's
flash path (the kernels' plain versions, on CPU tensors) is held against
the JAX package's (its Pallas kernels in interpret mode, as its own tests
run them), f32, params carried across with params_from_numpy, 2 layers:
- the port's fast configs have the JAX fast models' fields (read from the
  JAX bench.py by ast);
- cached_forward / moe_cached_forward: logits of a 128-token prompt (the
  cached kernel at start 0) and two decode steps (the decode kernel)
  within 1e-4 on an f32 cache; on an int8 one the caches within two
  quanta dequantised and the logits within 2e-2 (ROADMAP Queue C 2: a
  value on a rounding boundary quantises one step apart, and at dim 256
  one V element a quantum apart at a row's first position, where its
  attention weight is 1, moves that position's logits by 7.4e-3 a
  layer);
- greedy generate, fresh (the dense family's self-attention prefill),
  left-padded and on an int8 cache: token-equal;
- a ServeEngine pass at head dim 32 and an MoE one at 16: every stream
  equal to the JAX engine's and to generate() on its bucket-padded prompt.
The MoE models keep the JAX tests' generous capacity (capacity_factor 8: no
expert drops, so a routing tie cannot tell the two sides apart).
"""

import ast
import dataclasses
import functools
import gc
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_provisioner_tpu.models import decode as jd
from gpu_provisioner_tpu.models import engine as je
from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu.models import moe as jm
from gpu_provisioner_tpu.models import moe_serve as jms
from gpu_provisioner_tpu_torch import bench as tbench
from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.models import engine as te
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import moe as tm
from gpu_provisioner_tpu_torch.models import moe_serve as tms
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
ATOL, ATOL_INT8 = 1e-4, 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The JAX references compile while the port runs small ops: one torch
    thread keeps the module's CPU time to its own work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches():
    """Drops what this module compiled once it is done: a later test in the
    same worker would otherwise pay for those objects in every full garbage
    collection."""
    yield
    _params.cache_clear()
    jax.clear_caches()
    gc.collect()


def _jax_fast_fields(fn: str) -> dict:
    """The keyword fields of the fast model of JAX bench.py's ``fn``: the
    first branch of its ``(Config(...) if fast else Config(...))``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    body = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == fn)
    ifexp = next(n for n in ast.walk(body) if isinstance(n, ast.IfExp)
                 and isinstance(n.body, ast.Call)
                 and getattr(n.body.func, "id", "").endswith("Config"))
    return {k.arg: ast.literal_eval(k.value) for k in ifexp.body.keywords}


@pytest.mark.parametrize("fn,config", [
    ("bench_engine", tbench.engine_config),
    ("bench_moe_decode", tbench.moe_decode_config)])
def test_fast_serving_twins_take_the_jax_models(fn, config):
    """The fast twins serve the JAX models, heads included: dim 256, 8/4
    heads of 32 (bench.py:486-490, :529-531)."""
    fields = _jax_fast_fields(fn)
    cfg = config(True)
    assert {k: getattr(cfg, k) for k in fields} == fields
    assert (cfg.head_dim, cfg.n_heads, cfg.n_kv_heads) == (32, 8, 4)


# the models at head dims 32 and 16, f32, flash attention
MODELS = {
    "engine-d32": jl.LlamaConfig(**{**_jax_fast_fields("bench_engine"),
                                    "dtype": "float32", "max_seq_len": 512}),
    "moe-d32": jm.MoEConfig(**{**_jax_fast_fields("bench_moe_decode"),
                               "dtype": "float32", "max_seq_len": 512,
                               "capacity_factor": 8.0}),
    "tiny-moe-d16": dataclasses.replace(
        jm.PRESETS_MOE["tiny-moe"], dtype="float32", max_seq_len=512,
        capacity_factor=8.0, attn_impl="flash"),
}


def _tcfg(jcfg):
    return (tm.MoEConfig if isinstance(jcfg, jm.MoEConfig)
            else tl.LlamaConfig)(**dataclasses.asdict(jcfg))


@functools.cache
def _params(model: str):
    """(jax params, port params) of MODELS[model], seed 0."""
    jcfg = MODELS[model]
    init = jm.init_moe_model if isinstance(jcfg, jm.MoEConfig) \
        else jl.init_params
    jp = init(jax.random.key(0), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, shape,
                                                dtype=np.int32)


def _deq(buf, scl):
    return np.asarray(buf, np.float32) * np.asarray(scl)


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("model", list(MODELS))
def test_cached_forward_at_small_head_dims_matches_jax(model, kv_dtype):
    """A 128-token prompt (the cached kernel at start 0) then two decode
    steps (the decode kernel): logits agree with JAX, and an int8 cache's
    contents within two quanta, dequantised."""
    jcfg = dataclasses.replace(MODELS[model], kv_cache_dtype=kv_dtype)
    tcfg = _tcfg(jcfg)
    jp, tp = _params(model)
    moe = isinstance(jcfg, jm.MoEConfig)
    jfwd = jms.moe_cached_forward if moe else jd.cached_forward
    tfwd = tms.moe_cached_forward if moe else td.cached_forward
    atol = ATOL_INT8 if kv_dtype == "int8" else ATOL
    tok = _tokens(1, (2, 128), jcfg.vocab_size)
    jc = jd.init_kv_cache(jcfg, 2, 256)
    tc = td.init_kv_cache(tcfg, 2, 256, device="cpu")
    for _ in range(3):
        jlog, jc = jfwd(jp, jnp.asarray(tok), jc, jcfg)
        tlog, tc = tfwd(tp, torch.from_numpy(tok), tc, tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=atol)
        tok = np.array(jnp.argmax(jlog[:, -1:], axis=-1), np.int32)
    assert tc.length == int(jc.length) == 130
    if kv_dtype == "int8":
        qtol = 2 * float(np.max(np.asarray(jc.k_scale)))
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                _deq(getattr(tc, kv).numpy(), getattr(tc, kv + "_scale")),
                _deq(getattr(jc, kv), getattr(jc, kv + "_scale")), atol=qtol)


GENERATE_CASES = {"fresh": {}, "pad": {"pad_id": 0},
                  "int8-pad": {"pad_id": 0, "kv_cache_dtype": "int8"}}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
@pytest.mark.parametrize("model", list(MODELS))
def test_generate_at_small_head_dims_matches_jax(model, case):
    """Greedy generate of a 128-token prompt (two rows; one left-padded
    by 37 with pad_id) on an f32 or an int8 cache: the port's stream equals
    the JAX package's token for token. The MoE family has no fresh
    prefill: its "fresh" case runs the cached prefill on unpadded rows."""
    kw = dict(GENERATE_CASES[case])
    jcfg = dataclasses.replace(MODELS[model],
                               kv_cache_dtype=kw.pop("kv_cache_dtype",
                                                     "auto"))
    jp, tp = _params(model)
    prompt = _tokens(2, (2, 128), jcfg.vocab_size)
    if "pad_id" in kw:
        prompt[1, :37] = 0
    kw.update(max_new_tokens=5, max_len=256)
    j = jd.generate(jp, jnp.asarray(prompt), jcfg, **kw)
    t = td.generate(tp, torch.from_numpy(prompt), _tcfg(jcfg), device="cpu",
                    **kw)
    assert t.tolist() == np.asarray(j).tolist()


@pytest.mark.parametrize("model", ["engine-d32", "tiny-moe-d16"])
def test_engine_at_small_head_dims_matches_jax_engine(model):
    """A ServeEngine pass (two slots, a 128 bucket: admission on the cached
    kernel, every step on the decode kernel at per-row starts): each stream
    equals the JAX engine's and generate() on its bucket-padded prompt."""
    jcfg = MODELS[model]
    jp, tp = _params(model)
    reqs = [_tokens(10 + i, (n,), jcfg.vocab_size).tolist()
            for i, n in enumerate((100, 60, 128))]
    streams = []
    for mod, params, cfg, dev in ((je, jp, jcfg, {}),
                                  (te, tp, _tcfg(jcfg), {"device": "cpu"})):
        eng = mod.ServeEngine(params, cfg, slots=2, max_len=256,
                              prefill_buckets=(128,), **dev)
        ids = [eng.submit(p, n) for p, n in zip(reqs, (4, 5, 3))]
        eng.run()
        streams.append([eng.finished[i] for i in ids])
    assert streams[1] == streams[0]
    for p, n, got in zip(reqs, (4, 5, 3), streams[1]):
        padded = torch.tensor([[0] * (128 - len(p)) + p])
        want = td.generate(tp, padded, _tcfg(jcfg), max_new_tokens=n,
                           max_len=256, pad_id=0, device="cpu")
        assert got == want[0].tolist()
