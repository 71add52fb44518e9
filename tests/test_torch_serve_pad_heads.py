"""The serving paths at head dims 100 and 120 against the JAX package, on
the CPU.

On the card the forward, cached and decode kernels take head dims 100 and
120 (csrc/flash_fwd_pad.cu, csrc/flash_decode_pad.cu: D = 128's tile with
a zeroed pad inside its last k-step; at 100 a row of no whole number of
16-byte chunks, copied in 8-byte pieces in bf16 and 4-byte pieces in
int8; at 120 a bf16 row of 15 chunks and an int8 row of 120 bytes in
8-byte pieces), so Llama configs at OpenLLaMA-3B's widths (32/32 heads of
100) and at H2O-Danube3-4B's (32/8 heads of 120) serve through them. Here
the port's flash path (the kernels' plain versions, on CPU tensors) is
held against the JAX package's (its Pallas kernels in interpret mode, as
its own tests run them) at each head dim, f32, params carried across with
params_from_numpy, 2 layers: OpenLLaMA's multi-head attention at 4/4 heads
of 100 (dim 400), and Danube3's group of 4 at 4/1 heads of 120 (dim 480,
its norm eps and rope theta). The tests' names are from when 100 was the
one head dim here:
- each wrapper against its JAX twin on numpy-seeded inputs, at 4/4 and
  GQA 4/2 heads of 100 and at 4/1 and 4/2 heads of 120:
  ``flash_attention_with_lse`` (out and lse within 1e-5),
  ``flash_attention_cached`` with pads, a window and sinks on an f32 and
  an int8 cache, ``flash_attention_decode`` at per-row starts, S = 1 and
  S = 5 (within 1e-5);
- cached_forward: logits of a 128-token prompt and two decode steps within
  1e-4 on an f32 cache; on an int8 one the caches within two quanta
  dequantised and the logits within 2e-2 (ROADMAP Queue C 2);
- greedy generate, fresh, left-padded and on an int8 cache: token-equal;
- a ServeEngine pass: every stream equal to the JAX engine's.
"""

import dataclasses
import functools
import gc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_provisioner_tpu.models import decode as jd
from gpu_provisioner_tpu.models import engine as je
from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.models import engine as te
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy
from gpu_provisioner_tpu_torch.ops import flash_attention as tfa

# the JAX ops package re-exports flash_attention, shadowing the module name
jfa = importlib.import_module("gpu_provisioner_tpu.ops.flash_attention")
ATOL, ATOL_INT8, ATOL_OP = 1e-4, 2e-2, 1e-5

# OpenLLaMA-3B's attention shape (head dim 100, multi-head) at 4 heads and
# 2 layers (its norm eps), and H2O-Danube3-4B's (head dim 120, a group of 4)
# at 4/1 heads and 2 layers (its norm eps and rope theta)
MODELS = {
    "openllama-d100": jl.LlamaConfig(
        vocab_size=256, dim=400, n_layers=2, n_heads=4, n_kv_heads=4,
        hidden_dim=512, max_seq_len=512, norm_eps=1e-6, dtype="float32",
        attn_impl="flash"),
    "danube3-d120": jl.LlamaConfig(
        vocab_size=256, dim=480, n_layers=2, n_heads=4, n_kv_heads=1,
        hidden_dim=512, max_seq_len=512, norm_eps=1e-5, rope_theta=1e5,
        dtype="float32", attn_impl="flash"),
}
# the wrappers at each model's heads and at GQA 4/2: (head dim, Hq, Hkv)
HEADS = {"mha-4-4": (100, 4, 4), "gqa-4-2": (100, 4, 2),
         "d120-gqa-4-1": (120, 4, 1), "d120-gqa-4-2": (120, 4, 2)}


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


def _tcfg(jcfg):
    return tl.LlamaConfig(**dataclasses.asdict(jcfg))


@functools.cache
def _params(model: str):
    """(jax params, port params) of MODELS[model], seed 0."""
    jp = jl.init_params(jax.random.key(0), MODELS[model])
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, shape,
                                                dtype=np.int32)


def _deq(buf, scl):
    return np.asarray(buf, np.float32) * np.asarray(scl)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("heads", list(HEADS))
def test_flash_attention_with_lse_matches_jax(heads):
    """Causal self-attention at S = 256 (blocks of 128): out and lse."""
    D, Hq, Hkv = HEADS[heads]
    q, k, v = _normal(1, (2, 256, Hq, D), (2, 256, Hkv, D), (2, 256, Hkv, D))
    jout, jlse = jfa.flash_attention_with_lse(
        *(jnp.asarray(a) for a in (q, k, v)), block_q=128, block_k=128,
        interpret=True)
    out, lse = tfa.flash_attention_with_lse(
        *(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL_OP)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL_OP)


def _cache(seed, B, Hkv, ML, D, int8):
    """A head-major cache (numpy), quantised by the JAX package's own
    _quantize_kv for int8: (k, v, {k_scale, v_scale})."""
    kc, vc = _normal(seed, (B, Hkv, ML, D), (B, Hkv, ML, D))
    if not int8:
        return kc, vc, {}
    (k8, ks), (v8, vs) = (jd._quantize_kv(jnp.asarray(x)) for x in (kc, vc))
    return (np.array(k8), np.array(v8),
            {"k_scale": np.array(ks), "v_scale": np.array(vs)})


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("heads", list(HEADS))
def test_cached_and_decode_wrappers_match_jax(heads, int8):
    """flash_attention_cached (128 queries at start 100 against a cache of
    256, left pads 0 and 30, a window of 96 with 4 sinks) and
    flash_attention_decode (per-row starts 200 and 61, pads 3 and 40, S = 1
    and S = 5, the same window and sinks) on an f32 or an int8 cache."""
    D, Hq, Hkv = HEADS[heads]
    B, ML = 2, 256
    kc, vc, sc = _cache(2, B, Hkv, ML, D, int8)
    pads = np.array([0, 30], np.int32)
    kw = dict(window=96, sinks=4)
    jkw = dict(kw, pad_lens=jnp.asarray(pads),
               **{n: jnp.asarray(a) for n, a in sc.items()})
    tkw = dict(kw, pad_lens=torch.from_numpy(pads),
               **{n: torch.from_numpy(a) for n, a in sc.items()})
    jc = (jnp.asarray(kc), jnp.asarray(vc))
    tc = (torch.from_numpy(kc), torch.from_numpy(vc))
    (q,) = _normal(3, (B, 128, Hq, D))
    want = jfa.flash_attention_cached(jnp.asarray(q), *jc, 100, block_q=128,
                                      block_k=128, interpret=True, **jkw)
    got = tfa.flash_attention_cached(torch.from_numpy(q), *tc, 100, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_OP)
    starts = np.array([200, 61], np.int32)
    dkw = dict(jkw, pad_lens=jnp.asarray([3, 40], jnp.int32))
    tdkw = dict(tkw, pad_lens=torch.tensor([3, 40]))
    for S in (1, 5):
        (q,) = _normal(4 + S, (B, S, Hq, D))
        want = jfa.flash_attention_decode(jnp.asarray(q), *jc,
                                          jnp.asarray(starts),
                                          interpret=True, **dkw)
        got = tfa.flash_attention_decode(torch.from_numpy(q), *tc,
                                         torch.from_numpy(starts), **tdkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL_OP)


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("model", list(MODELS))
def test_cached_forward_at_head_dim_100_matches_jax(model, kv_dtype):
    """A 128-token prompt (the cached kernel at start 0) then two decode
    steps (the decode kernel): logits agree with JAX, and an int8 cache's
    contents within two quanta, dequantised."""
    jcfg = dataclasses.replace(MODELS[model], kv_cache_dtype=kv_dtype)
    tcfg = _tcfg(jcfg)
    jp, tp = _params(model)
    atol = ATOL_INT8 if kv_dtype == "int8" else ATOL
    tok = _tokens(1, (2, 128), jcfg.vocab_size)
    jc = jd.init_kv_cache(jcfg, 2, 256)
    tc = td.init_kv_cache(tcfg, 2, 256, device="cpu")
    for _ in range(3):
        jlog, jc = jd.cached_forward(jp, jnp.asarray(tok), jc, jcfg)
        tlog, tc = td.cached_forward(tp, torch.from_numpy(tok), tc, tcfg)
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
def test_generate_at_head_dim_100_matches_jax(model, case):
    """Greedy generate of a 128-token prompt (two rows; one left-padded by
    37 with pad_id) on an f32 or an int8 cache: the port's stream equals
    the JAX package's token for token."""
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


@pytest.mark.parametrize("model", list(MODELS))
def test_engine_at_head_dim_100_matches_jax_engine(model):
    """A ServeEngine pass (two slots, three requests, a 128 bucket:
    admission on the cached kernel, every step on the decode kernel at
    per-row starts): each stream equals the JAX engine's."""
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
