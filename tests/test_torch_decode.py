"""The port's KV-cache decode path against the JAX package's, on the CPU.

f32 throughout. Logits and cache contents: 1e-4 absolute (the two sides sum
in another order), 1e-3 for logits read from an int8 cache (a key on a
rounding boundary may quantise one step apart); greedy streams:
token-exact; logprobs: 1e-4 absolute; filter_logits: exact. Sampled streams cannot match across jax.random and
torch generators, so those are checked for vocabulary, reproducibility and
top-k 1 = greedy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_provisioner_tpu.models import decode as jd
from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy

JCFG = dataclasses.replace(jl.PRESETS["tiny"], dtype="float32",
                           max_seq_len=512)
JPARAMS = jl.init_params(jax.random.key(0), JCFG)
TPARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), device="cpu")
ATOL = 1e-4


def _tcfg(jcfg):
    return tl.LlamaConfig(**dataclasses.asdict(jcfg))


def _tokens(seed, shape, lo=1):
    return np.random.default_rng(seed).integers(lo, JCFG.vocab_size, shape,
                                                dtype=np.int32)


def _deq(buf, scl):
    x = np.asarray(buf, np.float32)
    return x * np.asarray(scl) if scl is not None else x


def _tdeq(buf, scl):
    x = buf.float()
    return (x * scl if scl is not None else x).numpy()


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_cached_forward_multiturn_matches_jax(kv_dtype, impl):
    """Prefill a 128-token turn (the cached kernel under flash), decode two
    tokens (the decode kernel), prefill a second turn at start 130: logits,
    cache contents and length agree with JAX."""
    jcfg = dataclasses.replace(JCFG, kv_cache_dtype=kv_dtype, attn_impl=impl)
    tcfg = _tcfg(jcfg)
    atol = 1e-3 if kv_dtype == "int8" else ATOL
    t1, t2 = _tokens(1, (2, 128)), _tokens(2, (2, 128))
    jc = jd.init_kv_cache(jcfg, 2, 384)
    tc = td.init_kv_cache(tcfg, 2, 384, device="cpu")
    jl1, jc = jd.cached_forward(JPARAMS, jnp.asarray(t1), jc, jcfg)
    tl1, tc = td.cached_forward(TPARAMS, torch.from_numpy(t1), tc, tcfg)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), atol=atol)
    tok = np.array(jnp.argmax(jl1[:, -1:], axis=-1), np.int32)
    for _ in range(2):
        jlog, jc = jd.cached_forward(JPARAMS, jnp.asarray(tok), jc, jcfg)
        tlog, tc = td.cached_forward(TPARAMS, torch.from_numpy(tok), tc,
                                     tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=atol)
        tok = np.array(jnp.argmax(jlog, axis=-1), np.int32)
    jl2, jc = jd.cached_forward(JPARAMS, jnp.asarray(t2), jc, jcfg)
    tl2, tc = td.cached_forward(TPARAMS, torch.from_numpy(t2), tc, tcfg)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=atol)
    assert tc.length == int(jc.length) == 258
    # int8: a value on a rounding boundary may land one quantum apart, so
    # caches compare dequantised, the values attention reads
    qtol = 2 * float(np.max(np.asarray(jc.k_scale))) if jc.k_scale is not \
        None else ATOL
    np.testing.assert_allclose(_tdeq(tc.k, tc.k_scale),
                               _deq(jc.k, jc.k_scale), atol=qtol)
    np.testing.assert_allclose(_tdeq(tc.v, tc.v_scale),
                               _deq(jc.v, jc.v_scale), atol=qtol)


def test_cached_forward_per_row_lengths_and_pads_match_jax():
    """The engine's step shape: a [B] length vector, left pads, S = 1 — the
    decode kernel with per-row starts under flash."""
    jcfg = dataclasses.replace(JCFG, attn_impl="flash")
    tcfg = _tcfg(jcfg)
    prompt = _tokens(3, (2, 12))
    prompt[1, :5] = 0
    pads = np.asarray([0, 5], np.int32)
    jc = jd.init_kv_cache(jcfg, 2, 256)
    tc = td.init_kv_cache(tcfg, 2, 256, device="cpu")
    _, jc = jd.cached_forward(JPARAMS, jnp.asarray(prompt), jc, jcfg,
                              pad_lens=jnp.asarray(pads))
    _, tc = td.cached_forward(TPARAMS, torch.from_numpy(prompt), tc, tcfg,
                              pad_lens=torch.from_numpy(pads))
    lengths = np.asarray([12, 9], np.int32)
    jc = jc._replace(length=jnp.asarray(lengths))
    tc = tc._replace(length=torch.from_numpy(lengths))
    tok = _tokens(4, (2, 1))
    jlog, jc = jd.cached_forward(JPARAMS, jnp.asarray(tok), jc, jcfg,
                                 pad_lens=jnp.asarray(pads))
    tlog, tc = td.cached_forward(TPARAMS, torch.from_numpy(tok), tc, tcfg,
                                 pad_lens=torch.from_numpy(pads))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)


GENERATE_CASES = {
    "dense": dict(),
    "flash-fresh": dict(attn_impl="flash"),
    "flash-pad": dict(attn_impl="flash", pad_id=0),
    "flash-eos": dict(attn_impl="flash", eos_id=-1),
    "flash-int8": dict(attn_impl="flash", kv_cache_dtype="int8"),
    "flash-window-sinks": dict(attn_impl="flash", sliding_window=40,
                               attn_sinks=4),
    "flash-window-sinks-pad": dict(attn_impl="flash", sliding_window=40,
                                   attn_sinks=4, pad_id=0),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generate_greedy_is_token_exact_vs_jax(case):
    kw = dict(GENERATE_CASES[case])
    pad_id, eos_id = kw.pop("pad_id", None), kw.pop("eos_id", None)
    jcfg = dataclasses.replace(JCFG, **kw)
    prompt = _tokens(5, (2, 128))
    if pad_id is not None:
        prompt[0, :30] = pad_id                  # a ragged, left-padded row
    gen = dict(max_new_tokens=8, max_len=256, pad_id=pad_id)
    if eos_id is not None:
        # an eos that the free-running stream emits early
        free = jd.generate(JPARAMS, jnp.asarray(prompt), jcfg, **gen)
        eos_id = int(np.asarray(free)[0, 2])
    want = jd.generate(JPARAMS, jnp.asarray(prompt), jcfg, eos_id=eos_id,
                       **gen)
    got = td.generate(TPARAMS, torch.from_numpy(prompt), _tcfg(jcfg),
                      eos_id=eos_id, device="cpu", **gen)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if eos_id is not None:
        assert (got[0, 3:] == eos_id).all()


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(0.0, None, None), (0.8, 20, 0.9)])
def test_generate_logprobs_match_jax(temperature, top_k, top_p):
    """Greedy: the streams and their logprobs agree. Sampled (which cannot
    draw the same tokens): the log-probability of each port-drawn token
    under JAX's filtered distribution, scored by teacher forcing."""
    prompt = _tokens(6, (2, 20))
    g = torch.Generator().manual_seed(0)
    toks, lps = td.generate(TPARAMS, torch.from_numpy(prompt), _tcfg(JCFG),
                            max_new_tokens=6, temperature=temperature,
                            top_k=top_k, top_p=top_p, generator=g,
                            return_logprobs=True, device="cpu")
    if temperature == 0.0:
        wt, wl = jd.generate(JPARAMS, jnp.asarray(prompt), JCFG,
                             max_new_tokens=6, return_logprobs=True)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(wt))
        np.testing.assert_allclose(lps.numpy(), np.asarray(wl), atol=ATOL)
        return
    seq = np.concatenate([prompt, toks.numpy()], axis=1)
    logits = jl.forward(JPARAMS, jnp.asarray(seq[:, :-1]), JCFG)[:, 19:]
    dist = jd.filter_logits(logits, temperature, top_k, top_p)
    want = jnp.take_along_axis(jax.nn.log_softmax(dist, axis=-1),
                               jnp.asarray(toks.numpy())[..., None],
                               axis=-1)[..., 0]
    np.testing.assert_allclose(lps.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(0.7, 5, None), (1.3, None, 0.8), (0.5, 3, 0.5),
                          (1.0, 1, None), (0.9, None, 1.0)])
def test_filter_logits_is_exact(temperature, top_k, top_p):
    logits = np.random.default_rng(7).standard_normal((4, 64)).astype(
        np.float32) * 3
    want = jd.filter_logits(jnp.asarray(logits), temperature, top_k, top_p)
    got = td.filter_logits(torch.from_numpy(logits), temperature, top_k,
                           top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_in_vocab_reproducible_and_topk1_greedy():
    prompt = torch.from_numpy(_tokens(8, (2, 10)))
    cfg = _tcfg(JCFG)

    def run(seed, **kw):
        return td.generate(TPARAMS, prompt, cfg, max_new_tokens=10,
                           generator=torch.Generator().manual_seed(seed),
                           device="cpu", **kw)

    a = run(1, temperature=1.0)
    assert torch.equal(a, run(1, temperature=1.0))
    assert not torch.equal(a, run(2, temperature=1.0))
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    greedy = td.generate(TPARAMS, prompt, cfg, max_new_tokens=10,
                         device="cpu")
    assert torch.equal(run(3, temperature=0.7, top_k=1), greedy)


def test_sampling_and_prefill_validation():
    cfg = _tcfg(JCFG)
    prompt = torch.from_numpy(_tokens(9, (1, 4)))
    with pytest.raises(ValueError, match="Generator"):
        td.generate(TPARAMS, prompt, cfg, max_new_tokens=2, temperature=1.0,
                    device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        td.validate_sampling_args(0.0, 0, None, None)
    with pytest.raises(ValueError, match="top_p"):
        td.validate_sampling_args(0.0, None, 1.5, None)
    with pytest.raises(ValueError, match="max_len"):
        td.generate(TPARAMS, prompt, cfg, max_new_tokens=8, max_len=8,
                    device="cpu")
    cache = td.init_kv_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="fresh"):
        td.prefill(TPARAMS, prompt, cache, cfg, fresh=True,
                   pad_lens=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        td.init_kv_cache(dataclasses.replace(cfg, kv_cache_dtype="fp8"), 1,
                         16, device="cpu")
    with pytest.raises(ValueError, match="int8 scales"):
        td.cached_forward(TPARAMS, prompt, cache,
                          dataclasses.replace(cfg, kv_cache_dtype="int8"))


def test_fresh_prefill_matches_general_prefill():
    cfg = _tcfg(JCFG)
    prompt = torch.from_numpy(_tokens(10, (2, 12)))
    a, ca = td.prefill(TPARAMS, prompt, td.init_kv_cache(cfg, 2, 32, "cpu"),
                       cfg, fresh=True)
    b, cb = td.prefill(TPARAMS, prompt, td.init_kv_cache(cfg, 2, 32, "cpu"),
                       cfg)
    torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    torch.testing.assert_close(ca.k, cb.k, atol=ATOL, rtol=0)
    assert ca.length == cb.length == 12
