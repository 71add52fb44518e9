"""The port's MoE serving path against the JAX package's, on the CPU.

Twins of the 8 cases of tests/test_moe_serve.py, each also held against
the JAX function on the same inputs, plus prefill_chunked for the dense
family and the dropless block. f32, params carried across with
params_from_numpy. Logits 1e-4 absolute (the two sides sum in another
order), 1e-3 for logits read from an int8 cache (a key on a quantisation
boundary may land one step apart); greedy streams token-exact. The JAX
flash paths run in interpret mode, as its own tests run them. Sampled
streams cannot match across jax.random and torch generators: checked for
vocabulary and reproducibility.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_provisioner_tpu.models import decode as jd
from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu.models import moe as jm
from gpu_provisioner_tpu.models import moe_serve as jms
from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import moe as tm
from gpu_provisioner_tpu_torch.models import moe_serve as tms
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy

# f32 + generous capacity: no expert drops anywhere, so the cached path
# must be the full forward (tests/test_moe_serve.py's configuration)
JCFG = jm.MoEConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, hidden_dim=128, max_seq_len=256,
                    n_experts=4, experts_per_token=2, capacity_factor=8.0,
                    dtype="float32")
JPARAMS = jm.init_moe_model(jax.random.key(0), JCFG)
TPARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), device="cpu")
ATOL = 1e-4


def _tcfg(jcfg):
    return (tm.MoEConfig if isinstance(jcfg, jm.MoEConfig)
            else tl.LlamaConfig)(**dataclasses.asdict(jcfg))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, shape,
                                                dtype=np.int32)


def _caches(jcfg, B, max_len):
    return (jd.init_kv_cache(jcfg, B, max_len),
            td.init_kv_cache(_tcfg(jcfg), B, max_len, device="cpu"))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol)


def _generate(prompt, jcfg, **kw):
    """(JAX stream, port stream) as lists, greedy."""
    j = jd.generate(JPARAMS, jnp.asarray(prompt), jcfg, **kw)
    t = td.generate(TPARAMS, torch.from_numpy(prompt), _tcfg(jcfg),
                    device="cpu", **kw)
    return np.asarray(j).tolist(), t.tolist()


def test_moe_prefill_matches_full_forward():
    prompt = _tokens(1, (2, 16))
    full, _ = tm.moe_forward(TPARAMS, torch.from_numpy(prompt), _tcfg(JCFG))
    jc, tc = _caches(JCFG, 2, 64)
    jlog, _ = jms.moe_cached_forward(JPARAMS, jnp.asarray(prompt), jc, JCFG)
    tlog, tc = tms.moe_cached_forward(TPARAMS, torch.from_numpy(prompt), tc,
                                      _tcfg(JCFG))
    assert tc.length == 16
    torch.testing.assert_close(tlog, full, atol=ATOL, rtol=ATOL)
    _close(tlog, jlog)


def test_moe_incremental_decode_matches_teacher_forcing():
    """One token at a time through the cache: every position's logits equal
    the full forward's and the JAX cached forward's."""
    prompt = _tokens(2, (1, 12))
    full, _ = tm.moe_forward(TPARAMS, torch.from_numpy(prompt), _tcfg(JCFG))
    jc, tc = _caches(JCFG, 1, 32)
    jlog, jc = jms.moe_cached_forward(JPARAMS, jnp.asarray(prompt[:, :4]),
                                      jc, JCFG)
    tlog, tc = tms.moe_cached_forward(TPARAMS,
                                      torch.from_numpy(prompt[:, :4]), tc,
                                      _tcfg(JCFG))
    torch.testing.assert_close(tlog, full[:, :4], atol=ATOL, rtol=ATOL)
    _close(tlog, jlog)
    for i in range(4, 12):
        piece = prompt[:, i:i + 1]
        jlog, jc = jms.moe_cached_forward(JPARAMS, jnp.asarray(piece), jc,
                                          JCFG)
        tlog, tc = tms.moe_cached_forward(TPARAMS, torch.from_numpy(piece),
                                          tc, _tcfg(JCFG))
        torch.testing.assert_close(tlog[:, 0], full[:, i], atol=ATOL,
                                   rtol=ATOL)
        _close(tlog, jlog)


def test_moe_generate_greedy_and_flash_parity():
    prompt = _tokens(3, (2, 16))
    jd_, td_ = _generate(prompt, JCFG, max_new_tokens=8, max_len=128)
    cfg_f = dataclasses.replace(JCFG, attn_impl="flash")
    jf, tf = _generate(prompt, cfg_f, max_new_tokens=8, max_len=128)
    assert np.asarray(td_).shape == (2, 8)
    assert all(0 <= t < JCFG.vocab_size for row in td_ for t in row)
    assert td_ == tf == jd_ == jf


# the bench_moe_decode model's head dim (its 16/8 heads of 64) at a narrow
# width: dim 256, 4/2 heads of 64, 2 layers
JCFG64 = dataclasses.replace(JCFG, dim=256, hidden_dim=256, max_seq_len=512)


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_moe_generate_at_head_dim_64_matches_jax(kv_dtype):
    """Greedy generate of an MoE model at head dim 64 (flash, a 128-token
    prompt, so the prefill takes the cached kernel and every step the
    decode kernel; one row left-padded) on an f32 or an int8
    cache: the port's stream equals the JAX package's and the port's dense
    stream, token for token."""
    jcfg = dataclasses.replace(JCFG64, attn_impl="flash",
                               kv_cache_dtype=kv_dtype)
    jp = jm.init_moe_model(jax.random.key(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompt = np.random.default_rng(5).integers(1, JCFG.vocab_size, (2, 128),
                                               dtype=np.int32)
    prompt[1, :28] = 0
    kw = dict(max_new_tokens=6, max_len=256, pad_id=0)
    j = jd.generate(jp, jnp.asarray(prompt), jcfg, **kw)
    t = td.generate(tp, torch.from_numpy(prompt), _tcfg(jcfg), device="cpu",
                    **kw)
    dense = td.generate(tp, torch.from_numpy(prompt),
                        _tcfg(dataclasses.replace(jcfg, attn_impl="dense")),
                        device="cpu", **kw)
    assert t.tolist() == np.asarray(j).tolist() == dense.tolist()


def test_moe_generate_sampling_reproducible():
    prompt = torch.from_numpy(_tokens(4, (2, 16)))
    cfg = _tcfg(JCFG)
    kw = dict(max_new_tokens=8, max_len=128, temperature=0.9, top_k=20,
              top_p=0.95, device="cpu")
    a = td.generate(TPARAMS, prompt, cfg,
                    generator=torch.Generator().manual_seed(3), **kw)
    b = td.generate(TPARAMS, prompt, cfg,
                    generator=torch.Generator().manual_seed(3), **kw)
    assert torch.equal(a, b)
    assert bool(((a >= 0) & (a < cfg.vocab_size)).all())


def test_moe_padded_row_matches_solo_generation():
    """A left-padded ragged batch: pads claim no expert capacity and shift
    neither RoPE nor attention — a padded row generates what it does
    alone, and what the JAX package generates for the batch."""
    PAD = 7
    p0, p1 = _tokens(9, (1, 20)), _tokens(10, (1, 12))
    batch = np.concatenate(
        [p0, np.concatenate([np.full((1, 8), PAD, np.int32), p1], 1)], 0)
    jgot, got = _generate(batch, JCFG, max_new_tokens=6, max_len=64,
                          pad_id=PAD)
    _, solo0 = _generate(p0, JCFG, max_new_tokens=6, max_len=64)
    _, solo1 = _generate(p1, JCFG, max_new_tokens=6, max_len=64)
    assert got == jgot
    assert got[0] == solo0[0] and got[1] == solo1[0]


def test_moe_int8_cache_serves():
    """int8 is lossy: strong top-1 agreement with the plain cache's
    stream, and the cached forward's logits within the int8 tolerance of
    JAX's."""
    prompt = _tokens(11, (2, 16))
    cfg_q = dataclasses.replace(JCFG, kv_cache_dtype="int8")
    _, toks_q = _generate(prompt, cfg_q, max_new_tokens=8, max_len=128)
    _, toks_d = _generate(prompt, JCFG, max_new_tokens=8, max_len=128)
    assert np.asarray(toks_q).shape == (2, 8)
    assert float((np.asarray(toks_q) == np.asarray(toks_d)).mean()) > 0.7
    jc, tc = _caches(cfg_q, 2, 64)
    for piece in (prompt, prompt[:, :1]):
        jlog, jc = jms.moe_cached_forward(JPARAMS, jnp.asarray(piece), jc,
                                          cfg_q)
        tlog, tc = tms.moe_cached_forward(TPARAMS, torch.from_numpy(piece),
                                          tc, _tcfg(cfg_q))
        _close(tlog, jlog, atol=1e-3)


def test_moe_prefill_then_continue_multiturn():
    """Prefill, decode, prefill again on the same cache: the second turn's
    last logits equal one full forward over the whole stream, and JAX's."""
    prompt, turn2 = _tokens(12, (1, 8)), _tokens(13, (1, 8))
    cfg = _tcfg(JCFG)
    jc, tc = _caches(JCFG, 1, 64)
    jl1, jc = jms.moe_prefill(JPARAMS, jnp.asarray(prompt), jc, JCFG)
    tl1, tc = tms.moe_prefill(TPARAMS, torch.from_numpy(prompt), tc, cfg)
    assert tuple(tl1.shape) == (1, cfg.vocab_size)
    nxt = np.array(jnp.argmax(jl1, axis=-1), np.int32)[:, None]
    jlog, jc = jms.moe_cached_forward(JPARAMS, jnp.asarray(nxt), jc, JCFG)
    tlog, tc = tms.moe_cached_forward(TPARAMS, torch.from_numpy(nxt), tc,
                                      cfg)
    _close(tlog, jlog)
    jl2, jc = jms.moe_prefill(JPARAMS, jnp.asarray(turn2), jc, JCFG)
    tl2, tc = tms.moe_prefill(TPARAMS, torch.from_numpy(turn2), tc, cfg)
    assert tc.length == int(jc.length) == 8 + 1 + 8
    stream = torch.from_numpy(np.concatenate([prompt, nxt, turn2], axis=1))
    full, _ = tm.moe_forward(TPARAMS, stream, cfg)
    torch.testing.assert_close(tl2, full[:, -1], atol=ATOL, rtol=ATOL)
    _close(tl2, jl2)


def test_moe_chunked_prefill_matches_single_shot():
    """Chunked MoE prefill == single shot at drop-free capacity, and ==
    the JAX package's chunked prefill."""
    prompt = _tokens(14, (1, 16))
    cfg = _tcfg(JCFG)
    single, _ = tms.moe_prefill(TPARAMS, torch.from_numpy(prompt),
                                td.init_kv_cache(cfg, 1, 64, device="cpu"),
                                cfg)
    jc, tc = _caches(JCFG, 1, 64)
    jch, jc = jd.prefill_chunked(JPARAMS, jnp.asarray(prompt), jc, JCFG,
                                 chunk=5)
    tch, tc = td.prefill_chunked(TPARAMS, torch.from_numpy(prompt), tc, cfg,
                                 chunk=5)
    assert tc.length == int(jc.length) == 16
    torch.testing.assert_close(tch, single, atol=ATOL, rtol=ATOL)
    _close(tch, jch)


@pytest.mark.parametrize("chunk", [5, 16, 64])
@pytest.mark.parametrize("padded", [False, True])
def test_dense_prefill_chunked_matches_jax(chunk, padded):
    """prefill_chunked for the dense family: last logits and the cache
    equal the JAX package's (and a single-shot cached forward's)."""
    jcfg = dataclasses.replace(jl.PRESETS["tiny"], dtype="float32")
    jparams = jl.init_params(jax.random.key(1), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    prompt = _tokens(15, (2, 37))
    pads = None
    if padded:
        prompt[1, :9] = 0
        pads = np.asarray([0, 9], np.int32)
    jpads = None if pads is None else jnp.asarray(pads)
    tpads = None if pads is None else torch.from_numpy(pads)
    jc, tc = _caches(jcfg, 2, 64)
    jlog, jc = jd.prefill_chunked(jparams, jnp.asarray(prompt), jc, jcfg,
                                  chunk=chunk, pad_lens=jpads)
    tlog, tc = td.prefill_chunked(tparams, torch.from_numpy(prompt), tc,
                                  _tcfg(jcfg), chunk=chunk, pad_lens=tpads)
    _close(tlog, jlog)
    assert tc.length == int(jc.length) == 37
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    single, _ = td.cached_forward(
        tparams, torch.from_numpy(prompt),
        td.init_kv_cache(_tcfg(jcfg), 2, 64, device="cpu"), _tcfg(jcfg),
        pad_lens=tpads)
    torch.testing.assert_close(tlog, single[:, -1], atol=ATOL, rtol=ATOL)


def test_prefill_chunked_refuses_an_empty_prompt_or_chunk():
    cfg = _tcfg(JCFG)
    cache = td.init_kv_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="positive chunk"):
        td.prefill_chunked(TPARAMS, torch.zeros(1, 4, dtype=torch.int32),
                           cache, cfg, chunk=0)
    with pytest.raises(ValueError, match="non-empty prompt"):
        td.prefill_chunked(TPARAMS, torch.zeros(1, 0, dtype=torch.int32),
                           cache, cfg)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.5])
def test_dropless_block_equals_single_steps(capacity_factor):
    """A 4-token dropless block (speculative verify's shape) gives the
    logits of four single-token steps, at a capacity where a plain 4-token
    block would drop too; and the JAX package's dropless block."""
    jcfg = dataclasses.replace(JCFG, capacity_factor=capacity_factor)
    cfg = _tcfg(jcfg)
    prompt, block = _tokens(16, (2, 10)), _tokens(17, (2, 4))
    jc, tc = _caches(jcfg, 2, 32)
    _, jc = jms.moe_cached_forward(JPARAMS, jnp.asarray(prompt), jc, jcfg)
    _, tc = tms.moe_cached_forward(TPARAMS, torch.from_numpy(prompt), tc,
                                   cfg)
    steps_cache = td.KVCache(*(t.clone() if isinstance(t, torch.Tensor)
                               else t for t in tc))
    step = td.family_fns(cfg, dropless_step=True)[1]
    tblk, _ = step(TPARAMS, torch.from_numpy(block), tc)
    jblk, _ = jd.family_fns(jcfg, dropless_step=True)[1](
        JPARAMS, jnp.asarray(block), jc)
    _close(tblk, jblk)
    for i in range(4):
        one, steps_cache = tms.moe_cached_forward(
            TPARAMS, torch.from_numpy(block[:, i:i + 1]), steps_cache, cfg)
        torch.testing.assert_close(tblk[:, i], one[:, 0], atol=ATOL,
                                   rtol=ATOL)


def test_family_fns_dispatches_both_families_and_refuses_others():
    @dataclasses.dataclass(frozen=True)
    class Other(tl.LlamaConfig):
        pass

    assert td.family_step(_tcfg(JCFG)) is tms.moe_cached_forward
    assert td.family_step(tl.PRESETS["tiny"]) is td.cached_forward
    with pytest.raises(NotImplementedError, match="Other"):
        td.family_fns(Other())
