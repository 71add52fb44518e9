"""The port's speculative decoding against the JAX package's, on the CPU.

Twins of the 18 tests of tests/test_speculative.py, with the same configs
(f32) and parameters carried across through numpy. Every greedy stream is
token-equal to the JAX ``speculative_generate`` on the same inputs AND to
the port's plain ``generate``, with the same ``target_calls`` as JAX;
logprobs agree with both at 1e-5 absolute. Sampled streams cannot match
across jax.random and torch generators (ROADMAP Queue C, "Sampled
streams"), so those cases check vocabulary, reproducibility from the
generator, and the rejection step's law (tests/test_speculative.py:176's
V=7, K=3, N=20000 at atol 0.015).
"""

import ast
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_provisioner_tpu.models import decode as jd
from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu.models import moe as jm
from gpu_provisioner_tpu.models import speculative as js
from gpu_provisioner_tpu_torch import bench as tbench
from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import moe as tm
from gpu_provisioner_tpu_torch.models import speculative as ts
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy

CFG_T = jl.LlamaConfig(vocab_size=128, dim=64, n_layers=4, n_heads=4,
                       n_kv_heads=2, hidden_dim=128, max_seq_len=512,
                       dtype="float32")
CFG_D = jl.LlamaConfig(vocab_size=128, dim=32, n_layers=2, n_heads=2,
                       n_kv_heads=1, hidden_dim=64, max_seq_len=512,
                       dtype="float32")
MIXTRAL_CAP = jm.MoEConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, hidden_dim=128, max_seq_len=512,
                           n_experts=8, experts_per_token=2,
                           capacity_factor=1.25, dtype="float32")
LP_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models hold a few thousand parameters: no torch op on them is
    worth splitting, and the idle OpenMP threads of a split would only
    spin. One thread keeps the module's CPU time to its own work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(jcfg):
    return (tm.MoEConfig if isinstance(jcfg, jm.MoEConfig)
            else tl.LlamaConfig)(**dataclasses.asdict(jcfg))


def _carry(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


@functools.cache
def _models(seed=0):
    """(jax target, jax draft, port target, port draft) of CFG_T/CFG_D."""
    jt = jl.init_params(jax.random.key(seed), CFG_T)
    jdr = jl.init_params(jax.random.key(seed + 1), CFG_D)
    return jt, jdr, _carry(jt), _carry(jdr)


@functools.cache
def _moe(seed, jcfg):
    jp = jm.init_moe_model(jax.random.key(seed), jcfg)
    return jp, _carry(jp)


def _prompt(seed, shape, lo=0):
    return np.random.default_rng(seed).integers(lo, 128, shape,
                                                dtype=np.int32)


def _jax_spec(jparams, jdraft, prompt, jcfg, jdcfg, **kw):
    """The JAX speculative_generate, jitted whole: one compile a call, about
    half the CPU time of the eager call's many. No two calls of this module
    share their static arguments (configs, lengths, spec_k, options), so
    there is no compile to reuse; LLVM's optimisation level 0 takes a third
    less CPU to compile the same program, which runs once."""
    args = (jparams, jdraft, jnp.asarray(prompt))
    return jax.jit(lambda p, d, t: js.speculative_generate(
        p, d, t, jcfg, jdcfg, **kw)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _spec_both(jparams, jdraft, tparams, tdraft, prompt, jcfg, jdcfg,
               **kw):
    """The same call on both sides → (jax out, port out); each out is
    (tokens, stats) or (tokens, logprobs, stats)."""
    jout = _jax_spec(jparams, jdraft, prompt, jcfg, jdcfg, **kw)
    tout = ts.speculative_generate(tparams, tdraft, torch.from_numpy(prompt),
                                   _tcfg(jcfg), _tcfg(jdcfg), device="cpu",
                                   **kw)
    return jout, tout


def _plain(tparams, prompt, jcfg, new, **kw):
    return td.generate(tparams, torch.from_numpy(prompt), _tcfg(jcfg),
                       max_new_tokens=new, max_len=256, device="cpu", **kw)


def _assert_greedy(jout, tout, want):
    """Port tokens == JAX tokens == plain generate; equal target_calls and
    per-row token counts."""
    (jt, jst), (tt, tst) = (jout[0], jout[-1]), (tout[0], tout[-1])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tt.numpy(), want.numpy())
    assert tst["target_calls"] == int(jst["target_calls"])
    np.testing.assert_array_equal(tst["tokens"].numpy(),
                                  np.asarray(jst["tokens"]))


def test_speculative_equals_plain_greedy():
    """An unrelated draft (most proposals rejected): still exact."""
    jt, jdr, tt, tdr = _models()
    prompt = _prompt(5, (1, 24))
    jout, tout = _spec_both(jt, jdr, tt, tdr, prompt, CFG_T, CFG_D,
                            max_new_tokens=24, spec_k=4)
    _assert_greedy(jout, tout, _plain(tt, prompt, CFG_T, 24))
    assert tout[1]["target_calls"] <= 24


def test_speculative_self_draft_max_acceptance():
    """Draft == target: every proposal accepted, spec_k+1 tokens a round."""
    jt, _, tt, _ = _models()
    prompt = _prompt(6, (1, 16))
    jout, tout = _spec_both(jt, jt, tt, tt, prompt, CFG_T, CFG_T,
                            max_new_tokens=20, spec_k=4)
    _assert_greedy(jout, tout, _plain(tt, prompt, CFG_T, 20))
    assert tout[1]["target_calls"] <= 5


def test_speculative_under_inference_mode_twice():
    """The twin of the reference's jit case: under torch.inference_mode()
    the stream is the same twice over, and equal to JAX's."""
    jt, jdr, tt, tdr = _models(seed=2)
    prompt = _prompt(7, (1, 16))
    jout = _jax_spec(jt, jdr, prompt, CFG_T, CFG_D, max_new_tokens=12,
                     spec_k=3)
    with torch.inference_mode():
        runs = [ts.speculative_generate(
            tt, tdr, torch.from_numpy(prompt), _tcfg(CFG_T), _tcfg(CFG_D),
            max_new_tokens=12, spec_k=3, device="cpu") for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    _assert_greedy(jout, runs[0], _plain(tt, prompt, CFG_T, 12))


def test_speculative_validation():
    _, _, tt, tdr = _models()
    zeros = torch.zeros((1, 8), dtype=torch.int32)
    tcfg, tdcfg = _tcfg(CFG_T), _tcfg(CFG_D)
    bad_vocab = dataclasses.replace(tdcfg, vocab_size=64)
    with pytest.raises(ValueError, match="vocabulary"):
        ts.speculative_generate(tt, tdr, zeros, tcfg, bad_vocab,
                                max_new_tokens=4, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        ts.speculative_generate(tt, tdr, zeros, tcfg, tdcfg,
                                max_new_tokens=16, max_len=20, device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ts.speculative_generate(tt, tdr, zeros, tcfg, tdcfg,
                                max_new_tokens=4, spec_k=0, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        ts.speculative_generate(tt, tdr, zeros, tcfg, tdcfg,
                                max_new_tokens=4, temperature=0.5, top_k=0,
                                generator=torch.Generator(), device="cpu")


def test_speculative_batched_equals_plain_greedy():
    """Per-row acceptance lengths and cache lengths: row for row plain
    greedy; self-draft still accepts everything per row."""
    jt, jdr, tt, tdr = _models(seed=6)
    prompt = _prompt(20, (4, 16))
    want = _plain(tt, prompt, CFG_T, 24)
    jout, tout = _spec_both(jt, jdr, tt, tdr, prompt, CFG_T, CFG_D,
                            max_new_tokens=24, spec_k=3)
    assert tuple(tout[0].shape) == (4, 24)
    _assert_greedy(jout, tout, want)
    jout2, tout2 = _spec_both(jt, jt, tt, tt, prompt, CFG_T, CFG_T,
                              max_new_tokens=24, spec_k=3)
    _assert_greedy(jout2, tout2, want)
    assert tout2[1]["target_calls"] <= 7       # ceil((24-1)/4) + 1


def test_speculative_batched_ragged_pad_id():
    """Left-padded ragged rows: plain generate's pad_id stream per row."""
    jt, jdr, tt, tdr = _models(seed=7)
    prompt = _prompt(21, (3, 20), lo=1)
    pads = np.asarray([0, 5, 11])
    prompt = np.where(np.arange(20)[None] < pads[:, None], 0,
                      prompt).astype(np.int32)
    jout, tout = _spec_both(jt, jdr, tt, tdr, prompt, CFG_T, CFG_D,
                            max_new_tokens=16, pad_id=0, spec_k=3)
    _assert_greedy(jout, tout, _plain(tt, prompt, CFG_T, 16, pad_id=0))


def test_speculative_batched_moe_target():
    """Batched speculation with the dropless MoE verify at Mixtral-style
    capacity: per-row lengths through moe_cached_forward."""
    jmp, tmp = _moe(22, MIXTRAL_CAP)
    _, jdr, _, tdr = _models()
    prompt = _prompt(23, (3, 16))
    jout, tout = _spec_both(jmp, jdr, tmp, tdr, prompt, MIXTRAL_CAP, CFG_D,
                            max_new_tokens=12, spec_k=2)
    _assert_greedy(jout, tout, _plain(tmp, prompt, MIXTRAL_CAP, 12))


def test_speculative_batched_int8_target():
    """An int8-cache target: the verify writes land values and scales at
    per-row offsets; stream equals plain int8 decode row for row."""
    cfg8 = dataclasses.replace(CFG_T, kv_cache_dtype="int8")
    jt, jdr, tt, tdr = _models(seed=10)
    prompt = _prompt(30, (3, 16))
    jout, tout = _spec_both(jt, jdr, tt, tdr, prompt, cfg8, CFG_D,
                            max_new_tokens=12, spec_k=3)
    _assert_greedy(jout, tout, _plain(tt, prompt, cfg8, 12))


def _sampled(tt, tdr, prompt, seed, **kw):
    return ts.speculative_generate(
        tt, tdr, torch.from_numpy(prompt), _tcfg(CFG_T), _tcfg(CFG_D),
        device="cpu", generator=torch.Generator().manual_seed(seed), **kw)


def test_speculative_batched_sampled_in_vocab_reproducible():
    """Sampled batched speculation: the same generator seed gives the same
    tokens, all in vocabulary, every row its full count."""
    _, _, tt, tdr = _models(seed=8)
    prompt = _prompt(24, (3, 12))
    kw = dict(max_new_tokens=12, spec_k=3, temperature=0.9, top_k=40)
    a, sa = _sampled(tt, tdr, prompt, 25, **kw)
    b, sb = _sampled(tt, tdr, prompt, 25, **kw)
    assert torch.equal(a, b) and sa["target_calls"] == sb["target_calls"]
    assert bool(((a >= 0) & (a < 128)).all())
    assert tuple(sa["tokens"].shape) == (3,)
    assert bool((sa["tokens"] == 12).all())


def test_speculative_batched_eos_per_row():
    """eos finishes per row: a finished row's tail reads eos_id while the
    others go on, as generate() does."""
    jt, jdr, tt, tdr = _models(seed=9)
    prompt = _prompt(26, (4, 12))
    eos = int(_plain(tt, prompt, CFG_T, 16)[0, 3])
    jout, tout = _spec_both(jt, jdr, tt, tdr, prompt, CFG_T, CFG_D,
                            max_new_tokens=16, spec_k=3, eos_id=eos)
    _assert_greedy(jout, tout, _plain(tt, prompt, CFG_T, 16, eos_id=eos))
    assert tuple(tout[1]["tokens"].shape) == (4,)


def test_spec_accept_preserves_target_distribution():
    """The correctness theorem, measured: with proposals drawn from the
    draft distributions, the first emitted token's empirical law is the
    TARGET distribution, however different the draft is."""
    V, K, N = 7, 3, 20000
    g = torch.Generator().manual_seed(42)
    p_d = torch.softmax(torch.randn(K, V, generator=g) * 1.5, dim=-1)
    p_t = torch.softmax(torch.randn(K + 1, V, generator=g) * 1.5, dim=-1)
    # independent draft distributions stand in for the prefix-conditioned
    # ones (the acceptance math does not care)
    proposal = torch.stack([torch.multinomial(p_d[i], N, replacement=True,
                                              generator=g)
                            for i in range(K)], dim=1).to(torch.int32)
    m, bonus = ts._spec_accept(g, proposal, p_d.expand(N, K, V),
                               p_t.expand(N, K + 1, V))
    first = torch.where(m > 0, proposal[:, 0], bonus)
    emp = np.bincount(first.numpy(), minlength=V) / N
    np.testing.assert_allclose(emp, p_t[0].numpy(), atol=0.015)
    # the rows' acceptance counts lie in 0..K and the bonus in vocabulary
    assert int(m.min()) >= 0 and int(m.max()) <= K
    assert int(bonus.min()) >= 0 and int(bonus.max()) < V


def test_speculative_sampled_reproducible_in_vocab():
    _, _, tt, tdr = _models(seed=3)
    prompt = _prompt(8, (1, 16))
    kw = dict(max_new_tokens=16, spec_k=3, temperature=0.9, top_k=40,
              top_p=0.95)
    a, sa = _sampled(tt, tdr, prompt, 11, **kw)
    b, _ = _sampled(tt, tdr, prompt, 11, **kw)
    assert torch.equal(a, b)
    assert bool(((a >= 0) & (a < 128)).all())
    assert sa["target_calls"] <= 16
    with pytest.raises(ValueError, match="Generator"):
        ts.speculative_generate(tt, tdr, torch.from_numpy(prompt),
                                _tcfg(CFG_T), _tcfg(CFG_D), max_new_tokens=4,
                                temperature=0.9, device="cpu")


def test_speculative_moe_target_dense_draft():
    """A dense draft for an MoE target: the MoE model's own greedy stream;
    self-draft MoE accepts everything."""
    moe_cfg = jm.MoEConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, hidden_dim=128, max_seq_len=512,
                           n_experts=4, experts_per_token=2,
                           capacity_factor=8.0, dtype="float32")
    jmp, tmp = _moe(9, moe_cfg)
    _, jdr, _, tdr = _models()
    prompt = _prompt(10, (1, 16))
    want = _plain(tmp, prompt, moe_cfg, 12)
    jout, tout = _spec_both(jmp, jdr, tmp, tdr, prompt, moe_cfg, CFG_D,
                            max_new_tokens=12, spec_k=3)
    _assert_greedy(jout, tout, want)
    jout2, tout2 = _spec_both(jmp, jmp, tmp, tmp, prompt, moe_cfg, moe_cfg,
                              max_new_tokens=12, spec_k=3)
    _assert_greedy(jout2, tout2, want)
    assert tout2[1]["target_calls"] <= 4


def test_speculative_moe_target_mixtral_capacity_exact():
    """Mixtral-shaped capacity (cf 1.25, k 2, E 8): the training capacity
    of a 3-token verify block drops, the verify's dropless override does
    not, so greedy equality holds anyway."""
    assert tm.capacity(_tcfg(MIXTRAL_CAP), 3) < 3
    jmp, tmp = _moe(13, MIXTRAL_CAP)
    _, jdr, _, tdr = _models()
    prompt = _prompt(14, (1, 16))
    want = _plain(tmp, prompt, MIXTRAL_CAP, 16)
    jout, tout = _spec_both(jmp, jdr, tmp, tdr, prompt, MIXTRAL_CAP, CFG_D,
                            max_new_tokens=16, spec_k=2)
    _assert_greedy(jout, tout, want)
    jout2, tout2 = _spec_both(jmp, jmp, tmp, tmp, prompt, MIXTRAL_CAP,
                              MIXTRAL_CAP, max_new_tokens=16, spec_k=2)
    _assert_greedy(jout2, tout2, want)
    assert tout2[1]["target_calls"] <= 6


def test_speculative_swa_sinks_target():
    """A sliding-window-with-sinks target through the windowed cached
    paths: greedy equality with plain generate holds."""
    cfg_t = dataclasses.replace(CFG_T, sliding_window=16, attn_sinks=2)
    jt, jdr, tt, tdr = _models(seed=5)
    prompt = _prompt(12, (1, 24))
    jout, tout = _spec_both(jt, jdr, tt, tdr, prompt, cfg_t, CFG_D,
                            max_new_tokens=16, spec_k=3)
    _assert_greedy(jout, tout, _plain(tt, prompt, cfg_t, 16))


def test_speculative_eos_matches_generate_and_early_exits():
    """eos: generate()'s finish semantics, and fewer target calls than the
    run without eos."""
    jt, jdr, tt, tdr = _models(seed=7)
    prompt = _prompt(13, (1, 16))
    eos = int(_plain(tt, prompt, CFG_T, 20)[0, 4])
    jout, tout = _spec_both(jt, jdr, tt, tdr, prompt, CFG_T, CFG_D,
                            max_new_tokens=20, spec_k=3, eos_id=eos)
    _assert_greedy(jout, tout, _plain(tt, prompt, CFG_T, 20, eos_id=eos))
    _, free = ts.speculative_generate(
        tt, tdr, torch.from_numpy(prompt), _tcfg(CFG_T), _tcfg(CFG_D),
        max_new_tokens=20, spec_k=3, device="cpu")
    assert tout[1]["target_calls"] < free["target_calls"]


def test_speculative_logprobs_match_generate():
    """Greedy logprobs under the target's unfiltered distribution: equal to
    generate(return_logprobs=True)'s and to JAX's at every position."""
    jt, jdr, tt, tdr = _models(seed=8)
    prompt = _prompt(14, (1, 16))
    want_t, want_lp = _plain(tt, prompt, CFG_T, 16, return_logprobs=True)
    jout, tout = _spec_both(jt, jdr, tt, tdr, prompt, CFG_T, CFG_D,
                            max_new_tokens=16, spec_k=3,
                            return_logprobs=True)
    _assert_greedy(jout, tout, want_t)
    np.testing.assert_allclose(tout[1].numpy(), want_lp.numpy(), atol=LP_TOL)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                               atol=LP_TOL)


def test_speculative_logprobs_sampled_and_eos():
    """Sampled logprobs: finite, <= 0, position 0 the filtered prefill
    distribution's log-prob of the emitted token; post-eos positions report
    exactly 0.0 (greedy, with the eos the JAX run sees too)."""
    jt, jdr, tt, tdr = _models(seed=9)
    prompt = _prompt(15, (1, 16))
    toks, lps, _ = _sampled(tt, tdr, prompt, 16, max_new_tokens=12, spec_k=3,
                            temperature=0.9, top_k=40, return_logprobs=True)
    assert bool(torch.isfinite(lps).all()) and bool((lps <= 0).all())
    logits0, _ = td.prefill(tt, torch.from_numpy(prompt),
                            td.init_kv_cache(_tcfg(CFG_T), 1, 64, "cpu"),
                            _tcfg(CFG_T), fresh=True)
    ld0 = torch.log_softmax(td.filter_logits(logits0, 0.9, 40, None), -1)
    assert abs(float(lps[0, 0]) - float(ld0[0, toks[0, 0]])) <= LP_TOL

    eos = int(_plain(tt, prompt, CFG_T, 12)[0, 2])
    jout, tout = _spec_both(jt, jdr, tt, tdr, prompt, CFG_T, CFG_D,
                            max_new_tokens=12, spec_k=3, eos_id=eos,
                            return_logprobs=True)
    _assert_greedy(jout, tout, _plain(tt, prompt, CFG_T, 12, eos_id=eos))
    t_e, lp_e = tout[0][0].numpy(), tout[1][0].numpy()
    first = int(np.argmax(t_e == eos))
    assert (lp_e[first + 1:] == 0.0).all()
    np.testing.assert_allclose(lp_e, np.asarray(jout[1][0]), atol=LP_TOL)


def test_spec_round_clamps_a_finished_rows_length_near_max_len():
    """A finished row whose frozen length sits past the verify bound
    (max_len - (spec_k+1)) is clamped to it, as the reference clamps, so
    its round's writes stay in the cache; the active row's round, the
    lengths and the active row's cache agree with JAX's spec_round."""
    jt, jdr, tt, tdr = _models(seed=11)
    tcfg, tdcfg = _tcfg(CFG_T), _tcfg(CFG_D)
    K, ML, S0 = 3, 32, 16
    prompt = _prompt(31, (2, S0))
    lengths = np.asarray([S0, ML - 2], np.int32)      # row 1 past the bound
    done = np.asarray([False, True])
    jcaches, tcaches = [], []
    for jcfg, jp, tp in ((CFG_T, jt, tt), (CFG_D, jdr, tdr)):
        jc = jd.init_kv_cache(jcfg, 2, ML)
        _, jc = jd.prefill(jp, jnp.asarray(prompt), jc, jcfg, fresh=True)
        jcaches.append(jc._replace(length=jnp.asarray(lengths)))
        tc = td.init_kv_cache(_tcfg(jcfg), 2, ML, "cpu")
        _, tc = td.prefill(tp, torch.from_numpy(prompt), tc, _tcfg(jcfg),
                           fresh=True)
        tcaches.append(tc._replace(length=torch.from_numpy(lengths)))
    last = np.asarray([7, 9], np.int32)
    kw = dict(spec_k=K, max_len=ML, sampled=False)
    jr = js.spec_round(jd.family_fns(CFG_T, dropless_step=True)[1],
                       jd.family_fns(CFG_D)[1], jt, jdr, jnp.asarray(last),
                       jnp.asarray(done), *jcaches, jax.random.key(0),
                       draft_vocab=128, **kw)
    tr = ts.spec_round(td.family_fns(tcfg, dropless_step=True)[1],
                       td.family_fns(tdcfg)[1], tt, tdr,
                       torch.from_numpy(last), torch.from_numpy(done),
                       *tcaches, None, **kw)
    np.testing.assert_array_equal(tr[0][0].numpy(), np.asarray(jr[0][0]))
    for i in (1, 2, 3):               # keep, emit_n, new_last
        np.testing.assert_array_equal(tr[i].numpy(), np.asarray(jr[i]))
    assert int(tr[2][1]) == 0 and int(tr[3][1]) == 9
    for tc, jc in ((tr[4], jr[4]), (tr[5], jr[5])):
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jc.length))
        assert int(tc.length[1]) == ML - (K + 1)
        # the active row's accepted keys equal JAX's
        n = int(tc.length[0])
        np.testing.assert_allclose(tc.k[:, 0, :, :n].numpy(),
                                   np.asarray(jc.k)[:, 0, :, :n], atol=1e-5)
    np.testing.assert_allclose(tr[6][0].numpy(), np.asarray(jr[6])[0],
                               atol=1e-4)


def _bench_keys(name):
    """The keys bench.py's section ``name`` puts in ``out`` (its dict
    literal and ``out.update``'s)."""
    tree = ast.parse((Path(__file__).resolve().parent.parent / "bench.py")
                     .read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    dicts = [n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", None) == "out"]
    dicts += [n.args[0] for n in ast.walk(fn) if isinstance(n, ast.Call)
              and getattr(n.func, "attr", None) == "update"
              and getattr(n.func.value, "id", None) == "out"]
    return {k.value for d in dicts if isinstance(d, ast.Dict)
            for k in d.keys}


def test_bench_speculative_twin_returns_the_jax_sections_keys():
    """The bench twin at tiny size: bench.py's keys, full self-draft
    acceptance (ceil((new-1)/(k+1)) + 1 target calls), positive times."""
    cfg = tl.LlamaConfig(vocab_size=64, dim=32, n_layers=1, n_heads=2,
                         n_kv_heads=1, hidden_dim=64, dtype="float32",
                         attn_impl="flash")
    out = tbench.bench_speculative(True, "cpu", cfg=cfg, shape=(8, 6, 2, 2))
    assert set(out) == _bench_keys("bench_speculative")
    assert (out["new_tokens"], out["spec_k"], out["batch"]) == (6, 2, 2)
    assert out["target_calls"] == 3
    assert all(out[k] > 0 for k in ("total_ms", "batched_total_ms",
                                    "tokens_per_s_upper_bound",
                                    "batched_tokens_per_s_upper_bound"))
