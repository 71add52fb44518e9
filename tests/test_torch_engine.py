"""The port's continuous-batching engine, on the CPU, in f32.

The engine's invariant (tests/test_engine.py): a request served through the
engine emits exactly the stream plain generate() produces for it alone.
Here each port stream must equal the port's own generate() AND the JAX
engine's stream for the same request, token for token; logprobs agree with
the JAX engine to 1e-4 absolute, and a speculative engine's with the port's
generate() to 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gpu_provisioner_tpu.models import engine as je
from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu.models import moe as jm
from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.models import engine as te
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import moe as tm
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy

JCFG = jl.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, hidden_dim=128, max_seq_len=256,
                      dtype="float32")
JPARAMS = jl.init_params(jax.random.key(0), JCFG)
TPARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), device="cpu")


def _tcfg(jcfg):
    return (tm.MoEConfig if isinstance(jcfg, jm.MoEConfig)
            else tl.LlamaConfig)(**dataclasses.asdict(jcfg))


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 128, n).tolist()


def _solo(prompt, new, cfg, **kw):
    toks = td.generate(TPARAMS, torch.tensor([prompt]), cfg,
                       max_new_tokens=new, max_len=256, device="cpu", **kw)
    return toks[0].tolist()


def _both(jcfg, requests, mid_flight=(), steps_before=0,
          params=(JPARAMS, TPARAMS), draft=None, **eng_kw):
    """Serve ``requests`` [(prompt, new, submit kwargs)] on the JAX and the
    port engines alike, ``mid_flight`` ones after ``steps_before`` steps;
    ``draft`` (jax params, port params, jax cfg) makes both speculative;
    returns (jax engine, port engine, jax ids, port ids)."""
    out = []
    for side, (mod, params, cfg, dev) in enumerate((
            (je, params[0], jcfg, {}),
            (te, params[1], _tcfg(jcfg), {"device": "cpu"}))):
        if draft is not None:
            dcfg = draft[2] if side == 0 else _tcfg(draft[2])
            dev = dict(dev, draft_params=draft[side], draft_cfg=dcfg)
        eng = mod.ServeEngine(params, cfg, **eng_kw, **dev)
        ids = [eng.submit(p, n, **kw) for p, n, kw in requests]
        for _ in range(steps_before):
            eng.step()
        ids += [eng.submit(p, n, **kw) for p, n, kw in mid_flight]
        eng.run()
        out.append((eng, ids))
    (jeng, jids), (teng, tids) = out
    return jeng, teng, jids, tids


def _assert_same_streams(jeng, teng, jids, tids):
    for j, t in zip(jids, tids):
        assert teng.finished[t] == jeng.finished[j], f"request {t}"


def test_engine_matches_generate_and_jax_engine():
    reqs = [(_prompt(1, 10), 8, {}), (_prompt(2, 20), 12, {})]
    jeng, teng, jids, tids = _both(JCFG, reqs, slots=2, max_len=64,
                                   prefill_buckets=(16, 32))
    _assert_same_streams(jeng, teng, jids, tids)
    for (p, n, _), t in zip(reqs, tids):
        assert teng.finished[t] == _solo(p, n, _tcfg(JCFG))


def test_engine_staggered_arrival_and_slot_reuse():
    reqs = [(_prompt(s, 8 + s), 4 + s, {}) for s in range(3)]
    late = [(_prompt(9, 12), 6, {})]
    jeng, teng, jids, tids = _both(JCFG, reqs, mid_flight=late,
                                   steps_before=3, slots=2, max_len=64,
                                   prefill_buckets=(16,))
    _assert_same_streams(jeng, teng, jids, tids)
    for (p, n, _), t in zip(reqs + late, tids):
        assert teng.finished[t] == _solo(p, n, _tcfg(JCFG))


def test_engine_eos_frees_slot_early():
    cfg = _tcfg(JCFG)
    eos = _solo(_prompt(4, 10), 12, cfg)[2]
    reqs = [(_prompt(4, 10), 12, {"eos_id": eos}), (_prompt(5, 10), 4, {})]
    jeng, teng, jids, tids = _both(JCFG, reqs, slots=1, max_len=64,
                                   prefill_buckets=(16,))
    _assert_same_streams(jeng, teng, jids, tids)
    first = teng.finished[tids[0]]
    assert first[-1] == eos and len(first) < 12
    assert first == _solo(_prompt(4, 10), 12, cfg, eos_id=eos)[:len(first)]
    assert teng.finished[tids[1]] == _solo(_prompt(5, 10), 4, cfg)


def test_engine_prefix_cache_hit_and_miss():
    prefix = _prompt(50, 11)
    reqs = [(_prompt(51 + i, 5 + i), 6, {"prefix": prefix}) for i in range(3)]
    reqs.append((_prompt(60, 7), 4, {"prefix": _prompt(61, 9)}))
    jeng, teng, jids, tids = _both(JCFG, reqs, slots=2, max_len=96,
                                   prefill_buckets=(16,),
                                   prefix_cache_size=2)
    _assert_same_streams(jeng, teng, jids, tids)
    assert (teng.prefix_misses, teng.prefix_hits) == (2, 2)
    st = teng.stats()
    assert st["prefix_cache_entries"] == 2 and st["requests_finished"] == 4
    assert st["tokens_emitted"] == 6 * 3 + 4
    # the prefix row survives its hits: a request after them still matches
    for (p, n, kw), t in zip(reqs[:3], tids):
        assert teng.finished[t] == _solo(prefix + p, n, _tcfg(JCFG))


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_engine_through_the_kernels_matches_jax(kv_dtype):
    """attn_impl="flash" with a 128 bucket: admission takes the cached
    kernel (and, after a prefix, at a start above 0), every step the
    decode kernel with per-row starts."""
    jcfg = dataclasses.replace(JCFG, attn_impl="flash",
                               kv_cache_dtype=kv_dtype)
    prefix = _prompt(70, 40)
    reqs = [(_prompt(71, 100), 5, {}), (_prompt(72, 60), 7, {}),
            (_prompt(73, 30), 4, {"prefix": prefix}),
            (_prompt(74, 20), 3, {"prefix": prefix})]
    jeng, teng, jids, tids = _both(jcfg, reqs, slots=2, max_len=512,
                                   prefill_buckets=(128,))
    _assert_same_streams(jeng, teng, jids, tids)
    assert teng.prefix_hits == 1


def test_engine_logprobs_match_jax_engine():
    reqs = [(_prompt(80, 9), 6, {}), (_prompt(81, 14), 5, {})]
    jeng, teng, jids, tids = _both(JCFG, reqs, slots=2, max_len=64,
                                   prefill_buckets=(16,),
                                   return_logprobs=True)
    _assert_same_streams(jeng, teng, jids, tids)
    for j, t in zip(jids, tids):
        np.testing.assert_allclose(teng.finished_logprobs[t],
                                   jeng.finished_logprobs[j], atol=1e-4)
        assert len(teng.finished_logprobs[t]) == len(teng.finished[t])


def test_engine_sampled_is_reproducible_and_in_vocab():
    cfg = _tcfg(JCFG)

    def run(seed):
        eng = te.ServeEngine(TPARAMS, cfg, slots=2, max_len=64,
                             prefill_buckets=(16,), temperature=0.9,
                             top_k=20, device="cpu",
                             generator=torch.Generator().manual_seed(seed))
        ids = [eng.submit(_prompt(90 + i, 8), 6) for i in range(3)]
        out = eng.run()
        return [out[i] for i in ids]

    a = run(0)
    assert a == run(0)
    assert all(0 <= t < 128 for s in a for t in s)
    assert all(len(s) == 6 for s in a)


def test_engine_validation():
    cfg = _tcfg(JCFG)
    # the reference's speculative validation (tests/test_engine.py:391-396
    # and engine.py:135-141)
    with pytest.raises(ValueError, match="spec_k"):
        te.ServeEngine(TPARAMS, cfg, draft_params=TPARAMS, draft_cfg=cfg,
                       spec_k=0, device="cpu")
    with pytest.raises(ValueError, match="together"):
        te.ServeEngine(TPARAMS, cfg, draft_params=TPARAMS, device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        te.ServeEngine(TPARAMS, cfg, draft_params=TPARAMS,
                       draft_cfg=dataclasses.replace(cfg, vocab_size=64),
                       device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        te.ServeEngine(TPARAMS, cfg, temperature=1.0, device="cpu")
    eng = te.ServeEngine(TPARAMS, cfg, slots=1, max_len=32,
                         prefill_buckets=(16,), device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(_prompt(1, 10), 20)
    with pytest.raises(ValueError, match="largest bucket"):
        eng.submit(_prompt(1, 17), 2)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([], 2)
    assert eng.stats()["requests_submitted"] == 0


def test_engine_sliding_window_with_sinks_matches_jax():
    """Window + sinks through the decode kernel with per-slot pads and
    lengths: streams equal the JAX engine's and the port's generate()."""
    jcfg = dataclasses.replace(JCFG, attn_impl="flash", sliding_window=12,
                               attn_sinks=3)
    reqs = [(_prompt(100, 9), 14, {}), (_prompt(101, 15), 10, {})]
    jeng, teng, jids, tids = _both(jcfg, reqs, slots=2, max_len=256,
                                   prefill_buckets=(16,))
    _assert_same_streams(jeng, teng, jids, tids)
    for (p, n, _), t in zip(reqs, tids):
        assert teng.finished[t] == _solo(p, n, _tcfg(jcfg))


MOE_CFG = jm.MoEConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, hidden_dim=128, max_seq_len=256,
                       n_experts=4, experts_per_token=2, dtype="float32")


def _moe_params(seed, jcfg):
    jp = jm.init_moe_model(jax.random.key(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_engine_serves_moe_as_generate_on_the_bucket_padded_prompt(impl):
    """The MoE half of tests/test_engine.py:80: expert capacity comes from
    the bucket length, so an MoE stream equals generate() on the prompt
    left-padded to its bucket — and the JAX engine's stream."""
    jcfg = dataclasses.replace(MOE_CFG, attn_impl=impl)
    params = _moe_params(7, jcfg)
    reqs = [(_prompt(8, 11), 6, {}), (_prompt(9, 16), 5, {}),
            (_prompt(10, 4), 7, {})]
    jeng, teng, jids, tids = _both(jcfg, reqs, params=params, slots=2,
                                   max_len=64, prefill_buckets=(16,))
    _assert_same_streams(jeng, teng, jids, tids)
    for (p, n, _), t in zip(reqs, tids):
        padded = torch.tensor([[0] * (16 - len(p)) + p])
        want = td.generate(params[1], padded, _tcfg(jcfg), max_new_tokens=n,
                           max_len=256, pad_id=0, device="cpu")
        assert teng.finished[t] == want[0].tolist()


def test_engine_serves_moe_at_head_dim_64_as_jax_and_generate():
    """An MoE model at head dim 64 (the bench_moe_decode model's: dim 256,
    4/2 heads of 64), flash, a 128 bucket: admission takes the cached
    kernel, every step the decode kernel at per-row starts; each stream
    equals the JAX engine's and generate() on its bucket-padded prompt."""
    jcfg = dataclasses.replace(MOE_CFG, dim=256, hidden_dim=256,
                               max_seq_len=512, attn_impl="flash")
    params = _moe_params(11, jcfg)
    reqs = [(_prompt(12, 100), 5, {}), (_prompt(13, 60), 6, {}),
            (_prompt(14, 128), 4, {})]
    jeng, teng, jids, tids = _both(jcfg, reqs, params=params, slots=2,
                                   max_len=512, prefill_buckets=(128,))
    _assert_same_streams(jeng, teng, jids, tids)
    for (p, n, _), t in zip(reqs, tids):
        padded = torch.tensor([[0] * (128 - len(p)) + p])
        want = td.generate(params[1], padded, _tcfg(jcfg), max_new_tokens=n,
                           max_len=512, pad_id=0, device="cpu")
        assert teng.finished[t] == want[0].tolist()


def test_engine_refuses_a_prefix_on_moe():
    """tests/test_engine.py:305's MoE case: prefix caching serves the
    dense family only."""
    jcfg = dataclasses.replace(MOE_CFG, n_layers=1)
    _, tparams = _moe_params(1, jcfg)
    eng = te.ServeEngine(tparams, _tcfg(jcfg), slots=1, max_len=64,
                         prefill_buckets=(16,), device="cpu")
    with pytest.raises(ValueError, match="dense family"):
        eng.submit(_prompt(82, 8), 4, prefix=_prompt(83, 8))
    assert eng.stats()["requests_submitted"] == 0


# the speculative engine: the draft of tests/test_engine.py's speculative
# cases (the target's width at one layer)
JDRAFT_CFG = dataclasses.replace(JCFG, n_layers=1)
JDRAFT = jl.init_params(jax.random.key(3), JDRAFT_CFG)
TDRAFT = params_from_numpy(jax.tree.map(np.asarray, JDRAFT), device="cpu")
DRAFT = (JDRAFT, TDRAFT, JDRAFT_CFG)
SELF_DRAFT = (JPARAMS, TPARAMS, JCFG)


def test_engine_speculative_matches_plain_streams():
    """tests/test_engine.py:172: speculative slots (draft a round, one
    wide verify, per-slot acceptance) emit exactly the plain greedy streams
    and the JAX speculative engine's, with slot reuse, staggered arrival,
    the quota cutting the last window, and eos inside an accepted one."""
    cfg = _tcfg(JCFG)
    reqs = [(_prompt(40 + i, 8 + i), 5 + i, {}) for i in range(3)]
    late = [(_prompt(44, 12), 7, {})]
    jeng, teng, jids, tids = _both(JCFG, reqs, mid_flight=late,
                                   steps_before=1, draft=DRAFT, spec_k=3,
                                   slots=2, max_len=64, prefill_buckets=(16,))
    _assert_same_streams(jeng, teng, jids, tids)
    for (p, n, _), t in zip(reqs + late, tids):
        assert teng.finished[t] == _solo(p, n, cfg)

    # self-draft: every proposal accepted, 1 admission token + 2 rounds
    eng = te.ServeEngine(TPARAMS, cfg, slots=1, max_len=64,
                         prefill_buckets=(16,), draft_params=TPARAMS,
                         draft_cfg=cfg, spec_k=3, device="cpu")
    r = eng.submit(_prompt(45, 8), 8)
    steps = 0
    while eng.pending:
        eng.step()
        steps += 1
    assert eng.finished[r] == _solo(_prompt(45, 8), 8, cfg)
    assert steps <= 3

    # eos inside an accepted window truncates and frees the slot
    eos = _solo(_prompt(46, 10), 12, cfg)[3]
    jeng, teng, jids, tids = _both(JCFG, [(_prompt(46, 10), 12,
                                           {"eos_id": eos})],
                                   draft=SELF_DRAFT, spec_k=3, slots=1,
                                   max_len=64, prefill_buckets=(16,))
    _assert_same_streams(jeng, teng, jids, tids)
    got = teng.finished[tids[0]]
    assert eos in got and got[-1] == eos
    assert got == _solo(_prompt(46, 10), 12, cfg, eos_id=eos)[:len(got)]


def test_engine_speculative_moe_target():
    """tests/test_engine.py:216: a Mixtral-capacity MoE target verifies
    drop-free, so speculative slots equal the plain engine's, and the JAX
    speculative engine's."""
    jcfg = dataclasses.replace(MOE_CFG, n_experts=8, capacity_factor=1.25)
    params = _moe_params(9, jcfg)
    p = _prompt(47, 9)
    jeng, teng, jids, tids = _both(jcfg, [(p, 8, {})], params=params,
                                   draft=DRAFT, spec_k=2, slots=2,
                                   max_len=64, prefill_buckets=(16,))
    _assert_same_streams(jeng, teng, jids, tids)
    plain = te.ServeEngine(params[1], _tcfg(jcfg), slots=2, max_len=64,
                           prefill_buckets=(16,), device="cpu")
    rp = plain.submit(p, 8)
    assert teng.finished[tids[0]] == plain.run()[rp]


def test_engine_prefix_with_speculation():
    """tests/test_engine.py:288: both caches carry the prefix row (each
    cloned before its suffix prefill), and the streams stay plain greedy's
    and the JAX engine's."""
    prefix = _prompt(70, 10)
    reqs = [(_prompt(71 + i, 8), 6, {"prefix": prefix}) for i in range(3)]
    jeng, teng, jids, tids = _both(JCFG, reqs, draft=DRAFT, spec_k=3,
                                   slots=2, max_len=96,
                                   prefill_buckets=(16,))
    _assert_same_streams(jeng, teng, jids, tids)
    assert (teng.prefix_misses, teng.prefix_hits) == (1, 2)
    for (p, n, _), t in zip(reqs, tids):
        assert teng.finished[t] == _solo(prefix + p, n, _tcfg(JCFG))


def test_engine_speculative_logprobs_match_generate():
    """The draft half of tests/test_engine.py:326: speculative slots score
    under the target's verify distribution, which equals generate()'s."""
    p = _prompt(95, 9)
    want_t, want_lp = td.generate(TPARAMS, torch.tensor([p]), _tcfg(JCFG),
                                  max_new_tokens=6, max_len=256,
                                  return_logprobs=True, device="cpu")
    jeng, teng, jids, tids = _both(JCFG, [(p, 6, {})], draft=DRAFT,
                                   spec_k=3, slots=2, max_len=64,
                                   prefill_buckets=(16,),
                                   return_logprobs=True)
    _assert_same_streams(jeng, teng, jids, tids)
    assert teng.finished[tids[0]] == want_t[0].tolist()
    got = teng.finished_logprobs[tids[0]]
    assert len(got) == 6
    np.testing.assert_allclose(got, want_lp[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(got, jeng.finished_logprobs[jids[0]],
                               atol=1e-4)


def test_engine_speculative_refuses_a_prefix_with_an_moe_draft():
    """Prefix caching needs a dense target AND a dense draft (reference
    engine.py:319-325)."""
    jcfg = dataclasses.replace(MOE_CFG, n_layers=1)
    _, tparams = _moe_params(1, jcfg)
    eng = te.ServeEngine(TPARAMS, _tcfg(JCFG), slots=1, max_len=64,
                         prefill_buckets=(16,), draft_params=tparams,
                         draft_cfg=_tcfg(jcfg), spec_k=2, device="cpu")
    with pytest.raises(ValueError, match="dense family"):
        eng.submit(_prompt(82, 8), 4, prefix=_prompt(83, 8))
    with pytest.raises(ValueError, match="verify slack"):
        eng.submit(_prompt(82, 8), 46)      # 16 + 46 + 3 > 64
    assert eng.submit(_prompt(82, 8), 45) == 0


def test_engine_speculative_sampled_is_reproducible_and_in_vocab():
    cfg = _tcfg(JCFG)

    def run(seed):
        eng = te.ServeEngine(TPARAMS, cfg, slots=2, max_len=64,
                             prefill_buckets=(16,), temperature=0.9,
                             top_k=20, draft_params=TDRAFT,
                             draft_cfg=_tcfg(JDRAFT_CFG), spec_k=3,
                             generator=torch.Generator().manual_seed(seed),
                             return_logprobs=True, device="cpu")
        ids = [eng.submit(_prompt(90 + i, 8), 6) for i in range(3)]
        out = eng.run()
        return ([out[i] for i in ids],
                [eng.finished_logprobs[i] for i in ids])

    a, lps = run(0)
    assert (a, lps) == run(0)
    assert all(0 <= t < 128 for s in a for t in s)
    assert all(len(s) == 6 for s in a)
    assert all(len(lp) == 6 and all(x <= 0 for x in lp) for lp in lps)
