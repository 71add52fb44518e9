"""The tensor-core instances of the rectangular kernels, on the CPU.

The bf16 ``flash_fwd`` (self-attention and the bf16 cache) and
``flash_bwd_dq`` run csrc/flash_tc.cuh's tile steps on the card: the
forward's P as two bf16 terms (hi + lo) before P·V, dQ's dS rounded to bf16
once before dS·K, where the JAX kernels keep both f32 (ROADMAP Queue C 12).
No CUDA kernel runs here, so the tests hold:
- the CPU replay of that arithmetic (hack/torch_tri_bf16_replay.py) on bf16
  values from a numpy seed, against the JAX kernels in interpret mode (in
  f32, so that both sides stop before the last rounding to bf16), at a
  ragged S (not a multiple of the kernels' 64-row tiles) and GQA 4/1:
  ``flash_attention_with_lse`` and its VJP (causal or not, window),
  ``flash_attention_cached`` (start, pads, window, sinks) and
  ``flash_attention_decode`` (per-row starts, which ``flash_fwd`` takes
  too); out within 5e-3 absolute and lse within 5e-5 (half the card's
  1e-2 and 1e-4), dQ within 5e-3 of its largest value; the int8 cache's
  fold (int8 widened to bf16, scales on the score and P columns) against
  the same JAX functions in int8 mode; each at head dims 64, 128, 80 and
  96 (every kernel takes them; dQ's replay at 64, 80 and 96 is those
  backward instances' arithmetic), the forward-only replays also at 16
  and 32;
- the launch path's layout rule: a strided bf16 q through
  ``flash_attention_with_lse`` or ``flash_attention_cached`` (a bf16 or an
  int8 cache) reaches the kernel as a copy that the tensor-core instances
  take (``_tc_layout``), the f32 instances take it as it is, and a direct
  launch of a misaligned bf16 ``flash_fwd`` (q, k, v; int8 K/V in chunks of
  16 values) or ``flash_bwd_dq`` raises before the kernel library (nvcc, a
  card) is asked for;
- the head-dim gates: D = 64 reaches ``flash_fwd`` (self-attention, a bf16
  and an int8 cache), ``flash_decode``, the backward kernels and the
  triangle kernels, through autograd and ``triangular=True`` too, with no
  kernel library built and no plain fallback; D = 32 and 16 reach
  ``flash_fwd`` and ``flash_decode`` (its narrow entry) and the backward
  and triangle kernels; D = 80 and 96 reach every kernel (their mid
  entries), through autograd and ``triangular=True`` too; D = 8, 24, 48,
  100 and 112 are refused by every kernel, each with a ValueError naming
  the head dim.
The launch itself is stood in (``_on_card``, ``_run``);
tests/test_torch_cuda.py holds the kernels.
"""

import ctypes
import gc
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.ops import _cuda
from gpu_provisioner_tpu_torch.ops import flash_attention as tfa

# the JAX ops package re-exports flash_attention, shadowing the module name
jfa = importlib.import_module("gpu_provisioner_tpu.ops.flash_attention")
ROOT = Path(__file__).resolve().parent.parent
D = 128
SCALE = D ** -0.5


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches():
    """Drops what this module compiled once it is done (a later test in the
    same worker would pay for those objects in every garbage collection)."""
    yield
    jax.clear_caches()
    gc.collect()


def _replay():
    """hack/torch_tri_bf16_replay.py as a module (it imports no JAX)."""
    spec = importlib.util.spec_from_file_location(
        "torch_tri_bf16_replay", ROOT / "hack" / "torch_tri_bf16_replay.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16) for s in shapes]


def _j(t):
    return jnp.asarray(t.float().numpy())


def _abs(got, want):
    return np.abs(got.numpy() - np.asarray(want)).max()


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


# the forward and dQ replays at head dims 64 and 128, and 80 and 96 (the D
# = 128 tile partly filled: the same arithmetic on the first D columns)
HEAD_DIMS = [pytest.param(64, id="d64"), pytest.param(128, id="d128"),
             pytest.param(80, id="d80"), pytest.param(96, id="d96")]
# the forward-only replays also at 32 and 16 (the D = 64 tile partly
# filled)
FWD_HEAD_DIMS = [pytest.param(16, id="d16"), pytest.param(32, id="d32"),
                 *HEAD_DIMS]


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal,window", [
    pytest.param(True, None, id="causal"),
    pytest.param(False, None, id="full"),
    pytest.param(True, 72, id="causal-window"),
    pytest.param(False, 72, id="full-window")])
def test_rectangular_rounding_stays_within_half_the_card_tolerance(
        causal, window, D):
    """Self-attention at S=200 (three full 64-row tiles and a ragged one),
    Hq 4 / Hkv 1: the replay of the tensor-core forward and dQ against JAX
    flash_attention_with_lse and its VJP (blocks of 40, interpret mode)."""
    replay = _replay()
    S, Hq, Hkv, scale = 200, 4, 1, D ** -0.5
    q, k, v, dout = _bf16(31, (1, S, Hq, D), (1, S, Hkv, D), (1, S, Hkv, D),
                          (1, S, Hq, D))
    outs, vjp = jax.vjp(lambda *a: jfa.flash_attention_with_lse(
        *a, causal=causal, window=window, block_q=40, block_k=40,
        interpret=True), *(_j(t) for t in (q, k, v)))
    jdq = vjp((_j(dout), jnp.zeros_like(outs[1])))[0]
    keep = replay.keep_mask(1, S, S, causal=causal, window=window)
    out, lse = replay.replay_fwd(q, k, v, scale, keep=keep)
    dq = replay.replay_dq(q, k, v, dout, out, lse, scale, keep=keep)
    assert _abs(out, outs[0]) <= 5e-3
    assert _abs(lse, outs[1]) <= 5e-5
    assert _rel(dq, jdq) <= 5e-3


@pytest.mark.parametrize("D", FWD_HEAD_DIMS)
@pytest.mark.parametrize("start,pads,window,sinks", [
    pytest.param(0, None, None, 0, id="start0"),
    pytest.param(100, [0, 30], None, 0, id="pads"),
    pytest.param(150, [5, 20], 64, 4, id="window-sinks")])
def test_cache_rounding_stays_within_half_the_card_tolerance(start, pads,
                                                             window, sinks,
                                                             D):
    """40 fresh queries (one ragged tile) at cache positions start.. against
    a head-major bf16 cache of 256, B=2, Hq 4 / Hkv 1: the replay of the
    tensor-core forward (flash_fwd's bf16-cache instance) against JAX
    flash_attention_cached (blocks 40 and 64, interpret mode). Pad-query
    rows are zeros on both sides."""
    replay = _replay()
    B, S, Hq, Hkv, ML, scale = 2, 40, 4, 1, 256, D ** -0.5
    q, kc, vc = _bf16(32, (B, S, Hq, D), (B, Hkv, ML, D), (B, Hkv, ML, D))
    kw = dict(window=window, sinks=sinks)
    if pads is not None:
        kw["pad_lens"] = jnp.asarray(pads, jnp.int32)
    want = jfa.flash_attention_cached(_j(q), _j(kc), _j(vc), start,
                                      block_q=40, block_k=64,
                                      interpret=True, **kw)
    keep = replay.keep_mask(B, S, ML, start=start, pad_lens=pads,
                            window=window, sinks=sinks)
    out, _ = replay.replay_fwd(q, kc.transpose(1, 2), vc.transpose(1, 2),
                               scale, keep=keep)
    assert _abs(out, want) <= 5e-3


@pytest.mark.parametrize("D", FWD_HEAD_DIMS)
@pytest.mark.parametrize("pads,window,sinks", [
    pytest.param(None, None, 0, id="starts"),
    pytest.param([3, 40], 100, 2, id="starts-pads-window-sinks")])
def test_per_row_starts_rounding_stays_within_half_the_card_tolerance(
        pads, window, sinks, D):
    """16 queries a row at per-row starts (a ragged tile; flash_fwd takes
    starts of B values as flash_attention_decode does): the replay of the
    tensor-core forward against JAX flash_attention_decode (interpret
    mode)."""
    replay = _replay()
    B, S, Hq, Hkv, ML, scale = 2, 16, 4, 1, 256, D ** -0.5
    starts = [200, 61]
    q, kc, vc = _bf16(33, (B, S, Hq, D), (B, Hkv, ML, D), (B, Hkv, ML, D))
    kw = dict(window=window, sinks=sinks)
    if pads is not None:
        kw["pad_lens"] = jnp.asarray(pads, jnp.int32)
    want = jfa.flash_attention_decode(_j(q), _j(kc), _j(vc),
                                      jnp.asarray(starts, jnp.int32),
                                      interpret=True, **kw)
    keep = replay.keep_mask(B, S, ML, start=starts, pad_lens=pads,
                            window=window, sinks=sinks)
    out, _ = replay.replay_fwd(q, kc.transpose(1, 2), vc.transpose(1, 2),
                               scale, keep=keep)
    assert _abs(out, want) <= 5e-3


def _int8_cache(seed, B, Hkv, ML, D=D):
    """A head-major cache quantised by the JAX package's own _quantize_kv:
    (int8 k, int8 v, f32 k_scale, f32 v_scale) as torch tensors."""
    from gpu_provisioner_tpu.models.decode import _quantize_kv
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.standard_normal((B, Hkv, ML, D)).astype(np.float32)
        out.append([torch.from_numpy(np.array(a))
                    for a in _quantize_kv(jnp.asarray(x))])
    (k8, ks), (v8, vs) = out
    return k8, v8, ks, vs


@pytest.mark.parametrize("D", FWD_HEAD_DIMS)
@pytest.mark.parametrize("op,start,pads,window,sinks", [
    pytest.param("cached", 0, None, None, 0, id="cached-start0"),
    pytest.param("cached", 100, [0, 30], None, 0, id="cached-pads"),
    pytest.param("cached", 150, [5, 20], 64, 4, id="cached-window-sinks"),
    pytest.param("decode", [200, 61], [3, 40], 100, 2,
                 id="decode-starts-pads-window-sinks")])
def test_int8_fold_rounding_stays_within_half_the_card_tolerance(
        op, start, pads, window, sinks, D):
    """The int8 cache's tensor-core forward (ROADMAP Queue C 15): its int8
    tiles widened exactly to bf16, k_scale on the score columns, v_scale
    folded into P's columns before the hi + lo split, the denominator from
    the unscaled P. The replay against JAX flash_attention_cached (40 fresh
    queries, one ragged tile) or flash_attention_decode (16 queries at
    per-row starts, which flash_fwd takes too) in int8 mode (interpret
    mode), B=2, Hq 4 / Hkv 1, a cache of 256: out within 5e-3 of the
    largest value, lse within 5e-5 of attention_plain's on the same int8
    inputs (the function tests/test_torch_flash.py holds against JAX; the
    JAX cached and decode kernels return no lse)."""
    replay = _replay()
    B, Hq, Hkv, ML, scale = 2, 4, 1, 256, D ** -0.5
    S = 40 if op == "cached" else 16
    (q,) = _bf16(37, (B, S, Hq, D))
    k8, v8, ks, vs = _int8_cache(38, B, Hkv, ML, D)
    kw = dict(window=window, sinks=sinks)
    if pads is not None:
        kw["pad_lens"] = jnp.asarray(pads, jnp.int32)
    jkw = dict(kw, k_scale=jnp.asarray(ks.numpy()),
               v_scale=jnp.asarray(vs.numpy()))
    if op == "cached":
        want = jfa.flash_attention_cached(
            _j(q), jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy()), start,
            block_q=40, block_k=64, interpret=True, **jkw)
    else:
        want = jfa.flash_attention_decode(
            _j(q), jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy()),
            jnp.asarray(start, jnp.int32), interpret=True, **jkw)
    keep = replay.keep_mask(B, S, ML, start=start, pad_lens=pads,
                            window=window, sinks=sinks)
    out, lse = replay.replay_fwd(q, k8.transpose(1, 2), v8.transpose(1, 2),
                                 scale, keep=keep,
                                 k_scale=ks.transpose(1, 2),
                                 v_scale=vs.transpose(1, 2))
    assert _rel(out, want) <= 5e-3
    tkw = dict(window=window, sinks=sinks, k_scale=ks, v_scale=vs,
               pad_lens=None if pads is None else torch.tensor(pads))
    st = torch.tensor(start) if isinstance(start, list) else start
    _, plain_lse = tfa.attention_plain(q.float(), k8, v8, st, **tkw)
    assert _abs(lse, plain_lse.numpy()) <= 5e-5


def _strided_q(S, Hq, dtype=torch.bfloat16):
    """[1, S, Hq, 128] with a row stride of Hq·128 + 4 elements: not a
    whole number of 16-byte chunks, as a narrow of a wider projection."""
    row = Hq * D + 4
    q = _bf16(34, (1, S, row))[0].to(dtype)
    return q.as_strided((1, S, Hq, D), (S * row, row, D, 1))


@pytest.fixture
def launches(monkeypatch):
    """Stands the card in: the wrappers take their launch path on CPU
    tensors, and every check and layout up to the C entry runs; the entry
    (``_run``) only records the argument struct it was given."""
    seen = []
    monkeypatch.setattr(tfa, "_on_card", lambda t: True)
    monkeypatch.setattr(tfa, "_run", lambda kernel, a, dev: seen.append(
        (kernel, a)))
    return seen


def test_forward_lays_out_a_strided_bf16_q_for_the_kernel(launches):
    """A bf16 q whose row stride is no whole number of 16-byte chunks: a
    direct flash_fwd launch refuses it (ValueError naming q), and
    flash_attention_with_lse hands the kernel a contiguous copy instead
    (_tc_layout), whose strides the tensor-core instance takes."""
    S, Hq, Hkv = 128, 2, 1
    q = _strided_q(S, Hq)
    k, v = _bf16(35, (1, S, Hkv, D), (1, S, Hkv, D))
    with pytest.raises(ValueError, match=r"flash_fwd: q strides"):
        tfa._launch("flash_fwd", q, k.transpose(1, 2), v.transpose(1, 2), 0,
                    causal=True, scale=SCALE)
    assert launches == []
    tfa.flash_attention_with_lse(q, k, v)
    (kernel, a), = launches
    assert kernel == "flash_fwd"
    assert a.q != q.data_ptr() and a.q % 16 == 0
    assert (a.q_sb, a.q_ss, a.q_sh) == (S * Hq * D, Hq * D, D)
    assert a.k == k.data_ptr() and a.v == v.data_ptr()   # no copy needed


def test_cached_prefill_lays_out_q_for_the_bf16_cache_only(launches):
    """flash_attention_cached with a strided q: a bf16 q reaches the
    tensor-core instances, which copy 16-byte chunks, as a contiguous copy,
    against a bf16 cache and (since the int8 cache's prefill runs on the
    tensor cores too) against an int8 cache, whose int8 tiles are taken as
    they are; an f32 q against an int8 cache reaches the FMA instance,
    which reads any row stride, as it is."""
    S, Hq, Hkv, ML = 128, 2, 1, 256
    q = _strided_q(S, Hq)
    kc, vc = _bf16(36, (1, Hkv, ML, D), (1, Hkv, ML, D))
    kq, ks = td._quantize_kv(kc)
    vq, vs = td._quantize_kv(vc)
    q32 = _strided_q(S, Hq, torch.float32)
    with torch.no_grad():
        tfa.flash_attention_cached(q, kc, vc, 64)
        tfa.flash_attention_cached(q, kq, vq, 64, k_scale=ks, v_scale=vs)
        tfa.flash_attention_cached(q32, kq, vq, 64, k_scale=ks, v_scale=vs)
    (_, bf), (_, i8), (_, f32) = launches
    assert bf.q != q.data_ptr() and bf.q_ss == Hq * D
    assert bf.k == kc.data_ptr() and bf.kv_dtype == 1
    assert i8.q != q.data_ptr() and i8.q % 16 == 0 and i8.q_ss == Hq * D
    assert i8.k == kq.data_ptr() and i8.kv_dtype == 2
    assert f32.q == q32.data_ptr() and f32.q_ss == Hq * D + 4
    assert f32.kv_dtype == 2
    assert tfa.LAUNCHES["flash_cached_int8"] >= 2


def test_launches_refuse_misaligned_bf16_copies_before_they_build():
    """The tensor-core flash_fwd copies q, k and v, flash_bwd_dq q, k, v and
    dout, in 16-byte chunks: a bf16 input off a 16-byte boundary raises
    ValueError naming it before the kernel library (nvcc, a card) is asked
    for; an f32 q (the FMA instances) takes any row stride."""
    S, Hq, Hkv = 128, 2, 1
    q = torch.zeros(1, S, Hq, D, dtype=torch.bfloat16)
    k = torch.zeros(1, S, Hkv, D, dtype=torch.bfloat16)
    off = torch.zeros(S * Hkv * D + 4, dtype=torch.bfloat16)[4:].view(
        1, S, Hkv, D)
    with pytest.raises(ValueError, match=r"flash_fwd: v is not 16-byte "
                                         r"aligned"):
        tfa._launch("flash_fwd", q, k.transpose(1, 2), off.transpose(1, 2),
                    0, causal=True, scale=SCALE)
    dout = torch.zeros(S * Hq * D + 4, dtype=torch.bfloat16)[4:].view(
        1, S, Hq, D)
    lse = torch.zeros(1, Hq, S)
    with pytest.raises(ValueError, match=r"flash_bwd_dq: dout is not "
                                         r"16-byte aligned"):
        tfa._launch_bwd("flash_bwd_dq", q, k, k, dout, lse, lse,
                        causal=True, scale=SCALE)
    tfa._check_tc_copies("flash_fwd", q=_strided_q(S, Hq, torch.float32),
                         k=k.float(), v=k.float())


def test_int8_prefill_refuses_misaligned_copies_before_it_builds():
    """The int8 cache's tensor-core prefill copies q in bf16 chunks and the
    int8 tiles in 16-byte chunks of 16 values: a bf16 q with a row stride
    of no whole number of chunks, or an int8 cache whose position stride
    is not a multiple of 16 values, raises ValueError naming it before the
    kernel library (nvcc, a card) is asked for; an f32 q (the FMA
    instance) takes both."""
    S, Hq, Hkv, ML = 128, 2, 1, 256
    kc = _bf16(39, (1, Hkv, ML, D))[0]
    k8, ks = td._quantize_kv(kc)
    kw = dict(causal=True, scale=SCALE, k_scale=ks, v_scale=ks)
    with pytest.raises(ValueError, match=r"flash_fwd: q strides"):
        tfa._launch("flash_fwd", _strided_q(S, Hq), k8, k8, 0, **kw)
    wide = torch.zeros(1, Hkv, ML, D + 8, dtype=torch.int8)[..., :D]
    q = torch.zeros(1, S, Hq, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"flash_fwd: k strides"):
        tfa._launch("flash_fwd", q, wide, k8, 0, **kw)
    tfa._check_tc_copies("flash_fwd", q=q.float(), k=wide, v=wide)


@pytest.fixture
def no_build(monkeypatch):
    """Fails the test where a wrapper asks for a kernel library (nvcc, a
    card), and gives the decode plan an H100's 132 SMs."""
    def refuse(name):
        raise AssertionError(f"the {name} library was asked for")
    monkeypatch.setattr(_cuda, "library", refuse)
    monkeypatch.setattr(tfa, "_sm_count", lambda dev: 132)


def test_head_dim_64_reaches_the_forward_kernels(launches, no_build):
    """flash_attention_with_lse, flash_attention_cached on a bf16 and an
    int8 cache, and flash_attention_decode on both, at head dim 64: each
    reaches its kernel's launch with D = 64 (the bench_moe_decode model's
    head dim)."""
    D, S, Hq, Hkv, ML = 64, 128, 4, 2, 256
    q, k, v = _bf16(40, (1, S, Hq, D), (1, S, Hkv, D), (1, S, Hkv, D))
    kc, vc = _bf16(41, (1, Hkv, ML, D), (1, Hkv, ML, D))
    (k8, ks), (v8, vs) = td._quantize_kv(kc), td._quantize_kv(vc)
    i8 = dict(k_scale=ks, v_scale=vs)
    tfa.flash_attention_with_lse(q, k, v)
    with torch.no_grad():
        tfa.flash_attention_cached(q, kc, vc, 64)
        tfa.flash_attention_cached(q, k8, v8, 64, **i8)
        tfa.flash_attention_decode(q[:, :1], kc, vc, 100)
        tfa.flash_attention_decode(q[:, :1], k8, v8, 100, **i8)
    assert [(kernel, a.D, a.kv_dtype) for kernel, a in launches] == [
        ("flash_fwd", 64, 1), ("flash_fwd", 64, 1), ("flash_fwd", 64, 2),
        ("flash_decode", 64, 1), ("flash_decode", 64, 2)]


@pytest.fixture
def tri_grid(monkeypatch):
    """Stands in the tri entries' grid and workspace queries (the kernel
    library answers them on the card), recording the head dims asked."""
    asked = []

    def ctas(entry, act_dtype, head_dim, device_index):
        asked.append((entry, head_dim))
        return 264

    monkeypatch.setattr(_cuda, "tri_ctas", ctas)
    monkeypatch.setattr(_cuda, "tri_ws_floats",
                        lambda entry, act_dtype, head_dim: 4 * 64 * head_dim)
    return asked


@pytest.mark.parametrize("triangular", [False, True])
def test_head_dim_64_backward_raises_before_any_build(launches, no_build,
                                                      tri_grid, triangular):
    """The backward kernels (rectangular and triangle) take head dim 64
    since the fast bench_train_step model trains at it, so nothing raises
    any more: a D = 64 self-attention runs its forward kernel, and its
    backward reaches the dQ and dK/dV launches (their triangle twins with
    triangular=True, which ask the tri grid for head dim 64) with D = 64,
    no library built and no plain fallback."""
    q, k, v = (t.requires_grad_() for t in _bf16(
        42, (1, 128, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64)))
    out = tfa.flash_attention(q, k, v, triangular=triangular)
    out.float().sum().backward()
    bwd = (["flash_bwd_dq_tri", "flash_bwd_dkv_tri"] if triangular
           else ["flash_bwd_dq", "flash_bwd_dkv"])
    assert [kernel for kernel, _ in launches] == ["flash_fwd"] + bwd
    assert all(a.D == 64 for _, a in launches)
    assert tri_grid == [(kernel, 64) for kernel in bwd if triangular]
    assert q.grad is not None and k.grad.shape == k.shape


def test_head_dim_64_triangle_forward_raises_before_any_build(
        launches, no_build, tri_grid):
    """tri_dispatch keeps the JAX budget rule: at head dim 64 in bf16 the
    triangle's forward starts past S = 24576, where a D = 64
    triangular=True call now reaches flash_fwd_tri's launch with D = 64
    (its grid and workspace asked for head dim 64) instead of raising, no
    library built; below it the rectangular forward takes the call."""
    assert tfa.tri_dispatch(24576, 64, 2, causal=True, triangular=True,
                            window=None) == (False, True)
    assert tfa.tri_dispatch(25088, 64, 2, causal=True, triangular=True,
                            window=None) == (True, True)
    with torch.no_grad():
        for S in (24576, 25088):
            q = torch.zeros(1, S, 1, 64, dtype=torch.bfloat16)
            tfa.flash_attention(q, q, q, triangular=True)
    (rect, a), (tri, b) = launches
    assert (rect, a.D, a.Sq, tri, b.D, b.S) == (
        "flash_fwd", 64, 24576, "flash_fwd_tri", 64, 25088)
    assert b.ctas == 264 and b.ws_floats == 264 * 4 * 64 * 64
    assert tri_grid == [("flash_fwd_tri", 64)]


@pytest.mark.parametrize("D", [8, 24, 48, 100, 112])
def test_other_head_dims_are_refused_by_every_kernel(launches, no_build, D):
    """Head dims other than 16, 32, 64, 80, 96 and 128 raise ValueError
    naming the head dim in every kernel's wrapper (the forward on
    self-attention, a bf16 and an int8 cache, the decode, the backward and
    the triangle), each before any library is built; 16 and 32 reach their
    launches instead (test_head_dims_32_and_16_reach_the_serving_kernels
    and test_head_dims_32_and_16_reach_the_backward_and_triangle_kernels),
    and so do 80 and 96 (test_head_dims_80_and_96_reach_the_serving_
    kernels_alone, every kernel's)."""
    S, Hq, Hkv, ML = 128, 4, 2, 256
    q, k, v = _bf16(43, (1, S, Hq, D), (1, S, Hkv, D), (1, S, Hkv, D))
    kc, vc = _bf16(44, (1, Hkv, ML, D), (1, Hkv, ML, D))
    (k8, ks), (v8, vs) = td._quantize_kv(kc), td._quantize_kv(vc)
    lse = torch.zeros(1, Hq, S)
    calls = {
        "flash_fwd": [lambda: tfa.flash_attention_with_lse(q, k, v),
                      lambda: tfa.flash_attention_cached(q, kc, vc, 64),
                      lambda: tfa.flash_attention_cached(
                          q, k8, v8, 64, k_scale=ks, v_scale=vs)],
        "flash_decode": [lambda: tfa.flash_attention_decode(
            q[:, :1], kc, vc, 100)],
        "flash_bwd_dq": [lambda: tfa.flash_attention_bwd(
            q, k, v, q, lse, q)],
        "flash_bwd_dkv": [lambda: tfa._launch_bwd(
            "flash_bwd_dkv", q, k, v, q, lse, lse, causal=True, scale=1.0)],
        "flash_bwd_dq_tri": [lambda: tfa.flash_attention_bwd(
            q, k, v, q, lse, q, triangular=True)],
        "flash_fwd_tri": [lambda: tfa._launch_tri(
            "flash_fwd_tri", q, k, v, scale=1.0)],
        "flash_bwd_dkv_tri": [lambda: tfa._launch_tri(
            "flash_bwd_dkv_tri", q, k, v, scale=1.0, dout=q, lse=lse,
            delta=lse)]}
    assert D not in tfa._HEAD_DIMS
    with torch.no_grad():
        for kernel, fns in calls.items():
            for fn in fns:
                with pytest.raises(ValueError,
                                   match=f"head dim {D}: {kernel} takes"):
                    fn()
    assert launches == []


@pytest.mark.parametrize("D", [16, 32])
def test_head_dims_32_and_16_reach_the_serving_kernels(launches, no_build,
                                                       tri_grid, D):
    """flash_attention_with_lse, flash_attention_cached on a bf16 and an
    int8 cache, and flash_attention_decode on both, at head dims 32 (the
    fast bench_engine and bench_moe_decode models' 8/4 heads) and 16 (the
    tiny presets' 4/2): each reaches its kernel's launch with that D, no
    library built and no plain fallback; the decode's C entry at these
    head dims is flash_decode_narrow (a source of its own). A D = 32 or 16
    self-attention's backward through autograd then reaches the dQ and
    dK/dV launches with that D (their triangle twins with triangular=True,
    which ask the tri grid for that head dim), as at D = 64."""
    S, Hq, Hkv, ML = 128, 4, 2, 256
    q, k, v = _bf16(45, (1, S, Hq, D), (1, S, Hkv, D), (1, S, Hkv, D))
    kc, vc = _bf16(46, (1, Hkv, ML, D), (1, Hkv, ML, D))
    (k8, ks), (v8, vs) = td._quantize_kv(kc), td._quantize_kv(vc)
    i8 = dict(k_scale=ks, v_scale=vs)
    with torch.no_grad():
        tfa.flash_attention_with_lse(q, k, v)
        tfa.flash_attention_cached(q, kc, vc, 64)
        tfa.flash_attention_cached(q, k8, v8, 64, **i8)
        tfa.flash_attention_decode(q[:, :1], kc, vc, 100)
        tfa.flash_attention_decode(q[:, :1], k8, v8, 100, **i8)
    assert [(kernel, a.D, a.kv_dtype) for kernel, a in launches] == [
        ("flash_fwd", D, 1), ("flash_fwd", D, 1), ("flash_fwd", D, 2),
        ("flash_decode", D, 1), ("flash_decode", D, 2)]
    assert [_cuda.entry(kernel, a.D) for kernel, a in launches] == [
        "flash_fwd"] * 3 + ["flash_decode_narrow"] * 2
    assert _cuda.entry("flash_decode", 64) == "flash_decode"
    for triangular in (False, True):
        launches.clear()
        qg = q.clone().requires_grad_()
        out = tfa.flash_attention(qg, k, v, triangular=triangular)
        out.float().sum().backward()
        bwd = (["flash_bwd_dq_tri", "flash_bwd_dkv_tri"] if triangular
               else ["flash_bwd_dq", "flash_bwd_dkv"])
        assert [(kernel, a.D, a.act_dtype) for kernel, a in launches] == [
            ("flash_fwd", D, 1)] + [(kernel, D, 1) for kernel in bwd]
        assert qg.grad is not None
    assert tri_grid == [(kernel, D) for kernel in
                        ("flash_bwd_dq_tri", "flash_bwd_dkv_tri")]


@pytest.mark.parametrize("D", [80, 96])
def test_head_dims_80_and_96_reach_the_serving_kernels_alone(
        launches, no_build, tri_grid, D):
    """At head dims 80 (H2O-Danube-1.8B's 32/8 heads) and 96 (Phi-3-mini's
    32/32), every kernel (the name is from when only the serving kernels
    took them): flash_attention_with_lse, flash_attention_cached on a bf16
    and an int8 cache, and flash_attention_decode on both reach their
    launches with that D and the C entries of csrc/flash_fwd_mid.cu and
    csrc/flash_decode_mid.cu; a self-attention whose input requires grad
    then reaches the dQ and dK/dV launches through autograd (their triangle
    twins with triangular=True, which ask the tri grid for that head dim),
    each at the C entry <kernel>_mid of csrc/flash_bwd_mid.cu or
    csrc/flash_tri_mid.cu; and _launch_tri reaches all three triangle
    entries with the grid and workspace asked for that head dim; no
    library built and no plain fallback."""
    S, Hq, Hkv, ML = 128, 4, 2, 256
    q, k, v = _bf16(48, (1, S, Hq, D), (1, S, Hkv, D), (1, S, Hkv, D))
    kc, vc = _bf16(49, (1, Hkv, ML, D), (1, Hkv, ML, D))
    (k8, ks), (v8, vs) = td._quantize_kv(kc), td._quantize_kv(vc)
    i8 = dict(k_scale=ks, v_scale=vs)
    with torch.no_grad():
        tfa.flash_attention_with_lse(q, k, v)
        tfa.flash_attention(q.clone().requires_grad_(), k, v)
        tfa.flash_attention_cached(q, kc, vc, 64)
        tfa.flash_attention_cached(q, k8, v8, 64, **i8)
        tfa.flash_attention_decode(q[:, :1], kc, vc, 100)
        tfa.flash_attention_decode(q[:, :5], k8, v8, 100, **i8)
    assert [(kernel, a.D, a.kv_dtype) for kernel, a in launches] == [
        ("flash_fwd", D, 1), ("flash_fwd", D, 1), ("flash_fwd", D, 1),
        ("flash_fwd", D, 2), ("flash_decode", D, 1), ("flash_decode", D, 2)]
    assert [_cuda.entry(kernel, a.D) for kernel, a in launches] == [
        "flash_fwd_mid"] * 4 + ["flash_decode_mid"] * 2
    for kernel in ("flash_fwd", "flash_decode"):
        assert _cuda.ENTRIES[kernel + "_mid"][0] == kernel + "_mid"
        assert _cuda.entry(kernel, 128) == kernel

    for triangular in (False, True):
        launches.clear()
        qg = q.clone().requires_grad_()
        out = tfa.flash_attention(qg, k, v, triangular=triangular)
        out.float().sum().backward()
        bwd = (["flash_bwd_dq_tri", "flash_bwd_dkv_tri"] if triangular
               else ["flash_bwd_dq", "flash_bwd_dkv"])
        assert [(kernel, a.D, a.act_dtype) for kernel, a in launches] == [
            ("flash_fwd", D, 1)] + [(kernel, D, 1) for kernel in bwd]
        assert [_cuda.entry(kernel, D) for kernel, _ in launches] == [
            kernel + "_mid" for kernel, _ in launches]
        assert qg.grad is not None
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert _cuda.ENTRIES[kernel + "_mid"][0] == "flash_bwd_mid"
        assert _cuda.entry(kernel, 128) == kernel
    assert tri_grid == [(kernel, D) for kernel in
                        ("flash_bwd_dq_tri", "flash_bwd_dkv_tri")]

    launches.clear()
    tri_grid.clear()
    lse = torch.zeros(1, Hq, S)
    with torch.no_grad():
        tfa._launch_tri("flash_fwd_tri", q, k, v, scale=D ** -0.5)
        kw = dict(scale=D ** -0.5, dout=q, lse=lse, delta=lse)
        tfa._launch_tri("flash_bwd_dq_tri", q, k, v, **kw)
        tfa._launch_tri("flash_bwd_dkv_tri", q, k, v, **kw)
    entries = ["flash_fwd_tri", "flash_bwd_dq_tri", "flash_bwd_dkv_tri"]
    assert [kernel for kernel, _ in launches] == entries
    assert tri_grid == [(kernel, D) for kernel in entries]
    for kernel, a in launches:
        assert (a.D, a.act_dtype, a.ctas) == (D, 1, 264)
        assert a.ws_floats == 264 * 4 * 64 * D
        assert _cuda.entry(kernel, D) == kernel + "_mid"
        assert _cuda.ENTRIES[kernel + "_mid"][0] == "flash_tri_mid"
        assert _cuda.entry(kernel, 128) == kernel


@pytest.mark.parametrize("D", [16, 32])
def test_head_dims_32_and_16_reach_the_backward_and_triangle_kernels(
        launches, no_build, tri_grid, D):
    """At head dims 32 (the fast bench_engine model's 8/4 heads) and 16
    (tiny's 4/2), with the card stood in (the autograd path:
    test_head_dims_32_and_16_reach_the_serving_kernels):
    flash_attention_bwd with an lse cotangent hands both backward kernels
    delta = rowsum(dO o O) - g_lse, and _launch_tri reaches all three
    triangle entries, each with that D in its argument struct, the bf16
    act dtype, the grid and workspace asked for that head dim, and its own
    C entry: flash_bwd.cu builds 16 to 128, the triangle's 32 and 16
    are flash_tri_narrow.cu's <entry>_narrow; no library built and no
    plain fallback."""
    B, S, Hq, Hkv = 1, 128, 4, 2
    q, k, v, dout = _bf16(47, (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                          (B, S, Hq, D))
    # delta as each launch sees it (the wrapper's tensor lives for the call)
    deltas, stand_in = [], tfa._run

    def run(kernel, a, dev):
        deltas.append(np.ctypeslib.as_array(ctypes.cast(
            a.delta, ctypes.POINTER(ctypes.c_float)), shape=(B * Hq * S,))
            .copy())
        stand_in(kernel, a, dev)

    out = torch.zeros(B, S, Hq, D, dtype=torch.bfloat16)
    out[..., :1] = 1.0
    g_lse = torch.full((B, Hq, S), 0.25)
    lse = torch.zeros(B, Hq, S)
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfa, "_run", run)
        tfa.flash_attention_bwd(q, k, v, out, lse, out, g_lse)
    (dq, a), (dkv, b) = launches
    assert (dq, dkv, a.D, b.D) == ("flash_bwd_dq", "flash_bwd_dkv", D, D)
    assert all((d == 0.75).all() for d in deltas) and len(deltas) == 2

    launches.clear()
    with torch.no_grad():
        tfa._launch_tri("flash_fwd_tri", q, k, v, scale=D ** -0.5)
        kw = dict(scale=D ** -0.5, dout=dout, lse=lse, delta=lse)
        tfa._launch_tri("flash_bwd_dq_tri", q, k, v, **kw)
        tfa._launch_tri("flash_bwd_dkv_tri", q, k, v, **kw)
    entries = ["flash_fwd_tri", "flash_bwd_dq_tri", "flash_bwd_dkv_tri"]
    assert [kernel for kernel, _ in launches] == entries
    assert tri_grid == [(kernel, D) for kernel in entries]
    for kernel, a in launches:
        assert (a.D, a.act_dtype, a.ctas) == (D, 1, 264)
        assert a.ws_floats == 264 * 4 * 64 * D
        assert _cuda.entry(kernel, D) == kernel + "_narrow"
        assert _cuda.ENTRIES[kernel + "_narrow"][0] == "flash_tri_narrow"
        assert _cuda.entry(kernel, 64) == kernel
    assert _cuda.entry("flash_bwd_dq", D) == "flash_bwd_dq"
    assert _cuda.entry("flash_bwd_dkv", D) == "flash_bwd_dkv"
