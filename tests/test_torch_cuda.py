"""The CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode: every test here takes the ``dev`` fixture,
which skips without a card (the plain versions are held against the JAX
package in tests/test_torch_flash.py). Run on a machine with an H100:
``python -m pytest tests/test_torch_cuda.py -q``. Tolerances: f32 1e-4
absolute (the kernel sums tiles in another order), bf16 1e-2 absolute (one
bf16 rounding of the output; the largest error seen on an H100 was 3.9e-3).
The backward kernels are held to the same bounds relative to the largest
plain gradient (max|kernel - plain| / max|plain|), since gradients scale
with S and the cotangents. The flattened-triangle kernels (flash_tri.cu)
are held to the same bounds at shapes where the persistent grid has more
CTAs than tiles, rows are cut into many pieces, and many rows lie whole in
one CTA's share, and at ragged S. In bf16 every self-attention kernel and
the bf16-cache forward run on the tensor cores (P as bf16 hi + lo in the
forward, P and dS each rounded to bf16 once in the backward: within 5e-3 of
the f32 functions on the CPU replay, tests/test_torch_flash_tri.py and
tests/test_torch_flash_tc.py); their cases add ragged S, windows with sinks
and pads, per-row starts, GQA 4/1, strided inputs and a misaligned one that
a direct launch refuses. Every kernel runs at head dims 16, 32, 64, 80,
96 and 128 (HEAD_DIMS): the forward, cached and decode kernels at each,
the backward and triangle kernels at 128 and in the ``*_at_head_dim_64``,
``*_at_head_dims_32_and_16`` and ``*_at_head_dims_96_and_80`` tests, and
autograd through them at 80 and 96
(``test_head_dims_80_and_96_serve_and_refuse_training``, which refuses
head dim 100 before any launch).
"""

import ctypes
import dataclasses
import functools

import numpy as np
import pytest
import torch

from gpu_provisioner_tpu_torch.models import checkpoint as tck
from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.models import engine as te
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import moe as tm
from gpu_provisioner_tpu_torch.models import moe_serve as tms
from gpu_provisioner_tpu_torch.models import speculative as tspec
from gpu_provisioner_tpu_torch.models import train as ttrain
from gpu_provisioner_tpu_torch.ops import _cuda
from gpu_provisioner_tpu_torch.ops import flash_attention as tfa
from gpu_provisioner_tpu_torch.parallel import jobs, launch

# the split decode schedule's edge cases, as chip_smoke.py runs them
from chip_smoke import DECODE_SPLIT_CASES

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the head dims of every kernel
HEAD_DIMS = [16, 32, 64, 80, 96, 128]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, *shape, dtype, dev):
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _rel(a, b):
    return _err(a, b) / b.float().abs().max().item()


# (B, S, Hq, Hkv, causal, window) of the forward: shapes the wrapper takes
# (S tiles into the JAX blocks), then ragged S (a zero-filled last query and
# key tile) at GQA 4/1, through the launch itself (the wrapper gives such
# shapes the dense path), with a window 1024 that skips key tiles
FWD_CASES = [(2, 256, 8, 2, True, None), (2, 256, 8, 2, False, None),
             (2, 256, 8, 2, True, 200), (2, 512, 8, 2, True, None),
             (2, 512, 8, 2, False, None), (2, 512, 8, 2, True, 200),
             (1, 1000, 4, 1, True, None), (2, 333, 4, 1, False, None),
             (1, 1500, 4, 1, True, 1024)]


def _q_view(g, B, S, Hq, extra, dtype, dev, D=128):
    """q [B, S, Hq, D] as a view of rows Hq·D + extra wide: extra 8 keeps
    every stride a whole number of 16-byte chunks in bf16, extra 4 does
    not."""
    row = Hq * D + extra
    return _randn(g, B, S, row, dtype=dtype, dev=dev).as_strided(
        (B, S, Hq, D), (S * row, row, D, 1))


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window", FWD_CASES)
@pytest.mark.parametrize("layout", ["contiguous", "strided", "misaligned"])
def test_flash_fwd_matches_plain(dev, dtype, B, S, Hq, Hkv, causal, window,
                                 layout, D):
    """The forward (bf16: the tensor-core instance) against the plain
    version, at head dims 16, 32 (the D = 64 tile partly filled), 64, 80,
    96 (the D = 128 tile partly filled) and 128. q contiguous, a strided
    view the
    kernels take as it is, or a view whose row stride is no whole number
    of 16-byte chunks: a direct bf16 launch refuses it (ValueError),
    flash_attention_with_lse copies it (_tc_layout) and matches."""
    g = torch.Generator(dev).manual_seed(0)
    q = (_randn(g, B, S, Hq, D, dtype=dtype, dev=dev)
         if layout == "contiguous" else
         _q_view(g, B, S, Hq, 8 if layout == "strided" else 4, dtype, dev,
                 D))
    k = _randn(g, B, S, Hkv, D, dtype=dtype, dev=dev)
    v = _randn(g, B, S, Hkv, D, dtype=dtype, dev=dev)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    kw = dict(causal=causal, window=window)
    refused = layout == "misaligned" and dtype == torch.bfloat16
    tiles = S % tfa._auto_block(S) == 0
    if refused:
        with pytest.raises(ValueError, match="flash_fwd: q strides"):
            tfa._launch("flash_fwd", q, kh, vh, 0, scale=D ** -0.5,
                        want_lse=True, **kw)
    tfa.reset_launches()
    if tiles:
        out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
        assert tfa.LAUNCHES["flash_fwd"] == 1
    elif refused:
        return
    else:
        out, lse = tfa._launch("flash_fwd", q, kh, vh, 0, scale=D ** -0.5,
                               want_lse=True, **kw)
    ref, ref_lse = tfa.attention_plain(q, kh, vh, 0, **kw)
    torch.cuda.synchronize()
    assert _err(out, ref) < TOL[dtype]
    assert _err(lse, ref_lse) < 1e-4


CASES = [
    # (B, S, start, pads, int8, window, sinks); S > 16 is flash_fwd (bf16:
    # the tensor-core instance), per-row starts there through the launch
    # itself (flash_attention_cached takes one start), S <= 16 flash_decode
    (1, 128, 0, [40], False, None, 0),
    (2, 256, 300, [0, 100], True, None, 0),
    (1, 128, 900, None, False, 256, 4),
    (2, 1, [600, 37], [0, 20], False, None, 0),
    (2, 5, [1000, 130], [3, 0], True, 300, 2),
    (2, 16, 1500, None, False, None, 0),
    (2, 200, 400, [0, 37], False, 256, 4),       # ragged S, window, sinks
    (2, 100, [300, 1200], [5, 0], False, 512, 3),  # per-row starts
    (2, 100, [300, 1200], [5, 0], True, None, 0),
]


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,start,pads,int8,window,sinks", CASES)
def test_cache_kernels_match_plain(dev, dtype, B, S, start, pads, int8,
                                   window, sinks, D):
    g = torch.Generator(dev).manual_seed(1)
    Hq, Hkv, ML = 32, 8, 2048
    q = _randn(g, B, S, Hq, D, dtype=dtype, dev=dev)
    kc = _randn(g, B, Hkv, ML, D, dtype=dtype, dev=dev)
    vc = _randn(g, B, Hkv, ML, D, dtype=dtype, dev=dev)
    kw = dict(window=window, sinks=sinks)
    if int8:
        kc, kw["k_scale"] = td._quantize_kv(kc)
        vc, kw["v_scale"] = td._quantize_kv(vc)
    if pads is not None:
        kw["pad_lens"] = torch.tensor(pads, dtype=torch.int32, device=dev)
    st = torch.tensor(start, dtype=torch.int32, device=dev) \
        if isinstance(start, list) else start
    if S <= tfa.DECODE_MAX_S:
        got = tfa.flash_attention_decode(q, kc, vc, st, **kw)
    elif isinstance(start, list):
        got, _ = tfa._launch("flash_fwd", q, kc, vc, st, causal=True,
                             scale=D ** -0.5, **kw)
    else:
        got = tfa.flash_attention_cached(q, kc, vc, st, **kw)
    ref = tfa.attention_plain(q, kc, vc, st, **kw)[0]
    torch.cuda.synchronize()
    assert _err(got, ref) < TOL[dtype]


def _cache_inputs(g, dev, dtype, B, S, ML, int8, pads, Hq=32, Hkv=8,
                  D=128):
    q = _randn(g, B, S, Hq, D, dtype=dtype, dev=dev)
    kc = _randn(g, B, Hkv, ML, D, dtype=dtype, dev=dev)
    vc = _randn(g, B, Hkv, ML, D, dtype=dtype, dev=dev)
    kw = {}
    if int8:
        kc, kw["k_scale"] = td._quantize_kv(kc)
        vc, kw["v_scale"] = td._quantize_kv(vc)
    if pads is not None:
        kw["pad_lens"] = torch.tensor(pads, dtype=torch.int32, device=dev)
    return q, kc, vc, kw


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,S,start,pads,window,sinks", DECODE_SPLIT_CASES)
def test_decode_split_schedule_matches_plain(dev, dtype, int8, B, S, start,
                                             pads, window, sinks, D):
    """flash_decode's split schedule (the live tiles of each unit shared
    among the CTAs the host plans, partials merged by a second launch)
    against the plain version, at the edge cases of the shares, at head
    dims 16, 32, 64 (the block's 8, 4 or 2 row groups on interleaved
    rows), 80, 96 (one row group, D of the 128 threads owning a column)
    and 128; one count on the int8 or the other counter."""
    g = torch.Generator(dev).manual_seed(12)
    q, kc, vc, kw = _cache_inputs(g, dev, dtype, B, S, 2048, int8, pads,
                                  D=D)
    kw.update(window=window, sinks=sinks)
    st = torch.tensor(start, dtype=torch.int32, device=dev) \
        if isinstance(start, list) else start
    tfa.reset_launches()
    got = tfa.flash_attention_decode(q, kc, vc, st, **kw)
    assert tfa.LAUNCHES["flash_decode_int8" if int8 else "flash_decode"] == 1
    ref = tfa.attention_plain(q, kc, vc, st, **kw)[0]
    torch.cuda.synchronize()
    assert _err(got, ref) < TOL[dtype]


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("splits", [1, 3, 32])
def test_decode_takes_any_split_count(dev, monkeypatch, splits, D):
    """The same decode at a forced split count: one split (the kernel
    writes the output, no merge), three, and 32 (more CTAs than live
    tiles: most shares empty; at D = 16 the merge block is a whole warp of
    which 16 threads store), bf16 and int8, against the plain version."""
    monkeypatch.setattr(tfa, "_decode_splits", lambda *a: splits)
    g = torch.Generator(dev).manual_seed(13)
    st = torch.tensor([540, 300, 610, 20], dtype=torch.int32, device=dev)
    for int8 in (False, True):
        q, kc, vc, kw = _cache_inputs(g, dev, torch.bfloat16, 4, 1, 2048,
                                      int8, [12, 0, 100, 3], D=D)
        got = tfa.flash_attention_decode(q, kc, vc, st, **kw)
        ref = tfa.attention_plain(q, kc, vc, st, **kw)[0]
        torch.cuda.synchronize()
        assert _err(got, ref) < 1e-2


def test_decode_entry_refuses_a_short_workspace(dev):
    """flash_decode checks the workspace against its own plan: a split
    launch given fewer f32 values than units × splits × R × (D + 2), or none,
    returns cudaErrorInvalidValue (1) before it launches anything."""
    q = torch.zeros(4, 1, 32, 128, device=dev)
    kc = torch.zeros(4, 8, 2048, 128, device=dev)
    ws = torch.empty(32 * 9 * 4 * 130 - 1, device=dev)
    a = _cuda.FlashArgs()
    a.q, a.k, a.v, a.out = (q.data_ptr(), kc.data_ptr(), kc.data_ptr(),
                            q.data_ptr())
    a.q_sb, a.q_ss, a.q_sh = q.stride()[:3]
    a.k_sb, a.k_sh, a.k_ss = kc.stride()[:3]
    a.v_sb, a.v_sh, a.v_ss = kc.stride()[:3]
    a.o_sb, a.o_ss, a.o_sh = q.stride()[:3]
    a.act_dtype, a.kv_dtype = 0, 0
    a.B, a.Sq, a.Sk, a.Hq, a.Hkv, a.D = 4, 1, 2048, 32, 8, 128
    a.start, a.n_start, a.causal, a.scale, a.splits = 100, 1, 1, 1.0, 9
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = _cuda.kernel("flash_decode")
    assert fn(ctypes.byref(a), stream) == 1
    a.ws, a.ws_floats = ws.data_ptr(), ws.numel()
    assert fn(ctypes.byref(a), stream) == 1
    a.splits = 33      # past DECODE_MAX_SPLITS
    assert fn(ctypes.byref(a), stream) == 1


# (B, S, start, pads, window, sinks) of the int8 cache's tensor-core prefill
# (flash_fwd on int8 tiles widened to bf16): start 0, pads, ragged S with a
# window and sinks, the serving row's shape, and per-row starts through the
# launch itself
INT8_FWD_CASES = [(1, 128, 0, [40], None, 0), (2, 256, 300, [0, 100], None, 0),
                  (2, 200, 400, [0, 37], 256, 4), (1, 256, 128, [28], None, 0),
                  (2, 100, [300, 1200], [5, 0], 512, 3)]


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("B,S,start,pads,window,sinks", INT8_FWD_CASES)
def test_int8_cache_prefill_on_the_tensor_cores_matches_plain(
        dev, B, S, start, pads, window, sinks, D):
    g = torch.Generator(dev).manual_seed(14)
    q, kc, vc, kw = _cache_inputs(g, dev, torch.bfloat16, B, S, 2048, True,
                                  pads, D=D)
    kw.update(window=window, sinks=sinks)
    if isinstance(start, list):
        st = torch.tensor(start, dtype=torch.int32, device=dev)
        got, _ = tfa._launch("flash_fwd", q, kc, vc, st, causal=True,
                             scale=D ** -0.5, **kw)
    else:
        st = start
        tfa.reset_launches()
        got = tfa.flash_attention_cached(q, kc, vc, st, **kw)
        assert tfa.LAUNCHES["flash_cached_int8"] == 1
    ref = tfa.attention_plain(q, kc, vc, st, **kw)[0]
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-2


def test_int8_cache_prefill_lays_out_a_misaligned_q(dev):
    """The int8 cache's tensor-core prefill copies q in 16-byte chunks: a
    bf16 q whose row stride is no whole number of them is refused by a
    direct launch and copied by flash_attention_cached, which matches."""
    g = torch.Generator(dev).manual_seed(15)
    S, Hq = 128, 32
    q = _q_view(g, 1, S, Hq, 4, torch.bfloat16, dev)
    _, kc, vc, kw = _cache_inputs(g, dev, torch.bfloat16, 1, 1, 2048, True,
                                  None)
    with pytest.raises(ValueError, match="flash_fwd: q strides"):
        tfa._launch("flash_fwd", q, kc, vc, 64, causal=True,
                    scale=128 ** -0.5, **kw)
    got = tfa.flash_attention_cached(q, kc, vc, 64, **kw)
    ref = tfa.attention_plain(q, kc, vc, 64, **kw)[0]
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-2


def test_decode_rows_beyond_one_block(dev):
    """group 8 x S 16 = 128 query rows per kv head: two row blocks (two
    units of 64 rows each)."""
    g = torch.Generator(dev).manual_seed(2)
    q = _randn(g, 1, 16, 16, 128, dtype=torch.float32, dev=dev)
    kc = _randn(g, 1, 2, 256, 128, dtype=torch.float32, dev=dev)
    vc = _randn(g, 1, 2, 256, 128, dtype=torch.float32, dev=dev)
    got = tfa.flash_attention_decode(q, kc, vc, 200)
    ref = tfa.attention_plain(q, kc, vc, 200)[0]
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-4


def test_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    """Head dims 64, 32 and 16 run the forward kernel and, through autograd,
    the backward kernels (their triangle twins with triangular=True), at
    32 and 16 held to their plain versions; 8 and 48 raise ValueError
    naming the head dim in the forward and in the backward, with no plain
    fallback and no launch; float16 raises TypeError."""
    g = torch.Generator(dev).manual_seed(16)
    for D in (16, 32):
        q, k, v = (_randn(g, 1, 128, h, D, dtype=torch.bfloat16, dev=dev)
                   .requires_grad_() for h in (4, 2, 2))
        dout = _randn(g, 1, 128, 4, D, dtype=torch.bfloat16, dev=dev)
        with torch.no_grad():
            ref, lse = tfa.attention_plain(q, k.transpose(1, 2),
                                           v.transpose(1, 2), 0)
            want = tfa.attention_bwd_plain(q, k, v, ref, lse, dout)
        for triangular in (False, True):
            tfa.reset_launches()
            out = tfa.flash_attention(q, k, v, triangular=triangular)
            got = torch.autograd.grad(out, (q, k, v), dout)
            torch.cuda.synchronize()
            bwd = ("flash_bwd_dq_tri", "flash_bwd_dkv_tri") if triangular \
                else ("flash_bwd_dq", "flash_bwd_dkv")
            assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {
                "flash_fwd": 1, bwd[0]: 1, bwd[1]: 1}
            assert _err(out, ref) < TOL[torch.bfloat16]
            for a, b in zip(got, want):
                assert _rel(a, b) < TOL[torch.bfloat16]
    tfa.reset_launches()
    for D in (8, 48):
        q = torch.zeros(1, 128, 4, D, device=dev)
        lse = torch.zeros(1, 4, 128, device=dev)
        for triangular in (False, True):
            with pytest.raises(ValueError, match=f"head dim {D}"):
                tfa.flash_attention_bwd(q, q[:, :, :2], q[:, :, :2], q, lse,
                                        q, triangular=triangular)
    assert not any(tfa.LAUNCHES.values())
    for D in (8, 48):
        q = torch.zeros(1, 128, 4, D, device=dev)
        with pytest.raises(ValueError, match=f"head dim {D}"):
            tfa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    for triangular in (False, True):
        q = torch.zeros(1, 128, 4, 64, device=dev, requires_grad=True)
        tfa.reset_launches()
        out = tfa.flash_attention(q, q[:, :, :2], q[:, :, :2],
                                  triangular=triangular)
        out.sum().backward()
        torch.cuda.synchronize()
        bwd = ("flash_bwd_dq_tri", "flash_bwd_dkv_tri") if triangular \
            else ("flash_bwd_dq", "flash_bwd_dkv")
        assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {
            "flash_fwd": 1, bwd[0]: 1, bwd[1]: 1}
        assert bool(torch.isfinite(q.grad).all())
    q = torch.zeros(1, 128, 4, 128, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(q, q[:, :, :2], q[:, :, :2])


@pytest.mark.parametrize("D", [80, 96])
def test_head_dims_80_and_96_serve_and_refuse_training(dev, D):
    """At head dims 80 and 96 the self-attention forward runs its kernel
    under no_grad (one flash_fwd launch, within 1e-2 of the plain version
    in bf16), and so does a training call: autograd through
    flash_attention, rectangular and with triangular=True, launches the
    forward and both backward kernels (their triangle twins), within 1e-2
    of the plain gradients; at head dim 100 (which no kernel takes) a
    forward that requires grad, triangular=True and the backward
    (rectangular and triangle) raise ValueError naming it before any
    launch."""
    g = torch.Generator(dev).manual_seed(17)
    q, k, v = (_randn(g, 1, 256, h, D, dtype=torch.bfloat16, dev=dev)
               for h in (4, 2, 2))
    dout = _randn(g, 1, 256, 4, D, dtype=torch.bfloat16, dev=dev)
    tfa.reset_launches()
    with torch.no_grad():
        out = tfa.flash_attention(q.clone().requires_grad_(), k, v)
    ref, lse = tfa.attention_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                                   0)
    torch.cuda.synchronize()
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {"flash_fwd": 1}
    assert _err(out, ref) < TOL[torch.bfloat16]
    want = tfa.attention_bwd_plain(q, k, v, ref, lse, dout)
    for triangular, bwd in ((False, ("flash_bwd_dq", "flash_bwd_dkv")),
                            (True, ("flash_bwd_dq_tri", "flash_bwd_dkv_tri"))):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        tfa.reset_launches()
        got = torch.autograd.grad(
            tfa.flash_attention(*leaves, triangular=triangular), leaves, dout)
        torch.cuda.synchronize()
        assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {
            "flash_fwd": 1, **dict.fromkeys(bwd, 1)}
        for a, b in zip(got, want):
            assert _rel(a, b) < TOL[torch.bfloat16]
    q, k, v = (_randn(g, 1, 256, h, 100, dtype=torch.bfloat16, dev=dev)
               for h in (4, 2, 2))
    lse = torch.zeros(1, 4, 256, device=dev)
    tfa.reset_launches()
    for fn in (lambda: tfa.flash_attention(q.clone().requires_grad_(), k, v),
               lambda: tfa.flash_attention(q, k, v, triangular=True),
               lambda: tfa.flash_attention_bwd(q, k, v, q, lse, q),
               lambda: tfa.flash_attention_bwd(q, k, v, q, lse, q,
                                               triangular=True)):
        with pytest.raises(ValueError, match="head dim 100"):
            fn()
    assert not any(tfa.LAUNCHES.values())


def test_engine_streams_equal_generate_on_the_card(dev):
    cfg = tl.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4,
                         n_kv_heads=2, hidden_dim=1024, dtype="float32",
                         attn_impl="flash")
    params = tl.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, 512, (n,), generator=g).tolist()
               for n in (100, 60, 120)]
    eng = te.ServeEngine(params, cfg, slots=2, max_len=512,
                         prefill_buckets=(128,))
    ids = [eng.submit(p, 6) for p in prompts]
    out = eng.run()
    for rid, p in zip(ids, prompts):
        want = td.generate(params, torch.tensor([p]), cfg, max_new_tokens=6,
                           max_len=512)
        assert out[rid] == want[0].tolist()


def _spec_models(dev):
    """A target and a draft at head dim 128 (the kernels'), f32, flash."""
    cfg = tl.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4,
                         n_kv_heads=2, hidden_dim=1024, dtype="float32",
                         attn_impl="flash")
    dcfg = dataclasses.replace(cfg, dim=256, n_layers=1, n_heads=2,
                               n_kv_heads=1, hidden_dim=512)
    return (cfg, tl.init_params(cfg, torch.Generator(dev).manual_seed(0), dev),
            dcfg, tl.init_params(dcfg, torch.Generator(dev).manual_seed(1),
                                 dev))


def test_speculative_flash_equals_dense_and_generate_on_the_card(dev):
    """Greedy speculation on a ragged pad_id batch: the flash kernels and
    the dense path give the same tokens, and both plain generate()'s."""
    cfg, params, dcfg, draft = _spec_models(dev)
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(1, 512, (3, 128), generator=g)
    prompt[1, :40] = 0
    prompt[2, :100] = 0
    kw = dict(max_new_tokens=12, spec_k=4, max_len=256, pad_id=0)
    flash = tspec.speculative_generate(params, draft, prompt, cfg, dcfg,
                                       **kw)[0]
    dense = tspec.speculative_generate(
        params, draft, prompt, dataclasses.replace(cfg, attn_impl="dense"),
        dataclasses.replace(dcfg, attn_impl="dense"), **kw)[0]
    want = td.generate(params, prompt, cfg, max_new_tokens=12, max_len=256,
                       pad_id=0)
    assert torch.equal(flash, dense)
    assert torch.equal(flash, want)


@pytest.mark.parametrize("spec_k", [4, 15])
def test_speculative_verify_blocks_launch_flash_decode(dev, spec_k):
    """Every round: spec_k + 1 draft steps and one verify block of spec_k +
    1 queries, each a flash_decode launch a layer; the fresh prefill of
    both models one flash_fwd a layer."""
    cfg, params, dcfg, draft = _spec_models(dev)
    prompt = torch.randint(1, 512, (2, 128),
                           generator=torch.Generator().manual_seed(3))
    tfa.reset_launches()
    _, st = tspec.speculative_generate(params, draft, prompt, cfg, dcfg,
                                       max_new_tokens=10, spec_k=spec_k,
                                       max_len=256)
    rounds = st["target_calls"] - 1
    assert rounds >= 1
    assert tfa.LAUNCHES["flash_fwd"] == cfg.n_layers + dcfg.n_layers
    assert tfa.LAUNCHES["flash_decode"] == rounds * (
        cfg.n_layers + dcfg.n_layers * (spec_k + 1))
    assert tfa.LAUNCHES["flash_cached"] == 0


@pytest.mark.parametrize("case", ["random", "ties", "overflow"])
def test_route_on_the_card_equals_the_cpu(dev, case):
    """MoE routing on the card: the same dispatch (the stable sort keeps
    lax.top_k's tie order on both) and combine within 1e-6."""
    g = torch.Generator().manual_seed(5)
    B, S, E = 2, 64, 8
    logits = torch.randn(B, S, E, generator=g)
    if case == "ties":
        logits[:, ::2] = 0.0
        logits[:, 1::4, 3:5] = 9.0
    cap = tm.capacity(tm.PRESETS_MOE["mixtral-ish"], S)
    if case == "overflow":
        logits[..., 6] += 3.0
    mask = torch.ones(B, S, dtype=torch.bool)
    mask[1, :10] = False
    cpu = tm.route(logits, 2, cap, token_mask=mask)
    card = tm.route(logits.to(dev), 2, cap, token_mask=mask.to(dev))
    assert torch.equal(card[0].cpu(), cpu[0])
    assert _err(card[1].cpu(), cpu[1]) <= 1e-6
    if case == "overflow":
        assert float(cpu[0].sum()) < B * S * 2 - 20


def test_moe_cached_forward_flash_equals_dense_on_the_card(dev):
    """mixtral-ish width, 2 layers, f32: a left-padded prefill (the cached
    kernel), then decode steps (the decode kernel), flash against dense."""
    cfg = dataclasses.replace(tm.PRESETS_MOE["mixtral-ish"], n_layers=2,
                              dtype="float32")
    params = tm.init_moe_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (2, 256), generator=g).to(dev)
    pads = torch.tensor([0, 70], dtype=torch.int32, device=dev)
    logits = {}
    tfa.reset_launches()
    for impl in ("dense", "flash"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        cache = td.init_kv_cache(c, 2, 512, dev)
        lg, cache = tms.moe_cached_forward(params, prompt, cache, c,
                                           pad_lens=pads)
        steps = [lg[:, -1]]
        for i in range(3):
            lg, cache = tms.moe_cached_forward(params, prompt[:, i:i + 1],
                                               cache, c, pad_lens=pads)
            steps.append(lg[:, 0])
        logits[impl] = torch.stack(steps)
    assert tfa.LAUNCHES["flash_cached"] == 2
    assert tfa.LAUNCHES["flash_decode"] == 6
    assert _err(logits["flash"], logits["dense"]) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Hq,kv_heads", [(256, 8, 2), (512, 8, 8),
                                           (333, 4, 1), (1000, 8, 2)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 200), (False, 200)])
def test_flash_bwd_matches_plain(dev, dtype, S, Hq, kv_heads, causal,
                                 window):
    """Both backward kernels (bf16: on the tensor cores) against the plain
    version, with an lse cotangent; ragged S (333, 1000: the forward takes
    the dense path there, the backward kernels a zero-filled last tile) at
    GQA 4/1."""
    g = torch.Generator(dev).manual_seed(3)
    q = _randn(g, 2, S, Hq, 128, dtype=dtype, dev=dev)
    k = _randn(g, 2, S, kv_heads, 128, dtype=dtype, dev=dev)
    v = _randn(g, 2, S, kv_heads, 128, dtype=dtype, dev=dev)
    dout = _randn(g, 2, S, Hq, 128, dtype=dtype, dev=dev)
    g_lse = _randn(g, 2, Hq, S, dtype=torch.float32, dev=dev)
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal,
                                            window=window)
    kw = dict(causal=causal, window=window)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, g_lse, **kw)
    want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel(a, b) < TOL[dtype]


# (B, S, Hq, Hkv, causal, window) of the bf16 dK/dV kernel on the tensor
# cores beyond test_flash_bwd_matches_plain's: ragged S (a zero-filled last
# key and query tile) at GQA 4/1 and 4/2, window 1024 (the band cuts tiles),
# non-causal with a window
DKV_CASES = [(1, 1000, 4, 1, True, None), (2, 333, 8, 2, False, None),
             (1, 2048, 8, 2, True, 1024), (1, 1500, 4, 1, False, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window", DKV_CASES)
def test_flash_bwd_dkv_matches_plain(dev, dtype, B, S, Hq, Hkv, causal,
                                     window):
    g = torch.Generator(dev).manual_seed(9)
    q = _randn(g, B, S, Hq, 128, dtype=dtype, dev=dev)
    k = _randn(g, B, S, Hkv, 128, dtype=dtype, dev=dev)
    v = _randn(g, B, S, Hkv, 128, dtype=dtype, dev=dev)
    dout = _randn(g, B, S, Hq, 128, dtype=dtype, dev=dev)
    g_lse = _randn(g, B, Hq, S, dtype=torch.float32, dev=dev)
    kw = dict(causal=causal, window=window)
    out, lse = tfa.attention_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                                   0, **kw)
    delta = tfa._bwd_delta(out, dout, g_lse).contiguous()
    got = tfa._launch_bwd("flash_bwd_dkv", q, k, v, dout, lse, delta,
                          scale=128 ** -0.5, **kw)
    want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse, **kw)[1:]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel(a, b) < TOL[dtype]


# (B, S, Hq, Hkv, causal, window) of #6/#7 at head dim 64: the fast
# bench_train_step model's heads at its length, ragged S at GQA 4/1 with
# an lse cotangent, non-causal, a window that skips tiles
BWD_D64_CASES = [(4, 512, 8, 4, True, None), (1, 1000, 4, 1, True, None),
                 (2, 333, 8, 2, False, None), (1, 2048, 8, 2, True, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window", BWD_D64_CASES)
def test_flash_bwd_matches_plain_at_head_dim_64(dev, dtype, B, S, Hq, Hkv,
                                                causal, window):
    """flash_bwd_dq and flash_bwd_dkv at head dim 64 (bf16: one-atom tiles
    on the tensor cores) against attention_bwd_plain, with an lse
    cotangent, from the plain forward's out and lse."""
    _bwd_against_plain(dev, dtype, B, S, Hq, Hkv, causal, window, 64, 10)


def _bwd_against_plain(dev, dtype, B, S, Hq, Hkv, causal, window, D, seed):
    """flash_attention_bwd (one launch of each backward kernel) against
    attention_bwd_plain at head dim D, with an lse cotangent, from the
    plain forward's out and lse."""
    g = torch.Generator(dev).manual_seed(seed)
    q, dout = (_randn(g, B, S, Hq, D, dtype=dtype, dev=dev)
               for _ in range(2))
    k, v = (_randn(g, B, S, Hkv, D, dtype=dtype, dev=dev) for _ in range(2))
    g_lse = _randn(g, B, Hq, S, dtype=torch.float32, dev=dev)
    kw = dict(causal=causal, window=window)
    out, lse = tfa.attention_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                                   0, **kw)
    tfa.reset_launches()
    got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, g_lse, **kw)
    want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse, **kw)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_bwd_dq"] == tfa.LAUNCHES["flash_bwd_dkv"] == 1
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel(a, b) < TOL[dtype]


# (B, S, Hq, Hkv, causal, window) of #6/#7 at head dims 32 and 16: the fast
# bench_engine model's 8/4 heads and tiny's 4/2 at (2, 256) causal, not
# causal and with a window of 100, and ragged S at GQA 4/1
BWD_SMALL_CASES = [(2, 256, 8, 4, True, None), (2, 256, 8, 4, False, None),
                   (2, 256, 4, 2, True, 100), (1, 333, 4, 1, True, None)]


@pytest.mark.parametrize("D", [32, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window", BWD_SMALL_CASES)
def test_flash_bwd_matches_plain_at_head_dims_32_and_16(
        dev, dtype, B, S, Hq, Hkv, causal, window, D):
    """flash_bwd_dq and flash_bwd_dkv at head dims 32 and 16 (bf16: the D =
    64 atom partly filled, its other chunks zeroed once) against
    attention_bwd_plain, with an lse cotangent, from the plain forward's
    out and lse."""
    _bwd_against_plain(dev, dtype, B, S, Hq, Hkv, causal, window, D, 11)


# (B, S, Hq, Hkv, causal, window) of #6/#7 at head dims 96 and 80:
# Phi-3-mini's 32/32 heads and H2O-Danube-1.8B's 32/8 causal, non-causal
# and with a window of 100, and ragged S at GQA 4/1
BWD_MID_CASES = [(1, 512, 32, 32, True, None), (1, 512, 32, 8, False, None),
                 (2, 256, 32, 8, True, 100), (1, 333, 4, 1, True, None)]


@pytest.mark.parametrize("D", [96, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window", BWD_MID_CASES)
def test_flash_bwd_matches_plain_at_head_dims_96_and_80(
        dev, dtype, B, S, Hq, Hkv, causal, window, D):
    """flash_bwd_dq and flash_bwd_dkv at head dims 96 and 80 (bf16: D =
    128's two atoms, the second partly filled and its pad zeroed once)
    against attention_bwd_plain, with an lse cotangent, from the plain
    forward's out and lse."""
    _bwd_against_plain(dev, dtype, B, S, Hq, Hkv, causal, window, D, 12)


@pytest.mark.parametrize("triangular", [False, True])
def test_backward_takes_a_cotangent_through_torch_cat(dev, triangular):
    """flash_attention's bf16 output through torch.cat beside a 12-wide
    piece: autograd hands the backward a cotangent with head stride 140,
    which the tensor-core kernels refuse; the backward copies it and the
    kernels' gradients match attention_bwd_plain (triangular=True takes
    the tri backward here; the default path the rectangular kernels)."""
    g = torch.Generator(dev).manual_seed(10)
    S, bf = 1024, torch.bfloat16
    q, k, v = (_randn(g, 1, S, h, 128, dtype=bf, dev=dev).requires_grad_()
               for h in (8, 2, 2))
    dout = _randn(g, 1, S, 8, 128, dtype=bf, dev=dev)
    extra = _randn(g, 1, S, 8, 12, dtype=bf, dev=dev)
    tfa.reset_launches()
    out = tfa.flash_attention(q, k, v, triangular=triangular)
    got = torch.autograd.grad(torch.cat([out, extra], -1), (q, k, v),
                              torch.cat([dout, extra], -1))
    torch.cuda.synchronize()
    bwd = ("flash_bwd_dq_tri", "flash_bwd_dkv_tri") if triangular \
        else ("flash_bwd_dq", "flash_bwd_dkv")
    assert all(tfa.LAUNCHES[n] == 1 for n in bwd)
    with torch.no_grad():
        ref, lse = tfa.attention_plain(q, k.transpose(1, 2),
                                       v.transpose(1, 2), 0)
        want = tfa.attention_bwd_plain(q, k, v, ref, lse, dout)
    for a, b in zip(got, want):
        assert _rel(a, b) < TOL[bf]


def test_autograd_runs_the_backward_kernels(dev):
    g = torch.Generator(dev).manual_seed(4)
    q, k, v = (_randn(g, 1, 256, h, 128, dtype=torch.float32, dev=dev)
               .requires_grad_() for h in (4, 2, 2))
    dout = _randn(g, 1, 256, 4, 128, dtype=torch.float32, dev=dev)
    tfa.reset_launches()
    got = torch.autograd.grad(tfa.flash_attention(q, k, v), (q, k, v), dout)
    assert tfa.LAUNCHES["flash_bwd_dq"] == tfa.LAUNCHES["flash_bwd_dkv"] == 1
    out, lse = tfa.attention_plain(q, k.transpose(1, 2), v.transpose(1, 2), 0)
    want = tfa.attention_bwd_plain(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-4


def test_bwd_raises_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 128, 4, 48, device=dev)
    lse = torch.zeros(1, 4, 128, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_bwd(q, q[:, :, :2], q[:, :, :2], q, lse, q)
    q = torch.zeros(1, 128, 4, 128, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._launch_bwd("flash_bwd_dq", q, q[:, :, :2], q[:, :, :2], q,
                        lse.transpose(1, 2).contiguous().transpose(1, 2),
                        lse, causal=True, scale=1.0)
    # the bf16 dQ copies 16-byte chunks: a dout off a 16-byte boundary
    qb = q.bfloat16()
    dout = torch.zeros(128 * 4 * 128 + 4, dtype=torch.bfloat16,
                       device=dev)[4:].view(1, 128, 4, 128)
    with pytest.raises(ValueError, match="flash_bwd_dq: dout is not"):
        tfa._launch_bwd("flash_bwd_dq", qb, qb[:, :, :2], qb[:, :, :2],
                        dout, lse, lse, causal=True, scale=1.0)


def test_flash_training_equals_dense_training_on_the_card(dev):
    cfg = tl.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2,
                         n_kv_heads=1, hidden_dim=512, dtype="float32")
    g = torch.Generator().manual_seed(5)
    inp = torch.randint(0, 512, (2, 256), generator=g).to(dev)
    tgt = torch.randint(0, 512, (2, 256), generator=g).to(dev)
    losses, grads = [], []
    for impl in ("flash", "dense"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        params, _ = ttrain.make_train_state(
            c, torch.Generator(dev).manual_seed(0), dev)
        loss = ttrain.loss_fn(params, inp, tgt, c)
        losses.append(loss.item())
        grads.append(torch.autograd.grad(loss, ttrain.param_leaves(params)))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    for a, b in zip(*grads):
        assert _err(a, b) <= 1e-4 * b.abs().max().item()


# a card-sized model for the training-state tests: head dim 128 (the
# kernels'), 2 layers, f32
CKPT_CFG = tl.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2,
                          n_kv_heads=1, hidden_dim=512, dtype="float32",
                          attn_impl="flash")
BF16_MU = functools.partial(ttrain.default_optimizer, mu_dtype=torch.bfloat16)


def _ckpt_batch(dev, seed):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, 512, (2, 257), generator=g).to(dev)
    return toks[:, :-1], toks[:, 1:]


def _ckpt_leaves(params, opt):
    out, tree = {}, {"params": params,
                     "opt_state": tck.adam_state_tree(params, opt)}
    stack = [("", tree)]
    while stack:
        prefix, t = stack.pop()
        for k, v in t.items():
            if isinstance(v, dict):
                stack.append((f"{prefix}{k}/", v))
            else:
                out[f"{prefix}{k}"] = v.detach().cpu().clone()
    return out


def _same(a, b):
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A bf16-mu state trained a step on the card, saved and restored onto
    the card: every leaf equal, the next step's loss bitwise equal."""
    params, opt = ttrain.make_train_state(
        CKPT_CFG, torch.Generator(dev).manual_seed(0), dev, optimizer=BF16_MU)
    step = ttrain.make_train_step(CKPT_CFG, opt)
    step(params, *_ckpt_batch(dev, 1))
    tck.save_train_state(tmp_path / "ckpt", params, opt, 1)
    r_params, r_opt, n = tck.restore_train_state(tmp_path / "ckpt", CKPT_CFG,
                                                 BF16_MU, device=dev)
    assert n == 1 and r_params["embed"].is_cuda
    assert _same(_ckpt_leaves(r_params, r_opt), _ckpt_leaves(params, opt))
    r_loss = ttrain.make_train_step(CKPT_CFG, r_opt)(
        r_params, *_ckpt_batch(dev, 2)).item()
    assert r_loss == step(params, *_ckpt_batch(dev, 2)).item()


def test_checkpoint_restores_from_the_card_onto_the_cpu(dev, tmp_path):
    params, opt = ttrain.make_train_state(
        CKPT_CFG, torch.Generator(dev).manual_seed(0), dev)
    ttrain.make_train_step(CKPT_CFG, opt)(params, *_ckpt_batch(dev, 3))
    tck.save_train_state(tmp_path / "ckpt", params, opt, 1)
    c_params, c_opt, n = tck.restore_train_state(tmp_path / "ckpt",
                                                 CKPT_CFG,
                                                 ttrain.default_optimizer,
                                                 device="cpu")
    assert n == 1 and c_params["embed"].device.type == "cpu"
    assert _same(_ckpt_leaves(c_params, c_opt), _ckpt_leaves(params, opt))


def test_bf16_mu_step_on_the_card_equals_the_cpu_step(dev):
    """One AdamWMu step from the same f32 params and gradients on the card
    and on the CPU: mu (bf16) within one bf16 ulp, nu and params at the f32
    tolerance (the card's foreach kernels round apart from the CPU's)."""
    g = torch.Generator().manual_seed(4)
    params = [torch.randn(64, 128, generator=g) for _ in range(3)]
    grads = [torch.randn(64, 128, generator=g) * 1e-2 for _ in range(3)]
    out = []
    for d in ("cpu", dev):
        leaves = [p.to(d, copy=True).requires_grad_() for p in params]
        opt = ttrain.default_optimizer(leaves, mu_dtype=torch.bfloat16)
        for _ in range(2):
            for p, gr in zip(leaves, grads):
                p.grad = gr.to(d)
            opt.step()
        out.append([(p.detach().cpu(), opt.state[p]["exp_avg"].cpu(),
                     opt.state[p]["exp_avg_sq"].cpu()) for p in leaves])
    for (p0, m0, v0), (p1, m1, v1) in zip(*out):
        assert m1.dtype == torch.bfloat16
        ulp = torch.ldexp(torch.ones_like(m0.float()),
                          torch.frexp(m0.float())[1] - 8)
        assert ((m1.float() - m0.float()).abs() <= ulp).all()
        torch.testing.assert_close(v1, v0, atol=1e-6, rtol=0)
        torch.testing.assert_close(p1, p0, atol=1e-6, rtol=0)


# (B, S, Hq, Hkv, lse cotangent): W < P with every row cut (S 128, 384,
# and 1000 at Hq 1: 136 tiles, each its own share at P 264 and 396, rows of
# up to 16 pieces), whole rows beside cut ones (S 2048); ragged S (1000,
# 200, 333) at GQA groups 4, 1 and 2 (the tensor-core kernels' zero-filled
# copies and masked last tile)
TRI_CASES = [(1, 128, 1, 1, False), (1, 384, 2, 1, True),
             (2, 2048, 16, 8, False), (1, 1000, 1, 1, False),
             (1, 1000, 4, 1, False), (2, 200, 8, 8, True),
             (1, 333, 4, 2, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,cot", TRI_CASES)
def test_tri_kernels_match_plain(dev, dtype, B, S, Hq, Hkv, cot):
    g = torch.Generator(dev).manual_seed(6)
    q = _randn(g, B, S, Hq, 128, dtype=dtype, dev=dev)
    k = _randn(g, B, S, Hkv, 128, dtype=dtype, dev=dev)
    v = _randn(g, B, S, Hkv, 128, dtype=dtype, dev=dev)
    dout = _randn(g, B, S, Hq, 128, dtype=dtype, dev=dev)
    g_lse = _randn(g, B, Hq, S, dtype=torch.float32, dev=dev) if cot else None
    scale = 128 ** -0.5
    out, lse = tfa._launch_tri("flash_fwd_tri", q, k, v, scale=scale)
    ref, ref_lse = tfa.attention_plain(q, k.transpose(1, 2),
                                       v.transpose(1, 2), 0)
    delta = tfa._bwd_delta(out, dout, g_lse).contiguous()
    kw = dict(scale=scale, dout=dout, lse=lse, delta=delta)
    dq = tfa._launch_tri("flash_bwd_dq_tri", q, k, v, **kw)
    dk, dv = tfa._launch_tri("flash_bwd_dkv_tri", q, k, v, **kw)
    want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse)
    torch.cuda.synchronize()
    assert _err(out, ref) < TOL[dtype]
    assert _err(lse, ref_lse) < 1e-4
    for a, b in zip((dq, dk, dv), want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel(a, b) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,cot", TRI_CASES)
def test_tri_kernels_match_plain_at_head_dim_64(dev, dtype, B, S, Hq, Hkv,
                                                cot):
    """The three tri kernels at head dim 64 (bf16: one-atom tiles; the
    workspace's cut rows D / 8 float pairs a thread) at TRI_CASES."""
    _tri_against_plain(dev, dtype, B, S, Hq, Hkv, cot, 64, 16)


def _tri_against_plain(dev, dtype, B, S, Hq, Hkv, cot, D, seed):
    """The three tri kernels, called directly, against the plain versions
    at head dim D, with an lse cotangent where ``cot``."""
    g = torch.Generator(dev).manual_seed(seed)
    q, dout = (_randn(g, B, S, Hq, D, dtype=dtype, dev=dev)
               for _ in range(2))
    k, v = (_randn(g, B, S, Hkv, D, dtype=dtype, dev=dev) for _ in range(2))
    g_lse = _randn(g, B, Hq, S, dtype=torch.float32, dev=dev) if cot else None
    out, lse = tfa._launch_tri("flash_fwd_tri", q, k, v, scale=D ** -0.5)
    ref, ref_lse = tfa.attention_plain(q, k.transpose(1, 2),
                                       v.transpose(1, 2), 0)
    delta = tfa._bwd_delta(out, dout, g_lse).contiguous()
    kw = dict(scale=D ** -0.5, dout=dout, lse=lse, delta=delta)
    dq = tfa._launch_tri("flash_bwd_dq_tri", q, k, v, **kw)
    dk, dv = tfa._launch_tri("flash_bwd_dkv_tri", q, k, v, **kw)
    want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse)
    torch.cuda.synchronize()
    assert _err(out, ref) < TOL[dtype]
    assert _err(lse, ref_lse) < 1e-4
    for a, b in zip((dq, dk, dv), want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel(a, b) < TOL[dtype]


@pytest.mark.parametrize("D", [32, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,cot", TRI_CASES)
def test_tri_kernels_match_plain_at_head_dims_32_and_16(dev, dtype, B, S, Hq,
                                                        Hkv, cot, D):
    """The three tri kernels at head dims 32 and 16 (bf16: the D = 64 atom
    partly filled, zeroed once a CTA; the cut rows' partials D columns) at
    TRI_CASES."""
    _tri_against_plain(dev, dtype, B, S, Hq, Hkv, cot, D, 17)


@pytest.mark.parametrize("D", [96, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,cot", TRI_CASES)
def test_tri_kernels_match_plain_at_head_dims_96_and_80(dev, dtype, B, S, Hq,
                                                        Hkv, cot, D):
    """The three tri kernels at head dims 96 and 80 (bf16: D = 128's two
    atoms, the second partly filled and zeroed once a CTA; the cut rows'
    partials D columns) at TRI_CASES."""
    _tri_against_plain(dev, dtype, B, S, Hq, Hkv, cot, D, 18)


def test_triangular_autograd_launches_where_tri_dispatch_says(dev):
    """S=16384 bf16 (past the resident budget): the tri forward and both
    tri backward kernels, once each, no rectangular launch; S=4096: the
    rectangular forward, the tri backward."""
    g = torch.Generator(dev).manual_seed(7)
    for S, fwd in ((16384, "flash_fwd_tri"), (4096, "flash_fwd")):
        q, k, v = (_randn(g, 1, S, h, 128, dtype=torch.bfloat16, dev=dev)
                   .requires_grad_() for h in (2, 1, 1))
        dout = _randn(g, 1, S, 2, 128, dtype=torch.bfloat16, dev=dev)
        tfa.reset_launches()
        got = torch.autograd.grad(tfa.flash_attention(q, k, v,
                                                      triangular=True),
                                  (q, k, v), dout)
        torch.cuda.synchronize()
        want = {fwd: 1, "flash_bwd_dq_tri": 1, "flash_bwd_dkv_tri": 1}
        assert {n: c for n, c in tfa.LAUNCHES.items() if c} == want
        ref = torch.autograd.grad(tfa.flash_attention(q, k, v), (q, k, v),
                                  dout)
        for a, b in zip(got, ref):
            assert _rel(a, b) < 2e-2


def test_tri_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 128, 4, 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tfa._launch_tri("flash_fwd_tri", q, q[:, :, :2], q[:, :, :2],
                        scale=1.0)
    q = torch.zeros(1, 128, 4, 128, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._launch_tri("flash_fwd_tri", q, q[:, :, :2], q[:, :, :2],
                        scale=1.0)
    q = torch.zeros(1, 128, 4, 128, device=dev)
    lse = torch.zeros(1, 4, 128, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._launch_tri("flash_bwd_dkv_tri", q, q[:, :, :2], q[:, :, :2],
                        scale=1.0, dout=q, lse=lse.transpose(1, 2)
                        .contiguous().transpose(1, 2), delta=lse)


def test_tri_tensor_core_kernels_refuse_misaligned_bf16(dev):
    """The bf16 forward and dQ copy 16-byte chunks: a row stride that is
    not a whole number of them raises ValueError naming the tensor; the
    same layout in f32 (FMA tile steps) runs and matches the plain
    version."""
    S, Hq, row = 128, 2, 2 * 128 + 4
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(dev).manual_seed(8)
        q = _randn(g, 1, S, row, dtype=dtype, dev=dev).as_strided(
            (1, S, Hq, 128), (S * row, row, 128, 1))
        k, v = (_randn(g, 1, S, 1, 128, dtype=dtype, dev=dev)
                for _ in range(2))
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="flash_fwd_tri: q strides"):
                tfa._launch_tri("flash_fwd_tri", q, k, v, scale=1.0)
            continue
        out, lse = tfa._launch_tri("flash_fwd_tri", q, k, v, scale=1.0)
        ref, ref_lse = tfa.attention_plain(q, k.transpose(1, 2),
                                           v.transpose(1, 2), 0, scale=1.0)
        torch.cuda.synchronize()
        assert _err(out, ref) < TOL[dtype] and _err(lse, ref_lse) < 1e-4


def test_bwd_dkv_grid_query_answers_for_the_launch(dev):
    """flash_bwd_dkv launches one block per (batch * kv head, key tile):
    64 keys in bf16 (tensor cores), 32 in f32; another dtype is refused."""
    assert _cuda.bwd_dkv_blocks(2, 4, 1000, 1) == 2 * 4 * 16
    assert _cuda.bwd_dkv_blocks(2, 4, 1000, 0) == 2 * 4 * 32
    with pytest.raises(RuntimeError, match="flash_bwd_dkv_blocks"):
        _cuda.bwd_dkv_blocks(2, 4, 1000, 2)


@pytest.mark.parametrize("act_dtype", [0, 1])
def test_tri_entries_refuse_a_short_workspace(dev, act_dtype):
    """flash_tri.cuh owns the workspace layout, which depends on the act
    dtype (0 f32, 1 bf16: the bf16 dK/dV tile edge is twice the f32 one)
    and the head dim: an entry given fewer than ctas ×
    flash_tri_ws_floats() f32 values (the f32-sized workspace too, where
    that is shorter) returns cudaErrorInvalidValue (1) before it launches
    anything, at every head dim; the queries refuse head dim 48."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    for D in HEAD_DIMS:
        q = torch.zeros(1, 128, 2, D, device=dev,
                        dtype=(torch.float32, torch.bfloat16)[act_dtype])
        for entry in _cuda.TRI_WHICH:
            P = _cuda.tri_ctas(entry, act_dtype, D, dev.index)
            n = P * _cuda.tri_ws_floats(entry, act_dtype, D)
            ws = torch.empty(n, device=dev)
            a = _cuda.FlashTriArgs()
            for name in ("q", "k", "v", "dout", "out", "dq", "dk", "dv"):
                setattr(a, name, q.data_ptr())
            a.lse, a.delta = ws.data_ptr(), ws.data_ptr()
            a.ws = ws.data_ptr()
            a.ws_floats = min(n - 1, P * _cuda.tri_ws_floats(entry, 0, D))
            a.act_dtype, a.B, a.S, a.Hq, a.Hkv, a.D = (act_dtype, 1, 128, 2,
                                                       2, D)
            a.ctas, a.scale = P, 1.0
            assert _cuda.kernel(_cuda.entry(entry, D))(
                ctypes.byref(a), stream) == 1, entry
    for fn in (lambda: _cuda.tri_ctas("flash_fwd_tri", act_dtype, 48,
                                      dev.index),
               lambda: _cuda.tri_ws_floats("flash_fwd_tri", act_dtype, 48)):
        with pytest.raises(RuntimeError, match="D=48"):
            fn()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_and_zigzag_flash_match_plain_on_the_card(dev, dtype):
    """Two ranks sharing the card over gloo, S_local = 256 (zigzag chunks of
    128), D 128, GQA 4/2: the flash ring and zigzag ring's out and
    gradients (the forward and both backward kernels on every live step,
    partials merged by lse) against attention_plain and attention_bwd_plain
    over the whole sequence, out within TOL, gradients within TOL of the
    largest plain one. The ranks only load the kernels built here."""
    _cuda.build()
    rng = np.random.default_rng(7)
    B, S, Hq, Hkv, D = 2, 512, 4, 2, 128
    q, dout = (rng.standard_normal((B, S, Hq, D), np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv, D), np.float32)
            for _ in range(2))
    name = str(dtype).split(".")[1]
    cases = [{"kind": "attention", "mesh": {"sp": 2}, "q": q, "k": k, "v": v,
              "dout": dout, "schedule": sched, "impl": "flash",
              "dtype": name} for sched in ("ring", "zigzag")]
    res = launch.spawn_ranks(jobs.run_cases, 2, backend="gloo", device=dev,
                             timeout_s=300, args=(cases, "cuda"))
    qt, kt, vt, dt = (torch.from_numpy(a).to(dev, dtype)
                      for a in (q, k, v, dout))
    out, lse = tfa.attention_plain(qt, kt.transpose(1, 2),
                                   vt.transpose(1, 2), 0, causal=True)
    want = dict(zip(("dq", "dk", "dv"),
                    tfa.attention_bwd_plain(qt, kt, vt, out, lse, dt)))
    want["out"] = out
    for i in range(len(cases)):
        parts = [r[i] for r in res]
        for key, ref in want.items():
            got = torch.from_numpy(jobs.assemble(parts, key, ref.shape))
            ref = ref.float().cpu()
            err = (got - ref).abs().max().item()
            if key != "out":
                err /= ref.abs().max().item()
            assert err < TOL[dtype], (cases[i]["schedule"], key, err)


def test_pipelined_and_expert_parallel_flash_steps_match_one_process(
        dev, tmp_path):
    """Two ranks sharing the card over gloo, f32, head dim 128: one
    pipelined step (pp 2, two microbatches) of a 2-layer Llama and one
    expert-parallel step (ep 2, capacity factor 0.5: choices drop) of a
    2-layer MoE, both through the flash kernels, against the same step in
    this process from the same seed and batch: the loss within 1e-5
    (relative), each rank's gradient shards within 1e-4 of the largest and
    its params within 1e-5 where |g| >= 1e-7; each rank launched each
    kernel once a microbatch and layer it holds."""
    _cuda.build()
    base = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                hidden_dim=512, max_seq_len=256, dtype="float32",
                attn_impl="flash")
    configs = {"pipeline": tl.LlamaConfig(**base),
               "moe": tm.MoEConfig(**base, n_experts=4,
                                   capacity_factor=0.5)}
    B, S = 4, 128
    cases = []
    for kind, cfg in configs.items():
        g = torch.Generator(dev).manual_seed(3)
        params, opt = (tm.make_moe_train_state(cfg, g, dev) if kind == "moe"
                       else ttrain.make_train_state(cfg, g, dev))
        step = (tm.make_moe_train_step if kind == "moe"
                else ttrain.make_train_step)(cfg, opt)
        loss = step(params, *jobs.seeded_batch(cfg, B, S, 4, dev)).item()

        def grads(tree):
            return {k: grads(v) if isinstance(v, dict) else v.grad
                    for k, v in tree.items()}

        ref = tmp_path / f"{kind}.pt"
        torch.save({"grads": grads(params), "params": params}, ref)
        cases.append(({"kind": kind, "mesh": {"pp": 2} if kind == "pipeline"
                       else {"ep": 2}, "cfg": cfg, "seed": 3,
                       "batch_shape": (B, S), "batch_seed": 4,
                       "reference": str(ref), "n_micro": 2}, loss))
    res = launch.spawn_ranks(jobs.run_cases, 2, backend="gloo", device=dev,
                             timeout_s=300,
                             args=([c for c, _ in cases], "cuda"))
    # a stage applies its 1 layer to 2 microbatches; an expert rank attends
    # its whole block in each of 2 layers
    calls = 2
    for i, (case, loss) in enumerate(cases):
        for r in (r[i] for r in res):
            assert abs(r["losses"][0] - loss) <= 1e-5 * abs(loss), (
                case["kind"], r["losses"], loss)
            assert r["grad_err"] <= 1e-4, (case["kind"], r["grad_err"])
            assert r["param_err"] <= 1e-5, (case["kind"], r["param_err"])
            assert r["launches"]["flash_fwd"] == calls, r["launches"]
            assert r["launches"]["flash_bwd_dq"] == calls, r["launches"]
            assert r["launches"]["flash_bwd_dkv"] == calls, r["launches"]
