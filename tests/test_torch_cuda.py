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
one CTA's share.
"""

import ctypes
import dataclasses

import pytest
import torch

from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.models import engine as te
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import train as ttrain
from gpu_provisioner_tpu_torch.ops import _cuda
from gpu_provisioner_tpu_torch.ops import flash_attention as tfa

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [256, 512])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 200)])
def test_flash_fwd_matches_plain(dev, dtype, S, causal, window):
    g = torch.Generator(dev).manual_seed(0)
    q = _randn(g, 2, S, 8, 128, dtype=dtype, dev=dev)
    k = _randn(g, 2, S, 2, 128, dtype=dtype, dev=dev)
    v = _randn(g, 2, S, 2, 128, dtype=dtype, dev=dev)
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal,
                                            window=window)
    ref, ref_lse = tfa.attention_plain(q, k.transpose(1, 2),
                                       v.transpose(1, 2), 0, causal=causal,
                                       window=window)
    torch.cuda.synchronize()
    assert _err(out, ref) < TOL[dtype]
    assert _err(lse, ref_lse) < 1e-4


CASES = [
    # (B, S, start, pads, int8, window, sinks)
    (1, 128, 0, [40], False, None, 0),
    (2, 256, 300, [0, 100], True, None, 0),
    (1, 128, 900, None, False, 256, 4),
    (2, 1, [600, 37], [0, 20], False, None, 0),
    (2, 5, [1000, 130], [3, 0], True, 300, 2),
    (2, 16, 1500, None, False, None, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,start,pads,int8,window,sinks", CASES)
def test_cache_kernels_match_plain(dev, dtype, B, S, start, pads, int8,
                                   window, sinks):
    g = torch.Generator(dev).manual_seed(1)
    Hq, Hkv, ML, D = 32, 8, 2048, 128
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
    else:
        got = tfa.flash_attention_cached(q, kc, vc, st, **kw)
    ref = tfa.attention_plain(q, kc, vc, st, **kw)[0]
    torch.cuda.synchronize()
    assert _err(got, ref) < TOL[dtype]


def test_decode_rows_beyond_one_block(dev):
    """group 8 x S 16 = 128 query rows per kv head: two row blocks."""
    g = torch.Generator(dev).manual_seed(2)
    q = _randn(g, 1, 16, 16, 128, dtype=torch.float32, dev=dev)
    kc = _randn(g, 1, 2, 256, 128, dtype=torch.float32, dev=dev)
    vc = _randn(g, 1, 2, 256, 128, dtype=torch.float32, dev=dev)
    got = tfa.flash_attention_decode(q, kc, vc, 200)
    ref = tfa.attention_plain(q, kc, vc, 200)[0]
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-4


def test_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    for D in (16, 64):
        q = torch.zeros(1, 128, 4, D, device=dev)
        with pytest.raises(ValueError, match="head dim"):
            tfa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros(1, 128, 4, 128, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(q, q[:, :, :2], q[:, :, :2])


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,kv_heads", [(256, 2), (512, 8)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 200), (False, 200)])
def test_flash_bwd_matches_plain(dev, dtype, S, kv_heads, causal, window):
    g = torch.Generator(dev).manual_seed(3)
    q = _randn(g, 2, S, 8, 128, dtype=dtype, dev=dev)
    k = _randn(g, 2, S, kv_heads, 128, dtype=dtype, dev=dev)
    v = _randn(g, 2, S, kv_heads, 128, dtype=dtype, dev=dev)
    dout = _randn(g, 2, S, 8, 128, dtype=dtype, dev=dev)
    g_lse = _randn(g, 2, 8, S, dtype=torch.float32, dev=dev)
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal,
                                            window=window)
    kw = dict(causal=causal, window=window)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, g_lse, **kw)
    want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel(a, b) < TOL[dtype]


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
    q = torch.zeros(1, 128, 4, 64, device=dev)
    lse = torch.zeros(1, 4, 128, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_bwd(q, q[:, :, :2], q[:, :, :2], q, lse, q)
    q = torch.zeros(1, 128, 4, 128, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._launch_bwd("flash_bwd_dq", q, q[:, :, :2], q[:, :, :2], q,
                        lse.transpose(1, 2).contiguous().transpose(1, 2),
                        lse, causal=True, scale=1.0)


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


# (B, S, Hq, Hkv, lse cotangent): W < P with every row cut (S 128, 384),
# whole rows beside cut ones (S 2048)
TRI_CASES = [(1, 128, 1, 1, False), (1, 384, 2, 1, True),
             (2, 2048, 16, 8, False)]


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
    q = torch.zeros(1, 128, 4, 64, device=dev)
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


def test_tri_entries_refuse_a_short_workspace(dev):
    """flash_tri.cu owns the workspace layout: an entry given fewer than
    ctas × flash_tri_ws_floats() f32 values returns cudaErrorInvalidValue
    (1) before it launches anything."""
    q = torch.zeros(1, 128, 2, 128, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for entry in _cuda.TRI_WHICH:
        P = _cuda.tri_ctas(entry, 0, dev.index)
        n = P * _cuda.tri_ws_floats(entry)
        ws = torch.empty(n, device=dev)
        a = _cuda.FlashTriArgs()
        for name in ("q", "k", "v", "dout", "out", "dq", "dk", "dv"):
            setattr(a, name, q.data_ptr())
        a.lse, a.delta = ws.data_ptr(), ws.data_ptr()
        a.ws, a.ws_floats = ws.data_ptr(), n - 1
        a.act_dtype, a.B, a.S, a.Hq, a.Hkv, a.D = 0, 1, 128, 2, 2, 128
        a.ctas, a.scale = P, 1.0
        assert _cuda.kernel(entry)(ctypes.byref(a), stream) == 1, entry
