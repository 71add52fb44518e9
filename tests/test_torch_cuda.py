"""The CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode: every test here takes the ``dev`` fixture,
which skips without a card (the plain versions are held against the JAX
package in tests/test_torch_flash.py). Run on a machine with an H100:
``python -m pytest tests/test_torch_cuda.py -q``. Tolerances: f32 1e-4
absolute (the kernel sums tiles in another order), bf16 1e-2 absolute (one
bf16 rounding of the output; the largest error seen on an H100 was 3.9e-3).
"""

import pytest
import torch

from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.models import engine as te
from gpu_provisioner_tpu_torch.models import llama as tl
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
