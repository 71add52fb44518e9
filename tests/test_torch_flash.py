"""The port's attention kernels' functions against the JAX package's.

Every case feeds the same numpy inputs (made from a seed) to the JAX
function, its Pallas kernel run in interpret mode as tests/test_ops.py runs
it, and to the port's wrapper on CPU tensors, which runs the kernel's plain
version. Tolerance: 1e-5 absolute and relative in f32 (the two sides sum in
another order; the functions are identical).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_provisioner_tpu.parallel import ring as jring
from gpu_provisioner_tpu_torch.ops import flash_attention as tfa
from gpu_provisioner_tpu_torch.parallel import ring as tring

# the JAX ops package re-exports flash_attention, shadowing the module name
jfa = importlib.import_module("gpu_provisioner_tpu.ops.flash_attention")
TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().cpu().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _cache(seed, B, Hkv, ML, D, int8):
    """(jax kwargs, torch kwargs) for a head-major cache, int8 with scales
    when asked (quantised by the JAX package's own _quantize_kv)."""
    from gpu_provisioner_tpu.models.decode import _quantize_kv
    kc, vc = _rand(seed, (B, Hkv, ML, D), (B, Hkv, ML, D))
    if not int8:
        return ((jnp.asarray(kc), jnp.asarray(vc), {}),
                (torch.from_numpy(kc), torch.from_numpy(vc), {}))
    kq, ks = (np.array(a) for a in _quantize_kv(jnp.asarray(kc)))
    vq, vs = (np.array(a) for a in _quantize_kv(jnp.asarray(vc)))
    jx = (jnp.asarray(kq), jnp.asarray(vq),
          dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    tx = (torch.from_numpy(kq), torch.from_numpy(vq),
          dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)))
    return jx, tx


@pytest.mark.parametrize("variant", ["resident", "streaming"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 100)])
@pytest.mark.parametrize("kv_heads", [4, 2])       # GQA groups 1 and 2
def test_flash_attention_with_lse_matches_jax(monkeypatch, variant, causal,
                                              window, kv_heads):
    if variant == "streaming":
        monkeypatch.setattr(jfa, "RESIDENT_KV_BUDGET", 0)
    q, k, v = _rand(0, (2, 256, 4, 32), (2, 256, kv_heads, 32),
                    (2, 256, kv_heads, 32))
    jo, jl = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, interpret=True, block_q=128, block_k=128)
    to, tl = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window)
    _close(to, jo)
    _close(tl, jl)
    _close(tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window), jo)


def test_flash_non_tiling_shape_takes_dense_path():
    q, k, v = _rand(1, (1, 100, 4, 16), (1, 100, 2, 16), (1, 100, 2, 16))
    jo, jl = jfa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), interpret=True)
    to, tl = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    _close(to, jo)
    _close(tl, jl)


@pytest.mark.parametrize("window,sinks", [(None, 0), (16, 0), (16, 3)])
def test_dense_attention_with_lse_matches_jax(window, sinks):
    q, k, v = _rand(2, (2, 48, 4, 16), (2, 48, 2, 16), (2, 48, 2, 16))
    jo, jl = jring.dense_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        sinks=sinks)
    to, tl = tring.dense_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=window, sinks=sinks)
    _close(to, jo)
    _close(tl, jl)


def test_fully_masked_rows_give_zeros_and_neg_inf_lse():
    """A pad floor above every query position masks every key."""
    q, k, v = _rand(3, (1, 4, 2, 16), (1, 2, 8, 16), (1, 2, 8, 16))
    out, lse = tfa.attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0,
        pad_lens=torch.tensor([6]))
    assert torch.all(out == 0)
    assert torch.all(lse == tfa.NEG_INF)


CACHED_CASES = [
    # (start, pads, int8, window, sinks)
    (0, False, False, None, 0),
    (37, False, False, None, 0),
    (130, False, False, None, 0),
    (384, False, False, None, 0),          # the last position: start + S = ML
    (0, True, False, None, 0),
    (130, True, True, None, 0),
    (37, False, True, None, 0),
    (130, False, False, 100, 0),
    (130, True, False, 100, 4),
    (384, False, True, 150, 4),
]


@pytest.mark.parametrize("start,pads,int8,window,sinks", CACHED_CASES)
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_flash_attention_cached_matches_jax(start, pads, int8, window, sinks,
                                            kv_heads):
    B, S, Hq, ML, D = 2, 128, 4, 512, 16
    assert tfa.cached_flash_supported(S, ML, Hq, kv_heads)
    (q,) = _rand(10 + start, (B, S, Hq, D))
    (jk, jv, jkw), (tk, tv, tkw) = _cache(20 + start, B, kv_heads, ML, D,
                                          int8)
    pad_lens = np.asarray([0, 70], np.int32) if pads else None
    if pads:
        jkw["pad_lens"] = jnp.asarray(pad_lens)
        tkw["pad_lens"] = torch.from_numpy(pad_lens)
    want = jfa.flash_attention_cached(
        jnp.asarray(q), jk, jv, jnp.asarray(start, jnp.int32),
        interpret=True, window=window, sinks=sinks, **jkw)
    got = tfa.flash_attention_cached(torch.from_numpy(q), tk, tv, start,
                                     window=window, sinks=sinks, **tkw)
    _close(got, want)
    # a one-element tensor start is the same call
    got_t = tfa.flash_attention_cached(torch.from_numpy(q), tk, tv,
                                       torch.tensor(start), window=window,
                                       sinks=sinks, **tkw)
    _close(got_t, want)


DECODE_CASES = [
    # (start, S, pads, int8, window, sinks)
    (0, 1, False, False, None, 0),
    (37, 1, False, False, None, 0),
    (130, 5, False, False, None, 0),
    (251, 5, False, False, None, 0),       # the last position: start + S = ML
    (255, 1, True, False, None, 0),
    ([37, 130], 1, False, False, None, 0),
    ([130, 0], 5, True, False, None, 0),
    ([251, 37], 5, True, True, None, 0),
    (130, 1, False, True, None, 0),
    (130, 5, False, False, 50, 0),
    ([200, 130], 1, True, False, 50, 3),
    (251, 5, False, True, 60, 2),
]


@pytest.mark.parametrize("start,S,pads,int8,window,sinks", DECODE_CASES)
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_flash_attention_decode_matches_jax(start, S, pads, int8, window,
                                            sinks, kv_heads):
    B, Hq, ML, D = 2, 4, 256, 16
    assert tfa.decode_flash_supported(ML, Hq, kv_heads, S=S)
    (q,) = _rand(30 + S, (B, S, Hq, D))
    (jk, jv, jkw), (tk, tv, tkw) = _cache(40 + S, B, kv_heads, ML, D, int8)
    if pads:
        pad_lens = np.asarray([20, 0], np.int32)
        jkw["pad_lens"] = jnp.asarray(pad_lens)
        tkw["pad_lens"] = torch.from_numpy(pad_lens)
    st = np.asarray(start, np.int32)
    want = jfa.flash_attention_decode(
        jnp.asarray(q), jk, jv, jnp.asarray(st), interpret=True,
        window=window, sinks=sinks, **jkw)
    t_start = torch.from_numpy(st) if st.ndim else int(st)
    got = tfa.flash_attention_decode(torch.from_numpy(q), tk, tv, t_start,
                                     window=window, sinks=sinks, **tkw)
    _close(got, want)


def test_wrappers_refuse_gradients_and_long_decode_blocks():
    """The KV-cache wrappers are forward-only, as their JAX twins are (no
    VJP); self-attention is differentiable (tests/test_torch_flash_bwd.py)."""
    q, k, v = _rand(5, (1, 128, 2, 16), (1, 2, 128, 16), (1, 2, 128, 16))
    tq = torch.from_numpy(q).requires_grad_()
    kv = torch.from_numpy(k), torch.from_numpy(v)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tfa.flash_attention_cached(tq, *kv, 0)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tfa.flash_attention_decode(tq[:, :1], *kv, 0)
    with torch.no_grad():
        tfa.flash_attention_cached(tq, *kv, 0)
    kc = torch.zeros(1, 2, 128, 16)
    with pytest.raises(ValueError, match="short query blocks"):
        tfa.flash_attention_decode(torch.zeros(1, 17, 2, 16), kc, kc, 0)
    with pytest.raises(ValueError, match="one start"):
        tfa.flash_attention_cached(torch.zeros(2, 128, 2, 16),
                                   torch.zeros(2, 2, 128, 16),
                                   torch.zeros(2, 2, 128, 16),
                                   torch.tensor([0, 1]))


@pytest.mark.parametrize("args", [(128, 256, 4, 2), (64, 256, 4, 2),
                                  (256, 100, 4, 2), (384, 768, 4, 2),
                                  (128, 256, 4, 3)])
def test_gates_match_jax(args):
    assert tfa.cached_flash_supported(*args) == \
        jfa.cached_flash_supported(*args)
    ML, Hq, Hkv = args[1:]
    for S in (1, 5, 16, 17):
        assert tfa.decode_flash_supported(ML, Hq, Hkv, S=S) == \
            jfa.decode_flash_supported(ML, Hq, Hkv, S=S)
