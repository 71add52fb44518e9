"""The port's flash attention gradients against the JAX package's.

The same numpy inputs (made from a seed) and cotangents on out AND lse go
to ``jax.vjp`` of the JAX ``flash_attention_with_lse``, whose backward runs
the Pallas kernels _bwd_dq_kernel / _bwd_dkv_kernel in interpret mode (as
tests/test_ops.py runs them), and to ``torch.autograd.grad`` of the port's
on CPU tensors, which runs the kernels' plain versions (attention_plain
forward, attention_bwd_plain backward). Tolerance: f32, 1e-4 absolute and
relative, the bound the JAX package's own gradient tests use.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_provisioner_tpu_torch.ops import flash_attention as tfa

# the JAX ops package re-exports flash_attention, shadowing the module name
jfa = importlib.import_module("gpu_provisioner_tpu.ops.flash_attention")
TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _inputs(seed, B, S, Hq, Hkv, D):
    return _rand(seed, (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                 (B, S, Hq, D), (B, Hq, S))


def _jax_grads(fn, q, k, v, g_out, g_lse):
    outs, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return outs, vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))


def _port_grads(fn, q, k, v, g_out, g_lse):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    outs = fn(*leaves)
    return outs, torch.autograd.grad(
        outs, leaves, (torch.from_numpy(g_out), torch.from_numpy(g_lse)))


@pytest.mark.parametrize("variant", ["resident", "streaming"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 100)])
@pytest.mark.parametrize("kv_heads,D", [       # GQA groups 1 and 2
    pytest.param(4, 32, id="4"), pytest.param(2, 32, id="2"),
    pytest.param(4, 64, id="4-d64"), pytest.param(2, 64, id="2-d64")])
def test_flash_grads_match_jax_vjp(monkeypatch, variant, causal, window,
                                   kv_heads, D):
    """Head dim 32 (the JAX fast models') and 64 (the fast
    bench_train_step model's, which the backward kernels take on the
    card)."""
    if variant == "streaming":
        monkeypatch.setattr(jfa, "RESIDENT_KV_BUDGET", 0)
    args = _inputs(0, 2, 256, 4, kv_heads, D)
    (jo, jl), jgrads = _jax_grads(
        lambda q, k, v: jfa.flash_attention_with_lse(
            q, k, v, causal=causal, window=window, interpret=True,
            block_q=128, block_k=128), *args)
    (to, tl), tgrads = _port_grads(
        lambda q, k, v: tfa.flash_attention_with_lse(
            q, k, v, causal=causal, window=window), *args)
    _close(to, jo)
    _close(tl, jl)
    for got, want in zip(tgrads, jgrads):
        _close(got, want)


def test_flash_attention_drops_the_lse_cotangent():
    """flash_attention's gradient is the with_lse one with g_lse = 0."""
    q, k, v, g_out, _ = _inputs(1, 1, 128, 4, 2, 32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention(*leaves), leaves,
                              torch.from_numpy(g_out))
    _, jgrads = _jax_grads(
        lambda *a: jfa.flash_attention_with_lse(*a, interpret=True), q, k, v,
        g_out, np.zeros((1, 4, 128), np.float32))
    for g, w in zip(got, jgrads):
        _close(g, w)


def test_non_tiling_shape_differentiates_the_dense_path():
    args = _inputs(2, 1, 100, 4, 2, 16)
    (jo, jl), jgrads = _jax_grads(
        lambda *a: jfa.flash_attention_with_lse(*a, interpret=True), *args)
    (to, tl), tgrads = _port_grads(tfa.flash_attention_with_lse, *args)
    _close(to, jo)
    _close(tl, jl)
    for got, want in zip(tgrads, jgrads):
        _close(got, want)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40), (False, 40)])
@pytest.mark.parametrize("kv_heads", [4, 1])
def test_attention_bwd_plain_matches_autograd_of_attention_plain(
        causal, window, kv_heads):
    """The explicit backward math against autograd through the forward's
    plain version, cotangents on both outputs."""
    q, k, v, g_out, g_lse = (torch.from_numpy(a) for a in
                             _inputs(3, 2, 96, 4, kv_heads, 16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = tfa.attention_plain(leaves[0], leaves[1].transpose(1, 2),
                                   leaves[2].transpose(1, 2), 0,
                                   causal=causal, window=window)
    want = torch.autograd.grad((out, lse), leaves, (g_out, g_lse),
                               retain_graph=True)
    got = tfa.attention_bwd_plain(q, k, v, out.detach(), lse.detach(), g_out,
                                  g_lse, causal=causal, window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    # no lse cotangent: the same math with Δ alone
    want = torch.autograd.grad(out, leaves, g_out)
    got = tfa.attention_bwd_plain(q, k, v, out.detach(), lse.detach(), g_out,
                                  causal=causal, window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_bwd_plain_zeroes_rows_that_attend_nothing():
    """lse = NEG_INF marks a row with nothing attendable: P = 0 there, so
    the row gets no dQ and sends nothing to dK/dV (the kernels' guard) —
    as if its cotangent were zero."""
    q, k, v, g_out, _ = (torch.from_numpy(a) for a in
                         _inputs(4, 1, 8, 2, 2, 16))
    out, lse = tfa.attention_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                                   0)
    dead = lse.clone()
    dead[:, :, 3] = tfa.NEG_INF
    dq, dk, dv = tfa.attention_bwd_plain(q, k, v, out, dead, g_out)
    assert torch.all(dq[:, 3] == 0)
    quiet = g_out.clone()
    quiet[:, 3] = 0
    _, dk0, dv0 = tfa.attention_bwd_plain(q, k, v, out, lse, quiet)
    torch.testing.assert_close(dk, dk0, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dv, dv0, atol=1e-6, rtol=1e-6)


def test_triangular_reference_equals_the_same_port_kernels(monkeypatch):
    """The JAX flattened-triangle kernels (#3 forward, #8/#9 backward, opt-in
    triangular=True) against the port's flash_attention(triangular=True),
    whose CPU path is the same plain versions as the rectangular kernels'.
    Forward and grads at the shape of the JAX package's own triangular test
    (S=384, streaming)."""
    monkeypatch.setattr(jfa, "RESIDENT_KV_BUDGET", 0)
    monkeypatch.setattr(tfa, "RESIDENT_KV_BUDGET", 0)
    q, k, v, g_out, _ = _inputs(5, 1, 384, 2, 1, 32)
    out, jgrads = _jax_grads(
        lambda *a: jfa.flash_attention_with_lse(
            *a, triangular=True, block_q=128, block_k=128, interpret=True),
        q, k, v, g_out, np.zeros((1, 2, 384), np.float32))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    to = tfa.flash_attention(*leaves, triangular=True)
    _close(to, out[0])
    for got, want in zip(torch.autograd.grad(to, leaves,
                                             torch.from_numpy(g_out)),
                         jgrads):
        _close(got, want)


def test_bf16_gradients_come_back_in_bf16():
    """bf16 inputs: the plain backward computes in f32 and returns each
    gradient in its input's dtype, as the JAX backward does; the values are
    the f32 gradients of the same (bf16-rounded) inputs, rounded once."""
    q, k, v, g_out, _ = _inputs(6, 1, 128, 4, 2, 32)
    bf = [torch.from_numpy(a).bfloat16() for a in (q, k, v, g_out)]
    leaves = [t.clone().requires_grad_() for t in bf[:3]]
    grads = torch.autograd.grad(tfa.flash_attention(*leaves), leaves, bf[3])
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    f32 = [t.float().requires_grad_() for t in bf[:3]]
    want = torch.autograd.grad(tfa.flash_attention(*f32), f32, bf[3].float())
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.float(), w, atol=2e-2, rtol=1e-2)


def _cat_cotangent(shape, other=12):
    """The gradient autograd hands to a bf16 tensor that went into
    torch.cat(..., dim=-1) beside a piece ``other`` wide: a narrow of the
    cat's gradient, head stride 128 + ``other``."""
    x = torch.zeros(shape, dtype=torch.bfloat16, requires_grad=True)
    seen = []
    y = x * 1
    y.register_hook(seen.append)
    z = torch.cat([y, torch.zeros(*shape[:-1], other, dtype=torch.bfloat16)],
                  -1)
    g = torch.from_numpy(_rand(8, z.shape)[0]).bfloat16()
    z.backward(g)
    return seen[0]


@pytest.mark.parametrize("layout", ["offset", "cat"])
def test_tc_layout_copies_what_the_tensor_core_kernels_refuse(layout):
    """A bf16 tensor whose base is off a 16-byte boundary (a storage offset
    of 4 elements) or whose head stride is not a whole number of 16-byte
    chunks (the width-12 narrow torch.cat's gradient gives back): the
    tensor-core kernels' check refuses it, and _tc_layout returns a copy
    the check accepts, equal to it; a tensor the check accepts comes back
    as itself."""
    S, Hq = 16, 2
    if layout == "offset":
        flat = torch.from_numpy(_rand(9, (S * Hq * 128 + 4,))[0]).bfloat16()
        t = flat[4:].view(1, S, Hq, 128)
    else:
        t = _cat_cotangent((1, S, Hq, 128))
        assert t.stride()[2] == 140
    ok = torch.zeros(1, S, Hq, 128, dtype=torch.bfloat16)
    assert tfa._tc_copy_fault(t) is not None
    with pytest.raises(ValueError, match="flash_bwd_dkv: dout"):
        tfa._check_tc_copies("flash_bwd_dkv", q=ok, k=ok, v=ok, dout=t)
    got = tfa._tc_layout(t)
    assert tfa._tc_copy_fault(got) is None and got.stride(-1) == 1
    assert torch.equal(got, t)
    tfa._check_tc_copies("flash_bwd_dkv", q=ok, k=ok, v=ok, dout=got)
    assert tfa._tc_layout(ok) is ok
    # any dtype: a head dim that is not contiguous is copied too
    cols = torch.zeros(1, S, 128, Hq).transpose(2, 3)
    assert tfa._tc_layout(cols).stride(-1) == 1


def test_launch_bwd_refuses_misaligned_bf16_copies_before_it_builds():
    """flash_bwd_dkv's bf16 instance copies q, k, v and dout in 16-byte
    chunks: a dout off a 16-byte boundary raises ValueError naming it
    before the kernel library (nvcc, a card) is asked for."""
    S, Hq, Hkv = 128, 2, 1
    q = torch.zeros(1, S, Hq, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, S, Hkv, 128, dtype=torch.bfloat16)
    dout = torch.zeros(S * Hq * 128 + 4, dtype=torch.bfloat16)[4:].view(
        1, S, Hq, 128)
    lse = torch.zeros(1, Hq, S)
    with pytest.raises(ValueError, match=r"flash_bwd_dkv: dout is not "
                                         r"16-byte aligned"):
        tfa._launch_bwd("flash_bwd_dkv", q, k, k, dout, lse, lse,
                        causal=True, scale=1.0)


@pytest.mark.parametrize("triangular", [False, True])
def test_backward_takes_a_cotangent_through_torch_cat(monkeypatch,
                                                      triangular):
    """flash_attention's output through torch.cat beside a 12-wide piece:
    autograd hands its backward the narrow of the cat's gradient, which the
    tensor-core kernels refuse; the backward copies it (_tc_layout) and the
    gradients equal those from the same cotangent laid out contiguously
    (here through the plain versions; on the card, tests/test_torch_cuda.py
    holds the kernels)."""
    monkeypatch.setattr(tfa, "RESIDENT_KV_BUDGET", 0)
    q, k, v, g_out, _ = _inputs(10, 1, 128, 4, 2, 128)
    bf = [torch.from_numpy(a).bfloat16() for a in (q, k, v, g_out)]
    extra = torch.from_numpy(_rand(11, (1, 128, 4, 12))[0]).bfloat16()
    leaves = [t.clone().requires_grad_() for t in bf[:3]]
    out = tfa.flash_attention(*leaves, triangular=triangular)
    got = torch.autograd.grad(torch.cat([out, extra], -1), leaves,
                              torch.cat([bf[3], extra], -1))
    want = torch.autograd.grad(
        tfa.flash_attention(*leaves, triangular=triangular), leaves, bf[3])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
