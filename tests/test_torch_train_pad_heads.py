"""The training paths at head dims 100 and 120 against the JAX package, on
the CPU.

On the card the backward and triangle kernels take head dims 100 and 120
(csrc/flash_bwd_pad.cu, csrc/flash_tri_pad.cu: D = 128's tile with a
zeroed pad inside its last k-step; at 100 a row of no whole number of
16-byte chunks, copied in 8-byte pieces, every store cut at column 100; at
120 a row of 15 chunks, every store 15 whole 8-column groups), so Llama
configs at OpenLLaMA-3B's widths (32/32 heads of 100) and at
H2O-Danube3-4B's (32/8 heads of 120) train through them. Here the port's
flash path (the kernels' plain versions, on CPU tensors) is held against
the JAX package's (its Pallas kernels in interpret mode, as its own tests
run them) at each head dim, at tests/test_torch_serve_pad_heads.py's
MODELS and HEADS (4/4 heads of 100 and 4/1 of 120, 2 layers, f32; each
also at GQA 4/2). The tests' names are from when 100 was the one head dim
here:
- ``flash_attention_with_lse`` and its gradients against ``jax.vjp``:
  causal, non-causal and windowed, the JAX forward resident or streaming
  (RESIDENT_KV_BUDGET lowered to 0), with and without an lse cotangent:
  out, lse and dQ/dK/dV within 1e-4;
- ``triangular=True`` against the JAX triangle (streaming forced, a 3-row
  triangle of 128-blocks): 2e-5 forward, 1e-4 gradients;
- ``loss_fn``'s gradients against ``jax.value_and_grad`` (1e-4; the loss
  1e-5 relative) and one ``make_train_step`` step against the optax AdamW
  step: params within 1e-4 where |g| >= 1e-7 or g == 0 (elsewhere Adam's
  first step is about lr·sign(g); tests/test_torch_train.py).
The bf16 tensor-core kernels' rounding at 100 (dQ in
tests/test_torch_flash_tc.py, dK/dV in tests/test_torch_flash_tri.py) is
replayed beside the other head dims'.
"""

import dataclasses
import functools
import gc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu.models import train as jtrain
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import train as ttrain
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy
from gpu_provisioner_tpu_torch.ops import flash_attention as tfa

from tests.test_torch_serve_pad_heads import HEADS, MODELS

# the JAX ops package re-exports flash_attention, shadowing the module name
jfa = importlib.import_module("gpu_provisioner_tpu.ops.flash_attention")

# the serving file's model, and the same at GQA 4/2
TRAIN_MODELS = dict(MODELS, **{
    f"{name}-gqa": dataclasses.replace(cfg, n_kv_heads=2)
    for name, cfg in MODELS.items()})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The JAX references compile while the port runs small ops: one torch
    thread keeps the module's CPU time to its own work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches():
    """Drops what this module compiled once it is done: a later test in the
    same worker would otherwise pay for those objects in every full garbage
    collection."""
    yield
    _params.cache_clear()
    jax.clear_caches()
    gc.collect()


@functools.cache
def _params(model: str):
    """The JAX params of TRAIN_MODELS[model], seed 0."""
    return jl.init_params(jax.random.key(0), TRAIN_MODELS[model])


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _vjp_against_jax(q, k, v, g_out, g_lse, *, atol_out, atol_grad, **kw):
    """Out, lse and the gradients of (out, lse) with cotangents (g_out,
    g_lse) through the port's flash_attention_with_lse against jax.vjp of
    the JAX one (blocks of 128, interpret mode), both from numpy."""
    outs, vjp = jax.vjp(lambda *a: jfa.flash_attention_with_lse(
        *a, block_q=128, block_k=128, interpret=True, **kw),
        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = tfa.flash_attention_with_lse(*leaves, **kw)
    grads = torch.autograd.grad((out, lse), leaves, (
        torch.from_numpy(g_out), torch.from_numpy(g_lse)))
    for got, want, atol in ((out, outs[0], atol_out), (lse, outs[1], atol_out),
                            *((g, jg, atol_grad) for g, jg in
                              zip(grads, jgrads))):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=atol, rtol=atol)


@pytest.mark.parametrize("causal,window,streaming,with_lse", [
    pytest.param(True, None, False, True, id="causal-resident-lse"),
    pytest.param(False, None, True, True, id="full-streaming-lse"),
    pytest.param(True, 96, True, False, id="window-streaming")])
@pytest.mark.parametrize("heads", list(HEADS))
def test_flash_gradients_match_jax_vjp(monkeypatch, heads, causal, window,
                                       streaming, with_lse):
    """Self-attention at S = 256, HEADS' head dims and heads: out, lse and
    dQ/dK/dV against jax.vjp within 1e-4, the JAX forward resident or
    streaming (its backward is the same kernels either way), an lse
    cotangent or none."""
    if streaming:
        monkeypatch.setattr(jfa, "RESIDENT_KV_BUDGET", 0)
    D, Hq, Hkv = HEADS[heads]
    q, k, v, g_out, g_lse = _normal(1, (2, 256, Hq, D), (2, 256, Hkv, D),
                                    (2, 256, Hkv, D), (2, 256, Hq, D),
                                    (2, Hq, 256))
    if not with_lse:
        g_lse = np.zeros_like(g_lse)
    _vjp_against_jax(q, k, v, g_out, g_lse, atol_out=1e-4, atol_grad=1e-4,
                     causal=causal, window=window)


@pytest.mark.parametrize("with_lse", [True, False])
@pytest.mark.parametrize("heads", list(HEADS))
def test_triangular_matches_jax_triangular(monkeypatch, heads, with_lse):
    """triangular=True at S = 384 (a 3-row triangle of 128-blocks; the
    streaming regime forced on both sides, so the JAX side runs its tri
    kernels #3, #8 and #9): the forward within 2e-5, the gradients within
    1e-4, with an lse cotangent or none."""
    monkeypatch.setattr(jfa, "RESIDENT_KV_BUDGET", 0)
    monkeypatch.setattr(tfa, "RESIDENT_KV_BUDGET", 0)
    D, Hq, Hkv = HEADS[heads]
    q, k, v, g_out, g_lse = _normal(7, (1, 384, Hq, D), (1, 384, Hkv, D),
                                    (1, 384, Hkv, D), (1, 384, Hq, D),
                                    (1, Hq, 384))
    if not with_lse:
        g_lse = np.zeros_like(g_lse)
    _vjp_against_jax(q, k, v, g_out, g_lse, atol_out=2e-5, atol_grad=1e-4,
                     triangular=True)


def _named(tree):
    """{path: leaf} of a nested dict, in the tree's order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": x for n, x in _named(v).items()})
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("model", list(TRAIN_MODELS))
def test_loss_grads_and_train_step_match_jax(model):
    """attn_impl="flash" at (2, 128), each model at its heads and at GQA
    4/2: the loss and every gradient against jax.value_and_grad (the JAX
    side runs its Pallas backward in interpret mode, the port the plain
    versions of the kernels that take head dims 100 and 120 on the card),
    then one make_train_step step
    against the optax AdamW step from those gradients."""
    jcfg, jparams = TRAIN_MODELS[model], _params(model)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 129),
                                             dtype=np.int32)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    jloss, jgrads = jax.value_and_grad(jtrain.loss_fn)(
        jparams, jnp.asarray(inp), jnp.asarray(tgt), jcfg)

    def state():
        return ttrain.train_state_from(params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu"))

    params, _ = state()
    loss = ttrain.loss_fn(params, torch.from_numpy(inp),
                          torch.from_numpy(tgt), tcfg)
    grads = dict(zip(_named(params), torch.autograd.grad(
        loss, ttrain.param_leaves(params))))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _named(jgrads)
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   atol=1e-4, err_msg=name)

    opt = jtrain.default_optimizer()
    updates, _ = opt.update(jgrads, opt.init(jparams), jparams)
    want_p = _named(optax.apply_updates(jparams, updates))
    params, optimizer = state()
    loss = ttrain.make_train_step(tcfg, optimizer)(
        params, torch.from_numpy(inp), torch.from_numpy(tgt))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    excluded = 0
    for name, p in _named(params).items():
        gj = np.asarray(want[name])
        steady = (np.abs(gj) >= 1e-7) | (gj == 0)
        excluded += int((~steady).sum())
        np.testing.assert_allclose(p.detach().numpy()[steady],
                                   np.asarray(want_p[name])[steady],
                                   atol=1e-4, err_msg=name)
    n = sum(p.numel() for p in ttrain.param_leaves(params))
    assert excluded < n // 1000, f"{excluded} of {n} elements excluded"
